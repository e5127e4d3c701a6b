"""`easydist_tpu_torch.sim.Autoscaler` over a live port `FleetRouter`,
held against the JAX package's autoscaler over a JAX router from the same
weights and the same scripted (or planned) targets
(tests/test_fleet/test_autoscale.py): every decision (tick, live replicas,
occupancy, queue depth, action, reason, target) equals the JAX one, drains
and joins under live traffic drop nothing and leave the ids equal to one
fixed session's, hysteresis and cooldown suppress flaps, and both fault
points degrade to hold and recover."""

import numpy as np
import pytest

import easydist_tpu.sim as jsim
import easydist_tpu_torch.sim as tsim
from tests.test_torch_fleet import model, sides  # noqa: F401

# the decision fields both packages compute from the same traffic; the
# latency percentiles are host-clock readings and differ run to run
FIELDS = ("tick", "n_live", "occupancy", "queue_depth", "action", "reason",
          "target", "added", "drained", "pending", "degraded")


def _prompts(cfg, n=8, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab, size=4 + i % 3).tolist()
            for i in range(n)]


class _ScriptedPlanner:
    """`target_replicas` returns the scripted value for the current call
    index (last value repeats)."""

    def __init__(self, targets):
        self.targets = list(targets)
        self.calls = 0

    def target_replicas(self, traffic, slo):
        t = self.targets[min(self.calls, len(self.targets) - 1)]
        self.calls += 1
        return t


def _sim(s):
    return tsim if s.port else jsim


def _scaler(s, router, targets=None, planner=None, slo=None, traffic=None,
            **cfg_kw):
    cfg_kw.setdefault("min_replicas", 1)
    cfg_kw.setdefault("max_replicas", 3)
    sc = _sim(s).Autoscaler(
        router, spawn=lambda rid: s.mk(rid),
        config=_sim(s).AutoscaleConfig(**cfg_kw),
        planner=planner or _ScriptedPlanner(targets),
        slo=slo if slo is not None else object())
    sc.set_traffic_hint(traffic if traffic is not None else object())
    return sc


def _decisions(scaler):
    return [{k: d[k] for k in FIELDS if k in d} for d in scaler.decision_log]


def _n_live(router):
    return len(router.live_decode_snapshot())


def _ramp(s, starts, targets, n_req, per_tick, ticks, plan="", max_new=4,
          **cfg_kw):
    """Drive a router of `starts` replicas through `ticks` control ticks,
    submitting `per_tick` requests each; returns ids, decisions, the live
    count and the scaler's stats."""
    prompts = _prompts(s.cfg, n=n_req)
    router = s.fleet.FleetRouter([s.mk(r) for r in starts])
    scaler = _scaler(s, router, targets, **cfg_kw)
    futs, queue = [], list(prompts)
    with s.fi.fault_plan(plan):
        for _ in range(ticks):
            for _ in range(per_tick):
                if queue:
                    futs.append(router.submit(queue.pop(0),
                                              max_new_tokens=max_new))
            router.step()
            scaler.evaluate()
        router.run_until_drained()
        assert s.fi.unfired() == []
    out = [f.result(timeout=5) for f in futs]
    assert all(o["finish_reason"] == "length" for o in out)
    return {"ids": [o["ids"] for o in out], "decisions": _decisions(scaler),
            "live": _n_live(router), "stats": {
                k: v for k, v in scaler.stats().items()
                if k != "decision_log"}}


def _twin(sides, **kw):
    got = [_ramp(s, **kw) for s in sides]
    assert got[1] == got[0]
    return got[1]


class TestDrainWhileRamping:
    def test_scale_down_drains_under_live_traffic(self, sides):
        got = _twin(sides, starts=("d0", "d1"), targets=[1], n_req=8,
                    per_tick=2, ticks=12)
        assert got["ids"] == sides[0].reference(_prompts(sides[0].cfg), 4)
        assert got["stats"]["scale_downs"] == 1 and got["live"] == 1

    def test_scale_up_joins_mid_stream(self, sides):
        got = _twin(sides, starts=("d0",), targets=[2], n_req=8,
                    per_tick=1, ticks=12)
        assert got["ids"] == sides[0].reference(_prompts(sides[0].cfg), 4)
        assert got["stats"]["scale_ups"] == 1 and got["live"] == 2


class TestHysteresis:
    def test_flipping_target_never_actuates(self, sides):
        got = _twin(sides, starts=("h0",), targets=[2, 1] * 4, n_req=0,
                    per_tick=0, ticks=8)
        assert got["stats"]["actions"] == 0
        reasons = {d["reason"] for d in got["decisions"]}
        assert {"hysteresis_pending", "at_target"} <= reasons

    def test_cooldown_suppresses_opposite_direction(self, sides):
        got = _twin(sides, starts=("c0",), targets=[2, 2, 1, 1, 1, 1, 1, 1],
                    n_req=0, per_tick=0, ticks=8, confirm_evals=2,
                    cooldown_evals=2)
        log = got["decisions"]
        ups = [d for d in log if d["action"] == "scale_up"]
        downs = [d for d in log if d["action"] == "scale_down"]
        assert len(ups) == 1 and len(downs) == 1
        assert sum(d["reason"] == "cooldown_suppressed" for d in log) == 2
        assert downs[0]["tick"] - ups[0]["tick"] >= 4

    def test_idempotent_at_target(self, sides):
        got = _twin(sides, starts=("i0", "i1"), targets=[2], n_req=0,
                    per_tick=0, ticks=5)
        assert all(d["action"] == "hold" and d["reason"] == "at_target"
                   for d in got["decisions"])
        assert got["live"] == 2 and got["stats"]["actions"] == 0


class TestFaultPoints:
    def test_stale_metrics_hold_then_recover(self, sides):
        """A frozen metrics feed with work in flight: the loop holds
        (metrics_stale) instead of acting on dead numbers; the requests
        still finish with the fixed session's ids."""
        got = _twin(sides, starts=("s0",), targets=[3], n_req=4,
                    per_tick=1, ticks=6, plan="autoscale.metrics.stale@*",
                    stale_evals=2, max_new=6)
        stale = [d for d in got["decisions"]
                 if d.get("reason") == "metrics_stale"]
        assert stale and all(d["action"] == "hold" for d in stale)
        assert got["ids"] == sides[0].reference(
            _prompts(sides[0].cfg, n=4), 6)

    def test_scaleup_failure_holds_then_retries(self, sides):
        got = _twin(sides, starts=("f0",), targets=[3], n_req=4,
                    per_tick=1, ticks=6, plan="autoscale.scaleup.fail@1")
        assert "scaleup_failed" in [d["reason"] for d in got["decisions"]]
        assert got["live"] == 3
        assert got["ids"] == sides[0].reference(
            _prompts(sides[0].cfg, n=4), 4)


def test_planner_driven_ramp(sides):
    """The ramp drill of `bench.py --autoscale` at the tiny size: the
    real `CapacityPlanner` sets the targets from a fixed replica profile,
    ramp-up / hold / ramp-down; each phase lands on the planner's target
    and the decisions equal the JAX package's."""
    from easydist_tpu.reshard.plan import MeshDesc as JMeshDesc
    from easydist_tpu_torch.reshard.plan import MeshDesc as TMeshDesc

    out = []
    for s in sides:
        sim = _sim(s)
        mesh = (TMeshDesc if s.port else JMeshDesc)(("replica",), (3,))
        profile = sim.ReplicaProfile(per_token_s=0.01, chunk_s=0.02,
                                     chunk_tokens=8, n_slots=2)
        svc = profile.ttft_service_s(6, False)
        slo = sim.SLO(ttft_p99_s=8.0 * svc, per_token_p99_s=10.0 * svc)
        high = sim.TrafficSpec(req_per_s=1.3 / svc, prompt_lens=(6,),
                               output_lens=(4,))
        low = sim.TrafficSpec(req_per_s=0.25 / svc, prompt_lens=(6,),
                              output_lens=(4,))
        planner = sim.CapacityPlanner(profile, mesh, n_requests=128)
        t_high = planner.target_replicas(high, slo)
        t_low = planner.target_replicas(low, slo)
        router = s.fleet.FleetRouter([s.mk("a0")])
        scaler = _scaler(s, router, planner=planner, slo=slo,
                         traffic=high, confirm_evals=2, cooldown_evals=2)
        rng = np.random.RandomState(0)
        queue = [rng.randint(0, s.cfg.vocab, size=6).tolist()
                 for _ in range(20)]
        futs, live = [], {}
        for name, traffic, per_tick, ticks in (
                ("ramp_up", high, 2, 6), ("hold", high, 1, 4),
                ("ramp_down", low, 0, 10)):
            scaler.set_traffic_hint(traffic)
            for _ in range(ticks):
                for _ in range(per_tick):
                    if queue:
                        futs.append(router.submit(queue.pop(0),
                                                  max_new_tokens=4))
                router.step()
                scaler.evaluate()
            live[name] = _n_live(router)
        router.run_until_drained()
        outs = [f.result(timeout=5) for f in futs]
        assert all(o["finish_reason"] == "length" for o in outs)
        assert live == {"ramp_up": t_high, "hold": t_high,
                        "ramp_down": t_low} and t_high > t_low
        out.append(([o["ids"] for o in outs], _decisions(scaler),
                    (t_high, t_low)))
    assert out[1] == out[0]
