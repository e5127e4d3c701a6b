"""Layer 12 of the port's analyzer against the JAX package's: the four
protocol specs explored to the same state and transition counts (and
their committed budgets), each seeded bug giving the same PROTO001 /
PROTO002 counterexample, the replay validators agreeing on the same
event logs, the host-code lints (PROTO004/005 and the donation lint's
host form, ALIAS001) giving the same findings on the same source texts
and none on the port's tree, and a CPU fleet drill of the port whose
router, health monitor and transport replay with no PROTO003."""

import os

import pytest

import easydist_tpu.analyze as ja
import easydist_tpu_torch.analyze as ta
from easydist_tpu_torch import config as tconfig
from tests.test_torch_fleet import (model, prompts_for,  # noqa: F401
                                    sides)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = ("HealthSpec", "RouterSpec", "ResumeSpec", "TransportSpec")
BUGS = {"HealthSpec": "flap_storm", "RouterSpec": "dropped_handoff",
        "ResumeSpec": "stale_resume", "TransportSpec": "nonidempotent_commit"}


def key(findings):
    return [(f.rule_id, f.severity, f.node) for f in findings]


@pytest.mark.parametrize("spec", SPECS)
def test_exploration_matches_jax(spec):
    res_j = ja.explore(getattr(ja, spec)())
    res_t = ta.explore(getattr(ta, spec)())
    assert res_t.to_json() == res_j.to_json()
    assert res_t.exhausted and res_t.states == ta.COMMITTED_STATES[
        res_t.spec_name]
    assert ta.COMMITTED_STATES == ja.COMMITTED_STATES == {
        "health": 40, "router": 1048, "resume": 48, "transport": 552}


@pytest.mark.parametrize("spec", SPECS)
def test_seeded_bug_gives_the_jax_counterexample(spec):
    fj, rj = ja.audit_spec(getattr(ja, spec)(bug=BUGS[spec]))
    ft, rt = ta.audit_spec(getattr(ta, spec)(bug=BUGS[spec]))
    assert key(ft) == key(fj) and len(ft) == 1
    assert [f.message for f in ft] == [f.message for f in fj]
    assert rt.to_json() == rj.to_json()
    with pytest.raises(ta.AnalysisError):
        ta.check_protocol_specs([getattr(ta, spec)(bug=BUGS[spec])])


def test_check_protocol_specs_clean_and_kill_switch(monkeypatch):
    assert ta.check_protocol_specs() == []
    monkeypatch.setattr(tconfig, "enable_analyze", False)
    assert ta.check_protocol_specs(
        [ta.ResumeSpec(bug="stale_resume")]) == []


HEALTH_LOGS = [
    [{"replica_id": "d0", "from": "alive", "to": "suspect"},
     {"replica_id": "d0", "from": "suspect", "to": "alive"}],
    [{"replica_id": "d0", "from": "alive", "to": "dead"}],
    [{"replica_id": "d0", "from": "suspect", "to": "bogus"}],
]
ROUTER_LOGS = [
    [{"request_id": 0, "event": "admitted"},
     {"request_id": 0, "event": "routed"},
     {"request_id": 0, "event": "completed"}],
    [{"request_id": 0, "event": "admitted"},
     {"request_id": 0, "event": "routed"},
     {"request_id": 0, "event": "completed"},
     {"request_id": 0, "event": "completed"}],
    [{"request_id": 1, "event": "routed"}],
]
TRANSPORT_LOGS = [
    [{"key": "k0", "event": "committed"}, {"key": "k0", "event": "deduped"}],
    [{"key": "k0", "event": "committed"}, {"key": "k0", "event": "committed"}],
    [{"key": "k1", "event": "deduped"}],
]
RESTORE_TRAILS = [
    [{"chunk_bytes": 64, "outcome": "oom"},
     {"chunk_bytes": 32, "outcome": "landed"}],
    [{"chunk_bytes": 64, "outcome": "oom"},
     {"chunk_bytes": 16, "outcome": "landed"}],
    [],
]


@pytest.mark.parametrize("i", range(3))
def test_replay_validators_match_jax(i):
    for fn, logs in (("replay_health_events", HEALTH_LOGS),
                     ("replay_router_protocol", ROUTER_LOGS),
                     ("replay_transport_commits", TRANSPORT_LOGS),
                     ("replay_restore_attempts", RESTORE_TRAILS)):
        fj = getattr(ja, fn)(logs[i])
        ft = getattr(ta, fn)(logs[i])
        assert key(ft) == key(fj), fn


SOURCES = {
    "clean": "def f(router):\n    return router.stats()\n",
    "read": "def f(router):\n    return len(router._inflight)\n",
    "write": ("def f(fleet, x):\n    fleet._handoffs.append(x)\n"
              "    fleet._replicas['a'] = x\n    del fleet._ring\n"),
    "own": "class A:\n    def f(self):\n        self._inflight.pop(1)\n",
    "donate_stale": ("def f(self, pool):\n"
                     "    out = self._decode_c(pool.cache, 1)\n"
                     "    return pool.cache, out\n"),
    "donate_rebind": ("def f(self, pool):\n"
                      "    pool.cache, out = self._decode_c(pool.cache, 1)\n"
                      "    return pool.cache, out\n"),
    "compiled": ("def f(step, s, x):\n    c = easydist_compile(step)\n"
                 "    y = c(s, x)\n    return s, y\n"),
    "broken": "def f(:\n",
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_host_lints_match_jax(name):
    src = SOURCES[name]
    for fn in ("lint_file_concurrency", "lint_file_donation"):
        fj = getattr(ja, fn)("x.py", rel="pkg/x.py", source=src)
        ft = getattr(ta, fn)("x.py", rel="pkg/x.py", source=src)
        assert [(f.rule_id, f.node, f.line) for f in ft] == \
            [(f.rule_id, f.node, f.line) for f in fj]


def test_host_lints_clean_on_the_port():
    assert ta.lint_host_concurrency(REPO) == []
    assert ta.lint_host_donation(REPO) == []
    assert ta.lint_host_concurrency(
        REPO, subdirs=("easydist_tpu_torch",)) == ja.lint_host_concurrency(
            REPO, subdirs=("easydist_tpu_torch",))


def test_fleet_drill_replays_without_drift(sides):
    """Disaggregated prefill with a page corrupted in flight, a replica
    killed mid-decode, then a graceful drain: the port's router, health
    monitor and transport logs replay through the specs with no
    PROTO003, and every request still completes."""
    port = sides[1]
    prompts = prompts_for(port.cfg, n=6)
    router = port.fleet.FleetRouter(
        [port.mk("d0"), port.mk("d1"), port.mk("d2", "paged")],
        prefill_replicas=[port.mk("p0", "paged")])
    futs = [router.submit(p, max_new_tokens=4) for p in prompts[:3]]
    with port.fi.fault_plan("fleet.transport.page_corrupt@1"):
        router.run_until_drained()
        assert port.fi.unfired() == []
    n_before = len(router.decision_log)
    futs += [router.submit(p, max_new_tokens=4) for p in prompts[3:]]
    target = router.decision_log[n_before]["replica_id"]
    order = list(router.stats()["replicas"])
    with port.fi.fault_plan(f"fleet.replica.crash@"
                            f"{2 * len(order) + order.index(target) + 1}"):
        router.run_until_drained()
        assert port.fi.unfired() == []
    router.add_replica(port.mk(target))
    futs += [router.submit(p, max_new_tokens=4) for p in prompts[:2]]
    router.step()
    router.drain("d1")
    router.run_until_drained()
    assert all(f.result(timeout=5)["ids"] for f in futs)
    events = [e["event"] for e in router.transport.transitions()]
    assert "rejected" in events and "committed" in events
    assert router.metrics.counter("requests_recovered") >= 1
    assert ta.check_protocol_conformance(router=router, health=router.health,
                                         transport=router.transport) == []
    assert ta.audit_routing(router.decision_log) == []


class _HotPages:
    """A destination that takes hot pages (the drain-migration commit)."""

    def import_hot_pages(self, by_bucket):
        return sum(len(p) for paths in by_bucket.values() for p in paths)


def test_drain_migration_to_two_survivors_replays_clean():
    """A drain sends one hot path to every survivor: two commits of one
    manifest to two destinations, then a duplicate delivery.  The port's
    commit stream keys each by its destination and replays clean; the
    JAX package's drops the destination, and the same deliveries read as
    one key committed twice (PROTO003)."""
    import numpy as np
    import torch

    from easydist_tpu.fleet import InProcessTransport as JTransport
    from easydist_tpu_torch.fleet import InProcessTransport as TTransport

    kv = {"k": np.ones((1, 2, 4, 8), np.float32),
          "v": np.ones((1, 2, 4, 8), np.float32)}
    paths = {"jax": [((0, 1, 2, 3), kv)],
             "port": [((0, 1, 2, 3), {k: torch.from_numpy(v.copy())
                                      for k, v in kv.items()})]}
    found = {}
    for name, tp, pkg in (("jax", JTransport(), ja),
                          ("port", TTransport(), ta)):
        a, b = _HotPages(), _HotPages()
        for dst, tag in ((a, "d0"), (b, "d1"), (a, "d0")):
            tp.transfer(paths[name], dst, None, src="g", dst=tag,
                        bucket=1024)
        assert [e["event"] for e in tp.transitions()] == [
            "committed", "committed", "deduped"]
        found[name] = pkg.replay_transport_commits(tp.transitions())
    assert found["port"] == []
    assert [f.rule_id for f in found["jax"]] == ["PROTO003"]
