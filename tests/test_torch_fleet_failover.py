"""Fleet fault tolerance in the port, held against the JAX package's
fleet under the same fault plans (tests/test_fleet/test_failover.py):
a replica killed mid-decode on bucketed and paged sessions (also
mid-speculation), the prefill replica killed mid-handoff, a wedged
replica caught by the liveness probe, probe flaps absorbed and
escalated, poison-request quarantine and revive by re-registration.
Every recovered stream equals the JAX fleet's and the single session's
ids, and the crash, health and protocol logs equal the JAX router's."""

import pytest

from tests.test_torch_fleet import model, prompts_for, routing, sides  # noqa: F401

# every scenario here injects faults and recovers from them; `-m chaos`
# selects exactly this class of test (still tier-1: chaos != slow)
pytestmark = pytest.mark.chaos


def crash_occurrence(router, order, step_no):
    """1-based `fleet.replica.crash` hit that lands on the replica the
    first request routed to, during router step `step_no` (step() hits
    the point once per live replica, in registration order)."""
    target = router.decision_log[0]["replica_id"]
    return (step_no - 1) * len(order) + order.index(target) + 1, target


def drill(sides, scenario, plan_for):
    """`scenario(side, arm)` on both packages, where `arm(router)` arms
    `plan_for(router)` on that package's fault injector and drives the
    router to the end; ids and routing must be equal on both, and every
    scheduled fault must fire."""
    out = []
    for s in sides:
        def arm(router, _s=s):
            with _s.fi.fault_plan(plan_for(router)):
                router.run_until_drained()
                assert _s.fi.unfired() == []
        out.append(scenario(s, arm))
    got_j, got_t = out
    assert got_t["ids"] == got_j["ids"]
    assert got_t["routing"] == got_j["routing"]
    return got_j, got_t


class _WedgedSession:
    """Alive-but-stuck replica: step() returns without doing any work."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self):
        return 0


class TestCrashRecovery:
    @pytest.mark.parametrize("layout,speculate_k", [
        ("bucketed", 0), ("paged", 0), ("bucketed", 3)])
    def test_mid_decode_crash_bitwise(self, sides, layout, speculate_k):
        def run(s, arm):
            prompts = prompts_for(s.cfg, n=4, seed=11)
            router = s.fleet.FleetRouter(
                [s.mk("d0", layout, speculate_k=speculate_k),
                 s.mk("d1", layout, speculate_k=speculate_k)])
            futs = [router.submit(p, max_new_tokens=6) for p in prompts]
            arm(router)
            out = [f.result(timeout=5) for f in futs]
            assert all(o["finish_reason"] == "length" for o in out)
            assert router.metrics.counter("replica_crashes") == 1
            assert router.metrics.counter("requests_recovered") >= 1
            return {"ids": [o["ids"] for o in out],
                    "routing": routing(router)}

        got_j, _ = drill(sides, run, lambda r: "fleet.replica.crash@%d"
                         % crash_occurrence(r, ["d0", "d1"], 4)[0])
        assert got_j["ids"] == sides[0].reference(
            prompts_for(sides[0].cfg, n=4, seed=11), 6, layout=layout)

    def test_prefill_replica_crash_falls_back(self, sides):
        def run(s, arm):
            router = s.fleet.FleetRouter([s.mk("d0")],
                                         prefill_replicas=[s.mk("p0")])
            futs = [router.submit(p, max_new_tokens=5)
                    for p in prompts_for(s.cfg, n=4, seed=14)]
            assert router.metrics.counter("prefill_handoffs") > 0
            arm(router)
            assert "p0" not in router.stats()["replicas"]
            assert router.metrics.counter("handoff_fallbacks") > 0
            return {"ids": [f.result(timeout=5)["ids"] for f in futs],
                    "routing": routing(router)}

        got_j, _ = drill(sides, run, lambda r: "fleet.replica.crash@2")
        assert got_j["ids"] == sides[0].reference(
            prompts_for(sides[0].cfg, n=4, seed=14), 5)

    def test_crash_then_revive_serves_again(self, sides):
        def run(s, arm):
            prompts = prompts_for(s.cfg, n=3, seed=13)
            router = s.fleet.FleetRouter([s.mk("d0"), s.mk("d1")])
            futs = [router.submit(p, max_new_tokens=5) for p in prompts]
            target = router.decision_log[0]["replica_id"]
            arm(router)
            router.add_replica(s.mk(target))
            assert router.health.state(target) == "alive"
            futs.append(router.submit(prompts[0], max_new_tokens=3))
            router.run_until_drained()
            assert target in router.stats()["replicas"]
            return {"ids": [f.result(timeout=5)["ids"] for f in futs],
                    "routing": routing(router)}

        drill(sides, run, lambda r: "fleet.replica.crash@%d"
              % crash_occurrence(r, ["d0", "d1"], 2)[0])


class TestHealth:
    def test_wedged_replica_fails_over(self, sides):
        def run(s, arm):
            router = s.fleet.FleetRouter(
                [_WedgedSession(s.mk("w0"))],
                config=s.fleet.FleetConfig(miss_budget=2))
            futs = [router.submit(p, max_new_tokens=4)
                    for p in prompts_for(s.cfg, n=3, seed=21)]
            router.add_replica(s.mk("d1"))
            arm(router)
            assert "w0" not in router.stats()["replicas"]
            assert router.metrics.counter("requests_recovered") == 3
            return {"ids": [f.result(timeout=5)["ids"] for f in futs],
                    "routing": routing(router)}

        drill(sides, run, lambda r: "")

    @pytest.mark.parametrize("plan,budget", [
        ("fleet.probe.flap@1", 3),
        ("fleet.probe.flap@1,fleet.probe.flap@3", 2)])
    def test_probe_flap(self, sides, plan, budget):
        """One flap rides inside the miss budget (SUSPECT, then ALIVE);
        flaps on consecutive probes of one replica exhaust it and its
        live work recovers on the survivor."""
        def run(s, arm):
            router = s.fleet.FleetRouter(
                [s.mk("d0")], config=s.fleet.FleetConfig(miss_budget=budget))
            futs = [router.submit(p, max_new_tokens=6)
                    for p in prompts_for(s.cfg, n=3, seed=22)]
            router.add_replica(s.mk("d1"))
            arm(router)
            return {"ids": [f.result(timeout=5)["ids"] for f in futs],
                    "routing": routing(router)}

        got_j, got_t = drill(sides, run, lambda r: plan)
        states = [e["state"] for e in got_t["routing"]["health"]
                  if e["replica_id"] == "d0"]
        assert states == (["suspect", "alive"] if budget == 3
                          else ["suspect", "dead"])


class TestQuarantine:
    def test_poison_request_quarantined(self, sides):
        out = []
        for s in sides:
            router = s.fleet.FleetRouter(
                [s.mk("d0"), s.mk("d1"), s.mk("d2")],
                config=s.fleet.FleetConfig(quarantine_after=2))
            fut = router.submit(prompts_for(s.cfg, n=1, seed=31)[0],
                                max_new_tokens=4)
            with s.fi.fault_plan("fleet.replica.crash@*"):
                router.step()
            with pytest.raises(s.fleet.PoisonRequestError) as ei:
                fut.result(timeout=5)
            assert len(ei.value.replicas) == 2
            assert router.stats()["inflight"] == 0
            out.append((sorted(ei.value.replicas), routing(router)))
        assert out[1] == out[0]

    def test_inflight_bookkeeping(self, sides):
        """Deadline expiry fails an entry, a cancelled future is swept,
        and the `router_inflight` gauge follows the live count."""
        out = []
        for s in sides:
            router = s.fleet.FleetRouter([s.mk("d0")])
            prompts = prompts_for(s.cfg, n=3, seed=41)
            late = router.submit(prompts[0], max_new_tokens=4,
                                 deadline_ms=0.01)
            gone = router.submit(prompts[1], max_new_tokens=8)
            kept = router.submit(prompts[2], max_new_tokens=3)
            assert router.metrics.snapshot()["gauges"][
                "router_inflight"] == 3
            assert gone.cancel()
            router.run_until_drained()
            with pytest.raises(s.serve.DeadlineExceededError):
                late.result(timeout=5)
            assert router.metrics.snapshot()["gauges"][
                "router_inflight"] == 0
            out.append((kept.result(timeout=5)["ids"], routing(router)))
        assert out[1] == out[0]
