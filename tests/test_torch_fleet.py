"""`easydist_tpu_torch.fleet` on the CPU, held against the JAX package's
fleet from the same weights (`GPTConfig.tiny()`, pages of 8 tokens, 2
slots: tests/test_fleet/test_router.py:19-37): the same prompts through a
port `FleetRouter` and a JAX `FleetRouter` give the same ids, equal to one
single session's, and the same routing (decision log, protocol events,
drain log, counters) — plain, disaggregated (also across layouts), drain
mid-stream and evacuate, on bucketed and paged sessions.  The hash ring
places every key where the JAX ring does, and `HealthMonitor` walks the
same states under one probe script."""

import jax
import numpy as np
import pytest

import easydist_tpu.fleet as jfleet
import easydist_tpu.serve as jserve
import easydist_tpu_torch.fleet as tfleet
import easydist_tpu_torch.serve as tserve
from easydist_tpu.models import gpt as jg
from easydist_tpu.resilience import faultinject as jfi
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.resilience import faultinject as tfi

CHUNK = 8


@pytest.fixture(scope="module")
def model():
    cfg = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg, jax.random.PRNGKey(0))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg, params_j, tg.GPTConfig.tiny(), params_t


class Side:
    """One package's fleet names and session factory, so a scenario runs
    unchanged on the JAX package and on the port."""

    def __init__(self, name, model):
        cfg_j, params_j, cfg_t, params_t = model
        self.name = name
        self.port = name == "port"
        self.fleet = tfleet if self.port else jfleet
        self.serve = tserve if self.port else jserve
        self.fi = tfi if self.port else jfi
        self.cfg = cfg_t if self.port else cfg_j
        self.params = params_t if self.port else params_j

    def mk(self, rid, layout="bucketed", **kw):
        kw.setdefault("prefill_chunk", CHUNK)
        kw.setdefault("prefill_batch", 2)
        sc = self.serve.ServeConfig(
            decode_buckets=(self.cfg.seq,), max_decode_slots=2,
            breaker_failure_threshold=3, kv_layout=layout, **kw)
        extra = {"device": "cpu"} if self.port else {}
        return self.serve.GenerationSession.for_gpt(
            self.params, self.cfg, config=sc, replica_id=rid, **extra)

    def reference(self, prompts, max_new, **mkkw):
        sess = self.mk("ref", **mkkw)
        futs = [sess.submit(p, max_new_tokens=max_new) for p in prompts]
        sess.run_until_drained()
        return [f.result(timeout=5)["ids"] for f in futs]


@pytest.fixture(scope="module")
def sides(model):
    return Side("jax", model), Side("port", model)


def prompts_for(cfg, n=5, seed=1, shared_len=9):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, cfg.vocab, size=shared_len).tolist()
    return [shared + rng.randint(0, cfg.vocab, size=2 + i % 3).tolist()
            for i in range(n)]


def routing(router):
    """What the router decided, in the form both packages share."""
    return {"decisions": list(router.decision_log),
            "protocol": router.transitions(),
            "drains": list(router.drain_log),
            "crashes": [{k: c[k] for k in ("replica_id", "role")}
                        for c in router.crash_log],
            "health": list(router.health.events),
            "counters": router.metrics.snapshot()["counters"]}


def twin(sides, scenario):
    """Run `scenario(side)` on both packages; its (ids, routing) must be
    equal, and the ids equal the JAX package's single session."""
    jax_side, port_side = sides
    got_j = scenario(jax_side)
    got_t = scenario(port_side)
    assert got_t["ids"] == got_j["ids"]
    assert got_t["routing"] == got_j["routing"]
    return got_j, got_t


LAYOUTS = ("bucketed", "paged")


class TestParity:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_fleet_matches_jax_and_single_session(self, sides, layout):
        def run(s):
            prompts = prompts_for(s.cfg)
            router = s.fleet.FleetRouter([s.mk("d0", layout),
                                          s.mk("d1", layout)])
            futs = [router.submit(p, max_new_tokens=5) for p in prompts]
            router.run_until_drained()
            out = [f.result(timeout=5) for f in futs]
            assert all(o["finish_reason"] == "length" for o in out)
            return {"ids": [o["ids"] for o in out],
                    "replicas": [o["replica_id"] for o in out],
                    "routing": routing(router)}

        got_j, got_t = twin(sides, run)
        assert got_t["replicas"] == got_j["replicas"]
        assert got_t["ids"] == sides[0].reference(
            prompts_for(sides[0].cfg), 5, layout=layout)

    @pytest.mark.parametrize("decode,prefill", [
        ("bucketed", "bucketed"), ("paged", "paged"),
        ("paged", "bucketed")])
    def test_disaggregated_prefill(self, sides, decode, prefill):
        """Page-aligned prefixes prefill on a dedicated replica and hand
        off through the manifest-verified transport (across layouts
        too); the ids and the handoffs equal the JAX fleet's."""
        def run(s):
            prompts = prompts_for(s.cfg, seed=2)
            tp = s.fleet.InProcessTransport()
            router = s.fleet.FleetRouter(
                [s.mk("d0", decode), s.mk("d1", decode)],
                prefill_replicas=[s.mk("p0", prefill)], transport=tp)
            futs = [router.submit(p, max_new_tokens=5) for p in prompts]
            router.run_until_drained()
            assert router.metrics.counter("prefill_handoffs") > 0
            assert tp.pages_moved > 0 and all(m["pages"]
                                              for m in tp.manifests)
            return {"ids": [f.result(timeout=5)["ids"] for f in futs],
                    "routing": routing(router),
                    "moved": tp.pages_moved,
                    "pages": [[(p["index"], p["tokens"], p["bytes"])
                               for p in m["pages"]] for m in tp.manifests]}

        got_j, got_t = twin(sides, run)
        assert got_t["moved"] == got_j["moved"]
        assert got_t["pages"] == got_j["pages"]
        assert got_t["ids"] == sides[0].reference(
            prompts_for(sides[0].cfg, seed=2), 5)

    def test_short_prompt_skips_disaggregation(self, sides):
        def run(s):
            router = s.fleet.FleetRouter([s.mk("d0")],
                                         prefill_replicas=[s.mk("p0")])
            fut = router.submit([1, 2, 3], max_new_tokens=3)
            router.run_until_drained()
            assert router.metrics.counter("prefill_handoffs") == 0
            return {"ids": fut.result(timeout=5)["ids"],
                    "routing": routing(router)}

        twin(sides, run)


class TestRouting:
    def test_warm_prefix_colocates(self, sides):
        def run(s):
            prompts = prompts_for(s.cfg, n=4, seed=3)
            router = s.fleet.FleetRouter([s.mk("d0"), s.mk("d1")])
            f0 = router.submit(prompts[0], max_new_tokens=3)
            router.run_until_drained()
            futs = [f0] + [router.submit(p, max_new_tokens=3)
                           for p in prompts[1:]]
            router.run_until_drained()
            first = router.decision_log[0]["replica_id"]
            warm = [d for d in router.decision_log[1:]
                    if d["affinity_tokens"] > 0]
            assert warm and all(d["replica_id"] == first for d in warm)
            return {"ids": [f.result(timeout=5)["ids"] for f in futs],
                    "routing": routing(router)}

        twin(sides, run)

    def test_cold_and_random_routes_equal(self, sides):
        """Cold prefixes route by the hash ring, the "random" policy by
        `random.Random(seed)`: both pick the JAX fleet's replicas."""
        picks = []
        for s in sides:
            prompts = prompts_for(s.cfg, n=6, seed=4, shared_len=CHUNK)
            hashed = s.fleet.FleetRouter(
                [s.mk(f"d{i}") for i in range(3)])
            rnd = s.fleet.FleetRouter(
                [s.mk("d0"), s.mk("d1")],
                config=s.fleet.FleetConfig(policy="random", seed=0))
            picks.append(
                ([hashed._route(p, i).replica_id
                  for i, p in enumerate(prompts)],
                 [rnd._route([1, 2, 3, 4, 5], i).replica_id
                  for i in range(20)]))
        assert picks[1] == picks[0]
        assert set(picks[1][1]) == {"d0", "d1"}

    def test_open_breaker_excluded(self, sides):
        def run(s):
            router = s.fleet.FleetRouter([s.mk("d0"), s.mk("d1")])
            rep = router.replica("d0")
            for _ in range(rep.session.config.breaker_failure_threshold):
                rep.breaker.record_failure()
            futs = [router.submit(p, max_new_tokens=3)
                    for p in prompts_for(s.cfg, n=3, seed=5)]
            router.run_until_drained()
            out = [f.result(timeout=5) for f in futs]
            assert all(o["replica_id"] == "d1" for o in out)
            with pytest.raises(s.serve.CircuitOpenError):
                for _ in range(3):
                    router.replica("d1").breaker.record_failure()
                router.submit([1, 2, 3, 4, 5], max_new_tokens=2)
            return {"ids": [o["ids"] for o in out],
                    "routing": routing(router)}

        twin(sides, run)

    def test_admission_errors(self, sides):
        for s in sides:
            router = s.fleet.FleetRouter(
                [s.mk("d0")], config=s.fleet.FleetConfig(max_queue=2))
            router.submit([1, 2, 3], max_new_tokens=2)
            router.submit([4, 5, 6], max_new_tokens=2)
            with pytest.raises(s.serve.QueueFullError):
                router.submit([7, 8, 9], max_new_tokens=2)
            with pytest.raises(s.serve.RequestTooLargeError):
                router.submit(list(range(s.cfg.seq + 4)), max_new_tokens=1)
            router.run_until_drained()


class TestDrain:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_graceful_drain_mid_stream(self, sides, layout):
        """Drain the replica the prefix family landed on while traffic is
        live: ids equal, zero dropped, its hot pages migrate (in waves of
        `migrate_wave_bytes`) exactly as the JAX fleet's do."""
        def run(s):
            prompts = prompts_for(s.cfg, n=6, seed=6,
                                  shared_len=2 * CHUNK + 1)
            router = s.fleet.FleetRouter([s.mk("d0", layout),
                                          s.mk("d1", layout)])
            futs = [router.submit(p, max_new_tokens=5) for p in prompts]
            router.step()
            drained = router.decision_log[0]["replica_id"]
            router.drain(drained, mode="graceful")
            router.run_until_drained()
            out = [f.result(timeout=5) for f in futs]
            assert all(o["finish_reason"] == "length" for o in out)
            assert drained not in router.stats()["replicas"]
            assert router.drain_log[0]["pages_migrated"] > 0
            return {"ids": [o["ids"] for o in out],
                    "routing": routing(router)}

        got_j, _ = twin(sides, run)
        assert got_j["ids"] == sides[0].reference(
            prompts_for(sides[0].cfg, n=6, seed=6, shared_len=2 * CHUNK + 1),
            5)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_evacuate_resumes_mid_stream(self, sides, layout):
        def run(s):
            prompts = prompts_for(s.cfg, n=4, seed=7)
            router = s.fleet.FleetRouter([s.mk("d0", layout),
                                          s.mk("d1", layout)])
            futs = [router.submit(p, max_new_tokens=6) for p in prompts]
            for _ in range(3):
                router.step()
            # the replica the prefix family landed on holds live decodes
            victim = router.decision_log[0]["replica_id"]
            router.drain(victim, mode="evacuate")
            router.run_until_drained()
            assert victim not in router.stats()["replicas"]
            assert router.metrics.counter("migrations") > 0
            return {"ids": [f.result(timeout=5)["ids"] for f in futs],
                    "routing": routing(router)}

        got_j, _ = twin(sides, run)
        assert got_j["ids"] == sides[0].reference(
            prompts_for(sides[0].cfg, n=4, seed=7), 6)

    def test_chunked_migration_waves(self, sides):
        """`send_paths_chunked` batches a drain's paths by the reshard
        wave planner: a cap of one page's bytes gives one wave a path."""
        def run(s):
            src = s.mk("src")
            prompts = prompts_for(s.cfg, n=3, seed=8, shared_len=2 * CHUNK)
            futs = [src.submit(p, max_new_tokens=2) for p in prompts]
            src.run_until_drained()
            [f.result(timeout=5) for f in futs]
            pages = src.export_hot_pages()
            (bucket, paths), = pages.items()
            dst = s.mk("dst")
            one = s.fleet.transport.path_nbytes(paths[0][:1])
            res = s.fleet.InProcessTransport().send_paths_chunked(
                paths, dst, bucket=bucket, max_wave_bytes=one)
            assert res["waves"] == len(paths)
            return {"ids": [], "routing": res}

        twin(sides, run)


class TestHashRing:
    def test_keys_land_where_the_jax_ring_puts_them(self):
        rng = np.random.RandomState(0)
        keys = [int(k) for k in rng.randint(0, 1 << 62, 500,
                                              dtype=np.int64)]
        for vnodes in (1, 16, 64):
            rings = [pkg.HashRing([f"r{i}" for i in range(5)],
                                  vnodes=vnodes) for pkg in (jfleet, tfleet)]
            assert rings[1]._points == rings[0]._points
            routes = [[r.route(k) for k in keys] for r in rings]
            assert routes[1] == routes[0]
            for r in rings:
                r.remove("r2")
            sub = ["r0", "r3"]
            routes = [[r.route(k, eligible=sub) for k in keys]
                      for r in rings]
            assert routes[1] == routes[0]
            assert set(routes[1]) <= set(sub)

    def test_prefix_key_equal(self):
        rng = np.random.RandomState(3)
        for n in (0, 1, 8, 64):
            toks = rng.randint(-5, 1 << 20, n).tolist()
            assert tfleet.prefix_hash_key(toks) == \
                jfleet.prefix_hash_key(toks)


class _Metrics:
    def __init__(self):
        self.counters = {}

    def counter(self, name):
        return self.counters.get(name, 0)


class _Session:
    def __init__(self):
        self.metrics = _Metrics()
        self.queue_depth = 1


class _Rep:
    def __init__(self, rid):
        self.replica_id = rid
        self.session = _Session()


# one probe script: per round, (replica, progress made, queue depth)
PROBE_SCRIPT = [
    {"a": (0, 1), "b": (0, 1), "c": (0, 0)},
    {"a": (1, 1), "b": (0, 1), "c": (0, 0)},
    {"a": (0, 1), "b": (0, 1), "c": (0, 1)},
    {"a": (2, 1), "b": (0, 1), "c": (0, 1)},
    {"a": (0, 0), "b": (1, 1), "c": (0, 1)},
    {"a": (0, 1), "b": (0, 1), "c": (3, 1)},
    {"a": (0, 1), "b": (0, 1), "c": (0, 1)},
]


def _walk(pkg, fi, plan):
    hm = pkg.HealthMonitor(pkg.HealthConfig(miss_budget=3))
    reps = {r: _Rep(r) for r in ("a", "b", "c")}
    dead, snaps = [], []
    with fi.fault_plan(plan):
        for rnd, script in enumerate(PROBE_SCRIPT):
            for rid, (adv, depth) in script.items():
                s = reps[rid].session
                s.queue_depth = depth
                s.metrics.counters["decode_steps"] = \
                    s.metrics.counter("decode_steps") + adv
            dead.append(hm.probe(list(reps.values())))
            if rnd == 4:
                hm.revive("b")
            snaps.append(hm.snapshot())
        unfired = fi.unfired()
    return {"dead": dead, "snaps": snaps, "events": hm.transitions(),
            "unfired": unfired}


@pytest.mark.parametrize("plan", ["", "fleet.probe.flap@4",
                                  "fleet.probe.flap@2,fleet.probe.flap@5"])
def test_health_monitor_walks_the_same_states(plan):
    got_j = _walk(jfleet, jfi, plan)
    got_t = _walk(tfleet, tfi, plan)
    assert got_t == got_j
    assert got_t["unfired"] == []
    assert any(e["state"] == tfleet.DEAD for e in got_t["events"])


def test_stats_and_metrics_export(sides, tmp_path):
    from easydist_tpu_torch.runtime.perfdb import PerfDB

    _, s = sides
    router = s.fleet.FleetRouter([s.mk("d0"), s.mk("d1")])
    futs = [router.submit(p, max_new_tokens=3)
            for p in prompts_for(s.cfg, n=3, seed=8)]
    router.run_until_drained()
    [f.result(timeout=5) for f in futs]
    st = router.stats()
    assert set(st["replicas"]) == {"d0", "d1"} and st["inflight"] == 0
    assert st["metrics"]["counters"]["requests_completed"] == 3
    assert st["replicas"]["d0"]["breaker"]["replica_id"] == "d0"
    db = router.export_metrics(db=PerfDB(path=str(tmp_path / "p.db")),
                               persist=False)
    hist = db.get_op_perf("serving", "engine[d0]")
    assert hist and hist[-1]["replica_id"] == "d0"
    assert db.get_op_perf("serving", "fleet_routing")
    snap = router.live_decode_snapshot()
    assert [r["replica_id"] for r in snap] == ["d0", "d1"]
    assert all(isinstance(r["queue_depth"], int) for r in snap)
