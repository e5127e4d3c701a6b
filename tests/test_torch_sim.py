"""`easydist_tpu_torch.sim` on the CPU, held against the JAX package's
simulator: the event substrate (`ServerPool`, `percentile`), traffic
traces, capacity sweeps and targets, the pipeline replay over each
package's own `_1f1b_schedule_tables`, and the serving predictors are
exactly equal (tests/test_sim/).  The port's own pieces: the op table's
resolution order, the host stream of the one-device replay, residuals
under the device-type key, and `replay_graph` on the port's MLP step
solved on a fake group of 8 (tests/test_sim/test_simulate.py:136-163),
whose collective seconds are the solver's own price for the same edges.
"""

import dataclasses

import numpy as np
import pytest
import torch

import easydist_tpu.sim as jsim
import easydist_tpu_torch.sim as tsim
from easydist_tpu.reshard.plan import MeshDesc as JMeshDesc
from easydist_tpu_torch.reshard.plan import MeshDesc as TMeshDesc

PROFILE_KW = dict(per_token_s=0.01, chunk_s=0.05, chunk_tokens=16,
                  n_slots=4, chips=1)


def _planners(n_devices=4, **kw):
    kw.setdefault("n_requests", 256)
    return (jsim.CapacityPlanner(jsim.ReplicaProfile(**PROFILE_KW),
                                 JMeshDesc(("replica",), (n_devices,)), **kw),
            tsim.CapacityPlanner(tsim.ReplicaProfile(**PROFILE_KW),
                                 TMeshDesc(("replica",), (n_devices,)), **kw))


class TestEvents:
    def test_server_pool_and_percentile(self):
        rng = np.random.RandomState(0)
        arrivals = np.cumsum(rng.exponential(0.01, 300)).tolist()
        service = rng.exponential(0.03, 300).tolist()
        out = []
        for pkg in (jsim, tsim):
            log = pkg.EventLog()
            pool = pkg.ServerPool(3, log, name="decode")
            served = [pool.submit(a, s) for a, s in zip(arrivals, service)]
            out.append((served, pool.waits, pool.sojourns, pool.drain_time(),
                        [(e.time, e.kind, e.payload) for e in log.events()],
                        [pkg.percentile(pool.sojourns, q)
                         for q in (0, 1, 50, 90, 99, 99.9, 100)],
                        pkg.percentile([], 99)))
        assert out[1] == out[0]

    def test_stream(self):
        for pkg in (jsim, tsim):
            s = pkg.Stream("compute")
            assert s.reserve(1.0, 2.0) == (1.0, 3.0)
            assert s.reserve(0.0, 1.0) == (3.0, 4.0)
            assert s.utilization() == pytest.approx(0.75)
            with pytest.raises(ValueError):
                s.reserve(0.0, -1.0)


class TestCapacity:
    def test_traffic_traces_equal(self):
        for kw in (dict(req_per_s=10.0, prompt_lens=(16, 64),
                        output_lens=(8,), prefix_reuse=0.5),
                   dict(req_per_s=3.5, prompt_lens=(5, 37, 700),
                        prompt_weights=(1.0, 2.0, 0.5), output_lens=(4, 32),
                        output_weights=(3.0, 1.0))):
            for seed in (0, 3):
                assert tsim.TrafficSpec(**kw).sample(64, seed=seed) == \
                    jsim.TrafficSpec(**kw).sample(64, seed=seed)
        snap = {"counters": {"prefills": 12, "requests_completed": 10,
                             "tokens_generated": 311,
                             "prefix_tokens_total": 900,
                             "prefix_tokens_reused": 256},
                "prompt_hist": {"5": 3, "37": 8, "700": 1}}
        assert dataclasses.astuple(tsim.TrafficSpec.from_metrics(
            snap, 4.0)) == dataclasses.astuple(
            jsim.TrafficSpec.from_metrics(snap, 4.0))

    @pytest.mark.parametrize("rate", [1.0, 4.0, 12.0, 40.0])
    def test_sweep_and_target_equal(self, rate):
        pj, pt = _planners()
        slo_kw = dict(ttft_p99_s=0.5, per_token_p99_s=0.05)
        traffic_kw = dict(req_per_s=rate, prompt_lens=(32, 96),
                          output_lens=(16,), prefix_reuse=0.25)
        plans = [[(p.as_dict(), p.detail) for p in pl.plan(
            pkg.TrafficSpec(**traffic_kw), pkg.SLO(**slo_kw))]
            for pl, pkg in ((pj, jsim), (pt, tsim))]
        assert plans[1] == plans[0]
        assert pt.target_replicas(tsim.TrafficSpec(**traffic_kw),
                                  tsim.SLO(**slo_kw)) == \
            pj.target_replicas(jsim.TrafficSpec(**traffic_kw),
                               jsim.SLO(**slo_kw))

    def test_target_monotone_in_load(self):
        _, pt = _planners(n_devices=8)
        slo = tsim.SLO(ttft_p99_s=0.5, per_token_p99_s=0.05)
        targets = [pt.target_replicas(tsim.TrafficSpec(
            req_per_s=r, prompt_lens=(64,), output_lens=(16,)), slo)
            for r in (1.0, 5.0, 10.0, 20.0, 40.0, 80.0)]
        assert targets == sorted(targets) and targets[-1] > targets[0]

    def test_profile_arithmetic_equal(self):
        pj = jsim.ReplicaProfile(**PROFILE_KW)
        pt = tsim.ReplicaProfile(**PROFILE_KW)
        for plen in (1, 16, 17, 64, 700):
            for hit in (False, True):
                assert pt.ttft_service_s(plen, hit) == \
                    pj.ttft_service_s(plen, hit)
        assert pt.decode_service_s(8) == pj.decode_service_s(8)


class TestPredictors:
    @pytest.mark.parametrize("pp,v,m", [(1, 1, 4), (4, 1, 8), (4, 1, 32),
                                        (2, 2, 8), (4, 2, 16)])
    def test_pipeline_replay_equal(self, pp, v, m):
        from easydist_tpu.parallel.pipeline import (
            _1f1b_schedule_tables as jtables)
        from easydist_tpu_torch.parallel.pipeline import (
            _1f1b_schedule_tables as ttables)

        tj, tt = jtables(pp, v, m), ttables(pp, v, m)
        for key in ("f_ok", "b_ok"):
            np.testing.assert_array_equal(np.asarray(tt[key]),
                                          np.asarray(tj[key]))
        rj = jsim.simulate_pipeline(tj, 1.25e-3, 2.5e-3)
        rt = tsim.simulate_pipeline(tt, 1.25e-3, 2.5e-3)
        assert (rt.predicted_s, rt.compute_s, rt.n_ops, rt.detail) == \
            (rj.predicted_s, rj.compute_s, rj.n_ops, rj.detail)
        assert tsim.predict_pipeline_step(pp, v, m, 0.1, 0.2).predicted_s \
            == jsim.predict_pipeline_step(pp, v, m, 0.1, 0.2).predicted_s

    def test_serving_predictors_equal(self):
        for args in ((0.1, 4, 0.01), (0.05, 1, 0.002), (0.3, 16, 0.02)):
            for kw in ({}, {"queue_wait_s": 1.0},
                       {"prefix_hit_chunks": 3}):
                assert tsim.predict_ttft(*args, **kw) == \
                    jsim.predict_ttft(*args, **kw)
        for occ in (0.0, 0.25, 1.0, 1.5):
            assert tsim.predict_decode_throughput(0.01, 8, occ) == \
                jsim.predict_decode_throughput(0.01, 8, occ)
        assert tsim.predict_decode_throughput(0.0, 4) == 0.0
        assert tsim.relative_error(1.1, 1.0) == \
            jsim.relative_error(1.1, 1.0)
        assert tsim.relative_error(1.0, 0.0) == float("inf")
        assert tsim.SIM_REL_ERROR_BOUND == jsim.SIM_REL_ERROR_BOUND == 0.60

    def test_op_table_resolution_order(self):
        cases = [("hit", 1e6, 1e9, None, 0.0), ("miss", 1e6, 1e9, 3.3e-5, 0),
                 (None, 10.0, 2e9, None, 0.0), (None, 1e9, 1.0, None, 1e9),
                 (None, 4e9, None, None, 0.0)]
        for pkg in (jsim, tsim):
            t = pkg.OpTimeTable({"hit": 1.5e-6}, hbm_bandwidth=1e9,
                                peak_flops=1e12)
            got = [t.node_seconds(sig, ob, fl, cp, in_bytes=ib)
                   for sig, ob, fl, cp, ib in cases]
            assert got == [1.5e-6, 3.3e-5, 2e9 / 1e12, 2.0, 4.0]
            assert (t.hits, t.misses) == (1, 4)

    def test_residual_roundtrip(self, tmp_path):
        from easydist_tpu_torch.runtime.perfdb import PerfDB

        db = PerfDB(path=str(tmp_path / "perf.db"))
        tsim.store_residual("train", 2.5, db=db)
        again = PerfDB(path=str(tmp_path / "perf.db"))
        assert tsim.load_residual("train", db=again) == pytest.approx(2.5)
        assert again.get_op_perf(tsim.RESIDUAL_KEY, "cpu:train") == 2.5
        assert tsim.load_residual("decode", db=again, default=3.0) == 3.0
        tsim.store_dispatch(2e-5, db=db)
        tsim.store_dispatch(1e-5, "prefill", db=db)
        tsim.store_launch_floor(4e-6, db=db)
        again = PerfDB(path=str(tmp_path / "perf.db"))
        tables = [tsim.OpTimeTable.from_perfdb(again, domain=d)
                  for d in (None, "decode", "prefill")]
        assert [t.dispatch_s for t in tables] == [2e-5, 2e-5, 1e-5]
        assert all(t.launch_s == 4e-6 for t in tables)

    def test_report_scaled(self):
        rep = tsim.SimReport(predicted_s=2.0, compute_s=1.5, comm_s=0.5,
                             host_s=1.0)
        scaled = rep.scaled(1.5)
        assert scaled.predicted_s == pytest.approx(3.0)
        assert (scaled.residual, scaled.compute_s, scaled.host_s) == \
            (1.5, 1.5, 1.0)
        assert scaled.as_dict()["host_s"] == 1.0


class TestFlatReplay:
    @staticmethod
    def fn(x):
        return torch.tanh(x @ x) + 1.0

    def test_device_stream_alone(self):
        t = tsim.OpTimeTable({}, hbm_bandwidth=1e9, peak_flops=1e12)
        rep = tsim.predict_fn_seconds(self.fn, torch.ones(16, 16),
                                      op_table=t)
        # mm, tanh, add: each priced by its output bytes (16 x 16 x 4)
        assert rep.n_ops == 3
        assert rep.predicted_s == pytest.approx(3 * 1024 / 1e9)
        assert rep.host_s == 0.0 and rep.comm_s == 0.0

    def test_host_stream_bounds_the_program(self):
        t = tsim.OpTimeTable({}, hbm_bandwidth=1e9, peak_flops=1e12,
                             dispatch_s=1e-5)
        rep = tsim.predict_fn_seconds(self.fn, torch.ones(16, 16),
                                      op_table=t)
        assert rep.host_s == pytest.approx(3e-5)
        # the last kernel starts once the host issued it
        assert rep.predicted_s == pytest.approx(3e-5 + 1024 / 1e9)

    def test_profiled_table_hits_every_node(self):
        from easydist_tpu_torch.runtime.op_profile import profile_ops

        x = torch.ones(16, 16)
        times = profile_ops(self.fn, x, trials=1, persist=False)
        rep = tsim.predict_fn_seconds(self.fn, x,
                                      op_table=tsim.OpTimeTable(times))
        assert rep.op_db_hit_rate == 1.0
        assert rep.predicted_s == pytest.approx(sum(times.values()))

    def test_launch_floor_comes_off_measured_times(self):
        floor = tsim.measure_launch_floor("cpu", trials=5)
        assert 0.0 < floor < 1e-2
        t = tsim.OpTimeTable({"a": 3e-5, "b": 1e-6}, launch_s=2e-5)
        assert t.node_seconds("a", 0.0) == pytest.approx(1e-5)
        assert t.node_seconds("b", 0.0) == 0.0
        # proxies price device work only: nothing to take off
        assert t.node_seconds("c", 4e9) == pytest.approx(
            4e9 / t.hbm_bandwidth)


def test_replay_graph_on_solved_mlp_step():
    """The port's MLP train step solved on a fake group of 8 (the JAX
    package's constants, under which data parallelism wins), replayed:
    internally consistent, and its wire seconds are `resharding_cost`
    over the solved op-to-op edges — the solver's price for the same
    edges.  The solver's objective also prices the edges out of the
    step's inputs; the replay takes inputs as already placed, so the
    difference is exactly those edges."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch import config
    from easydist_tpu_torch.autoflow.cost_model import resharding_cost
    from easydist_tpu_torch.fxfront import (easydist_compile,
                                            make_device_mesh,
                                            set_device_mesh)
    from easydist_tpu_torch.metashard.metair import Placement
    from easydist_tpu_torch.models.mlp import make_mlp_train_step, mlp_init
    from tests.test_torch_fxfront_e2e import _jax_constants

    saved = {k: getattr(config, k) for k in (
        *_jax_constants(), "discovery_device", "discovery_persistent_cache",
        "enable_compile_cache")}
    for k, v in _jax_constants().items():
        setattr(config, k, v)
    config.discovery_device = "cpu"
    config.discovery_persistent_cache = False
    config.enable_compile_cache = False
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    try:
        mesh = make_device_mesh((8,), ("d",), device_type="cpu")
        g = torch.Generator().manual_seed(0)
        params = mlp_init(g, sizes=(256, 512, 256), device="cpu")
        x = torch.randn(2048, 256, generator=g)
        y = torch.randn(2048, 256, generator=g)
        res = easydist_compile(make_mlp_train_step(), mesh=mesh,
                               compile_only=True)(params, x, y)
        # the axis prices its wire with the constants the solve saw
        table = tsim.OpTimeTable({}, hbm_bandwidth=1e9, peak_flops=1e12)
        rep = tsim.simulate_train_step(res, op_table=table)
        dispatched = tsim.simulate_train_step(
            res, op_table=tsim.OpTimeTable({}, hbm_bandwidth=1e9,
                                           peak_flops=1e12, dispatch_s=1e-3))
        graph, ax, chosen = (res.graphs[0], res.axis_specs[0],
                             res.strategies[0])
        edges = {True: 0.0, False: 0.0}
        for node in graph.ops:
            for idx, var in enumerate(node.invars):
                if var is None or var.producer is None:
                    continue
                up_s, down_s = chosen[var.producer.name], chosen[node.name]
                up = (up_s.out_placements[var.producer_idx]
                      if var.producer_idx < len(up_s.out_placements)
                      else None)
                down = (down_s.in_placements[idx]
                        if idx < len(down_s.in_placements) else None)
                edges[var.producer.is_input] += resharding_cost(
                    var.size_bytes(), up or Placement.replicate(),
                    down or Placement.replicate(), ax)
    finally:
        dist.destroy_process_group()
        set_device_mesh(None)
        for k, v in saved.items():
            setattr(config, k, v)
    assert rep.predicted_s > 0.0 and rep.n_ops == len(graph.ops)
    assert rep.predicted_s >= rep.comm_exposed_s
    assert rep.comm_s >= rep.comm_exposed_s >= 0.0
    assert rep.n_collectives > 0, "the pick shards nothing"
    assert rep.comm_s == pytest.approx(edges[False], rel=1e-12)
    assert res.solver_costs[0] == pytest.approx(edges[False] + edges[True],
                                                rel=1e-6)
    assert edges[True] > 0.0

    # with the host issuing every op, the step never ends before it has
    assert dispatched.host_s == pytest.approx(1e-3 * rep.n_ops)
    assert dispatched.predicted_s >= dispatched.host_s
    assert dispatched.comm_s == pytest.approx(rep.comm_s)


def test_profile_ops_skips_indices_it_cannot_draw_on_the_card():
    """`profile_ops` draws integer inputs in [1, 8): an index op over a
    shorter dim raises on the CPU and would fail a device-side assert on
    the card, so on every device it is skipped before it runs.  On a
    prefill chunk of SERVE_KW's 4 rows, the ops flagged are exactly the
    ones left untimed, and each of them raises when run on the CPU."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    import chip_smoke
    from easydist_tpu_torch.fxfront.interpreter import node_signature
    from easydist_tpu_torch.runtime.op_profile import (_drawn_call,
                                                       _index_out_of_range,
                                                       profile_ops)

    cpu = torch.device("cpu")
    assert chip_smoke.SERVE_KW["prefill_batch"] == 4
    (_, _, _, build), = [p for p in chip_smoke.sim_presets(
        cpu, gpt_kw=dict(vocab=128, dim=64, heads=2, layers=1))
        if p[0] == "gpt_prefill"]
    fn, args = build()
    timed = profile_ops(fn, *args, trials=1, persist=False)
    flat, spec = pytree.tree_flatten((args, {}))

    def flat_fn(*xs):
        a, kw = pytree.tree_unflatten(list(xs), spec)
        return pytree.tree_leaves(fn(*a, **kw))

    with torch.no_grad():
        gm = make_fx(flat_fn, tracing_mode="fake")(*flat)
    calls = {node_signature(n): n for n in gm.graph.nodes
             if n.op == "call_function" and "getitem" not in str(n.target)}
    flagged = {s for s, n in calls.items() if _index_out_of_range(n)}
    assert flagged and flagged == set(calls) - set(timed)
    gen = torch.Generator().manual_seed(0)
    for sig in flagged:
        with pytest.raises((IndexError, RuntimeError)):
            with torch.no_grad():
                _drawn_call(calls[sig], gen, cpu)()