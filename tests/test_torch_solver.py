"""Solver parity: the port's coarsening, `SpmdSolver` (ILP and beam
search), memory planner and native helpers against the JAX package's on
the same MetaGraphs.

The graphs are the JAX frontend's (`make_jaxpr` -> `inline_calls` ->
`ShardingAnalyzer.run()` -> `jaxpr_to_metagraph`, as
`tests/test_autoflow/test_solver.py` makes them) for the `models/mlp.py`
and `GPTConfig.tiny(layers=2)` train steps.  `carry_graph` walks each one
and builds the port's MetaGraph through the port's public classes, node
by node in the same order.  Both solvers see the same mesh axis (explicit
bandwidth and latency) and the same cost constants.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from easydist_tpu_torch import config as pconfig
from easydist_tpu_torch import native as pnative
from easydist_tpu_torch.autoflow import MeshAxisSpec, SpmdSolver, resharding_cost
from easydist_tpu_torch.metashard.annotation import (DimSharding, HaloSpec,
                                                     ShardSpace)
from easydist_tpu_torch.metashard.combination import Recombine, Reduction
from easydist_tpu_torch.metashard.metair import (MetaGraph, MetaNode, MetaVar,
                                                 NodeStrategy, Placement)
from easydist_tpu_torch.schedule import plan_graph_memory
from tests.test_torch_metashard import numpy_args

BANDWIDTH, LATENCY = 1e11, 1e-6
AXIS_SIZES = (2, 4)
MODELS = ("mlp", "gpt_tiny")


# ------------------------------------------------- carrying a graph across

def _carry_recombine(fn):
    if isinstance(fn, (list, tuple)):
        return [_carry_recombine(f) for f in fn]
    kw = {k: Reduction(v.value) if hasattr(v, "value") else v
          for k, v in fn.keywords.items()}
    return functools.partial(getattr(Recombine, fn.func.__name__), **kw)


def _carry_space(space):
    if space is None:
        return None
    return ShardSpace([[DimSharding(d.group, d.block,
                                    None if d.halo is None
                                    else HaloSpec(d.halo.width, d.halo.dim))
                        for d in row] for row in space.table])


def _carry_placement(p):
    if p is None:
        return None
    return Placement(p.kind, p.dim,
                     None if p.reduction is None else Reduction(
                         p.reduction.value))


def _carry_strategy(s):
    if s is None:
        return None
    out = NodeStrategy([_carry_placement(p) for p in s.in_placements],
                       [_carry_placement(p) for p in s.out_placements])
    out.intrinsic_cost = s.intrinsic_cost
    out.compute_cost = s.compute_cost
    if hasattr(s, "meta"):
        out.meta = dict(s.meta)
    return out


def carry_graph(jgraph) -> MetaGraph:
    """The port's MetaGraph of a JAX-package MetaGraph, built node by
    node in the JAX graph's order through the port's public classes."""
    graph = MetaGraph(jgraph.name)
    mvars = {}

    def var(v):
        if v is None:
            return None
        if v.name not in mvars:
            mvars[v.name] = MetaVar(v.name, v.shape, v.dtype)
        return mvars[v.name]

    def node(jn):
        n = MetaNode(name=jn.name, op_key=jn.op_key,
                     invars=[var(v) for v in jn.invars],
                     outvars=[var(v) for v in jn.outvars],
                     space=_carry_space(jn.space),
                     recombines={g: _carry_recombine(fn)
                                 for g, fn in jn.recombines.items()},
                     arg_rows=list(jn.arg_rows), is_input=jn.is_input,
                     sig=jn.sig)
        n.flops = jn.flops
        n.compute_proxy = jn.compute_proxy
        if jn.explicit_strategies is not None:
            n.explicit_strategies = [_carry_strategy(s)
                                     for s in jn.explicit_strategies]
        n.pinned = _carry_strategy(jn.pinned)
        return n

    for jn in jgraph.inputs:
        graph.add_input(node(jn))
    for jn in jgraph.ops:
        graph.add_op(node(jn))
    graph.outputs = [mvars[v.name] for v in jgraph.outputs]
    by_name = {n.name: n for n in graph.inputs}
    graph.state_io = {k: by_name[n.name] for k, n in jgraph.state_io.items()}
    return graph


# ------------------------------------------------------------- fixtures

@pytest.fixture(autouse=True)
def _same_constants(monkeypatch, tmp_path):
    """One set of cost constants on both sides (the port's), no PerfDB
    op times on either, the default solver knobs."""
    from easydist_tpu import config as jconfig

    for knob in ("peak_flops", "hbm_bandwidth"):
        monkeypatch.setattr(jconfig, knob, getattr(pconfig, knob))
    monkeypatch.setattr(pconfig, "prof_db_path", str(tmp_path / "perf.db"))
    monkeypatch.setattr(jconfig, "prof_db_path", str(tmp_path / "jperf.db"))
    for knob in ("per_device_memory_cap", "solver_cluster_dedup",
                 "predict_comm_overlap", "beam_width", "solver_time_limit",
                 "solver_mip_rel_gap", "all_to_all_punish_factor",
                 "comm_quant_dtype", "comm_quant_min_numel"):
        assert getattr(jconfig, knob) == getattr(pconfig, knob), knob


@pytest.fixture(scope="module")
def frontend():
    """{(model, axis size): a function building the JAX package's
    MetaGraph of that train step anew} (traced and analyzed once)."""
    import jax
    import jax.numpy as jnp

    from easydist_tpu import config as jconfig
    from easydist_tpu.jaxfront.api import ShardingAnalyzer, infer_state_io
    from easydist_tpu.jaxfront.bridge import jaxpr_to_metagraph
    from easydist_tpu.jaxfront.inline import inline_calls
    from easydist_tpu.models import GPTConfig, make_gpt_train_step
    from easydist_tpu.models.mlp import make_mlp_train_step, mlp_init

    def steps():
        params = mlp_init(jax.random.PRNGKey(0))
        yield "mlp", make_mlp_train_step(), (
            params, jnp.ones((32, 16)), jnp.ones((32, 8)))
        cfg = GPTConfig.tiny(layers=2)
        step, init = make_gpt_train_step(cfg)
        tokens = jnp.zeros((8, cfg.seq), jnp.int32)
        yield "gpt_tiny", step, (init(jax.random.PRNGKey(0)), tokens, tokens)

    saved = jconfig.discovery_persistent_cache
    jconfig.discovery_persistent_cache = False
    makers = {}
    try:
        for model, step, args in steps():
            closed = inline_calls(jax.make_jaxpr(step)(*args))
            pairs = infer_state_io(args, jax.eval_shape(step, *args))
            for world in AXIS_SIZES:
                analyzer = ShardingAnalyzer(closed, world_size=world)
                rules, shape_info = analyzer.run()
                jaxpr, names = closed.jaxpr, analyzer.names
                state_io = {names.name(jaxpr.outvars[o]):
                            names.name(jaxpr.invars[i])
                            for o, i in pairs.items()}
                makers[model, world] = functools.partial(
                    jaxpr_to_metagraph, closed, rules, shape_info,
                    world_size=world, names=names, state_io=state_io)
    finally:
        jconfig.discovery_persistent_cache = saved
    return makers


def _pair(frontend, model, world, level=1):
    """(JAX solver, port solver) on the coarsened graphs of one train
    step for one axis."""
    from easydist_tpu.autoflow import MeshAxisSpec as JAxis
    from easydist_tpu.autoflow import SpmdSolver as JSolver

    jgraph = frontend[model, world]()
    pgraph = carry_graph(jgraph)
    jgraph.coarsen(world, level=level)
    pgraph.coarsen(world, level=level)
    jsolver = JSolver(jgraph, JAxis("dp", world, bandwidth=BANDWIDTH,
                                    latency=LATENCY))
    psolver = SpmdSolver(pgraph, MeshAxisSpec("dp", world, bandwidth=BANDWIDTH,
                                              latency=LATENCY))
    return jsolver, psolver


def _strategies(chosen):
    return {name: repr(s) for name, s in chosen.items()}


def _close(a, b, rel=1e-9):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


CASES = [(m, w) for m in MODELS for w in AXIS_SIZES]


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("model,world", CASES)
def test_carried_graph_is_the_same_graph(model, world, frontend):
    jgraph = frontend[model, world]()
    pgraph = carry_graph(jgraph)
    assert [n.name for n in pgraph.all_nodes()] == \
        [n.name for n in jgraph.all_nodes()]
    for jn, pn in zip(jgraph.all_nodes(), pgraph.all_nodes()):
        assert [repr(s) for s in pn.strategy_pool(world)] == \
            [repr(s) for s in jn.strategy_pool(world)], jn.name
    assert [v.name for v in pgraph.outputs] == [v.name for v in jgraph.outputs]
    assert {k: n.name for k, n in pgraph.state_io.items()} == \
        {k: n.name for k, n in jgraph.state_io.items()}
    assert pgraph.state_io, "the train step threads its state"
    assert [[v.name for v in live] for live in pgraph.liveness()] == \
        [[v.name for v in live] for live in jgraph.liveness()]


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("model,world", CASES)
def test_same_clusters_after_coarsen(model, world, level, frontend):
    jsolver, psolver = _pair(frontend, model, world, level)

    def clusters(graph):
        return [(sorted(c.nodes[u].name for u in c.nodes),
                 c.output_node.name,
                 [{c.nodes[u].name: (i, repr(s)) for u, (i, s) in st.items()}
                  for st in c.strategies])
                for c in graph.clusters]

    assert clusters(psolver.graph) == clusters(jsolver.graph)
    assert len(psolver.edges) == len(jsolver.edges)
    for pe, je in zip(psolver.edges, jsolver.edges):
        np.testing.assert_allclose(pe.comm, je.comm, rtol=1e-12, atol=0)
        np.testing.assert_allclose(pe.mem, je.mem, rtol=1e-12, atol=0)
    assert psolver.tie_rep == jsolver.tie_rep


@pytest.mark.parametrize("backend", ["milp", "beam"])
@pytest.mark.parametrize("model,world", CASES)
def test_solver_matches_jax(model, world, backend, frontend, monkeypatch):
    """The beam is held against the JAX package's Python beam: its C++
    core keeps a different one of equal-cost candidates (an unstable
    partial_sort) and can end elsewhere; the port's core sorts stably."""
    from easydist_tpu import native as jnative

    jsolver, psolver = _pair(frontend, model, world)
    solve = "_ilp_solve" if backend == "milp" else "beam_search"
    monkeypatch.setattr(jnative, "available", lambda: False)
    jchosen = getattr(jsolver, solve)()
    pchosen = getattr(psolver, solve)()
    assert _close(psolver.last_comm_cost, jsolver.last_comm_cost)
    assert _close(psolver.assignment_comm_cost(pchosen),
                  jsolver.assignment_comm_cost(jchosen))
    assert _strategies(pchosen) == _strategies(jchosen)


@pytest.mark.parametrize("model,world", CASES)
def test_memory_plan_matches_jax(model, world, frontend):
    from easydist_tpu.schedule import plan_graph_memory as jplan

    jsolver, psolver = _pair(frontend, model, world)
    jchosen, pchosen = jsolver._ilp_solve(), psolver._ilp_solve()
    jp = jplan(jsolver.graph, [jchosen], [world])
    pp = plan_graph_memory(psolver.graph, [pchosen], [world])
    assert pp.var_names == jp.var_names
    for field in ("starts", "ends", "sizes", "offsets"):
        np.testing.assert_array_equal(getattr(pp, field), getattr(jp, field))
    assert (pp.peak_bytes, pp.peak_live_bytes) == (jp.peak_bytes,
                                                   jp.peak_live_bytes)
    assert pp.validate() == [] == jp.validate()


@pytest.mark.parametrize("model,world", CASES)
def test_native_equals_python(model, world, frontend, monkeypatch):
    """The C++ planner and beam core give what their Python versions give
    on the solved train-step graphs."""
    assert pnative.available()
    _, psolver = _pair(frontend, model, world)
    plan = plan_graph_memory(psolver.graph, [psolver._ilp_solve()], [world])
    args = (plan.starts, plan.ends, plan.sizes)
    offsets, peak = pnative.skyline_plan_py(*args)
    np.testing.assert_array_equal(offsets, plan.offsets)
    assert peak == plan.peak_bytes
    assert pnative.peak_live_py(*args) == plan.peak_live_bytes
    assert pnative.check_plan_py(*args, plan.offsets) == [] == \
        pnative.check_plan(*args, plan.offsets)
    bad = plan.offsets.copy()
    bad[:] = 0  # every buffer at offset 0: overlapping lifetimes collide
    assert pnative.check_plan(*args, bad, max_report=10 ** 6) == \
        pnative.check_plan_py(*args, bad) != []

    native_pick = _strategies(psolver.beam_search())
    native_cost = psolver.last_comm_cost
    monkeypatch.setattr(pnative, "available", lambda: False)
    assert _strategies(psolver.beam_search()) == native_pick
    assert psolver.last_comm_cost == native_cost


@pytest.mark.parametrize("dtype,nbytes", [("float32", 4), (torch.float32, 4),
                                          (torch.bfloat16, 2), (np.dtype("int8"), 1)])
def test_metavar_dtype_is_a_bare_name(dtype, nbytes):
    var = MetaVar("v", (3, 5), dtype)
    assert not var.dtype.startswith("torch.")
    assert var.size_bytes() == 15 * nbytes


def test_native_builds_into_its_own_directory():
    lib = pnative._build()
    assert lib is not None and lib.parent == pnative.BUILD_DIR
    assert lib.name.startswith("libed_native-") and lib.suffix == ".so"


@pytest.mark.parametrize("up,down", [("R", "S0"), ("S0", "S0"), ("S0", "R"),
                                     ("P", "R"), ("P", "S0"), ("S0", "S1"),
                                     ("P", "P")])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_resharding_cost_matches_jax(up, down, n):
    from easydist_tpu.autoflow import MeshAxisSpec as JAxis
    from easydist_tpu.autoflow import resharding_cost as jcost
    from easydist_tpu.metashard.metair import Placement as JPlacement

    def place(cls, code):
        return (cls.replicate() if code == "R" else cls.partial()
                if code == "P" else cls.shard(int(code[1])))

    got = resharding_cost(1e6, place(Placement, up), place(Placement, down),
                          MeshAxisSpec("d", n, bandwidth=BANDWIDTH,
                                       latency=LATENCY))
    want = jcost(1e6, place(JPlacement, up), place(JPlacement, down),
                 JAxis("d", n, bandwidth=BANDWIDTH, latency=LATENCY))
    assert got == want


def test_axis_kinds_read_the_h100_constants(monkeypatch):
    nvlink = MeshAxisSpec("tp", 8)
    ib = MeshAxisSpec("dp", 2, kind="ib")
    assert nvlink.resolved_bandwidth() == pconfig.nvlink_bandwidth == 450e9
    assert ib.resolved_bandwidth() == pconfig.ib_bandwidth == 50e9
    assert nvlink.resolved_latency() == pconfig.nvlink_latency
    assert ib.resolved_latency() == pconfig.ib_latency
    monkeypatch.setattr(pconfig, "nvlink_bandwidth", 1.0)
    assert nvlink.resolved_bandwidth() == 1.0  # read at use, not latched
    with pytest.raises(ValueError):
        MeshAxisSpec("x", 4, kind="ici")


@pytest.mark.parametrize("source", ["auto", "measured", "config"])
@pytest.mark.parametrize("measured", [None, 0.3, 1.7])
def test_overlap_discount_ratio_matches_jax(source, measured, monkeypatch):
    """The overlap fraction resolves alike from the same knobs, with and
    without a measured fraction (clamped to [0, 1])."""
    from easydist_tpu import config as jconfig
    from easydist_tpu.autoflow.cost_model import overlap_discount_ratio as jr
    from easydist_tpu_torch.autoflow.cost_model import overlap_discount_ratio

    for cfg in (pconfig, jconfig):
        monkeypatch.setattr(cfg, "comm_overlap_ratio_source", source)
        monkeypatch.setattr(cfg, "comm_overlap_ratio_measured", measured)
        monkeypatch.setattr(cfg, "comm_overlap_ratio", 0.5)
    assert overlap_discount_ratio() == jr()


@pytest.mark.parametrize("size", [4, 8])
def test_chip_smoke_mlp_block_on_the_cpu(size, monkeypatch):
    """`chip_smoke.py`'s solver phase (c) with rules the port discovers on
    the CPU at narrow widths: both solvers agree, the batch sharding wins,
    the plan validates, native peaks equal Python's."""
    monkeypatch.setattr(pconfig, "discovery_device", "cpu")
    from easydist_tpu_torch.metashard import MetaOp

    rules = {}
    for name in ("addmm_c_fc", "gelu", "addmm_c_proj", "add_residual"):
        op, _, narrow, kwargs = chip_smoke.RULE_CASES[name]
        args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in numpy_args(narrow, seed=0)]
        rules[name] = MetaOp(op, args, kwargs=kwargs).discover()
    got = chip_smoke.solve_mlp_block(rules, size)
    assert got["cost"] == {"milp": 0.0, "beam": 0.0}
    # x, h, gelu(h), the projection and the output sharded 1/size; weights
    # and biases replicated; the skyline packs to the sum-of-live peak
    assert got["peak"] >= got["live_peak"] > 0
