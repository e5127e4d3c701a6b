"""The multi-device frontend's pieces in one process: the aten presets
against ShardCombine discovery (`_crosscheck_preset`), their coverage of
the traced train steps, propagation groups and the persistent rule cache
(the counterparts of `tests/test_jaxfront/test_discovery.py` and
`test_cache.py`), the strategy cache key, the mesh helpers, `profile_ops`
and the compile surface; and the solver's objective on the MLP train
step over an (8,) axis against the JAX package's, compiled against
torch's fake process group of 8 ranks (created and destroyed by a
fixture)."""

import numpy as np
import pytest
import torch

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.fxfront import discovery as disc
from easydist_tpu_torch.fxfront.api import _trace, solve_axes
from easydist_tpu_torch.fxfront.interpreter import (_CROSSCHECK_SKIP,
                                                    ShardingAnalyzer,
                                                    node_signature,
                                                    target_name)
from easydist_tpu_torch.fxfront.presets import rule_for
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.models import mlp as tmlp

GPT = dict(vocab=128, seq=64, dim=128, heads=4, layers=2)


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    """CPU discovery, rule cache and PerfDB under the test's directory."""
    monkeypatch.setattr(edconfig, "discovery_device", "cpu")
    monkeypatch.setattr(edconfig, "discovery_cache_dir",
                        str(tmp_path / "rules"))
    monkeypatch.setattr(edconfig, "compile_cache_dir",
                        str(tmp_path / "compile"))
    monkeypatch.setattr(edconfig, "prof_db_path", str(tmp_path / "perf.db"))
    disc.clear_cache_instances()
    yield
    disc.clear_cache_instances()


def _mlp_gm(sizes=(16, 64, 64, 8), batch=32):
    params = tmlp.mlp_init(torch.Generator().manual_seed(0), sizes,
                           device="cpu")
    args = (params, torch.ones(batch, sizes[0]), torch.zeros(batch,
                                                             sizes[-1]))
    return _trace(tmlp.make_mlp_train_step(), args, {})[0]


def _gpt_gm(attention):
    step, init = tg.make_gpt_train_step(tg.GPTConfig(**GPT,
                                                     attention=attention))
    state = init(torch.Generator().manual_seed(0), device="cpu")
    tok = torch.zeros(8, GPT["seq"], dtype=torch.long)
    return _trace(step, (state, tok, tok), {})[0]


TRACES = {"mlp": _mlp_gm, "gpt_einsum": lambda: _gpt_gm("einsum"),
          "gpt_flash": lambda: _gpt_gm("flash")}


def _analyze(gm, world=2, **knobs):
    saved = {k: getattr(edconfig, k) for k in knobs}
    for k, v in knobs.items():
        setattr(edconfig, k, v)
    try:
        a = ShardingAnalyzer(gm, world)
        rules, _ = a.run()
        return a, rules
    finally:
        for k, v in saved.items():
            setattr(edconfig, k, v)


def _rule_repr(rule):
    recs = {g: [getattr(f, "func", f).__name__ for f in (
        fn if isinstance(fn, list) else [fn])]
        for g, fn in rule["recombines"].items()}
    return repr(rule["space"]), recs


# ------------------------------------------------------------ presets

@pytest.mark.parametrize("trace", list(TRACES))
def test_crosscheck_mode_validates_presets(trace):
    """Every preset outside `_CROSSCHECK_SKIP` executes through the
    ShardCombine harness and recombines as it declares."""
    a, _ = _analyze(TRACES[trace](), discovery_crosscheck=True,
                    discovery_persistent_cache=False)
    c = a.counters
    assert c.crosscheck_checked > 0
    assert c.crosscheck_failures == 0


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_every_traced_target_has_a_preset(attention):
    import operator

    gm = _gpt_gm(attention)
    missing = {str(n.target) for n in gm.graph.nodes
               if n.op == "call_function" and n.target is not operator.getitem
               and rule_for(n.target) is None}
    assert not missing


@pytest.mark.parametrize("presets", [True, False])
@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_gpt_trace_resolves_without_replicate_fallback(attention, presets):
    a, _ = _analyze(_gpt_gm(attention), discovery_use_presets=presets,
                    discovery_persistent_cache=False)
    assert a.replicated_on_failure == []
    if presets:
        assert a.counters.rules_discovered == 0
    else:
        assert a.counters.rules_discovered > 0


def test_crosscheck_skip_entries_are_presets():
    import easydist_tpu_torch.fxfront.presets as presets

    for name in _CROSSCHECK_SKIP:
        assert name in presets._RULES, name


def test_kernels_replicate():
    a, rules = _analyze(_gpt_gm("flash"), discovery_persistent_cache=False)
    for sig, rule in rules.items():
        if sig.startswith("easydist_tpu_torch."):
            assert rule["space"].max_group() == 0, sig


# -------------------------------------------- groups and the rule cache

@pytest.mark.parametrize("trace", ["mlp", "gpt_einsum"])
def test_pruning_preserves_rules_and_strategies(trace):
    """Propagation groups never change a rule or a solve."""
    from easydist_tpu_torch.autoflow import MeshAxisSpec

    gm = TRACES[trace]()
    out = {}
    for prune in (True, False):
        a, rules = _analyze(gm, discovery_use_presets=False,
                            discovery_prune=prune,
                            discovery_persistent_cache=False)
        per_axis, _, _ = solve_axes(gm, [MeshAxisSpec("d", 2)], 2, rules,
                                    a.shape_info, a.names)
        out[prune] = ({s: _rule_repr(r) for s, r in rules.items()},
                      {k: repr(v) for k, v in per_axis[0].items()}, a)
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    assert out[True][2].counters.rules_from_group > 0


def test_kill_switch_disables_all_reuse():
    a, _ = _analyze(_mlp_gm(), discovery_use_presets=False,
                    discovery_prune=False, discovery_persistent_cache=False)
    assert a.counters.rules_from_group == 0
    assert a.counters.rules_from_cache == 0


def test_grouping_reuses_rules_across_sizes():
    """Layers of different widths share a group when their dims play the
    same roles."""
    a, _ = _analyze(_mlp_gm(sizes=(16, 64, 128, 8)),
                    discovery_use_presets=False,
                    discovery_persistent_cache=False)
    assert a.counters.rules_from_group > 0
    assert a.counters.groups < a.counters.rules_discovered \
        + a.counters.rules_from_group


def test_grouping_respects_divisibility_roles():
    gm = _mlp_gm(sizes=(16, 64, 63, 8))
    a, rules = _analyze(gm, discovery_use_presets=False,
                        discovery_persistent_cache=False)
    b, rules_b = _analyze(gm, discovery_use_presets=False,
                          discovery_prune=False,
                          discovery_persistent_cache=False)
    assert {s: _rule_repr(r) for s, r in rules.items()} == \
        {s: _rule_repr(r) for s, r in rules_b.items()}


def test_persistent_cache_warm_start_is_probe_free():
    gm = _mlp_gm()
    cold, rules = _analyze(gm, discovery_use_presets=False,
                           discovery_persistent_cache=True)
    assert cold.counters.rules_discovered > 0
    disc.clear_cache_instances()
    warm, rules_w = _analyze(gm, discovery_use_presets=False,
                             discovery_persistent_cache=True)
    assert warm.counters.rules_discovered == 0
    assert warm.counters.probes_compiled == 0
    assert warm.counters.rules_from_cache > 0
    assert {s: _rule_repr(r) for s, r in rules.items()} == \
        {s: _rule_repr(r) for s, r in rules_w.items()}


def test_cache_salt_isolates_knob_and_device_changes(monkeypatch):
    base = disc.cache_salt()
    monkeypatch.setattr(edconfig, "discovery_nshards", 4)
    assert disc.cache_salt() != base
    monkeypatch.setattr(edconfig, "discovery_nshards", 2)
    assert disc.cache_salt() == base
    monkeypatch.setattr(edconfig, "discovery_device", "cuda")
    assert disc.cache_salt() != base


def test_failed_discovery_replicates_and_is_not_persisted(monkeypatch):
    from easydist_tpu_torch.metashard import MetaOp

    def boom(self, prompt=None):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(MetaOp, "discover", boom)
    a, rules = _analyze(_mlp_gm(), discovery_use_presets=False,
                        discovery_persistent_cache=True)
    assert a.replicated_on_failure
    cache = disc.get_cache()
    assert len(cache) > 0  # the views' analytic rules are kept
    kept = {e["target"] for e in cache._mem.values()}
    assert kept <= {"aten.view", "aten._unsafe_view"}, kept


# ------------------------------------------------------ strategy cache

def test_compile_cache_key_distinguishes_wiring():
    from easydist_tpu_torch.autoflow import MeshAxisSpec
    from easydist_tpu_torch.fxfront.api import _compile_cache_key

    axes = [MeshAxisSpec("d", 2)]
    x, y = torch.ones(4, 4), torch.ones(4, 4)
    a = _trace(lambda p, q: (p @ q) - q, (x, y), {})[0]
    b = _trace(lambda p, q: (p @ q) - p, (x, y), {})[0]
    a2 = _trace(lambda p, q: (p @ q) - q, (x, y), {})[0]
    assert _compile_cache_key(a, axes) != _compile_cache_key(b, axes)
    assert _compile_cache_key(a, axes) == _compile_cache_key(a2, axes)
    assert _compile_cache_key(a, axes) != _compile_cache_key(
        a, [MeshAxisSpec("d", 2, kind="ib")])


# --------------------------------------------------------------- mesh

def test_mesh_needs_a_process_group():
    import torch.distributed as dist

    from easydist_tpu_torch.fxfront import make_device_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_device_mesh((2,), ("dp",), device_type="cpu")


def test_axis_solve_order_puts_ib_first():
    from easydist_tpu_torch.autoflow import MeshAxisSpec
    from easydist_tpu_torch.fxfront.api import _axis_solve_order

    axes = [MeshAxisSpec("tp", 8), MeshAxisSpec("dp", 2, kind="ib"),
            MeshAxisSpec("sp", 4)]
    assert _axis_solve_order(axes) == [1, 0, 2]


# ------------------------------------------------------- compile surface

def test_mesh_spec_that_is_no_device_mesh_raises():
    from easydist_tpu_torch.fxfront import easydist_compile

    with pytest.raises(TypeError, match="DeviceMesh"):
        easydist_compile(tmlp.make_mlp_train_step(), mesh=["cpu", "cpu"])


def test_state_io_dict_pairs_explicitly():
    from easydist_tpu_torch.fxfront import easydist_compile

    params = tmlp.mlp_init(torch.Generator().manual_seed(0), device="cpu")
    leaves = torch.utils._pytree.tree_leaves(params)
    before = [p.clone() for p in leaves]
    compiled = easydist_compile(tmlp.make_mlp_train_step(), state_io={0: 0})
    new, _ = compiled(params, torch.ones(2, 16), torch.zeros(2, 8))
    new_leaves = torch.utils._pytree.tree_leaves(new)
    assert new_leaves[0] is leaves[0]
    assert not torch.equal(leaves[0], before[0])
    assert all(torch.equal(p, b) for p, b in zip(leaves[1:], before[1:]))
    assert new_leaves[1] is not leaves[1]


def test_profile_ops_feeds_the_solver():
    from easydist_tpu_torch.autoflow.solver import _cached_op_times
    from easydist_tpu_torch.runtime.op_profile import profile_ops

    params = tmlp.mlp_init(torch.Generator().manual_seed(0), device="cpu")
    args = (params, torch.ones(4, 16), torch.zeros(4, 8))
    times = profile_ops(tmlp.make_mlp_train_step(), *args, trials=1)
    gm = _trace(tmlp.make_mlp_train_step(), args, {})[0]
    sigs = {node_signature(n) for n in gm.graph.nodes
            if n.op == "call_function" and target_name(n.target)
            .startswith("aten.")}
    assert sigs <= set(times) and all(t > 0 for t in times.values())
    assert set(times) <= set(_cached_op_times())


# ----------------------------------------------- solver parity with JAX

@pytest.fixture
def fake_world8():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch.fxfront import set_device_mesh

    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    yield
    set_device_mesh(None)
    dist.destroy_process_group()


def _objective(solver, chosen) -> float:
    """Edge communication plus the per-strategy compute and output costs
    at the picked strategies (what the ILP minimizes, memory aside)."""
    pick = {}
    for c in solver.clusters:
        for s in range(c.strategy_count()):
            if all(c.strategies[s][uid][1] == chosen.get(c.nodes[uid].name)
                   for uid in c.strategies[s]):
                pick[c.cid] = s
                break
    comm = sum(e.comm[pick[e.up_cluster.cid], pick[e.down_cluster.cid]]
               for e in solver.edges)
    return float(comm + sum(v[pick[cid]]
                            for cid, v in solver.output_y_cost.items()))


def _jax_mlp_objective(params, x, y):
    import jax

    from easydist_tpu.autoflow import MeshAxisSpec, SpmdSolver
    from easydist_tpu.jaxfront.api import infer_state_io
    from easydist_tpu.jaxfront.bridge import jaxpr_to_metagraph
    from easydist_tpu.jaxfront.inline import inline_calls
    from easydist_tpu.jaxfront.interpreter import (
        ShardingAnalyzer, _inject_partial_propagation)
    from easydist_tpu.models import mlp as jmlp

    args = (params, x, y)
    closed, out = jax.make_jaxpr(jmlp.make_mlp_train_step(),
                                 return_shape=True)(*args)
    closed = inline_calls(closed)
    analyzer = ShardingAnalyzer(closed, world_size=8)
    rules, shapes = analyzer.run()
    names, jaxpr = analyzer.names, closed.jaxpr
    state_io = {names.name(jaxpr.outvars[o]): names.name(jaxpr.invars[i])
                for o, i in infer_state_io(args, out).items()}
    graph = jaxpr_to_metagraph(closed, rules, shapes, world_size=8,
                               names=names, state_io=state_io)
    _inject_partial_propagation(graph, 8)
    graph.coarsen(8, level=1)
    solver = SpmdSolver(graph, MeshAxisSpec(
        "d", 8, bandwidth=edconfig.nvlink_bandwidth,
        latency=edconfig.nvlink_latency))
    return _objective(solver, solver.solve())


# The two objectives on the MLP step (256 -> 512 -> 256, batch 2048)
# over (8,) at the JAX package's cost constants.  They differ: the aten
# graph (detach nodes, t / sum / view of the bias gradients, mean's
# P(avg)) is not the jaxpr (broadcast_in_dim, integer_pow, add_any), so
# the ILP prices other nodes and reaches another optimum (ROADMAP queue C,
# divergences).  Both are pinned.  The port's matmuls are priced by their
# roofline at local sizes, as the JAX package's dots are (the solver
# reads an "aten.mm" node's FLOPs).
PORT_OBJECTIVE = 5.519589e-05
JAX_OBJECTIVE = 4.9506949197530863e-05


def test_solver_objective_against_jax_on_mlp(fake_world8, monkeypatch):
    import jax

    from easydist_tpu import config as jconfig
    from easydist_tpu.models import mlp as jmlp
    from easydist_tpu_torch.fxfront import compile_step, make_device_mesh

    monkeypatch.setattr(jconfig, "discovery_persistent_cache", False)
    monkeypatch.setattr(edconfig, "discovery_persistent_cache", False)
    for knob, jknob in (("peak_flops", "peak_flops"),
                        ("hbm_bandwidth", "hbm_bandwidth"),
                        ("nvlink_bandwidth", "ici_bandwidth"),
                        ("nvlink_latency", "ici_latency")):
        monkeypatch.setattr(edconfig, knob, getattr(jconfig, jknob))
    params_j = jmlp.mlp_init(jax.random.PRNGKey(0), (256, 512, 256))
    rs = np.random.RandomState(1)
    x = rs.randn(2048, 256).astype(np.float32)
    y = rs.randn(2048, 256).astype(np.float32)
    jax_obj = _jax_mlp_objective(params_j, x, y)

    mesh = make_device_mesh((8,), ("d",), device_type="cpu")
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    result = compile_step(tmlp.make_mlp_train_step(),
                          (params_t, torch.from_numpy(x),
                           torch.from_numpy(y)), {}, mesh=mesh)
    port_obj = _objective(result.solvers[0], result.strategies[0])
    np.testing.assert_allclose(port_obj, PORT_OBJECTIVE, rtol=1e-6)
    np.testing.assert_allclose(jax_obj, JAX_OBJECTIVE, rtol=1e-6)
    assert any(n.startswith("mm") and not s.is_all_replicate()
               for n, s in result.strategies[0].items())


@pytest.mark.parametrize("bias", [False, True])
def test_conv_presets_hold_against_discovery(bias):
    """The convolution presets (no probe runs a convolution: on the card
    a probe at disagreeing shapes read past its buffers) recombine as
    ShardCombine finds on the CPU, forward and backward, at even sizes
    (the harness cannot split an odd dim in two)."""
    import torch.nn.functional as F

    def conv_grads(x, w, b):
        y = F.conv2d(F.pad(x, (0, 1, 0, 1)), w, b, stride=2)
        return torch.autograd.grad((y * y).sum(), (x, w))

    args = (torch.randn(4, 4, 8, 8).requires_grad_(),
            torch.randn(6, 4, 3, 3).requires_grad_(),
            torch.randn(6).requires_grad_() if bias else None)
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(conv_grads, tracing_mode="fake")(*args)
    convs = [n for n in gm.graph.nodes
             if str(n.target).startswith("aten.convolution")]
    assert len(convs) == 2
    a, rules = _analyze(gm, discovery_crosscheck=True,
                        discovery_persistent_cache=False)
    assert a.counters.crosscheck_checked >= 2
    assert a.counters.crosscheck_failures == 0
    for n in convs:
        groups = rules[node_signature(n)]["space"].max_group()
        assert groups == (2 if bias and n.target is torch.ops.aten.
                          convolution.default else 3), n.target
