"""Compiler-chosen remat of the port (`schedule/remat.py`, wired into
`easydist_compile` under a memory cap) and `remat_policy`, against the
JAX package's (tests/test_schedule/test_remat_knobs.py,
tests/test_jaxfront/test_auto_remat.py, test_config_flags.py::
test_remat_policy_recomputes_in_backward).

The planner runs over the traced aten program: candidates ranked by
resident bytes per recompute second, the chain cap, determinism, the
FLOP proxy and measured op times; a plan under a cap lowers the planned
peak and keeps the numbers; no plan when the program fits; a tiny GPT
under a cap (base peak > cap >= planned peak) trains like its uncapped
twin (rtol 1e-5) and like the JAX package (rtol 1e-4 / atol 1e-5); no
kernel op, random op or collective is ever recomputed; the rewritten
program keeps its chains (no CSE folds them).  `remat_policy="all"`
recomputes the forward in the backward of a caller that differentiates
through a compiled forward, with the gradients of eager torch.
"""

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.fxfront import easydist_compile
from easydist_tpu_torch.schedule import remat as rm


@pytest.fixture(autouse=True)
def _knobs(monkeypatch, tmp_path):
    for name in ("per_device_memory_cap", "remat_max_chain_len",
                 "peak_flops", "use_op_cost_db", "remat_policy",
                 "enable_auto_remat", "hbm_bandwidth", "nvlink_bandwidth",
                 "nvlink_latency"):
        monkeypatch.setattr(edconfig, name, getattr(edconfig, name))
    monkeypatch.setattr(edconfig, "prof_db_path", str(tmp_path / "p.db"))
    monkeypatch.setattr(edconfig, "discovery_device", "cpu")
    monkeypatch.setattr(edconfig, "discovery_cache_dir",
                        str(tmp_path / "disc"))


def make_program():
    """Two equal-size 256 KB activations span the peak: `a` rebuilds from
    a 1 KB vector through expand + tanh (cheap), `b` through expand + mm
    (expensive).  The ranking must evict `a` and stop."""
    def f(xs, w):
        a = torch.tanh(xs.expand(256, 256))
        b = xs.expand(256, 256) @ w
        big = torch.cat([w, w], 0)
        big2 = torch.cat([big, big], 0)
        r = big2.sum()
        ya = (a @ w).sum()
        yb = (b @ w).sum()
        return r + ya + yb

    return make_fx(f, tracing_mode="fake")(torch.ones(256),
                                           torch.eye(256))


def _targets(gm, plan):
    by_name = {n.name: n for n in gm.graph.nodes}
    return {by_name[u].target for ch in plan.recompute.values() for u in ch}


def test_candidates_ordered_by_bytes_per_recompute_second():
    gm = make_program()
    probe = rm.plan_remat(gm, 1)  # impossible cap: exposes the base peak
    assert probe is not None and probe.base_peak > 0
    cap = probe.base_peak - 50_000  # one 256 KB eviction suffices
    plan = rm.plan_remat(gm, cap)
    assert plan is not None and plan.predicted_peak <= cap
    # the cheap candidate won: the chain is tanh, never the mm of `b`
    assert torch.ops.aten.mm.default not in _targets(gm, plan)
    assert plan.n_remat_vars == 1


def test_candidate_score_metric():
    assert rm.candidate_score(100.0, 1.0) > rm.candidate_score(100.0, 2.0)
    assert rm.candidate_score(200.0, 1.0) > rm.candidate_score(100.0, 1.0)
    assert rm.candidate_score(100.0, 0.0) == pytest.approx(100.0 / 1e-6)


def test_chain_length_cap_respected():
    gm = make_program()
    cap = rm.plan_remat(gm, 1).base_peak - 50_000
    # `a`'s chain is one node (tanh; the expand of the input is a view the
    # chain reads): a cap of 0 bans it and everything else
    edconfig.remat_max_chain_len = 0
    assert rm.plan_remat(gm, cap) is None
    edconfig.remat_max_chain_len = 96
    assert rm.plan_remat(gm, cap) is not None


def test_plan_deterministic():
    gm = make_program()
    cap = rm.plan_remat(gm, 1).base_peak - 50_000
    p1, p2 = rm.plan_remat(gm, cap), rm.plan_remat(gm, cap)
    assert p1.recompute == p2.recompute and p1.records == p2.records
    assert p1.predicted_peak == p2.predicted_peak


def test_eqn_flops_proxy():
    gm = make_fx(lambda x, w: torch.tanh(x @ w), tracing_mode="fake")(
        torch.ones(8, 16), torch.ones(16, 4))
    nodes = {n.target: n for n in gm.graph.nodes if n.op == "call_function"}
    assert rm._eqn_flops(nodes[torch.ops.aten.mm.default]) \
        == 2.0 * (8 * 4) * 16
    assert rm._eqn_flops(nodes[torch.ops.aten.tanh.default]) == 8 * 4


def test_flop_proxy_drives_seconds():
    gm = make_program()
    cap = rm.plan_remat(gm, 1).base_peak - 50_000
    edconfig.use_op_cost_db = False
    edconfig.peak_flops = 1e12
    s1 = rm.plan_remat(gm, cap).recompute_seconds
    edconfig.peak_flops = 5e11
    s2 = rm.plan_remat(gm, cap).recompute_seconds
    assert s1 > 0 and s2 == pytest.approx(2.0 * s1)


class _UniformTimes(dict):
    """Fake op-times DB: every signature measures 1.0 s."""

    def get(self, key, default=None):
        return 1.0

    def __bool__(self):
        return True


def _mlp_step(L=6, D=64, B=8192):
    def mk():
        return [torch.ones(D, D) / D * (1 + 0.1 * i) for i in range(L)]

    x = torch.from_numpy(np.random.RandomState(0).randn(B, D)
                         .astype(np.float32))

    def step(params, x):
        ps = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():
            h = x
            for w in ps:
                h = torch.tanh(h @ w)
            loss = torch.mean(h ** 2)
            g = torch.autograd.grad(loss, ps)
        return [p - 0.1 * gi for p, gi in zip(params, g)], loss.detach()

    return step, mk, x


def test_auto_remat_reduces_planned_peak():
    """An activation-dominated step over a cap: the rewrite lands the
    planned peak under the cap and keeps the numbers; the chains stay in
    the program that runs (nothing folds them back)."""
    step, mk, x = _mlp_step()
    edconfig.per_device_memory_cap = 0
    r0 = easydist_compile(step).get_compiled(mk(), x)
    assert r0.remat_plan is None
    out0 = r0.tree_jitted(mk(), x)

    base = rm.program_peak(r0.traced)
    floor = rm.plan_remat(r0.traced, 1).predicted_peak
    cap = (base + floor) // 2
    edconfig.per_device_memory_cap = int(cap / edconfig.memory_ratio) + 1
    r1 = easydist_compile(step).get_compiled(mk(), x)
    plan = r1.remat_plan
    assert plan is not None and plan.n_remat_vars > 0
    assert plan.base_peak > cap >= plan.predicted_peak
    clones = [n for n in r1.graph_module.graph.nodes if "remat_of" in n.meta]
    assert len(clones) == plan.recomputed_nodes > 0
    assert rm.program_peak(r1.graph_module) == plan.predicted_peak
    out1 = r1.tree_jitted(mk(), x)
    np.testing.assert_allclose(float(out0[1]), float(out1[1]), rtol=1e-5)
    for a, b in zip(out0[0], out1[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_remat_chain_cost_uses_measured_op_times(monkeypatch):
    """With a PerfDB profile, chains are priced by the measured seconds:
    a uniform 1 s a node makes recompute_seconds count the recomputed
    nodes that run a kernel (views and getitems cost nothing)."""
    import easydist_tpu_torch.runtime.op_profile as op_profile

    step, mk, x = _mlp_step()
    monkeypatch.setattr(op_profile, "load_op_times", lambda: _UniformTimes())
    edconfig.use_op_cost_db = True
    edconfig.per_device_memory_cap = 0
    r0 = easydist_compile(step).get_compiled(mk(), x)
    gm = r0.traced
    plan = rm.plan_remat(gm, rm.program_peak(gm) - 1)
    by_name = {n.name: n for n in gm.graph.nodes}
    n_exec = sum(1 for r in plan.records for u in r.chain
                 if not rm._aliases_input(by_name[u])
                 and by_name[u].target.__name__ != "getitem")
    assert plan.recompute_seconds == pytest.approx(float(n_exec))


def test_no_remat_when_program_fits():
    step, mk, x = _mlp_step(L=2, D=32, B=64)
    edconfig.per_device_memory_cap = 1 << 30
    assert easydist_compile(step).get_compiled(mk(), x).remat_plan is None


def test_resolve_memory_cap(monkeypatch):
    edconfig.per_device_memory_cap = 1000
    assert rm.resolve_memory_cap() == int(1000 * edconfig.memory_ratio)
    edconfig.per_device_memory_cap = 0
    assert rm.resolve_memory_cap(device="cuda") == 0
    edconfig.per_device_memory_cap = -1
    assert rm.resolve_memory_cap(device="cpu") == 0  # CPU: uncapped
    assert rm.resolve_memory_cap() == 0

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert rm.resolve_memory_cap(device="cuda") == int(
        80 * 2**30 * edconfig.memory_ratio)


def test_banned_nodes_never_recomputed():
    """The kernels' custom ops, random draws and in-place ops are no chain
    material; a chain reaching one is dropped."""
    from easydist_tpu_torch.ops.flash_attention import flash_attention

    def f(q, w):
        o = flash_attention(q, q, q, True)
        d = torch.nn.functional.dropout(o @ w, 0.5, True)
        s = o.clone()
        s.add_(1.0)
        return (o * d).sum() + s.sum() + (o @ w).sum()

    gm = make_fx(f, tracing_mode="fake")(torch.ones(1, 2, 64, 16),
                                         torch.ones(16, 16))
    banned = [n for n in gm.graph.nodes if n.op == "call_function"
              and ("flash" in str(n.target) or "dropout" in str(n.target)
                   or "bernoulli" in str(n.target) or "add_" in str(n.target))]
    assert banned and not any(rm.recomputable(n) for n in banned)
    plan = rm.plan_remat(gm, 1)
    if plan is not None:
        by_name = {n.name: n for n in gm.graph.nodes}
        assert not any(by_name[u] in banned for r in plan.records
                       for u in r.chain)


def _gpt_data(cfg, batch, seed=1):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, cfg.vocab, (batch, cfg.seq)).astype(np.int32)
    return tok


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_gpt_train_under_cap_matches_uncapped(attention):
    """A tiny GPT step that does not fit the cap: a plan under it, the
    same losses as the uncapped twin (rtol 1e-5) and as the JAX package
    (rtol 1e-4 / atol 1e-5), and no kernel op in any chain."""
    import jax

    from easydist_tpu.models import GPTConfig as JCfg
    from easydist_tpu.models import make_gpt_train_step as j_step
    from easydist_tpu_torch.models.gpt import (GPTConfig,
                                               make_gpt_train_step,
                                               params_from_numpy)
    from easydist_tpu_torch.models.optim import adam_init

    kw = dict(seq=32, dim=32, heads=4, layers=2, vocab=128)
    jstep, jinit = j_step(JCfg.tiny(**kw))
    jstate = jinit(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jstate[0])
    tok = _gpt_data(JCfg.tiny(**kw), 4)
    jit = jax.jit(jstep)
    j_losses = []
    for _ in range(2):
        jstate, lv = jit(jstate, tok, tok)
        j_losses.append(float(lv))

    cfg = GPTConfig.tiny(attention=attention, **kw)
    step, _ = make_gpt_train_step(cfg)
    t = torch.from_numpy(tok)

    def state():
        p = params_from_numpy(params_np, device="cpu")
        return (p, adam_init(p))

    edconfig.per_device_memory_cap = 0
    r0 = easydist_compile(step).get_compiled(state(), t, t)
    base = rm.program_peak(r0.traced)
    floor = rm.plan_remat(r0.traced, 1).predicted_peak
    cap = (base + floor) // 2
    edconfig.per_device_memory_cap = int(cap / edconfig.memory_ratio) + 1
    r1 = easydist_compile(step).get_compiled(state(), t, t)
    plan = r1.remat_plan
    assert plan is not None and plan.base_peak > cap >= plan.predicted_peak
    assert not any("easydist_tpu_torch" in str(n.target)
                   for n in r1.graph_module.graph.nodes
                   if "remat_of" in n.meta)
    losses = {}
    for key, r in (("base", r0), ("capped", r1)):
        s = state()
        losses[key] = []
        for _ in range(2):
            s, lv = r.tree_jitted(s, t, t)
            losses[key].append(float(lv))
    np.testing.assert_allclose(losses["capped"], losses["base"], rtol=1e-5)
    np.testing.assert_allclose(losses["capped"], j_losses, rtol=1e-4,
                               atol=1e-5)


def test_collectives_never_recomputed():
    """On a mesh the planner runs over this rank's emitted program (fake
    group of 2): its collectives and helpers are never chain material."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch.fxfront import make_device_mesh, set_device_mesh

    step, mk, x = _mlp_step(L=4, D=64, B=4096)
    # the JAX package's constants, under which dp wins at this size
    for name, value in (("peak_flops", 4.9e13), ("hbm_bandwidth", 8.1e11),
                        ("nvlink_bandwidth", 2e11), ("nvlink_latency", 1e-6)):
        setattr(edconfig, name, value)
    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        mesh = make_device_mesh((2,), ("dp",), device_type="cpu")
        edconfig.per_device_memory_cap = 0
        r0 = easydist_compile(step, mesh=mesh, compile_only=True)(mk(), x)
        assert r0.collectives
        edconfig.per_device_memory_cap = 2  # plan as far as it goes
        r1 = easydist_compile(step, mesh=mesh, compile_only=True)(mk(), x)
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()
    plan = r1.remat_plan
    assert plan is not None
    clones = [n for n in r1.graph_module.graph.nodes if "remat_of" in n.meta]
    assert clones and all(rm.recomputable(n) for n in clones)
    assert [(c.kind, c.group_bytes) for c in r1.collectives] == \
        [(c.kind, c.group_bytes) for c in r0.collectives]


def _fwd(w, x):
    for wi in w:
        x = torch.tanh(x @ wi)
    return x


def _mm_calls(fn):
    """aten mm calls dispatched while fn() runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                count[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return count[0], out


@pytest.mark.parametrize("policy", ["all", "dots"])
def test_remat_policy_recomputes_in_backward(policy):
    """Differentiating through a compiled forward: "all" recomputes the
    forward's matmuls in the backward (more mm calls than "none"), "dots"
    keeps them (no more than "none"); the gradients equal eager torch's."""
    rs = np.random.RandomState(0)
    w0 = [torch.from_numpy(rs.randn(64, 64).astype(np.float32) / 8)
          for _ in range(4)]
    x = torch.from_numpy(rs.randn(32, 64).astype(np.float32))

    def grads():
        w = [t.clone().requires_grad_() for t in w0]
        compiled = easydist_compile(_fwd, donate_state=False)

        def run():
            return torch.autograd.grad(compiled(w, x).sum(), w)

        return _mm_calls(run)

    edconfig.remat_policy = "none"
    base, g0 = grads()
    edconfig.remat_policy = policy
    got, g1 = grads()
    if policy == "all":
        assert got > base, (got, base)
    else:
        assert got <= base, (got, base)
    w = [t.clone().requires_grad_() for t in w0]
    want = torch.autograd.grad(_fwd(w, x).sum(), w)
    for a, b, c in zip(g0, g1, want):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b, c, rtol=1e-5, atol=1e-6)


def test_remat_policy_unknown_raises():
    edconfig.remat_policy = "most"
    with pytest.raises(ValueError, match="remat_policy"):
        easydist_compile(_fwd)([torch.ones(4, 4)], torch.ones(2, 4))
