"""Tensor parallelism inside pipeline stages:
`easydist_compile(loss, pp_stages=2, tp_axes=("tp",))` of the port
(`fxfront/pp_compile.py::_solve_tp`, `parallel/auto_pipeline.py::
_run_nodes_tp`) against the JAX package's
(tests/test_jaxfront/test_pp_compile.py: test_hybrid_tp_inside_stages_
parity, test_hybrid_tp_1f1b_parity, test_hybrid_tp_mixed_replicated_
weight_grads, test_tp_axis_idles_when_nothing_profitable).

All cases run in one spawn on gloo, a (2, 1, 2) "pp" x "dp" x "tp" mesh
(world 4; the JAX tests take (2, 2, 2) at world 8), priced with the JAX
package's cost constants: 3 Adam steps (lr 1e-2) hold the eager torch
step and the JAX package's at the JAX bar, rtol 8e-4 / atol 5e-5 (rtol
2e-4 / atol 2e-5 for the idle axis, as there).  The wide 4-layer MLP
is sharded, the mixed loss keeps its narrow head replicated while its
wide layers are sharded, a narrow MLP leaves the axis idle, and a tiny
GPT with flash attention (1f1b) is split on the tp axis around its
replicated kernel ops; each rank's
tp collectives equal what the plan's conversions give, and the
validation errors hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from easydist_tpu.models import GPTConfig as JGPT
from easydist_tpu.models import gpt_init as j_gpt_init
from easydist_tpu.models.gpt import gpt_loss as j_gpt_loss
from easydist_tpu.models.optim import adam_init as j_adam_init
from easydist_tpu.models.optim import adam_update as j_adam_update
from easydist_tpu_torch.fxfront import easydist_compile
from easydist_tpu_torch.fxfront.pp_compile import PPCompiledFunction
from tests import test_torch_fxfront_ranks as ranks
from tests import test_torch_parallel_ranks as pr

SCENARIO = "tests.test_torch_parallel_ranks:pp_tp_modes"
JAX_CONSTANTS = dict(peak_flops=4.9e13, hbm_bandwidth=8.1e11,
                     nvlink_bandwidth=2e11, nvlink_latency=1e-6)
LR = 1e-2


def _wide(rs, D=1024):
    return {f"w{i}": (0.02 * rs.randn(D, D)).astype(np.float32)
            for i in range(4)}


def _cases():
    rs = np.random.RandomState(0)
    D, H = 1024, 8
    wide = _wide(rs)
    x = rs.randn(8, D).astype(np.float32)
    y = rs.randn(8, D).astype(np.float32)
    mixed = {"w0": (0.02 * rs.randn(D, D)).astype(np.float32),
             "w1": (0.02 * rs.randn(D, D)).astype(np.float32),
             "head": (0.02 * rs.randn(D, H)).astype(np.float32)}
    ym = rs.randn(8, H).astype(np.float32)
    narrow = {f"w{i}": (0.3 * rs.randn(16, 16)).astype(np.float32)
              for i in range(4)}
    xn = rs.randn(16, 16).astype(np.float32)
    yn = rs.randn(16, 16).astype(np.float32)
    gpt = jax.tree.map(np.asarray, j_gpt_init(
        JGPT.tiny(**pr.GPT_TP_KW), jax.random.PRNGKey(0)))
    tok = rs.randint(0, pr.GPT_TP_KW["vocab"],
                     (4, pr.GPT_TP_KW["seq"])).astype(np.int32)
    tgt = rs.randint(0, pr.GPT_TP_KW["vocab"],
                     (4, pr.GPT_TP_KW["seq"])).astype(np.int32)
    return {"wide_gpipe": ("wide", wide, x, y, "gpipe", 2),
            "gpt_1f1b": ("gpt", gpt, tok, tgt, "1f1b", 2),
            "wide_1f1b": ("wide", wide, x, y, "1f1b", 2),
            "mixed_gpipe": ("mixed", mixed, x, ym, "gpipe", 2),
            "mixed_1f1b": ("mixed", mixed, x, ym, "1f1b", 2),
            "idle": ("pp", narrow, xn, yn, "gpipe", 4)}


def _j_loss(name):
    def mlp(p, x, y):
        h = x
        for i in range(4):
            h = jnp.tanh(h @ p[f"w{i}"])
        return jnp.mean((h - y) ** 2)

    def mixed(p, x, y):
        h = jnp.tanh(x @ p["w0"])
        h = jnp.tanh(h @ p["w1"])
        return jnp.mean((h @ p["head"] - y) ** 2)

    def gpt(p, tok, tgt):
        return j_gpt_loss(p, JGPT.tiny(**pr.GPT_TP_KW), tok, tgt)

    return {"mixed": mixed, "gpt": gpt}.get(name, mlp)


def _t_loss(name):
    import torch

    return {"wide": pr.wide_loss, "mixed": pr.mixed_loss,
            "pp": pr.pp_loss, "gpt": pr.gpt_tp_loss}[name], torch


def _jax_eager(name, params, x, y):
    loss = _j_loss(name)

    @jax.jit
    def step(p, o):
        lv, g = jax.value_and_grad(loss)(p, x, y)
        p2, o2 = j_adam_update(p, g, o, lr=LR)
        return p2, o2, lv

    p, o, out = dict(params), j_adam_init(params), []
    for _ in range(3):
        p, o, lv = step(p, o)
        out.append(float(lv))
    return out


def _torch_eager(name, params, x, y):
    from easydist_tpu_torch.models.optim import adam_init, adam_update

    from torch.utils import _pytree as pytree

    fn, torch = _t_loss(name)
    p = pr.from_numpy(params)
    o, out = adam_init(p), []
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        leaves, spec = pytree.tree_flatten(p)
        q = [v.clone().requires_grad_() for v in leaves]
        lv = fn(pytree.tree_unflatten(q, spec), xt, yt)
        g = pytree.tree_unflatten(list(torch.autograd.grad(lv, q)), spec)
        p, o = adam_update(p, g, o, lr=LR)
        out.append(float(lv.detach()))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    res = ranks.spawn(SCENARIO, 4, tmp_path_factory.mktemp("pp_tp"),
                      shape=(2, 1, 2), cases=cases, constants=JAX_CONSTANTS,
                      timeout=400)
    return cases, res


def _bars(key):
    return (2e-4, 2e-5) if key == "idle" else (8e-4, 5e-5)


@pytest.mark.parametrize("key", ["wide_gpipe", "wide_1f1b", "mixed_gpipe",
                                 "mixed_1f1b", "idle", "gpt_1f1b"])
def test_three_step_adam_parity(runs, key):
    """The 3-step losses of every rank against eager torch and the JAX
    package's step on the same weights (the JAX tests' check: a gradient
    a tp lane sums where it should average shows in the next loss)."""
    cases, res = runs
    name, params, x, y, _, _ = cases[key]
    rtol, atol = _bars(key)
    j_losses = _jax_eager(name, params, x, y)
    t_losses = _torch_eager(name, params, x, y)
    for r in res:
        got = r[key]
        np.testing.assert_allclose(got["losses"], t_losses, rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(got["losses"], j_losses, rtol=rtol,
                                   atol=atol)


def test_plan_shapes(runs):
    """The wide MLP is sharded; the mixed loss shards its wide layers and
    keeps the narrow head replicated (fewer than its three matmuls
    planned); the narrow MLP leaves the axis idle."""
    _, res = runs
    for r in res:
        wide = r["wide_gpipe"]
        assert wide["summary"]["planned"] and wide["summary"]["sharded"]
        mixed = r["mixed_gpipe"]
        assert mixed["sharded_ops"], mixed
        assert sum(1 for n in mixed["operands"] if n == 2) < 3, mixed
        assert r["idle"]["summary"] == {"planned": 0, "sharded": 0}
        assert r["gpt_1f1b"]["summary"]["sharded"] > 0


@pytest.mark.parametrize("key", ["wide_gpipe", "wide_1f1b", "mixed_1f1b",
                                 "idle", "gpt_1f1b"])
def test_tp_collectives_equal_the_plan(runs, key):
    """Every rank's tp collectives over 3 steps equal the plan's per-
    microbatch conversions (forward and their gradients) x 3 x M."""
    _, res = runs
    for r in res:
        got = r[key]
        want = {k: [c * got["steps_mb"], b * got["steps_mb"]]
                for k, (c, b) in got["per_mb"].items()}
        assert got["seen"] == want, (got["stage"], got["seen"], want)


class _Mesh:
    mesh_dim_names = ("pp", "dp", "tp")


def _loss(p, x, y):
    return (x @ p["w"] - y).pow(2).mean()


def test_tp_axes_validation():
    """The JAX package's rules (jaxfront/pp_compile.py:93-103): one tp
    axis at most, and it is a non-pp axis of the mesh."""
    with pytest.raises(NotImplementedError, match="one tp axis"):
        PPCompiledFunction(_loss, _Mesh(), 2, 4, tp_axes=("tp", "dp"))
    for bad in (("pp",), ("xx",)):
        with pytest.raises(ValueError, match="non-pp mesh axis"):
            PPCompiledFunction(_loss, _Mesh(), 2, 4, tp_axes=bad)
    compiled = PPCompiledFunction(_loss, _Mesh(), 2, 4, tp_axes=("tp",))
    assert compiled.tp_axes == ("tp",)
    assert compiled.tp_plan == {}
    assert compiled.tp_summary() == {"planned": 0, "sharded": 0}
    with pytest.raises(ValueError, match="non-pp"):
        easydist_compile(_loss, pp_stages=2, mesh=_Mesh(), tp_axes=("pp",))


def test_solver_prices_aten_matmul_flops():
    """The solver reads an aten matmul's FLOPs (the FX bridge names the
    node "aten.mm"), so its roofline, where sharding the weight shows,
    prices the node; before, only its output bytes did."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from easydist_tpu_torch.autoflow.reachability import _node_flops
    from easydist_tpu_torch.fxfront.bridge import fx_to_metagraph

    gm = make_fx(lambda x, w: x @ w, tracing_mode="fake")(
        torch.ones(8, 64), torch.ones(64, 32))
    graph = fx_to_metagraph(gm, {}, {}, world_size=2)
    (mm,) = [n for n in graph.ops if n.op_key == "aten.mm"]
    assert _node_flops(mm) == 2.0 * 8 * 32 * 64
