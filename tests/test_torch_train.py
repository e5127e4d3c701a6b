"""The port's training slice against the JAX package from the same
weights: the tiny GPT train step compiled by `fxfront.easydist_compile`
(einsum and flash attention) against `jax.jit(make_gpt_train_step)`,
step-1 gradients, compiled against eager, the flash kernels' nodes in
the traced step, the optimizers, the MLP step, the train state carried
across by `params_from_numpy`, and the compile surface (mesh, state_io,
donate_state).

Weights come from the JAX package's init functions and cross with
`params_from_numpy`; tokens and gradients come from numpy seeds.
Tolerance: rtol 1e-4 (losses; the bar of __graft_entry__.py:125), rtol
1e-4 / atol 1e-5 (gradients, parameters) in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.models import gpt as jg
from easydist_tpu.models import mlp as jmlp
from easydist_tpu.models import optim as jopt
from easydist_tpu_torch.fxfront import easydist_compile
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.models import mlp as tmlp
from easydist_tpu_torch.models import optim as topt

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return tg.params_from_numpy(_np_tree(tree), device="cpu")


def _close_trees(got, want):
    flat_w, _ = jax.tree_util.tree_flatten(_np_tree(want))
    flat_g = torch.utils._pytree.tree_leaves(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def _tokens(cfg, batch=4, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, cfg.vocab, (batch, cfg.seq)).astype(np.int32),
            rs.randint(0, cfg.vocab, (batch, cfg.seq)).astype(np.int32))


@pytest.fixture(scope="module", params=["einsum", "flash"])
def run(request):
    """One attention backend: the JAX state, its 3-step jitted losses and
    step-1 gradients, and the port's compiled step over the same state."""
    attention = request.param
    cfg_j = jg.GPTConfig.tiny(attention=attention)
    cfg_t = tg.GPTConfig.tiny(attention=attention)
    step_j, init_j = jg.make_gpt_train_step(cfg_j)
    state0 = init_j(jax.random.PRNGKey(0))
    tok, tgt = _tokens(cfg_j)
    grads_j = jax.grad(jg.gpt_loss)(state0[0], cfg_j, jnp.asarray(tok),
                                    jnp.asarray(tgt))
    jitted = jax.jit(step_j)
    state_j, losses_j = state0, []
    for _ in range(STEPS):
        state_j, loss = jitted(state_j, jnp.asarray(tok), jnp.asarray(tgt))
        losses_j.append(float(loss))

    step_t, _ = tg.make_gpt_train_step(cfg_t)
    compiled = easydist_compile(step_t)
    state_t = tuple(_torch_tree(state0))
    tok_t, tgt_t = torch.from_numpy(tok), torch.from_numpy(tgt)
    losses_t = []
    for _ in range(STEPS):
        state_t, loss = compiled(state_t, tok_t, tgt_t)
        losses_t.append(float(loss))
    return dict(cfg_t=cfg_t, state0=state0, tok=tok_t, tgt=tgt_t,
                losses_j=losses_j, state_j=state_j, grads_j=grads_j,
                step_t=step_t, compiled=compiled, losses_t=losses_t,
                state_t=state_t)


class TestGPTTrainStep:
    def test_compiled_losses_match_jax(self, run):
        np.testing.assert_allclose(run["losses_t"], run["losses_j"],
                                   rtol=RTOL)

    def test_compiled_params_match_jax_after_three_steps(self, run):
        # Adam's step is about lr * sign(g) where g is near 0, so there a
        # rounding-level gradient difference can flip it: two updates
        # differ by at most 2 * lr per step
        flat_w = jax.tree_util.tree_leaves(_np_tree(run["state_j"][0]))
        flat_g = torch.utils._pytree.tree_leaves(run["state_t"][0])
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                       atol=2 * 1e-4 * STEPS)
        assert int(run["state_t"][1]["count"]) == STEPS

    def test_step1_grads_match_jax(self, run):
        cfg = run["cfg_t"]
        _, grads = topt.value_and_grad(
            lambda p: tg.gpt_loss(p, cfg, run["tok"], run["tgt"]),
            _torch_tree(run["state0"][0]))
        _close_trees(grads, run["grads_j"])

    def test_compiled_matches_eager(self, run):
        state = tuple(_torch_tree(run["state0"]))
        eager = []
        for _ in range(STEPS):
            state, loss = run["step_t"](state, run["tok"], run["tgt"])
            eager.append(float(loss))
        np.testing.assert_allclose(run["losses_t"], eager, rtol=RTOL)

    def test_one_signature_and_state_threads_in_place(self, run):
        compiled = run["compiled"]
        assert compiled.cache_stats() == {"size": 1, "hits": STEPS - 1,
                                          "misses": 1}
        state = tuple(_torch_tree(run["state0"]))
        wte = state[0]["wte"]
        new_state, _ = compiled(state, run["tok"], run["tgt"])
        assert new_state[0]["wte"] is wte  # written into its input

    def test_flash_nodes_in_the_traced_step(self, run):
        result = next(iter(run["compiled"]._cache.values()))
        targets = [str(n.target) for n in result.graph_module.graph.nodes]
        layers = run["cfg_t"].layers
        attention = run["cfg_t"].attention
        for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            want = layers if attention == "flash" else 0
            assert targets.count(f"easydist_tpu_torch.{op}.default") == want


def test_params_from_numpy_carries_the_jax_train_state():
    cfg = jg.GPTConfig.tiny()
    state = jg.make_gpt_train_step(cfg)[1](jax.random.PRNGKey(5))
    got = tg.params_from_numpy(_np_tree(state), device="cpu")
    params, opt = got
    assert set(opt) == {"mu", "nu", "count"}
    assert opt["count"].dtype == torch.int32 and opt["count"].shape == ()
    assert opt["mu"]["blocks"][1]["attn"]["qkv"]["w"].shape == (32, 96)
    flat_w = jax.tree_util.tree_leaves(_np_tree(state))
    flat_g = torch.utils._pytree.tree_leaves(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------------ optimizers


def _opt_inputs(seed=0):
    rs = np.random.RandomState(seed)
    params = {"a": rs.standard_normal((4, 3)).astype(np.float32),
              "b": [rs.standard_normal((5,)).astype(np.float32),
                    rs.standard_normal((2, 2)).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: rs.standard_normal(x.shape).astype(
        np.float32), params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", ["adam", "adam_per_leaf_lr", "adamw",
                                  "adam_l2"])
def test_adam_matches_jax(kind):
    params, grads = _opt_inputs()
    kw = {"adam": dict(lr=1e-2),
          "adam_per_leaf_lr": dict(lr={"a": 1e-2, "b": [3e-3, 1e-1]}),
          "adamw": dict(lr=1e-2, weight_decay=0.1, decoupled=True),
          "adam_l2": dict(lr=1e-2, weight_decay=0.1)}[kind]
    p_j = jax.tree.map(jnp.asarray, params)
    s_j = jopt.adam_init(p_j)
    p_t = tg.params_from_numpy(params, device="cpu")
    s_t = topt.adam_init(p_t)
    for g in grads:
        p_j, s_j = jopt.adam_update(p_j, jax.tree.map(jnp.asarray, g), s_j,
                                    **kw)
        p_t, s_t = topt.adam_update(p_t, tg.params_from_numpy(g, "cpu"),
                                    s_t, **kw)
    _close_trees(p_t, p_j)
    _close_trees(s_t["mu"], s_j["mu"])
    _close_trees(s_t["nu"], s_j["nu"])
    assert s_t["count"].dtype == torch.int32 and int(s_t["count"]) == 3


def test_adamw_update_is_decoupled_adam():
    params, grads = _opt_inputs(1)
    p_t = tg.params_from_numpy(params, device="cpu")
    g = tg.params_from_numpy(grads[0], device="cpu")
    a, _ = topt.adamw_update(p_t, g, topt.adam_init(p_t), lr=1e-2)
    b, _ = topt.adam_update(p_t, g, topt.adam_init(p_t), lr=1e-2,
                            weight_decay=1e-2, decoupled=True)
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["rmsprop", "rmsprop_momentum_centered",
                                  "adagrad", "sgd", "sgd_nesterov"])
def test_other_optimizers_match_jax(kind):
    params, grads = _opt_inputs(2)
    p_j = jax.tree.map(jnp.asarray, params)
    p_t = tg.params_from_numpy(params, device="cpu")
    if kind.startswith("rmsprop"):
        kw = (dict(momentum=0.9, centered=True) if "momentum" in kind
              else {})
        s_j, s_t = (jopt.rmsprop_init(p_j, **kw),
                    topt.rmsprop_init(p_t, **kw))

        def upd(mod, p, g, s):
            return mod.rmsprop_update(p, g, s, lr=1e-2, weight_decay=0.01,
                                      **kw)
    elif kind == "adagrad":
        s_j, s_t = jopt.adagrad_init(p_j, 0.1), topt.adagrad_init(p_t, 0.1)

        def upd(mod, p, g, s):
            return mod.adagrad_update(p, g, s, lr=1e-2, lr_decay=0.1)
    else:
        s_j, s_t = jopt.sgd_init(p_j), topt.sgd_init(p_t)
        nesterov = kind == "sgd_nesterov"

        def upd(mod, p, g, s):
            return mod.sgd_update(p, g, lr=1e-2, momentum=0.9,
                                  nesterov=nesterov, weight_decay=0.01,
                                  state=s)
    keys = list(s_t)
    for g in grads:
        p_j, s_j = upd(jopt, p_j, jax.tree.map(jnp.asarray, g), s_j)
        p_t, s_t = upd(topt, p_t, tg.params_from_numpy(g, "cpu"), s_t)
    _close_trees(p_t, p_j)
    assert list(s_t) == keys  # key order kept, so compiled steps pair


def test_sgd_without_state_returns_params_only():
    params, grads = _opt_inputs(3)
    p_t = tg.params_from_numpy(params, device="cpu")
    out = topt.sgd_update(p_t, tg.params_from_numpy(grads[0], "cpu"),
                          lr=0.5)
    assert isinstance(out, dict)
    with pytest.raises(ValueError, match="momentum requires state"):
        topt.sgd_update(p_t, p_t, momentum=0.9)


# ------------------------------------------------------------------- MLP


def test_mlp_step_matches_jax():
    params_j = jmlp.mlp_init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(4)
    x = rs.standard_normal((8, 16)).astype(np.float32)
    y = rs.standard_normal((8, 8)).astype(np.float32)
    step_j = jax.jit(jmlp.make_mlp_train_step())
    compiled = easydist_compile(tmlp.make_mlp_train_step())
    p_j, p_t = params_j, _torch_tree(params_j)
    for _ in range(STEPS):
        p_j, loss_j = step_j(p_j, jnp.asarray(x), jnp.asarray(y))
        p_t, loss_t = compiled(p_t, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    _close_trees(p_t, p_j)
    assert compiled.cache_stats()["size"] == 1
    np.testing.assert_allclose(
        tmlp.mlp_apply(p_t, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.mlp_apply(p_j, jnp.asarray(x))), rtol=RTOL,
        atol=ATOL)


def test_mlp_init_shapes():
    params = tmlp.mlp_init(torch.Generator().manual_seed(0), (3, 5, 2),
                           device="cpu")
    assert [tuple(p["w"].shape) for p in params] == [(3, 5), (5, 2)]
    assert all(float(p["b"].abs().sum()) == 0 for p in params)


# -------------------------------------------------------- compile surface


class _Mesh:
    def __init__(self, n):
        self.devices = np.empty((n,), dtype=object)


@pytest.mark.parametrize("mesh", [["cpu", "cpu"], _Mesh(4)])
def test_mesh_larger_than_one_device_raises(mesh):
    # several devices compile only over a torch.distributed DeviceMesh
    # (the multi-device frontend, tests/test_torch_fxfront_*.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        easydist_compile(tmlp.make_mlp_train_step(), mesh=mesh)


@pytest.mark.parametrize("mesh", [None, "cpu", torch.device("cpu"),
                                  [torch.device("cpu")], _Mesh(1)])
def test_one_device_mesh_compiles(mesh):
    compiled = easydist_compile(tmlp.make_mlp_train_step(), mesh=mesh)
    params = tmlp.mlp_init(torch.Generator().manual_seed(0), device="cpu")
    _, loss = compiled(params, torch.ones(2, 16), torch.zeros(2, 8))
    assert torch.isfinite(loss)


def test_state_io_other_than_auto_raises():
    # a {flat output: flat input} dict pairs explicitly
    # (test_torch_fxfront_frontend.py); any other value raises
    with pytest.raises(ValueError, match="state_io"):
        easydist_compile(tmlp.make_mlp_train_step(), state_io="positional")


def test_donate_state_false_leaves_inputs_unchanged():
    params = tmlp.mlp_init(torch.Generator().manual_seed(0), device="cpu")
    before = [p.clone() for p in torch.utils._pytree.tree_leaves(params)]
    compiled = easydist_compile(tmlp.make_mlp_train_step(),
                                donate_state=False)
    new, _ = compiled(params, torch.ones(2, 16), torch.zeros(2, 8))
    for b, p in zip(before, torch.utils._pytree.tree_leaves(params)):
        assert torch.equal(b, p)
    assert new[0]["w"] is not params[0]["w"]
    assert not torch.equal(new[0]["w"], params[0]["w"])
