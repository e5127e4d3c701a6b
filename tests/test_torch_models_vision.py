"""The port's ViT, ResNet and GAT (easydist_tpu_torch.models.{vit,resnet,
gat}) against the JAX package from the same weights, at `tiny()` widths:
the forward and one train step (Adam for ViT, SGD for ResNet and GAT),
and the port's one-device `easydist_compile` of each step against the
uncompiled step.

Weights come from the JAX package's initialisers and cross through numpy
with each model's converter (`vit_params_from_numpy` and
`resnet_params_from_numpy` transpose HWIO kernels to OIHW; images cross
NHWC -> NCHW).  Tolerance: tests/test_models/test_models_e2e.py's,
rtol 1e-3 / atol 1e-5 on the loss and rtol 1e-3 / atol 1e-4 on the new
parameters; the forward's logits at the same bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.models import gat as jgat
from easydist_tpu.models import resnet as jres
from easydist_tpu.models import vit as jvit
from easydist_tpu_torch.models import gat as tgat
from easydist_tpu_torch.models import resnet as tres
from easydist_tpu_torch.models import vit as tvit

LOSS = dict(rtol=1e-3, atol=1e-5)
PARAMS = dict(rtol=1e-3, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _nchw(images):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(images).transpose(0, 3, 1, 2)))


def _oihw(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _compiled_equals_uncompiled(step, *args):
    from easydist_tpu_torch.fxfront import easydist_compile

    want_state, want_loss = step(*args)
    got_state, got_loss = easydist_compile(step, donate_state=False)(*args)
    _close(got_loss, want_loss, rtol=1e-5, atol=1e-6)
    for g, w in zip(torch.utils._pytree.tree_leaves(got_state),
                    torch.utils._pytree.tree_leaves(want_state)):
        _close(g, w, rtol=1e-5, atol=1e-6)


def test_vit_forward_and_adam_step_match_jax():
    cfg_j = jvit.ViTConfig.tiny()
    step_j, init_j = jvit.make_vit_train_step(cfg_j)
    state_j = init_j(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    images = rs.randn(4, cfg_j.image, cfg_j.image, 3).astype(np.float32)
    labels = rs.randint(0, cfg_j.classes, (4,)).astype(np.int32)

    cfg_t = tvit.ViTConfig.tiny()
    params_t = tvit.vit_params_from_numpy(_np(state_j[0]), device="cpu")
    x_t, y_t = _nchw(images), torch.from_numpy(labels)
    _close(tvit.vit_apply(params_t, cfg_t, x_t).detach(),
           jvit.vit_apply(state_j[0], cfg_j, jnp.asarray(images)),
           rtol=1e-3, atol=1e-5)

    step_t, _ = tvit.make_vit_train_step(cfg_t)
    from easydist_tpu_torch.models.optim import adam_init

    state_t = (params_t, adam_init(params_t))
    (new_j, _), loss_j = jax.jit(step_j)(state_j, jnp.asarray(images),
                                         jnp.asarray(labels))
    (new_t, _), loss_t = step_t(state_t, x_t, y_t)
    _close(loss_t.detach(), loss_j, **LOSS)
    new_j = _np(new_j)
    _close(new_t["patch"], _oihw(new_j["patch"]), **PARAMS)
    for key in ("pos", "cls"):
        _close(new_t[key], new_j[key], **PARAMS)
    for bt, bj in zip(new_t["blocks"], new_j["blocks"]):
        for name in ("qkv", "proj", "fc", "fc2"):
            _close(bt[name]["w"], bj[name]["w"], **PARAMS)
    _compiled_equals_uncompiled(step_t, state_t, x_t, y_t)


def test_resnet_forward_and_sgd_step_match_jax():
    params_j, arch = jres.resnet_init(jax.random.PRNGKey(0), widths=(8, 16),
                                      blocks_per_stage=1, classes=10)
    rs = np.random.RandomState(1)
    # odd spatial size: the stride-2 SAME pad puts the odd pixel last
    x = rs.randn(4, 9, 9, 3).astype(np.float32)
    labels = rs.randint(0, 10, (4,)).astype(np.int32)
    params_t = tres.resnet_params_from_numpy(_np(params_j), device="cpu")
    _, arch_t = tres.resnet_init(torch.Generator().manual_seed(0),
                                 widths=(8, 16), blocks_per_stage=1,
                                 classes=10, device="cpu")
    assert arch_t == arch
    x_t, y_t = _nchw(x), torch.from_numpy(labels)
    _close(tres.resnet_apply(params_t, arch_t, x_t),
           jres.resnet_apply(params_j, arch, jnp.asarray(x)),
           rtol=1e-3, atol=1e-5)

    new_j, loss_j = jax.jit(jres.make_resnet_train_step(arch))(
        params_j, jnp.asarray(x), jnp.asarray(labels))
    step_t = tres.make_resnet_train_step(arch_t)
    new_t, loss_t = step_t(params_t, x_t, y_t)
    _close(loss_t, loss_j, **LOSS)
    want = tres.resnet_params_from_numpy(_np(new_j), device="cpu")
    for g, w in zip(torch.utils._pytree.tree_leaves(new_t),
                    torch.utils._pytree.tree_leaves(want)):
        _close(g, w, **PARAMS)
    _compiled_equals_uncompiled(step_t, params_t, x_t, y_t)


def test_gat_forward_and_sgd_step_match_jax():
    cfg_j = jgat.GATConfig.tiny()
    params_j = jgat.gat_init(cfg_j, jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    n = cfg_j.nodes
    adj = np.maximum((rs.rand(n, n) < 0.1).astype(np.float32),
                     np.eye(n, dtype=np.float32))
    x = rs.randn(n, cfg_j.features).astype(np.float32)
    labels = rs.randint(0, cfg_j.classes, (n,)).astype(np.int32)
    params_t = tgat.gat_params_from_numpy(_np(params_j), device="cpu")
    a_t, x_t, y_t = (torch.from_numpy(v) for v in (adj, x, labels))
    _close(tgat.gat_apply(params_t, a_t, x_t),
           jgat.gat_apply(params_j, jnp.asarray(adj), jnp.asarray(x)),
           rtol=1e-3, atol=1e-5)

    new_j, loss_j = jax.jit(jgat.make_gat_train_step(cfg_j))(
        params_j, jnp.asarray(adj), jnp.asarray(x), jnp.asarray(labels))
    step_t = tgat.make_gat_train_step(tgat.GATConfig.tiny())
    new_t, loss_t = step_t(params_t, a_t, x_t, y_t)
    _close(loss_t, loss_j, **LOSS)
    for g, w in zip(torch.utils._pytree.tree_leaves(new_t),
                    jax.tree.leaves(_np(new_j))):
        _close(g, w, **PARAMS)
    _compiled_equals_uncompiled(step_t, params_t, a_t, x_t, y_t)


@pytest.mark.parametrize("name", ["vit", "resnet", "gat"])
def test_init_is_seeded_and_placed(name):
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        if name == "vit":
            return tvit.vit_init(tvit.ViTConfig.tiny(), g, device="cpu")
        if name == "resnet":
            return tres.resnet_init(g, device="cpu")[0]
        return tgat.gat_init(tgat.GATConfig.tiny(), g, device="cpu")

    a, b, c = make(0), make(0), make(1)
    la, lb, lc = (torch.utils._pytree.tree_leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert any(not torch.equal(x, y) for x, y in zip(la, lc))
    assert all(x.dtype == torch.float32 and x.device.type == "cpu"
               for x in la)
