"""ViT-B/16-style vision transformer: the port of
easydist_tpu/models/vit.py.  Patchify is a stride-`patch` conv, written
in torch's NCHW layout (images [batch, 3, H, W]; the patch kernel
[dim, 3, patch, patch]); the encoder is pre-norm transformer blocks with
tanh-approximate gelu and population-variance layer norms, as the JAX
model has them.  `vit_params_from_numpy` carries the JAX package's
parameters (NHWC / HWIO) across."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from easydist_tpu_torch import resolve_device

from .gpt import params_from_numpy
from .optim import adam_init, adam_update, value_and_grad


@dataclass
class ViTConfig:
    image: int = 224
    patch: int = 16
    dim: int = 768
    heads: int = 12
    layers: int = 12
    classes: int = 1000
    dtype: str = "float32"

    @staticmethod
    def b16(**kw):
        return ViTConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(image=32, patch=8, dim=32, heads=4, layers=2, classes=10)
        base.update(kw)
        return ViTConfig(**base)

    @property
    def n_patches(self):
        return (self.image // self.patch) ** 2


def _randn(generator, shape, device):
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def _linear_init(generator, n_in, n_out, device):
    return {"w": _randn(generator, (n_in, n_out), device) / math.sqrt(n_in),
            "b": torch.zeros(n_out, device=device)}


def _norm(dim, device):
    return {"g": torch.ones(dim, device=device),
            "b": torch.zeros(dim, device=device)}


def vit_init(cfg: ViTConfig, generator: torch.Generator, device=None) -> Dict:
    """Random float32 parameters drawn from `generator` (on its own
    device), placed on `device` (default: the card).  The numbers differ
    from the JAX package's for any seed; carry JAX weights across with
    `vit_params_from_numpy`."""
    device = resolve_device(device)
    p = cfg.patch
    params = {
        "patch": _randn(generator, (cfg.dim, 3, p, p), device)
        * math.sqrt(2.0 / (p * p * 3)),
        "pos": _randn(generator, (cfg.n_patches + 1, cfg.dim), device) * 0.02,
        "cls": torch.zeros(cfg.dim, device=device),
        "blocks": [],
        "ln_f": _norm(cfg.dim, device),
        "head": _linear_init(generator, cfg.dim, cfg.classes, device),
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln1": _norm(cfg.dim, device),
            "qkv": _linear_init(generator, cfg.dim, 3 * cfg.dim, device),
            "proj": _linear_init(generator, cfg.dim, cfg.dim, device),
            "ln2": _norm(cfg.dim, device),
            "fc": _linear_init(generator, cfg.dim, 4 * cfg.dim, device),
            "fc2": _linear_init(generator, 4 * cfg.dim, cfg.dim, device),
        })
    return params


def vit_params_from_numpy(tree, device=None) -> Dict:
    """The JAX package's ViT parameters (numpy leaves) in the port's
    layout: the HWIO patch kernel [p, p, 3, dim] becomes OIHW
    [dim, 3, p, p]; every other leaf keeps its layout."""
    params = params_from_numpy(tree, device=device)
    params["patch"] = params["patch"].permute(3, 2, 0, 1).contiguous()
    return params


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _mha(x, blk, heads):
    b, t, d = x.shape
    hd = d // heads
    qkv = x @ blk["qkv"]["w"] + blk["qkv"]["b"]
    q, k, v = qkv.split(d, dim=-1)

    def sh(y):
        return y.reshape(b, t, heads, hd).transpose(1, 2)

    q, k, v = sh(q), sh(k), sh(v)
    att = torch.softmax(
        torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", att, v)
    out = out.transpose(1, 2).reshape(b, t, d)
    return out @ blk["proj"]["w"] + blk["proj"]["b"]


def vit_apply(params, cfg: ViTConfig, images):
    """images: [batch, 3, H, W] -> logits [batch, classes]."""
    b = images.shape[0]
    x = F.conv2d(images, params["patch"], stride=cfg.patch)
    x = x.flatten(2).transpose(1, 2)  # [b, patches, dim], row-major
    cls = params["cls"].expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos"][None]
    for blk in params["blocks"]:
        x = x + _mha(_layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]),
                     blk, cfg.heads)
        h = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"])
        h = F.gelu(h @ blk["fc"]["w"] + blk["fc"]["b"], approximate="tanh")
        x = x + h @ blk["fc2"]["w"] + blk["fc2"]["b"]
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return x[:, 0] @ params["head"]["w"] + params["head"]["b"]


def _xent(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_vit_train_step(cfg: ViTConfig, lr=1e-4):
    """Returns (train_step, init_state): state = (params, adam state);
    train_step(state, images, labels) -> ((params, opt), loss), a new
    state.  init_state(generator, device=None) draws the params with
    `vit_init`."""

    def init_state(generator: torch.Generator, device=None):
        params = vit_init(cfg, generator, device=device)
        return (params, adam_init(params))

    def train_step(state, images, labels):
        params, opt = state
        loss, grads = value_and_grad(
            lambda p: _xent(vit_apply(p, cfg, images), labels), params)
        new_params, new_opt = adam_update(params, grads, opt, lr=lr)
        return (new_params, new_opt), loss

    return train_step, init_state
