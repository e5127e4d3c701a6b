"""Graph attention network: the port of easydist_tpu/models/gat.py
(reference benchmark: GAT 4096 nodes x 12288 features).  Dense-adjacency
formulation, the JAX model's: static shapes, attention logits masked to
-1e30 off the graph's edges, SGD.  The parameter layout is the JAX
package's, so `gat_params_from_numpy` only moves the leaves."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from easydist_tpu_torch import resolve_device

from .gpt import params_from_numpy
from .optim import sgd_update, value_and_grad


@dataclass
class GATConfig:
    nodes: int = 4096
    features: int = 12288
    hidden: int = 256
    classes: int = 16
    layers: int = 2

    @staticmethod
    def bench(**kw):
        return GATConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(nodes=64, features=32, hidden=16, classes=4, layers=2)
        base.update(kw)
        return GATConfig(**base)


def gat_init(cfg: GATConfig, generator: torch.Generator,
             device=None) -> Dict:
    """Random float32 layers drawn from `generator` (on its own device),
    placed on `device` (default: the card)."""
    device = resolve_device(device)
    dims = [cfg.features] + [cfg.hidden] * (cfg.layers - 1) + [cfg.classes]

    def randn(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    return {"layers": [
        {"w": randn(d_in, d_out) / math.sqrt(d_in),
         "a_src": randn(d_out) / math.sqrt(d_out),
         "a_dst": randn(d_out) / math.sqrt(d_out)}
        for d_in, d_out in zip(dims[:-1], dims[1:])]}


def gat_params_from_numpy(tree, device=None) -> Dict:
    """The JAX package's GAT parameters (numpy leaves) as the port's: the
    same keys and layouts."""
    return params_from_numpy(tree, device=device)


def gat_apply(params, adj, x):
    """adj: [N, N] dense 0/1 adjacency (self-loops included); x: [N, F]
    -> [N, classes]."""
    h = x
    for i, layer in enumerate(params["layers"]):
        z = h @ layer["w"]
        e_src = z @ layer["a_src"]
        e_dst = z @ layer["a_dst"]
        e = F.leaky_relu(e_src[:, None] + e_dst[None, :], 0.2)
        e = torch.where(adj > 0, e, torch.full_like(e, -1e30))
        h = torch.softmax(e, dim=-1) @ z
        if i < len(params["layers"]) - 1:
            h = F.elu(h)
    return h


def make_gat_train_step(cfg: GATConfig, lr=1e-2):
    """train_step(params, adj, x, labels) -> (new params, loss)."""
    del cfg

    def train_step(params, adj, x, labels):
        def loss_fn(p):
            logp = torch.log_softmax(gat_apply(p, adj, x), dim=-1)
            return -logp.gather(-1, labels.long()[:, None]).mean()

        loss, grads = value_and_grad(loss_fn, params)
        return sgd_update(params, grads, lr=lr), loss

    return train_step
