"""Plain MLP, the smallest end-to-end train step: the port of
easydist_tpu/models/mlp.py (same parameter layout: a list of {"w"
[n_in, n_out], "b" [n_out]})."""

from __future__ import annotations

import math

import torch

from easydist_tpu_torch import resolve_device

from .optim import sgd_update, value_and_grad


def mlp_init(generator: torch.Generator, sizes=(16, 64, 64, 8),
             device=None):
    """Random float32 layers drawn from `generator` (on its own device),
    placed on `device` (default: the card).  The numbers differ from the
    JAX package's for any seed; carry JAX weights across with
    `params_from_numpy`."""
    device = resolve_device(device)
    return [{"w": (torch.randn((n_in, n_out), generator=generator,
                               device=generator.device)
                   / math.sqrt(n_in)).to(device),
             "b": torch.zeros(n_out, device=device)}
            for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params, x):
    for layer in params[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]


def make_mlp_train_step(lr=1e-2):
    """step(params, x, y) -> (new_params, loss): mean squared error, SGD."""

    def train_step(params, x, y):
        loss, grads = value_and_grad(
            lambda p: torch.mean((mlp_apply(p, x) - y) ** 2), params)
        return sgd_update(params, grads, lr=lr), loss

    return train_step
