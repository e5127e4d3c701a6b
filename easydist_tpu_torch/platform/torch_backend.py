"""PyTorch implementation of the platform micro-API.

Ops run eagerly on the device their inputs live on; `from_numpy` puts
new tensors on `config.discovery_device` (the card unless the caller
asks for the CPU).  Differences from the JAX backend that the engine
relies on:

- `clone` copies (torch tensors are mutable; jax arrays are not);
- `chunk` raises on an uneven split, as `jnp.split` does;
- `to_numpy` returns bfloat16 as float32 (numpy has no bfloat16; the
  widening is exact, and the engine only compares values);
- `batched_call` raises where an op has no batching rule (vmap's slow
  per-example fallback is switched off while it runs) or writes an input,
  so that `MetaOp` falls back to its per-shard loop.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.platform import writes_input

Tensor = torch.Tensor


def add(x, y):
    return torch.add(x, y)


def equal(x, y):
    return x.shape == y.shape and bool(torch.equal(x, y))


def allclose(x, y, equal_nan=False):
    if getattr(x, "shape", None) != getattr(y, "shape", None):
        return False
    dt = torch.promote_types(x.dtype, y.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float64  # integer and bool outputs compare as numpy does
    return bool(torch.allclose(x.to(dt), y.to(dt), rtol=edconfig.allclose_rtol,
                               atol=edconfig.allclose_atol,
                               equal_nan=equal_nan))


def zeros_like(x):
    return torch.zeros_like(x)


def minimum(x, y):
    return torch.minimum(x, y)


def maximum(x, y):
    return torch.maximum(x, y)


def concatenate(tensors, dim=0):
    return torch.cat(list(tensors), dim=dim)


def chunk(tensor, chunks, dim=0):
    """Split into `chunks` equal parts along `dim` (must divide evenly)."""
    size = tensor.shape[dim]
    if size % chunks:
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{chunks} equal parts")
    return list(torch.split(tensor, size // chunks, dim=dim))


def narrow(tensor, dim, start, length):
    return tensor.narrow(dim, start, length)


def clone(x):
    return x.clone()


def stack(tensors, dim=0):
    return torch.stack(list(tensors), dim=dim)


def batched_call(fn, flat_args, in_axes):
    """Run `fn(*flat_args)` vmapped over the axis-0 entries of `in_axes`:
    one eager dispatch for all shards of a discovery candidate instead of
    nshards sequential calls (metashard.MetaOp._run_sharded_batched)."""
    if writes_input(fn):
        raise RuntimeError(f"{fn} writes an input; probe it shard by shard")
    functorch = torch._C._functorch
    saved = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        return torch.func.vmap(fn, in_dims=tuple(in_axes))(*flat_args)
    finally:
        functorch._set_vmap_fallback_enabled(saved)


def from_numpy(x):
    return torch.from_numpy(np.array(x)).to(edconfig.discovery_device)


def to_numpy(x):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def tree_flatten(tree):
    return pytree.tree_flatten(tree)


def tree_unflatten(leaves, spec):
    return pytree.tree_unflatten(list(leaves), spec)
