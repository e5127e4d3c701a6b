"""Gradient-synchronization entry points of the manual parallel modes and
the solver's reduction fences: the port of easydist_tpu/comm/reduce.py.

`parallel/dp.py` (ddp / zero2 / zero3) calls these instead of raw
collectives, and `fxfront/emit.py` fences a P -> R / P -> S edge with
`fence_plan` and the collectives of `comm.quant`.  Each is a functional
collective (`torch.ops._c10d_functional`) on a process group, so a
rank's step runs eagerly or traces with `make_fx` into collective
nodes.  Contract:

  * with `comm_quant_dtype="none"` and `comm_bucket_bytes=0` (the
    defaults) every function issues one exact collective per leaf at
    the gradient's own dtype;
  * with them set, leaves are bucketed (fewer launches) and/or
    block-quantized on the wire (fewer bytes), with the per-leaf
    opt-out of `comm.quant.leaf_quantizable`;
  * every launch is recorded in `comm_counters` when it is issued
    (eagerly, or once while `make_fx` traces a step), its wire bytes
    priced with the closed forms the solver's cost model uses
    (`int8_wire_bytes` for the int8 route).

Leaf order: a tree's leaves are planned in the JAX package's flatten
order (dict keys sorted at every level, `keyed_leaves`), so the bucket
plans of a tree equal the JAX package's; leaf paths are
`torch.utils._pytree.keystr` paths, the same strings as `jax.tree_util.
keystr` gives (`"['blocks'][0]['attn']['qkv']['b']"`), which
`comm_quant_skip` matches against.

`group` is a ProcessGroup or its name (`ProcessGroup.group_name`, as
`DeviceMesh.get_group(axis)` gives it); `axis_size` is its size.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig

from .bucketer import bucketed_reduce
from .counters import (comm_counters, ring_all_reduce_bytes,
                       ring_reduce_scatter_bytes)
from .quant import (bf16_psum, bf16_psum_scatter, comm_enabled,
                    int8_wire_bytes, leaf_quantizable, quant_mode,
                    quantized_psum, quantized_psum_scatter)

_c10d = torch.ops._c10d_functional


def group_name(group) -> str:
    return group if isinstance(group, str) else group.group_name


# ---------------------------------------------------- plain collectives

def all_reduce_sum(x, group):
    y = _c10d.all_reduce(x.contiguous(), "sum", group_name(group))
    return _c10d.wait_tensor(y)


def reduce_scatter_sum(x, group, n: int):
    """Sum over the group, this rank's dim-0 block of the result."""
    y = _c10d.reduce_scatter_tensor(x.contiguous(), "sum", n,
                                    group_name(group))
    return _c10d.wait_tensor(y)


def all_gather_dim0(x, group, n: int):
    """The group's blocks concatenated along dim 0, in rank order."""
    y = _c10d.all_gather_into_tensor(x.contiguous(), n, group_name(group))
    return _c10d.wait_tensor(y)


# --------------------------------------------------------------- accounting

def wire_bytes(kind: str, numel: int, itemsize: int, n: int, mode: str,
               quantized: bool) -> float:
    """Bytes one rank sends for a reduction `kind` ("all_reduce" |
    "reduce_scatter") of `numel` elements: exact at `itemsize`, bf16 at
    2 bytes, int8 as `comm.quant` moves it."""
    ring = (ring_all_reduce_bytes if kind == "all_reduce"
            else ring_reduce_scatter_bytes)
    if not quantized:
        return ring(numel * float(itemsize), n)
    if mode == "bf16":
        return ring(numel * 2.0, n)
    return int8_wire_bytes(kind, numel, n)


def _record(kind: str, numel: int, itemsize: int, n: int, mode: str,
            quantized: bool, fallback: bool = False,
            bucketed_leaves: int = 0) -> None:
    ring = (ring_all_reduce_bytes if kind == "all_reduce"
            else ring_reduce_scatter_bytes)
    comm_counters.record(
        bytes_on_wire=wire_bytes(kind, numel, itemsize, n, mode, quantized),
        bytes_fp32_equiv=ring(numel * 4.0, n), quantized=quantized,
        fallback=fallback, bucketed_leaves=bucketed_leaves)


# ------------------------------------------------------------------ leaves

def _sort_key(path) -> tuple:
    return tuple((0, k.key) if isinstance(k, pytree.MappingKey)
                 else (1, getattr(k, "idx", getattr(k, "name", 0)))
                 for k in path)


def keyed_leaves(tree) -> Tuple[list, List[str], object, List[int]]:
    """(flat leaves, their keystr paths, treespec, JAX order): the last is
    the permutation of the flat indices into the JAX package's flatten
    order (dict keys sorted at every level)."""
    kps, spec = pytree.tree_flatten_with_path(tree)
    leaves = [leaf for _, leaf in kps]
    paths = [pytree.keystr(kp) for kp, _ in kps]
    order = sorted(range(len(kps)), key=lambda i: _sort_key(kps[i][0]))
    return leaves, paths, spec, order


# --------------------------------------------------------------- buckets

def issue_bucket(flat, bucket, group, axis_size: int, mean: bool,
                 mode: str) -> Callable[[], torch.Tensor]:
    """Issue one bucket's reduction (block-scaled int8, bf16 or exact per
    `bucket.quantize` and `mode`) and record it; returns the function that
    waits for it and gives the reduced vector.  The exact and bf16 routes
    wait at that call (first use); the int8 route dequantizes between its
    two passes, so it has waited when this returns."""
    n = axis_size
    fused = len(bucket.indices)
    quantized = bucket.quantize and mode in ("int8", "bf16")
    _record("all_reduce", flat.numel(), flat.element_size(), n, mode,
            quantized=quantized, bucketed_leaves=fused)
    if quantized and mode == "int8":
        out = quantized_psum(flat, group, n, mean=mean)
        return lambda: out
    dtype = flat.dtype
    wire = flat.to(torch.bfloat16) if quantized else flat
    y = _c10d.all_reduce(wire.contiguous(), "sum", group_name(group))

    def finish():
        r = _c10d.wait_tensor(y).to(dtype)
        return r / n if mean else r
    return finish


def reduce_bucket_collective(flat, bucket, group, axis_size: int,
                             mean: bool, mode: str):
    """One bucket's reduction collective, with counter recording: shared
    by the sequential flush below and the overlapped flush
    (`comm.overlap`)."""
    return issue_bucket(flat, bucket, group, axis_size, mean, mode)()


# --------------------------------------------------------------- tree reduce

def reduce_gradients(grads, group, axis_size: int, op: str = "pmean",
                     emission_order=None):
    """Synchronize a gradient tree over `group` (the DDP path).

    Off -> one all_reduce per leaf (mean for "pmean").  On -> the leaves,
    in JAX order, are partitioned by quantizability, packed into
    `comm_bucket_bytes` buckets, and each bucket pays ONE collective.
    With `comm_overlap` the flush goes to `comm.overlap.
    overlapped_reduce_gradients`, planned in `emission_order`."""
    if op not in ("pmean", "psum"):
        raise ValueError(f"op={op!r}; expected pmean|psum")
    mean = op == "pmean"
    n = axis_size
    mode = quant_mode()
    if edconfig.comm_overlap:
        from .overlap import overlapped_reduce_gradients

        return overlapped_reduce_gradients(grads, group, axis_size, op=op,
                                           emission_order=emission_order)
    if not comm_enabled():
        return pytree.tree_map(
            lambda g: all_reduce_grad(g, group, n, mean=mean), grads)
    leaves, paths, spec, order = keyed_leaves(grads)
    ordered = [leaves[i] for i in order]
    flags = [leaf_quantizable(paths[i], leaves[i].numel(), mode)
             for i in order]
    reduced = bucketed_reduce(
        ordered, flags, edconfig.comm_bucket_bytes,
        lambda flat, b: reduce_bucket_collective(flat, b, group, n, mean,
                                                 mode))
    out = [None] * len(leaves)
    for j, i in enumerate(order):
        out[i] = reduced[j]
    return pytree.tree_unflatten(out, spec)


# --------------------------------------------------------------- leaf reduce

def all_reduce_grad(g, group, axis_size: int, *, mean: bool = True,
                    path: str = ""):
    """One leaf's all_reduce (the ZeRO replicated-leaf path); `path` is
    the leaf's keystr path, which the quantization opt-out matches."""
    mode = quant_mode()
    if leaf_quantizable(path, g.numel(), mode):
        _record("all_reduce", g.numel(), g.element_size(), axis_size, mode,
                quantized=True)
        if mode == "int8":
            return quantized_psum(g, group, axis_size, mean=mean)
        return bf16_psum(g, group, mean=mean, axis_size=axis_size)
    _record("all_reduce", g.numel(), g.element_size(), axis_size, mode,
            quantized=False, fallback=mode == "none")
    out = all_reduce_sum(g, group)
    return out / axis_size if mean else out


def reduce_scatter_grad(g, group, axis_size: int, *, scatter_dim: int = 0,
                        mean: bool = True, path: str = ""):
    """One leaf's reduce_scatter over `scatter_dim`, the ZeRO-2/3
    sharded-gradient path: this rank's reduced block."""
    mode = quant_mode()
    if leaf_quantizable(path, g.numel(), mode):
        _record("reduce_scatter", g.numel(), g.element_size(), axis_size,
                mode, quantized=True)
        if mode == "int8":
            return quantized_psum_scatter(g, group, axis_size,
                                          scatter_dim=scatter_dim, mean=mean)
        return bf16_psum_scatter(g, group, scatter_dim=scatter_dim,
                                 mean=mean, axis_size=axis_size)
    _record("reduce_scatter", g.numel(), g.element_size(), axis_size, mode,
            quantized=False, fallback=mode == "none")
    x = g.movedim(scatter_dim, 0) if scatter_dim else g
    out = reduce_scatter_sum(x, group, axis_size)
    if scatter_dim:
        out = out.movedim(0, scatter_dim)
    return out / axis_size if mean else out


# ----------------------------------------------------------- region fences

def fence_plan(kind: str, numel: int, itemsize: int, axis_size: int
               ) -> Tuple[str, float]:
    """The route of a deferred reduction's fence ("all_reduce" for
    P -> R, "reduce_scatter" for P -> S) and the bytes a rank sends
    for it, recorded in `comm_counters`: "int8" / "bf16" when the value
    is quantizable (no leaf path exists here, so size alone decides, as
    the JAX fence's `leaf_quantizable("", numel)`), else "exact".  The
    solver prices the same (`autoflow.cost_model.resharding_cost`)."""
    mode = quant_mode()
    quantized = leaf_quantizable("", numel, mode)
    _record(kind, numel, itemsize, axis_size, mode, quantized=quantized,
            fallback=mode == "none")
    return (mode if quantized else "exact",
            wire_bytes(kind, numel, itemsize, axis_size, mode, quantized))


def fence_psum(val, group, axis_size: int):
    """The P -> R fence of a deferred reduction: quantized when
    `fence_plan` says so, else the exact all_reduce (sum)."""
    route, _ = fence_plan("all_reduce", val.numel(), val.element_size(),
                          axis_size)
    if route == "int8":
        return quantized_psum(val, group, axis_size)
    if route == "bf16":
        return bf16_psum(val, group)
    return all_reduce_sum(val, group)


def fence_psum_scatter(val, group, axis_size: int, scatter_dim: int):
    """The P -> S fence: reduce_scatter at half the all_reduce bytes."""
    route, _ = fence_plan("reduce_scatter", val.numel(), val.element_size(),
                          axis_size)
    if route == "int8":
        return quantized_psum_scatter(val, group, axis_size,
                                      scatter_dim=scatter_dim)
    if route == "bf16":
        return bf16_psum_scatter(val, group, scatter_dim=scatter_dim,
                                 axis_size=axis_size)
    x = val.movedim(scatter_dim, 0) if scatter_dim else val
    out = reduce_scatter_sum(x, group, axis_size)
    return out.movedim(0, scatter_dim).contiguous() if scatter_dim else out
