"""Gradient-synchronization entry points of the manual parallel modes:
the port of easydist_tpu/comm/reduce.py, default path only.

`parallel/dp.py` (ddp / zero2 / zero3) calls these instead of raw
collectives.  Each is a functional collective (`torch.ops.
_c10d_functional`) on a process group, so a rank's step runs eagerly or
traces with `make_fx` into collective nodes, and each records its wire
bytes in `comm_counters` when it is issued, priced with the ring closed
forms of the solver's cost model.

Only the JAX package's default path is ported: one collective per leaf
at the gradient's own dtype.  The knobs that change the emission
(`config.comm_quant_dtype` != "none", `comm_bucket_bytes` > 0,
`comm_overlap`) raise NotImplementedError: quantized, bucketed and
overlapped reduction come with ROADMAP queue A item 7.

`group` is a ProcessGroup or its name (`ProcessGroup.group_name`, as
`DeviceMesh.get_group(axis)` gives it); `axis_size` is its size.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig

from .counters import (comm_counters, ring_all_reduce_bytes,
                       ring_reduce_scatter_bytes)

_c10d = torch.ops._c10d_functional


def check_comm_knobs() -> None:
    """Raise for the comm knobs whose emission is not ported yet."""
    mode = (edconfig.comm_quant_dtype or "none").lower()
    set_knobs = [name for name, on in (
        (f"comm_quant_dtype={edconfig.comm_quant_dtype!r}", mode != "none"),
        (f"comm_bucket_bytes={edconfig.comm_bucket_bytes}",
         edconfig.comm_bucket_bytes > 0),
        ("comm_overlap=True", bool(edconfig.comm_overlap))) if on]
    if set_knobs:
        raise NotImplementedError(
            f"{', '.join(set_knobs)}: quantized, bucketed and overlapped "
            f"gradient reduction are not ported yet (ROADMAP queue A item "
            f"7); unset them for the exact one-collective-per-leaf path")


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


def _record_all_reduce(numel: int, itemsize: int, n: int) -> None:
    comm_counters.record(
        bytes_on_wire=ring_all_reduce_bytes(numel * float(itemsize), n),
        bytes_fp32_equiv=ring_all_reduce_bytes(numel * 4.0, n),
        fallback=True)


def _record_reduce_scatter(numel: int, itemsize: int, n: int) -> None:
    comm_counters.record(
        bytes_on_wire=ring_reduce_scatter_bytes(numel * float(itemsize), n),
        bytes_fp32_equiv=ring_reduce_scatter_bytes(numel * 4.0, n),
        fallback=True)


# --------------------------------------------------------------- tree reduce

def reduce_gradients(grads, group, axis_size: int, op: str = "pmean"):
    """Synchronize a gradient tree over `group` (the DDP path): one
    all_reduce per leaf, divided by the group's size for "pmean"."""
    if op not in ("pmean", "psum"):
        raise ValueError(f"op={op!r}; expected pmean|psum")
    check_comm_knobs()
    return pytree.tree_map(
        lambda g: all_reduce_grad(g, group, axis_size,
                                  mean=op == "pmean"), grads)


# --------------------------------------------------------------- leaf reduce

def all_reduce_grad(g, group, axis_size: int, *, mean: bool = True,
                    path: str = ""):
    """One leaf's all_reduce (the ZeRO replicated-leaf path).  `path` is
    the leaf's name, kept for the JAX signature (the quantization opt-out
    list matches against it)."""
    del path
    check_comm_knobs()
    _record_all_reduce(g.numel(), g.element_size(), axis_size)
    out = all_reduce_sum(g, group)
    return out / axis_size if mean else out


def reduce_scatter_grad(g, group, axis_size: int, *, scatter_dim: int = 0,
                        mean: bool = True, path: str = ""):
    """One leaf's reduce_scatter over `scatter_dim`, the ZeRO-2/3
    sharded-gradient path: this rank's reduced block."""
    del path
    check_comm_knobs()
    _record_reduce_scatter(g.numel(), g.element_size(), axis_size)
    x = g.movedim(scatter_dim, 0) if scatter_dim else g
    out = reduce_scatter_sum(x, group, axis_size)
    if scatter_dim:
        out = out.movedim(0, scatter_dim)
    return out / axis_size if mean else out
