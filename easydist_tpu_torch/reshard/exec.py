"""Execute a `ReshardPlan` on live tensors: the port of
easydist_tpu/reshard/exec.py.

A rank holds its own block of a tensor, a DTensor's local tensor or a
plain tensor whose layout the caller states (`(MeshDesc, spec)`, the mesh
over ranks 0..n-1 of the default process group).  Two lowerings, picked
by what the device sets allow:

  * **collective path**: source and destination span the same ranks, the
    whole default group in order.  Per chunk of the plan (a window of
    dim-0 rows), every rank puts in its source block's part of the chunk,
    one `all_gather` (the functional collective `comm.all_gather_dim0`,
    as `fxfront/emit.py` lowers its gathers) hands every rank the whole
    chunk, and each keeps its destination window of it.  Live bytes per
    rank: the source and destination blocks and one chunk (with its
    gathered parts).

  * **staged path**: the rank sets differ (an elastic shrink or grow).
    Each destination block is built from the source windows that overlap
    it, one chunk at a time: the rank holding a piece sends it and the
    destination rank receives it (point to point, every rank walking the
    same total order of transfers, so no pair waits on another), or
    copies it itself when it holds the piece.  No rank ever builds the
    global tensor.

`fetch_chunked` is the export variant (device -> host): per-chunk reads
instead of one whole-tensor copy.  Every entry point plans with
`plan_redistribute` first and raises `ReshardOOMError` when a step would
stage more than the plan's chunked bound.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from . import plan as planlib
from .plan import block_view, window_slices


class ReshardOOMError(RuntimeError):
    """A chunked transfer step exceeded its memory budget (a real out of
    memory, or the `elastic.restore.oom` fault point said it did);
    recoverable by replanning with a smaller chunk."""


def _group_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _resolve(layout, ndim: int):
    """(MeshDesc, spec, ranks, DeviceMesh or None, placements) of a
    layout: `(DeviceMesh, placements)` or `(MeshDesc, spec[, shape])`
    (ranks 0..n-1)."""
    if planlib._is_layout(layout):
        mesh, spec = planlib.sharding_desc(layout, ndim)
        return mesh, spec, list(range(mesh.n_devices)), None, None
    device_mesh, placements = layout
    desc = planlib.MeshDesc.from_mesh(device_mesh)
    spec = planlib.placements_spec(desc, placements, ndim)
    return (desc, spec, [int(r) for r in device_mesh.mesh.flatten()],
            device_mesh, tuple(placements))


def _check_budget(rplan: planlib.ReshardPlan) -> None:
    if rplan.peak_live_bytes() > rplan.chunked_bound():
        raise ReshardOOMError(
            f"plan stages {rplan.peak_live_bytes()} B, over its chunked "
            f"bound {rplan.chunked_bound()} B")


def redistribute(x, dst, src=None, *, chunk_bytes: Optional[int] = None,
                 rplan: Optional[planlib.ReshardPlan] = None):
    """Move a tensor from layout `src` to layout `dst` as the chunked
    program `plan_redistribute` gives (or the caller's `rplan`).

    `x` is a DTensor (its mesh and placements are the source; `src` is
    ignored) or this rank's block of the source, None on a rank outside
    the source's mesh.  `dst` / `src` are `(DeviceMesh, placements)` or
    `(MeshDesc, spec[, global_shape])`.  Every rank of the default group
    calls it.  Returns this rank's destination block (a DTensor when `dst`
    names a DeviceMesh), None on a rank outside the destination's mesh.
    Never builds the global tensor on any rank."""
    if hasattr(x, "device_mesh"):
        src = (x.device_mesh, tuple(x.placements))
        shape, dtype, device = tuple(x.shape), x.dtype, x.device
        x = x.to_local()
        ndim = len(shape)
    elif src is None:
        raise ValueError("a plain block needs its source layout `src`")
    else:
        first = (_resolve(src, 0)[2] if planlib._is_layout(src)
                 else [int(src[0].mesh.flatten()[0])])[0]
        local, dtype, device = _broadcast_meta(x, first)
        explicit = planlib._is_layout(src) and len(src) > 2
        ndim = len(src[2]) if explicit else len(local)
        shape = (planlib.global_shape(src, local) if explicit or
                 planlib._is_layout(src) else None)
    s_mesh, s_spec, s_ranks, _, _ = _resolve(src, ndim)
    d_mesh, d_spec, d_ranks, d_dm, d_pl = _resolve(dst, ndim)
    rank, world = _group_world()
    if shape is None:
        shape = tuple(int(n) * (s_mesh.axis_size(a) if a else 1)
                      for n, a in zip(local, s_spec))
    if rplan is None:
        rplan = planlib.plan_redistribute(shape, dtype, (s_mesh, s_spec),
                                          (d_mesh, d_spec),
                                          chunk_bytes=chunk_bytes)
    _check_budget(rplan)
    s_wins = planlib.device_windows(shape, s_mesh, s_spec)
    d_wins = planlib.device_windows(shape, d_mesh, d_spec)
    if rank in s_ranks:
        x = block_view(x, s_wins[s_ranks.index(rank)])
    same = (s_mesh, s_spec, s_ranks) == (d_mesh, d_spec, d_ranks)
    out = None
    if rank in d_ranks:
        dwin = d_wins[d_ranks.index(rank)]
        out = x if same else torch.empty([hi - lo for lo, hi in dwin],
                                         dtype=dtype, device=device)
    if not same:  # else already there
        if s_ranks == d_ranks == list(range(world)):
            _exec_collective(x, out, rplan, s_wins, d_wins, rank)
        else:
            _exec_staged(x, out, rplan, s_wins, s_ranks, d_wins, d_ranks,
                         rank)
    if out is None or d_dm is None:
        return out
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out, d_dm, d_pl, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _broadcast_meta(x, first: int):
    """(local shape, dtype, device) of the source's first rank's block on
    every rank (a rank outside the source holds no block to read them
    from)."""
    rank, world = _group_world()
    box = [(tuple(x.shape), x.dtype, x.device.type) if rank == first
           else None]
    if world > 1:
        dist.broadcast_object_list(box, src=first)
    shape, dtype, dev_type = box[0]
    device = x.device if x is not None else torch.device(
        dev_type if dev_type == "cpu" else f"{dev_type}:"
        f"{torch.cuda.current_device()}")
    return shape, dtype, device


def _exec_collective(x, out, rplan, s_wins, d_wins, rank: int) -> None:
    """Same ranks, the whole default group: per chunk, one all_gather of
    every rank's part of the chunk (padded to the largest part), then
    each rank keeps its destination window of it."""
    from easydist_tpu_torch.comm.reduce import all_gather_dim0

    n = len(s_wins)
    group = dist.group.WORLD
    replicated = all(a is None for a in rplan.src_spec)
    for op in rplan.chunks:
        win = op.window
        dwin = d_wins[rank]
        need = planlib.intersect(dwin, win)
        if replicated:
            # every rank holds the whole source: the chunk is local
            if need is not None:
                out[window_slices(need, dwin)] = \
                    x[window_slices(need, s_wins[rank])]
            continue
        parts = [planlib.intersect(w, win) for w in s_wins]
        sizes = [planlib.window_bytes(p, 1) if p is not None else 0
                 for p in parts]
        width = max(sizes)
        mine = parts[rank]
        flat = torch.zeros(width, dtype=x.dtype, device=x.device)
        if mine is not None:
            flat[:sizes[rank]] = \
                x[window_slices(mine, s_wins[rank])].reshape(-1)
        gathered = all_gather_dim0(flat, group, n).reshape(n, width)
        if need is None:
            continue
        for j, p in enumerate(parts):
            ov = planlib.intersect(p, need) if p is not None else None
            if ov is None:
                continue
            block = gathered[j, :sizes[j]].reshape(
                [hi - lo for lo, hi in p])
            out[window_slices(ov, dwin)] = block[window_slices(ov, p)]


def _exec_staged(x, out, rplan, s_wins, s_ranks, d_wins, d_ranks,
                 rank: int) -> None:
    """Different rank sets: every (chunk, destination rank, source window)
    transfer in one total order that every rank walks; the holder of a
    piece sends it, its destination receives it, and a rank that holds
    its own piece copies it."""
    for op in rplan.chunks:
        for j, dwin in enumerate(d_wins):
            dst_rank = d_ranks[j]
            region = planlib.intersect(dwin, op.window)
            if region is None:
                continue
            seen = set()
            for swin in s_wins:
                if swin in seen:
                    continue  # a replica: the window is already taken
                ov = planlib.intersect(swin, region)
                if ov is None:
                    continue
                seen.add(swin)
                holders = [s_ranks[k] for k, w in enumerate(s_wins)
                           if w == swin]
                sender = dst_rank if dst_rank in holders else holders[0]
                if rank == sender == dst_rank:
                    out[window_slices(ov, dwin)] = \
                        x[window_slices(ov, swin)]
                elif rank == sender:
                    dist.send(x[window_slices(ov, swin)].contiguous(),
                              dst=dst_rank)
                elif rank == dst_rank:
                    buf = torch.empty([hi - lo for lo, hi in ov],
                                      dtype=out.dtype, device=out.device)
                    dist.recv(buf, src=sender)
                    out[window_slices(ov, dwin)] = buf


def fetch_chunked(x, chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """Device -> host gather in chunk-bounded reads: the whole tensor as a
    CPU tensor (the full host buffer is the point of an export; what the
    plan bounds is the staging).  A DTensor is gathered chunk by chunk
    over its mesh (every rank of the default group calls it and gets the
    whole tensor); a plain tensor is copied one chunk of rows at a
    time."""
    shape = tuple(x.shape)
    if hasattr(x, "device_mesh"):
        mesh, spec, ranks, _, _ = _resolve(
            (x.device_mesh, tuple(x.placements)), x.ndim)
        if ranks != list(range(_group_world()[1])):
            raise ValueError("fetch_chunked gathers a DTensor over a mesh "
                             "of the whole default group, in rank order")
    else:
        mesh, spec = planlib.MeshDesc(("rep",), (1,)), ()
    rplan = planlib.plan_redistribute(shape, x.dtype, (mesh, spec),
                                      (planlib.HOST, ()),
                                      chunk_bytes=chunk_bytes)
    _check_budget(rplan)
    if not shape:
        return x.full_tensor().cpu() if hasattr(x, "to_local") \
            else x.detach().cpu()
    out = torch.empty(shape, dtype=x.dtype)
    if not hasattr(x, "device_mesh"):
        for op in rplan.chunks:
            lo, hi = op.window[0]
            out[lo:hi] = x[lo:hi]
        return out
    s_wins = planlib.device_windows(shape, mesh, spec)
    full = tuple((0, n) for n in shape)
    _exec_collective(x.to_local(), out, rplan, s_wins,
                     [full] * len(s_wins), _group_world()[0])
    return out


__all__: List[str] = ["ReshardOOMError", "fetch_chunked", "redistribute"]
