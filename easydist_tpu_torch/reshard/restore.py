"""Checkpoint-restore planning on the redistribution substrate: the port
of easydist_tpu/reshard/restore.py.

`plan_restore(like, saved_meta)` turns the manifest's fingerprint (what
the state looked like at SAVE time) and the restore template (this rank's
tensors as the caller wants them NOW) into per-leaf destination layouts
and `ReshardPlan`s:

  * the destination is stated (a `layout=` entry, or the template leaf
    is a DTensor) -> that IS the destination; the plan prices the saved
    -> stated move;
  * the fingerprint recorded a (mesh, spec) for the leaf and the template
    leaf is this rank's block of that layout re-fitted onto the current
    world (the outermost axis absorbs the world ratio) -> the leaf
    restores as that block, never replicated;
  * otherwise the template leaf is the whole leaf on every rank: the
    replicated fallback, whose per-rank cost is the whole leaf.

`runtime.checkpoint.load_checkpoint` executes the plan: each rank reads
only the saved ranks' files whose windows overlap its own.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import plan as planlib


@dataclass
class RestorePlan:
    """Per-leaf destinations and plans of one checkpoint restore."""

    topology_shift: bool = False
    had_fingerprint: bool = False
    # flat, aligned with the template's leaves: (MeshDesc, spec, whole
    # shape) of each tensor leaf's destination, None for other leaves
    shardings: List[Any] = field(default_factory=list)
    plans: List[Tuple[int, planlib.ReshardPlan]] = field(
        default_factory=list)
    # (leaf index, per-rank bytes) of the leaves restored replicated
    replicated_leaves: List[Tuple[int, int]] = field(default_factory=list)

    def peak_live_bytes(self) -> int:
        return max((p.peak_live_bytes() for _i, p in self.plans), default=0)

    def chunked_bound(self) -> int:
        return max((p.chunked_bound() for _i, p in self.plans), default=0)

    def replicated_bytes_per_device(self) -> int:
        return sum(b for _i, b in self.replicated_leaves)

    def summary(self) -> Dict[str, Any]:
        return {"topology_shift": self.topology_shift,
                "had_fingerprint": self.had_fingerprint,
                "n_planned": len(self.plans),
                "n_replicated": len(self.replicated_leaves),
                "replicated_bytes_per_device":
                    int(self.replicated_bytes_per_device()),
                "peak_live_bytes": int(self.peak_live_bytes()),
                "chunked_bound": int(self.chunked_bound())}


def _fit_mesh(saved: planlib.MeshDesc, n_now: int
              ) -> Optional[planlib.MeshDesc]:
    """Re-fit a saved mesh onto `n_now` devices: the OUTERMOST axis
    absorbs the device ratio (elastic scale events add or remove whole
    slices along one axis); None when no integer fit exists."""
    p = saved.n_devices
    if p == n_now:
        return saved
    sizes = list(saved.axis_sizes)
    if not sizes:
        return None
    scaled = sizes[0] * n_now
    if scaled % p != 0:
        return None
    new0 = scaled // p
    if new0 < 1:
        return None
    return planlib.MeshDesc(saved.axis_names, (new0, *sizes[1:]),
                            saved.device_kinds)


def _live(like_leaves) -> Tuple[int, int, str]:
    """(rank, world, device name) of the restoring process."""
    import torch.distributed as dist

    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    dev = next((getattr(x, "to_local", lambda: x)().device
                for x in like_leaves if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    return rank, world, planlib.device_kind(dev)


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if len(shape) else 1


def plan_restore(like: Any, saved_meta: Optional[Dict[str, Any]],
                 chunk_bytes: Optional[int] = None, layout: Any = None,
                 rank: Optional[int] = None,
                 world: Optional[int] = None) -> RestorePlan:
    """The restore plan of template `like` (this rank's tree of tensors)
    given the checkpoint manifest's meta (its `mesh` fingerprint; None or
    a fingerprint-less meta for legacy checkpoints).  `layout` states the
    destination of plain per-rank tensors (see `plan.flatten_layout`);
    `rank` / `world` default to the default process group's."""
    leaves, treespec = pytree.tree_flatten(like)
    live_rank, live_world, kind = _live(leaves)
    rank = live_rank if rank is None else rank
    n_now = live_world if world is None else world
    fp = (saved_meta or {}).get("mesh") if saved_meta else None
    fp = fp if fp and "leaves" in fp else None
    out = RestorePlan(had_fingerprint=bool(fp),
                      topology_shift=planlib.topology_shifted(
                          fp, world=n_now, kind=kind))
    saved_leaves = list(fp.get("leaves", [])) if fp else []
    lays = (planlib.flatten_layout(layout, treespec) if layout is not None
            else [None] * len(leaves))
    rep = planlib.MeshDesc(("restore",), (n_now,), (kind,))

    for i, (leaf, lay) in enumerate(zip(leaves, lays)):
        if not isinstance(leaf, torch.Tensor):
            out.shardings.append(None)
            continue
        local = tuple(getattr(leaf, "to_local", lambda: leaf)().shape)
        saved = saved_leaves[i] if i < len(saved_leaves) else {}
        src_desc, saved_shape = None, None
        if saved.get("kind") == "array":
            saved_shape = tuple(saved.get("shape", ()))
            if "mesh" in saved:
                src_desc = (planlib.MeshDesc.from_meta(saved["mesh"]),
                            planlib.normalize_spec(
                                tuple(saved.get("spec", [])),
                                len(saved_shape)))
        dst = lay if lay is not None else (
            leaf if hasattr(leaf, "device_mesh") else None)
        if dst is not None:
            # the caller's layout wins; the plan prices saved -> stated
            shape = planlib.global_shape(dst, local)
            mesh, spec = planlib.sharding_desc(dst, len(shape))
            out.shardings.append((mesh, spec, shape))
            if src_desc is not None and saved_shape == shape:
                if mesh.axis_sizes != src_desc[0].axis_sizes:
                    out.topology_shift = True
                out.plans.append((i, planlib.plan_redistribute(
                    shape, leaf.dtype, src_desc, (mesh, spec),
                    chunk_bytes=chunk_bytes)))
            continue

        if src_desc is not None:
            fitted = _fit_mesh(src_desc[0], n_now)
            spec = src_desc[1]
            if (fitted is not None and any(a is not None for a in spec)
                    and rank < fitted.n_devices):
                win = planlib.device_windows(saved_shape, fitted,
                                             spec)[rank]
                if _numel([hi - lo for lo, hi in win]) == _numel(local) \
                        and local != saved_shape:
                    if fitted != src_desc[0]:
                        out.topology_shift = True
                    out.shardings.append((fitted, spec, saved_shape))
                    out.plans.append((i, planlib.plan_redistribute(
                        saved_shape, leaf.dtype, src_desc, (fitted, spec),
                        chunk_bytes=chunk_bytes)))
                    continue

        # the replicated fallback: the template holds the whole leaf, and
        # so does every rank (a sharded save is still gathered chunk by
        # chunk, and priced)
        rep_spec = planlib.normalize_spec((), len(local))
        out.shardings.append((rep, rep_spec, local))
        out.replicated_leaves.append(
            (i, _numel(local) * leaf.element_size()))
        if src_desc is not None and saved_shape == local:
            out.plans.append((i, planlib.plan_redistribute(
                local, leaf.dtype, src_desc, (rep, rep_spec),
                chunk_bytes=chunk_bytes)))
    return out
