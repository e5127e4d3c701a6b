"""Checkpoint save / restore with an atomic commit protocol: the port of
easydist_tpu/runtime/checkpoint.py.

A checkpoint is only ever observed fully committed or not at all:

    path/
      .tmp_step_42_ab12ef/        in-flight write (never read)
        arrays/rank00000.pt       each rank's leaves, one file a rank
        MANIFEST.json             per-file sha256 + step + caller meta
      step_42/                    os.replace(tmpdir) -> atomic appearance
        arrays/  MANIFEST.json
        COMMITTED                 marker written + fsynced after the rename

Write protocol: every rank writes its own file into the temp directory
(so the local blocks of a sharded state never collide: zero2's moments
are [1, d0/n, ...] on every rank under the same key) -> barrier -> rank
0 checksums every file into MANIFEST.json (fsync) -> `os.replace` the
temp directory to `step_N` -> the COMMITTED marker (fsync file and
directory) -> barrier.  `latest_step` counts only COMMITTED directories.

Read protocol: `verify_checkpoint` checks the manifest before a restore;
a corrupt or partial checkpoint falls back to the previous COMMITTED
step.  I/O retries with exponential backoff and jitter
(`resilience_ckpt_retries` / `_backoff_s` / `_backoff_jitter`).

The manifest carries caller metadata: the elastic loop records its data
cursor there, so the batches a state has seen commit atomically with
the state.  `meta["mesh"]` is the state's fingerprint
(`reshard.state_fingerprint`): the world size as `n_devices`, the device
type and name, and per leaf its whole shape, dtype and, for a leaf
spread over ranks, its (mesh, spec) — read from DTensor leaves, or from
the `layout=` the caller states for plain per-rank tensors
(`parallel.dp.dp_state_layout` gives a ddp / ZeRO state's).

Restore onto another world: `load_checkpoint(..., layout=)` plans each
leaf's destination on this rank (`reshard.plan_restore`), opens only the
saved ranks' files whose windows overlap its own, with `torch.load(...,
mmap=True)` so that the bytes it does not copy are never read, and
copies chunk by chunk (`config.reshard_chunk_bytes` a chunk) into the
template's devices.  A rank's live bytes beyond its restored state stay
within one chunk.  A state saved on several ranks without a stated
layout restores only on the same world (its per-rank blocks cannot be
placed elsewhere).

Fault points (resilience/faultinject): `ckpt.write.partial` truncates a
just-written file and dies before the commit; `ckpt.manifest.corrupt`
flips bytes in a committed file; `elastic.restore.chunk_corrupt` damages
the checkpoint being restored, so verification falls back;
`elastic.restore.oom` fails a restore's first plan with
`ReshardOOMError`, and the restore halves its chunk and replans.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import re
import shutil
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.reshard import (ReshardOOMError, plan_restore,
                                        state_fingerprint)
from easydist_tpu_torch.reshard.plan import (block_view, chunk_spans,
                                             device_windows, dtype_name,
                                             intersect, window_slices)
from easydist_tpu_torch.resilience import faultinject

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
COMMITTED_NAME = "COMMITTED"
ARRAYS_SUBDIR = "arrays"
MANIFEST_FORMAT = 1
# dead .tmp_* write dirs are collected once they are plausibly not a
# concurrent writer's in-flight save anymore
_TMP_GC_AGE_S = 3600.0


class CheckpointCorruptionError(RuntimeError):
    """Every candidate checkpoint failed manifest verification (or an
    explicitly requested step did)."""


def _retry_io(fn, what: str):
    """Run `fn()` retrying OSErrors with exponential backoff + jitter.
    Injected faults and logic errors propagate at once."""
    retries = edconfig.resilience_ckpt_retries
    backoff = edconfig.resilience_ckpt_backoff_s
    jitter = edconfig.resilience_ckpt_backoff_jitter
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = backoff * (2 ** attempt)
            delay *= 1.0 + jitter * random.random()
            logger.warning(
                "checkpoint: %s failed (%s: %s); retry %d/%d in %.3fs",
                what, type(e).__name__, e, attempt + 1, retries, delay)
            time.sleep(delay)
            attempt += 1


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # some filesystems refuse O_RDONLY on dirs; best-effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256_file(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


def _walk_files(root: str) -> List[str]:
    """Relative paths of every regular file under root (sorted, stable)."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(out)


def _world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_file(rank: int) -> str:
    return os.path.join(ARRAYS_SUBDIR, f"rank{rank:05d}.pt")


def _broadcast(obj):
    """`obj` from rank 0 on every rank (itself without a group)."""
    rank, world = _world()
    if world == 1:
        return obj
    box = [obj if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _barrier() -> None:
    if _world()[1] > 1:
        dist.barrier()


# timings of the most recent save in this process
_last_save_report: Optional[Dict[str, Any]] = None


def last_save_report() -> Optional[Dict[str, Any]]:
    """Seconds and bytes of the most recent `save_checkpoint`: `write_s`
    (device -> host copy and file write), `hash_s` (sha256 of every
    file), `commit_s`, `total_s`, `bytes` (this rank's file)."""
    return _last_save_report


def _host_leaves(state) -> List[Any]:
    """This rank's leaves on the host (a DTensor's local block)."""
    return [getattr(x, "to_local", lambda: x)().detach().to(
        "cpu", copy=True) if isinstance(x, torch.Tensor) else x
        for x in pytree.tree_leaves(state)]


def save_checkpoint(path: str, state: Any, step: int, keep: int = 3,
                    meta: Optional[Dict[str, Any]] = None,
                    layout: Any = None) -> str:
    """Atomically save `state` (a tree of tensors, this rank's blocks)
    under `path/step_{step}`.  Synchronous; every rank of the default
    process group calls it.  Returns the committed directory.  `meta`
    lands in the manifest (the elastic loop stores the data cursor there);
    the state's fingerprint is stamped as `meta["mesh"]`, with the layout
    of plain per-rank tensors from `layout` (the state's tree with a
    `(MeshDesc, spec[, whole_shape])` at every leaf)."""
    global _last_save_report
    t0 = time.perf_counter()
    rank, world = _world()
    meta = dict(meta or {})
    meta.setdefault("mesh", state_fingerprint(state, layout))
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    token = _broadcast(uuid.uuid4().hex[:8])
    tmp = os.path.join(path, f".tmp_step_{step}_{token}")
    final = os.path.join(path, f"step_{step}")
    mine = os.path.join(tmp, _rank_file(rank))
    os.makedirs(os.path.dirname(mine), exist_ok=True)
    paths = [pytree.keystr(kp)
             for kp, _ in pytree.tree_flatten_with_path(state)[0]]

    def do_save():
        with open(mine, "wb") as f:
            torch.save({"paths": paths, "leaves": _host_leaves(state)}, f)
            f.flush()
            os.fsync(f.fileno())

    try:
        _retry_io(do_save, f"save step {step}")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    t_write = time.perf_counter()
    _barrier()
    error = None
    t_hash = t_write
    if rank == 0:
        try:
            if faultinject.fire("ckpt.write.partial"):
                # dying mid-write: tear the largest file, then "crash"
                # before any commit; the tempdir must never be resumable
                files = _walk_files(tmp)
                victim = os.path.join(tmp, max(
                    files, key=lambda f: os.path.getsize(
                        os.path.join(tmp, f))))
                with open(victim, "r+b") as fh:
                    fh.truncate(os.path.getsize(victim) // 2)
                raise faultinject.InjectedFault("ckpt.write.partial")
            manifest = {"format": MANIFEST_FORMAT, "step": int(step),
                        "created": time.time(), "meta": meta, "files": {}}
            for rel in _walk_files(tmp):
                digest, nbytes = _sha256_file(os.path.join(tmp, rel))
                manifest["files"][rel] = {"sha256": digest, "bytes": nbytes}
            t_hash = time.perf_counter()
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            # commit: atomic appearance, then the marker
            if os.path.isdir(final):  # a re-save of the same step
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            with open(os.path.join(final, COMMITTED_NAME), "w") as f:
                json.dump({"step": int(step), "committed": time.time()}, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(final)
            _fsync_dir(path)
            if faultinject.fire("ckpt.manifest.corrupt"):
                # bit rot after the commit: verification must catch it
                _flip_committed_bytes(final)
            _gc_old(path, keep, protect=step)
        except BaseException as e:
            shutil.rmtree(tmp, ignore_errors=True)
            error = e
    failed = _broadcast(None if error is None else repr(error))
    if error is not None:
        raise error
    if failed is not None:
        raise RuntimeError(f"checkpoint step {step}: rank 0 failed to "
                           f"commit: {failed}")
    t_end = time.perf_counter()
    _last_save_report = {
        "step": int(step), "bytes": os.path.getsize(
            os.path.join(final, _rank_file(rank))),
        "write_s": t_write - t0, "hash_s": t_hash - t_write,
        "commit_s": t_end - t_hash, "total_s": t_end - t0}
    return final


def _flip_committed_bytes(ckpt_dir: str) -> None:
    """Flip 8 bytes mid-file in the largest data file of a committed
    checkpoint (the shared corruption of `ckpt.manifest.corrupt` and
    `elastic.restore.chunk_corrupt`)."""
    files = sorted(
        ((os.path.getsize(os.path.join(ckpt_dir, r)), r)
         for r in _walk_files(ckpt_dir)
         if r not in (MANIFEST_NAME, COMMITTED_NAME)), reverse=True)
    if files:
        victim = os.path.join(ckpt_dir, files[0][1])
        with open(victim, "r+b") as fh:
            size = os.path.getsize(victim)
            fh.seek(size // 2)
            data = fh.read(8)
            fh.seek(size // 2)
            fh.write(bytes(b ^ 0xFF for b in data) or b"\xff")


def _step_dirs(path: str) -> List[Tuple[int, str]]:
    try:
        entries = os.listdir(path)
    except FileNotFoundError:
        return []
    out = []
    for d in entries:
        m = re.fullmatch(r"step_(\d+)", d)
        if m:
            out.append((int(m.group(1)), os.path.join(path, d)))
    return sorted(out)


def _is_committed(ckpt_dir: str) -> bool:
    return os.path.isfile(os.path.join(ckpt_dir, COMMITTED_NAME))


def latest_step(path: str) -> Optional[int]:
    """Newest COMMITTED step under `path` (uncommitted or partial
    directories are invisible to resume)."""
    steps = [s for s, d in _step_dirs(path) if _is_committed(d)]
    return max(steps) if steps else None


def checkpoint_meta(path: str, step: int) -> Dict[str, Any]:
    """Caller metadata recorded in the manifest at save time; {} without
    a manifest."""
    man = os.path.join(os.path.abspath(path), f"step_{step}", MANIFEST_NAME)
    try:
        with open(man) as f:
            return dict(json.load(f).get("meta", {}))
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def verify_checkpoint(ckpt_dir: str) -> List[str]:
    """Commit-protocol + integrity audit of one checkpoint directory: a
    list of problems (empty = verified)."""
    problems: List[str] = []
    if not os.path.isdir(ckpt_dir):
        return [f"missing directory {ckpt_dir}"]
    if not _is_committed(ckpt_dir):
        problems.append("no COMMITTED marker")
    try:
        with open(os.path.join(ckpt_dir, MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        problems.append("no MANIFEST.json")
        return problems
    except json.JSONDecodeError as e:
        problems.append(f"manifest unparsable: {e}")
        return problems
    for rel, want in manifest.get("files", {}).items():
        try:
            digest, nbytes = _sha256_file(os.path.join(ckpt_dir, rel))
        except FileNotFoundError:
            problems.append(f"listed file missing: {rel}")
            continue
        if nbytes != want.get("bytes"):
            problems.append(
                f"size mismatch {rel}: {nbytes} != {want.get('bytes')}")
        elif digest != want.get("sha256"):
            problems.append(f"checksum mismatch {rel}")
    return problems


def load_checkpoint(path: str, like: Any, step: Optional[int] = None,
                    verify: bool = True, fallback: bool = True,
                    with_meta: bool = False, layout: Any = None) -> Any:
    """Restore into the structure, devices and dtypes of `like` (a tree of
    tensors as this rank holds them), on this world: `layout` states the
    destination layout of plain per-rank tensors (DTensor leaves carry
    their own), so a state saved on another world size restores as this
    rank's blocks (see the module docstring).

    With `step=None` the committed steps are tried newest first; one that
    fails verification is skipped with a warning (fallback to the last
    good step).  An explicitly requested `step` that fails raises
    `CheckpointCorruptionError`.  `with_meta=True` returns
    (state, step, meta)."""
    path = os.path.abspath(path)
    if step is not None:
        candidates, explicit = [step], True
    else:
        candidates = sorted(
            (s for s, d in _step_dirs(path) if _is_committed(d)),
            reverse=True)
        explicit = False
        if not candidates:
            raise FileNotFoundError(f"no committed checkpoints under {path}")
    last_err: Optional[str] = None
    for cand in candidates:
        ckpt_dir = os.path.join(path, f"step_{cand}")
        if faultinject.fire("elastic.restore.chunk_corrupt"):
            # bit rot found at restore time: damage the candidate before
            # verification, which must catch it and fall back
            _flip_committed_bytes(ckpt_dir)
        t0 = time.perf_counter()
        problems = verify_checkpoint(ckpt_dir) if verify else []
        t_verify = time.perf_counter() - t0
        if problems:
            msg = f"step {cand}: " + "; ".join(problems)
            if explicit or not fallback:
                raise CheckpointCorruptionError(msg)
            logger.warning("checkpoint: %s — falling back to the previous "
                           "committed step", msg)
            last_err = msg
            continue
        meta = checkpoint_meta(path, cand)
        state = _restore(ckpt_dir, like, meta, t_verify, layout)
        return (state, cand, meta) if with_meta else state
    raise CheckpointCorruptionError(
        f"every committed checkpoint under {path} failed verification "
        f"(last: {last_err})")


# diagnostics of the most recent _restore in this process
_last_restore_report: Optional[Dict[str, Any]] = None


def last_restore_report() -> Optional[Dict[str, Any]]:
    """Summary of the most recent restore: `ckpt_dir`, `topology_shift`,
    `saved_n_devices`, the plan's `n_planned`, `n_replicated`,
    `peak_live_bytes` against its `chunked_bound` (a rank's live bytes:
    its source and destination windows and one chunk), `chunk_bytes`
    (halved on each `elastic.restore.oom`), `attempts`, `files_opened` and
    `bytes_copied` (this rank's), `verify_s` (sha256 of every file) and
    `load_s` (planning, reading and copying onto the template's
    devices)."""
    return _last_restore_report


class _SavedRanks:
    """The saved ranks' files, each opened at its first use with
    `torch.load(mmap=True)`: a leaf's bytes are read only when a window
    of it is copied."""

    def __init__(self, ckpt_dir: str, n_leaves: int):
        self.dir, self.n_leaves, self.blobs = ckpt_dir, n_leaves, {}
        self.copied = 0  # bytes copied out of the files

    def leaf(self, rank: int, i: int):
        if rank not in self.blobs:
            file = os.path.join(self.dir, _rank_file(rank))
            blob = _retry_io(lambda: torch.load(
                file, map_location="cpu", mmap=True, weights_only=True),
                f"restore {self.dir}")
            if len(blob["leaves"]) != self.n_leaves:
                raise ValueError(
                    f"checkpoint {self.dir} holds {len(blob['leaves'])} "
                    f"leaves, the template {self.n_leaves}")
            self.blobs[rank] = blob
        return self.blobs[rank]["leaves"][i], self.blobs[rank]["paths"][i]


def _restore_leaf(files, i: int, t, dest, saved: Dict[str, Any],
                  saved_n: int, rank: int, chunk_bytes: int):
    """Leaf i of this rank's restored state: its destination window
    (`dest` = (MeshDesc, spec, whole shape)) built chunk by chunk from the
    saved windows that overlap it, on the template's device."""
    mesh, spec, shape = dest
    local = getattr(t, "to_local", lambda: t)()
    if tuple(saved.get("shape", shape)) != tuple(shape):
        raise ValueError(f"checkpoint leaf {i}: saved as {saved['shape']}, "
                         f"the template holds {list(shape)}")
    if saved.get("dtype", dtype_name(t.dtype)) != dtype_name(t.dtype):
        raise ValueError(f"checkpoint leaf {i}: saved {saved['dtype']}, "
                         f"the template {t.dtype}")
    if rank >= mesh.n_devices:
        raise ValueError(f"checkpoint leaf {i}: rank {rank} is outside "
                         f"the destination mesh of {mesh.n_devices}")
    full = tuple((0, n) for n in shape)
    dwin = device_windows(shape, mesh, spec)[rank] if shape else ()
    if "mesh" in saved:
        from easydist_tpu_torch.reshard import MeshDesc

        s_wins = device_windows(shape, MeshDesc.from_meta(saved["mesh"]),
                                saved["spec"])
    else:
        s_wins = [full] * saved_n
    # one holder per distinct saved window: this rank when it holds it
    holders = {}
    for s, w in enumerate(s_wins):
        if w not in holders or s == rank:
            holders[w] = s
    buf = torch.empty([hi - lo for lo, hi in dwin], dtype=local.dtype,
                      device=local.device)
    if not shape:
        x, _ = files.leaf(holders[()], i)
        buf.copy_(x)
    else:
        row = max(1, local.element_size() * int(np.prod(shape[1:])))
        for lo, hi in chunk_spans(shape[0], max(1, chunk_bytes // row)):
            region = intersect(dwin, ((lo, hi),) + full[1:])
            if region is None:
                continue
            for swin, s in holders.items():
                ov = intersect(swin, region)
                if ov is None:
                    continue
                x, path = files.leaf(s, i)
                if x.dtype != buf.dtype:
                    raise ValueError(f"checkpoint leaf {path}: {x.dtype}, "
                                     f"the template {buf.dtype}")
                buf[window_slices(ov, dwin)] = \
                    block_view(x, swin)[window_slices(ov, swin)]
                files.copied += int(np.prod([b - a for a, b in ov])) * \
                    local.element_size()
    buf = buf.view(local.shape)
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(buf, t.device_mesh, t.placements,
                                  shape=t.shape, stride=t.stride())
    return buf


def _restore(ckpt_dir: str, like: Any, meta: Dict[str, Any],
             verify_s: float, layout: Any = None) -> Any:
    global _last_restore_report
    rank, world = _world()
    fp = meta.get("mesh") or {}
    saved_n = int(fp.get("n_devices", world))
    if saved_n != world and saved_n > 1 and not fp.get("layout"):
        raise ValueError(
            f"checkpoint {ckpt_dir} was saved on {saved_n} ranks without "
            f"a stated layout; its per-rank blocks restore only on "
            f"{saved_n} ranks (save with layout= to restore elsewhere)")
    t0 = time.perf_counter()
    tmpl, spec = pytree.tree_flatten(like)
    saved_leaves = fp.get("leaves") or [{}] * len(tmpl)
    if len(saved_leaves) != len(tmpl):
        raise ValueError(f"checkpoint {ckpt_dir} holds {len(saved_leaves)} "
                         f"leaves, the template {len(tmpl)}")
    chunk_bytes = int(edconfig.reshard_chunk_bytes)
    attempts: List[Dict[str, Any]] = []
    while True:
        rplan = plan_restore(like, meta, chunk_bytes=chunk_bytes,
                             layout=layout, rank=rank, world=world)
        files = _SavedRanks(ckpt_dir, len(tmpl))
        try:
            if faultinject.fire("elastic.restore.oom"):
                raise ReshardOOMError("elastic.restore.oom (injected)")
            out = []
            for i, (t, dest) in enumerate(zip(tmpl, rplan.shardings)):
                if dest is None:  # a non-tensor leaf: this rank's own
                    out.append(files.leaf(rank if rank < saved_n else 0,
                                          i)[0])
                    continue
                out.append(_restore_leaf(files, i, t, dest,
                                         saved_leaves[i], saved_n, rank,
                                         chunk_bytes))
        except (ReshardOOMError, torch.cuda.OutOfMemoryError) as e:
            attempts.append({"chunk_bytes": chunk_bytes, "outcome": "oom"})
            if chunk_bytes <= 1:
                raise
            chunk_bytes = max(1, chunk_bytes // 2)
            logger.warning("checkpoint: chunked restore exceeded its memory "
                           "budget (%s); replanning with chunk_bytes=%d",
                           e, chunk_bytes)
            continue
        attempts.append({"chunk_bytes": chunk_bytes, "outcome": "landed"})
        break
    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
           for t in tmpl):
        torch.cuda.synchronize()
    if rplan.topology_shift:
        logger.warning(
            "checkpoint: topology shift restoring %s (saved on %d rank(s), "
            "restored on %d): %d per-leaf redistribution(s), peak live %d B "
            "under bound %d B, %d leaf/leaves replicated", ckpt_dir, saved_n,
            world, len(rplan.plans), rplan.peak_live_bytes(),
            rplan.chunked_bound(), len(rplan.replicated_leaves))
    _last_restore_report = {
        "ckpt_dir": ckpt_dir, **rplan.summary(), "saved_n_devices": saved_n,
        "chunk_bytes": chunk_bytes, "attempts": attempts,
        "files_opened": len(files.blobs), "bytes_copied": files.copied,
        "verify_s": verify_s, "load_s": time.perf_counter() - t0}
    return pytree.tree_unflatten(out, spec)


def _gc_old(path: str, keep: int, protect: Optional[int] = None) -> None:
    """Collect old checkpoints: the keep-count applies only to COMMITTED
    steps; the step just written (`protect`) is never collected; a
    concurrent deleter is tolerated; dead `.tmp_*` dirs older than an
    hour and uncommitted `step_N` dirs superseded by a committed step are
    swept."""
    try:
        entries = os.listdir(path)
    except FileNotFoundError:
        return
    committed, uncommitted = [], []
    for d in entries:
        m = re.fullmatch(r"step_(\d+)", d)
        if not m:
            continue
        full = os.path.join(path, d)
        try:
            (committed if _is_committed(full) else uncommitted).append(
                int(m.group(1)))
        except FileNotFoundError:
            continue
    committed.sort()
    for s in (committed[:-keep] if keep > 0 else []):
        if protect is not None and s == protect:
            continue
        shutil.rmtree(os.path.join(path, f"step_{s}"), ignore_errors=True)
    newest = committed[-1] if committed else None
    for s in uncommitted:
        if protect is not None and s == protect:
            continue
        if newest is not None and s <= newest:
            shutil.rmtree(os.path.join(path, f"step_{s}"),
                          ignore_errors=True)
    now = time.time()
    for d in entries:
        if not d.startswith(".tmp_step_"):
            continue
        full = os.path.join(path, d)
        try:
            if now - os.path.getmtime(full) > _TMP_GC_AGE_S:
                shutil.rmtree(full, ignore_errors=True)
        except FileNotFoundError:
            continue
