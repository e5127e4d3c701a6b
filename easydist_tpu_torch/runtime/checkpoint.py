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
the state.  `meta["mesh"]["n_devices"]` stamps the world size the state
was saved on; the port restores onto the template's devices and
placements, and restoring a checkpoint saved on another world raises
NotImplementedError (restore across a topology change comes with ROADMAP
queue A item 8).

Fault points (resilience/faultinject): `ckpt.write.partial` truncates a
just-written file and dies before the commit; `ckpt.manifest.corrupt`
flips bytes in a committed file; `elastic.restore.chunk_corrupt` damages
the checkpoint being restored, so verification falls back.
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

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig
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


def mesh_stamp(state: Any) -> Dict[str, Any]:
    """What the manifest records of the topology the state was saved on:
    the world size as `n_devices` (the key the elastic loop reads) and the
    device type of the state's tensors."""
    _, world = _world()
    dev = next((x.device.type for x in pytree.tree_leaves(state)
                if isinstance(x, torch.Tensor)), "cpu")
    return {"format": 1, "n_devices": world, "world_size": world,
            "device_type": dev}


# timings of the most recent save in this process
_last_save_report: Optional[Dict[str, Any]] = None


def last_save_report() -> Optional[Dict[str, Any]]:
    """Seconds and bytes of the most recent `save_checkpoint`: `write_s`
    (device -> host copy and file write), `hash_s` (sha256 of every
    file), `commit_s`, `total_s`, `bytes` (this rank's file)."""
    return _last_save_report


def _host_leaves(state) -> List[Any]:
    return [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else x for x in pytree.tree_leaves(state)]


def save_checkpoint(path: str, state: Any, step: int, keep: int = 3,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomically save `state` (a tree of tensors, this rank's blocks)
    under `path/step_{step}`.  Synchronous; every rank of the default
    process group calls it.  Returns the committed directory.  `meta`
    lands in the manifest (the elastic loop stores the data cursor there);
    the topology is stamped as `meta["mesh"]`."""
    global _last_save_report
    t0 = time.perf_counter()
    rank, world = _world()
    meta = dict(meta or {})
    meta.setdefault("mesh", mesh_stamp(state))
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
                    with_meta: bool = False) -> Any:
    """Restore into the structure, devices and dtypes of `like` (a tree of
    tensors as this rank holds them).

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
        state = _restore(ckpt_dir, like, meta, t_verify)
        return (state, cand, meta) if with_meta else state
    raise CheckpointCorruptionError(
        f"every committed checkpoint under {path} failed verification "
        f"(last: {last_err})")


# diagnostics of the most recent _restore in this process
_last_restore_report: Optional[Dict[str, Any]] = None


def last_restore_report() -> Optional[Dict[str, Any]]:
    """Summary of the most recent restore: `ckpt_dir`, `topology_shift`
    (always False: a shift raises), `saved_n_devices`, `bytes`,
    `verify_s` (sha256 of every file), `load_s` (read and copy onto the
    template's devices)."""
    return _last_restore_report


def _restore(ckpt_dir: str, like: Any, meta: Dict[str, Any],
             verify_s: float) -> Any:
    global _last_restore_report
    rank, world = _world()
    saved = (meta.get("mesh") or {}).get("n_devices", world)
    if saved != world:
        raise NotImplementedError(
            f"checkpoint {ckpt_dir} was saved on {saved} device(s), this "
            f"job runs on {world}: restore across a topology change "
            f"(reshard/) comes with ROADMAP queue A item 8")
    t0 = time.perf_counter()
    file = os.path.join(ckpt_dir, _rank_file(rank))

    def do_load():
        with open(file, "rb") as f:
            return torch.load(f, map_location="cpu", weights_only=True)

    blob = _retry_io(do_load, f"restore {ckpt_dir}")
    tmpl, spec = pytree.tree_flatten(like)
    got = blob["leaves"]
    if len(got) != len(tmpl):
        raise ValueError(f"checkpoint {ckpt_dir} holds {len(got)} leaves, "
                         f"the template {len(tmpl)}")
    out = []
    for t, x, p in zip(tmpl, got, blob["paths"]):
        if isinstance(t, torch.Tensor):
            if tuple(x.shape) != tuple(t.shape) or x.dtype != t.dtype:
                raise ValueError(
                    f"checkpoint leaf {p}: {tuple(x.shape)} {x.dtype}, the "
                    f"template {tuple(t.shape)} {t.dtype}")
            x = x.to(t.device)
        out.append(x)
    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
           for t in tmpl):
        torch.cuda.synchronize()
    _last_restore_report = {
        "ckpt_dir": ckpt_dir, "topology_shift": False,
        "saved_n_devices": saved, "bytes": os.path.getsize(file),
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
