"""Continuous micro-batching: queue, pack, scatter (port of
easydist_tpu/serve/batcher.py).

Requests carry UNBATCHED args (one example each).  The batcher drains the
queue under `max_batch_size`/`max_wait_ms`, pads heterogeneous requests to
a common bucket shape (leading dim of every rank>=1 arg -> the smallest
configured seq bucket that fits the longest request; batch -> the smallest
batch bucket that fits the drained count), stacks them into one device
batch, and scatters results back to per-request futures.

Padding policy: seq padding replicates `pad_value`; batch padding repeats
the last real row (finite values by construction — a NaN-poisoned pad row
could otherwise infect reductions).  Outputs are un-padded by slicing any
leading output dim that equals the padded seq length back to the request's
original length (`unpad_outputs`).

Packed batches are host numpy arrays (the engine moves them to its
device); `scatter_results` copies the batch's outputs to the host ONCE,
then splits rows on the host.

The pure functions (`select_bucket`, `pack_requests`, `scatter_results`)
are the unit-test surface; `MicroBatcher` only adds the thread + clock.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .admission import (DeadlineExceededError, EngineStoppedError,
                        RequestTooLargeError)


@dataclass
class Request:
    """One queued inference request: unbatched args + its result future."""
    args: Tuple[object, ...]
    future: Future = field(default_factory=Future)
    enqueue_t: float = 0.0
    deadline_t: Optional[float] = None  # absolute monotonic seconds

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t

    def shape_class(self) -> tuple:
        """Requests pack together only when they agree on everything but
        the leading (seq) dim of each array arg."""
        sig = []
        for a in self.args:
            if hasattr(a, "shape") and getattr(a, "ndim", 0) >= 1:
                sig.append(("arr", tuple(a.shape[1:]), str(a.dtype)))
            else:
                sig.append(("scalar", type(a).__name__))
        return tuple(sig)


class RequestQueue:
    """Thread-safe bounded FIFO with a batching drain: block for the first
    request, then collect more until `max_n` or `max_wait_s` elapses."""

    def __init__(self, max_depth: int):
        self.max_depth = max_depth
        self._items: List[Request] = []
        self._cond = threading.Condition()

    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    def put(self, req: Request) -> bool:
        """False when full (caller raises QueueFullError — admission owns
        the policy; the queue only reports capacity)."""
        with self._cond:
            if len(self._items) >= self.max_depth:
                return False
            self._items.append(req)
            self._cond.notify()
            return True

    def drain(self, max_n: int, max_wait_s: float,
              stop: threading.Event,
              clock: Callable[[], float] = time.monotonic) -> List[Request]:
        """Up to `max_n` requests: waits (interruptibly) for the first,
        then keeps the window open `max_wait_s` for stragglers.  Returns
        [] when `stop` is set and the queue is empty."""
        with self._cond:
            while not self._items:
                if stop.is_set():
                    return []
                self._cond.wait(timeout=0.05)
            deadline = clock() + max_wait_s
            while len(self._items) < max_n and not stop.is_set():
                remaining = deadline - clock()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            got = self._items[:max_n]
            del self._items[:max_n]
            return got

    def drain_all(self) -> List[Request]:
        with self._cond:
            got, self._items = self._items, []
            return got


def select_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds every bucket."""
    fitting = [b for b in buckets if b >= n]
    return min(fitting) if fitting else None


@dataclass
class PackMeta:
    """Everything scatter needs to undo the packing."""
    n_real: int
    batch_bucket: int
    # per request: per arg, the original leading length (None for scalars
    # and for args that were not padded)
    orig_lens: List[Tuple[Optional[int], ...]]
    padded_lens: Tuple[Optional[int], ...]  # per arg, the bucketed length


def _pad_leading(arr: np.ndarray, target: int, pad_value) -> np.ndarray:
    if arr.shape[0] == target:
        return arr
    widths = [(0, target - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=pad_value)


def pack_requests(reqs: Sequence[Request],
                  batch_buckets: Sequence[int],
                  seq_buckets: Optional[Sequence[int]],
                  pad_value=0) -> Tuple[Tuple[np.ndarray, ...], PackMeta]:
    """Pad + stack same-shape-class requests into one bucketed batch.

    Raises RequestTooLargeError when the drained count exceeds the largest
    batch bucket (the batcher's drain cap should prevent this) or a seq
    length exceeds the largest seq bucket.  With `seq_buckets=None`, all
    requests must agree exactly on every arg shape (batch-only padding).
    """
    if not reqs:
        raise ValueError("pack_requests needs at least one request")
    n = len(reqs)
    batch_bucket = select_bucket(n, batch_buckets)
    if batch_bucket is None:
        raise RequestTooLargeError(
            f"{n} requests exceed the largest batch bucket "
            f"{max(batch_buckets)}")

    n_args = len(reqs[0].args)
    padded_lens: List[Optional[int]] = []
    for j in range(n_args):
        vals = [r.args[j] for r in reqs]
        if not (hasattr(vals[0], "shape") and getattr(vals[0], "ndim", 0) >= 1):
            if any(v != vals[0] for v in vals[1:]):
                raise ValueError(
                    f"scalar arg {j} differs across packed requests")
            padded_lens.append(None)
            continue
        lens = [int(v.shape[0]) for v in vals]
        if seq_buckets is None:
            if len(set(lens)) != 1:
                raise ValueError(
                    f"arg {j} has heterogeneous leading dims {sorted(set(lens))} "
                    f"but no seq_buckets are configured")
            padded_lens.append(None)
            continue
        target = select_bucket(max(lens), seq_buckets)
        if target is None:
            raise RequestTooLargeError(
                f"arg {j} length {max(lens)} exceeds the largest seq "
                f"bucket {max(seq_buckets)}")
        padded_lens.append(target)

    batched = []
    for j in range(n_args):
        if padded_lens[j] is None and not (
                hasattr(reqs[0].args[j], "shape")
                and getattr(reqs[0].args[j], "ndim", 0) >= 1):
            batched.append(reqs[0].args[j])  # shared scalar, not batched
            continue
        rows = []
        for r in reqs:
            a = np.asarray(r.args[j])
            if padded_lens[j] is not None:
                a = _pad_leading(a, padded_lens[j], pad_value)
            rows.append(a)
        # batch padding repeats the last real row: finite by construction
        rows.extend([rows[-1]] * (batch_bucket - n))
        batched.append(np.stack(rows, axis=0))

    orig_lens = []
    for r in reqs:
        row = []
        for j, a in enumerate(r.args):
            if padded_lens[j] is not None:
                row.append(int(a.shape[0]))
            else:
                row.append(None)
        orig_lens.append(tuple(row))
    meta = PackMeta(n_real=n, batch_bucket=batch_bucket,
                    orig_lens=orig_lens, padded_lens=tuple(padded_lens))
    return tuple(batched), meta


def _to_host(leaf):
    """One output leaf on the host: a numpy array, or a CPU tensor where
    numpy has no dtype for it (bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def scatter_results(outputs, meta: PackMeta,
                    unpad_outputs: bool = True) -> List[object]:
    """Split a batched output pytree back into per-request results.

    Every output leaf's leading axis is the batch; row i belongs to request
    i.  The leaves cross to the host once per batch (where the JAX package
    calls `jax.device_get`).  When un-padding, a row dim that equals a
    padded seq length is sliced back to that request's original length
    for that arg (arg 0 wins when several args share the padded length —
    the conventional "first arg is the sequence" layout)."""
    leaves, treedef = pytree.tree_flatten(outputs)
    leaves = [_to_host(leaf) for leaf in leaves]
    per_req: List[object] = []
    pad_targets = [(j, t) for j, t in enumerate(meta.padded_lens)
                   if t is not None]
    for i in range(meta.n_real):
        rows = []
        for leaf in leaves:
            row = leaf[i]
            if unpad_outputs and getattr(row, "ndim", 0) >= 1:
                for j, target in pad_targets:
                    if row.shape[0] == target \
                            and meta.orig_lens[i][j] is not None:
                        row = row[: meta.orig_lens[i][j]]
                        break
            rows.append(row)
        per_req.append(pytree.tree_unflatten(rows, treedef))
    return per_req


class MicroBatcher:
    """Background drain loop: queue -> groups by shape class -> executor.

    `execute(requests)` (the engine) owns padding, running, and resolving
    futures; the batcher owns timing, grouping, and deadline expiry so the
    engine never sees an expired request."""

    def __init__(self, queue: RequestQueue, execute, *,
                 max_batch_size: int, max_wait_ms: float,
                 metrics=None, clock: Callable[[], float] = time.monotonic):
        self.queue = queue
        self.execute = execute
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1e3
        self.metrics = metrics
        self.clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="easydist-serve-batcher",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        for req in self.queue.drain_all():
            if not req.future.done():
                req.future.set_exception(
                    EngineStoppedError("engine stopped before execution"))

    def expire(self, reqs: List[Request]) -> List[Request]:
        """Fail expired requests; return the still-live ones."""
        now = self.clock()
        live = []
        for r in reqs:
            if r.expired(now):
                if not r.future.done():
                    r.future.set_exception(DeadlineExceededError(
                        f"deadline expired {1e3 * (now - r.deadline_t):.1f}ms "
                        f"ago while queued"))
                if self.metrics is not None:
                    self.metrics.inc("requests_timed_out")
            else:
                live.append(r)
        return live

    def _loop(self):
        while not self._stop.is_set():
            reqs = self.queue.drain(self.max_batch_size, self.max_wait_s,
                                    self._stop, clock=self.clock)
            if self.metrics is not None:
                self.metrics.set_gauge("queue_depth", self.queue.depth())
            reqs = self.expire(reqs)
            if not reqs:
                continue
            # group by shape class, preserving arrival order within groups
            groups: dict = {}
            for r in reqs:
                groups.setdefault(r.shape_class(), []).append(r)
            for group in groups.values():
                try:
                    self.execute(group)
                except Exception as e:  # executor must not kill the loop
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)
