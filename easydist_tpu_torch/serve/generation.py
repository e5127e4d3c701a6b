"""Token-level decode serving: `GenerationSession` (port of
easydist_tpu/serve/generation.py, bucketed KV layout).

Continuous batching over a cache-carrying model
(models/gpt.py::gpt_prefill_chunk / gpt_decode_step):

  * **chunked, batched prefill** — each admitted prompt runs in fixed
    [prefill_batch, prefill_chunk] windows against a multi-row staging
    cache, so ONE compiled prefill signature per bucket serves every
    prompt length, and up to `prefill_batch` pending prompts share each
    chunk call;
  * **prefix-reuse KV cache** — finished prefills commit their aligned
    KV chunks into a per-bucket token trie (serve/prefix_cache.py);
    admission restores the longest cached whole-chunk prefix and resumes
    prefill at `prefix_len` instead of 0.  Restored and recomputed KV are
    the same numbers, so the cache never changes the output ids;
  * **bounded prefill pressure** — `step()` runs at most
    `prefill_chunks_per_step` chunk calls before the decode rounds;
  * **bucketed KV pool + one compiled decode step** — one slot pool per
    `ServeConfig.decode_buckets` entry, decode always steps ALL slots,
    slots recycle through a free list;
  * **caches updated in place** — pool and staging are positional arg 0
    and output 0 of every program that changes them, so
    `infer_state_io` pairs them, and the programs write them in place
    (where the JAX package donates the buffers to XLA).

Every program goes through the port's `easydist_compile`.  Greedy
decoding: the argmax runs inside the compiled step, so only int32 ids
cross to the host per token.

Not ported yet (ROADMAP.md lists each): the paged layout, speculative
decoding, the host tier, fleet export/import and drain migration, the
`analyze` audits, the `faultinject` points, and the one-shot
(non-chunked) prefill path.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import resolve_device
from easydist_tpu_torch.fxfront import easydist_compile

from .admission import ReplicaDrainingError, RequestTooLargeError
from .batcher import select_bucket
from .engine import ServeConfig
from .metrics import ServeMetrics
from .prefix_cache import PrefixCache

# process-level memo of compiled programs, keyed by `compile_key`.  Every
# program is pure over its arguments (cache, params and tokens all cross
# as arguments), so sessions over the same model share traces.
_COMPILED_MEMO: Dict[object, tuple] = {}


@dataclass
class _Slot:
    """Host-side view of one pooled decode row."""
    request_id: int
    future: Future
    pos: int                      # next cache write position
    token: int                    # last generated token (not yet in cache)
    max_new: int
    eos_id: Optional[int]
    generated: List[int] = field(default_factory=list)
    pinned: List[object] = field(default_factory=list)  # trie nodes held
    prompt: List[int] = field(default_factory=list)


@dataclass
class _PrefillJob:
    """One prompt mid-prefill: owns a staging row and a reserved pool
    slot; `start` advances one chunk per batched chunk call."""
    request_id: int
    future: Future
    prompt: List[int]
    max_new: int
    eos_id: Optional[int]
    row: int                      # staging row
    slot_idx: int                 # reserved pool slot
    start: int                    # next chunk start (multiple of chunk)
    prefix_nodes: List[object]    # trie nodes restored (pinned)
    t_submit: float


class _BucketPool:
    """One decode bucket: pooled cache + free-list slot allocator +
    multi-row staging cache shared by the chunked-prefill scheduler +
    the bucket's prefix trie."""

    def __init__(self, bucket: int, n_slots: int, init_cache, n_rows: int,
                 chunk: int, prefix_bytes: int):
        self.bucket = bucket
        self.n_slots = n_slots
        self.cache = init_cache(n_slots, bucket)
        self.n_rows = n_rows
        self.staging = init_cache(n_rows, bucket)
        self.chunk = chunk
        self.free: List[int] = list(range(n_slots))
        self.slots: Dict[int, _Slot] = {}          # slot index -> _Slot
        self.free_rows: List[int] = list(range(n_rows))
        self.jobs: Dict[int, _PrefillJob] = {}     # staging row -> job
        self.trie: Optional[PrefixCache] = \
            PrefixCache(chunk, prefix_bytes) if prefix_bytes else None

    @property
    def n_active(self) -> int:
        return len(self.slots)


# ---------------------------------------------------- cache programs
#
# Row, slot and start indices cross as int32 tensors (a Python int would
# be baked into the trace).  Each clamps into range the way
# `jax.lax.dynamic_update_slice` / `dynamic_slice` clamp their starts.


def _index1(i, hi: int):
    """A 0-d int index tensor as a clamped int64 [1] index."""
    return i.long().reshape(1).clamp(0, hi)


def _window(start, length: int, total: int):
    """Positions [start, start + length) with start clamped to fit."""
    s = start.long().clamp(0, total - length)
    return s + torch.arange(length, device=start.device)


def _restore(staging, chunk_kv, row, start):
    """Write one committed chunk {"k","v"} [layers, heads, chunk, hd] into
    staging row `row` at `start`, in place."""
    for k in ("k", "v"):
        _, rows, _, t, _ = staging[k].shape
        c = chunk_kv[k].shape[2]
        # advanced indices on dims 1 and 3 put [c] first: [c, L, h, hd]
        staging[k][:, _index1(row, rows - 1), :, _window(start, c, t)] = \
            chunk_kv[k].permute(2, 0, 1, 3).to(staging[k].dtype)
    return staging


def _migrate(pool, staging, row, slot):
    """Copy staging row `row` into pool slot `slot`, in place."""
    for k in ("k", "v"):
        pool[k][:, _index1(slot, pool[k].shape[1] - 1)] = \
            staging[k][:, _index1(row, staging[k].shape[1] - 1)].to(
                pool[k].dtype)
    return pool


def _extract_program(chunk_len: int):
    """Program copying `chunk_len` positions of one staging row out as a
    committed chunk {"k","v"} [layers, heads, chunk, hd] — a copy, so the
    trie never aliases the staging cache the next chunk call rewrites."""
    def _extract(staging, row, start):
        out = {}
        for k in ("k", "v"):
            _, rows, _, t, _ = staging[k].shape
            blk = staging[k][:, _index1(row, rows - 1), :,
                             _window(start, chunk_len, t)]  # [c, L, h, hd]
            out[k] = blk.permute(1, 2, 0, 3).contiguous()
        return out

    return _extract


class GenerationSession:
    """Continuous-batching token generation over a cache-carrying model.

    model_prefill_chunk(params, cache, tokens, start_pos, lengths)
        -> (cache, logits) — fixed-chunk window at absolute positions
    model_decode(params, cache, token, pos) -> (cache, logits)
    init_cache(batch, max_len, dtype=None) -> cache {"k", "v"}

    Both model functions write `cache` in place and return it.  `submit`
    returns a Future resolving to {"ids": [...generated ids...],
    "finish_reason": "eos"|"length"|"bucket_full"}; drive with `step()`
    (admit + bounded prefill chunks + decode + harvest) or
    `run_until_drained()`.  Host tensors are staged to `device`.

    `compile_key` (any hashable; `for_gpt` derives one from the model
    config and device) opts the session into the process-level memo of
    compiled programs, shared with other sessions of the same key.
    """

    def __init__(self, params, *, model_prefill_chunk: Callable,
                 model_decode: Callable, init_cache: Callable,
                 device=None, config: Optional[ServeConfig] = None,
                 eos_id: Optional[int] = None,
                 max_prompt_len: Optional[int] = None,
                 compile_key: Optional[object] = None):
        self.config = config or ServeConfig()
        if max_prompt_len is not None:
            bad = [b for b in self.config.decode_buckets
                   if b > max_prompt_len]
            if bad:
                raise ValueError(
                    f"decode_buckets {bad} exceed the model's maximum "
                    f"sequence length {max_prompt_len}; set "
                    f"ServeConfig(decode_buckets=...) within it")
        self.params = params
        self.device = resolve_device(device)
        self.eos_id = eos_id
        self.metrics = ServeMetrics()
        self._closed = False
        self._init_cache = init_cache
        self._pending: collections.deque = collections.deque()
        self._pools: Dict[int, _BucketPool] = {}
        self._next_request_id = 0

        def _prefill_chunk(staging, params, tokens, start, lengths):
            staging, logits = model_prefill_chunk(params, staging, tokens,
                                                  start, lengths)
            return staging, torch.argmax(logits, dim=-1).to(torch.int32)

        def _decode(pool, params, token, pos):
            pool, logits = model_decode(params, pool, token, pos)
            return pool, torch.argmax(logits, dim=-1).to(torch.int32)

        shared = _COMPILED_MEMO.get(compile_key) \
            if compile_key is not None else None
        if shared is None:
            shared = (easydist_compile(_prefill_chunk),
                      easydist_compile(_restore),
                      easydist_compile(_migrate),
                      easydist_compile(_decode), {})
            if compile_key is not None:
                while len(_COMPILED_MEMO) >= 32:  # live sessions keep refs
                    _COMPILED_MEMO.pop(next(iter(_COMPILED_MEMO)))
                _COMPILED_MEMO[compile_key] = shared
        (self._prefill_chunk_c, self._restore_c, self._migrate_c,
         self._decode_c, self._extract_cs) = shared

    def _extract_for(self, chunk_len: int) -> Callable:
        """Compiled chunk extractor for one chunk size (the slice size is
        static, so each chunk length is its own program)."""
        fn = self._extract_cs.get(chunk_len)
        if fn is None:
            fn = easydist_compile(_extract_program(chunk_len))
            self._extract_cs[chunk_len] = fn
        return fn

    def _tensor(self, x) -> torch.Tensor:
        """Host ints / int32 arrays as int32 tensors on the device."""
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    # ------------------------------------------------------------ admission
    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Future:
        """Queue one prompt; generation interleaves with every other live
        request (continuous batching) as `step()` is driven."""
        if self._closed:
            raise ReplicaDrainingError(
                "session is closed: nothing new is admitted")
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if select_bucket(len(prompt) + 1, self.config.decode_buckets) is None:
            raise RequestTooLargeError(
                f"prompt of {len(prompt)} tokens does not fit any decode "
                f"bucket {self.config.decode_buckets} with room to "
                f"generate")
        fut = Future()
        self._pending.append(
            (prompt, max_new_tokens,
             self.eos_id if eos_id is None else eos_id, fut,
             time.perf_counter()))
        self.metrics.inc("requests_submitted")
        self.metrics.set_gauge("queue_depth", self.queue_depth)
        return fut

    @property
    def queue_depth(self) -> int:
        """Live requests this session owns: queued + prefilling +
        decoding."""
        return len(self._pending) + sum(
            len(p.jobs) + p.n_active for p in self._pools.values())

    # ------------------------------------------------------------- plumbing
    def _pool_for(self, bucket: int) -> _BucketPool:
        pool = self._pools.get(bucket)
        if pool is None:
            cfg = self.config
            pool = _BucketPool(
                bucket, cfg.max_decode_slots, self._cache_factory,
                n_rows=cfg.prefill_batch,
                chunk=min(cfg.prefill_chunk, bucket),
                prefix_bytes=(cfg.prefix_cache_bytes
                              if cfg.enable_prefix_cache else 0))
            self._pools[bucket] = pool
        return pool

    def _cache_factory(self, batch: int, max_len: int):
        dtype = self.config.kv_cache_dtype
        return self._init_cache(batch, max_len,
                                None if dtype == "auto" else dtype)

    def _admit_one(self) -> bool:
        """Pop one pending request toward generation: reserve a pool slot
        and a staging row, restore the longest cached prefix, and enqueue
        a prefill job (its chunks run in `step()`).  Returns False when
        nothing is admissible."""
        if not self._pending:
            return False
        prompt, max_new, eos, fut, t_submit = self._pending[0]
        bucket = select_bucket(len(prompt) + 1, self.config.decode_buckets)
        pool = self._pool_for(bucket)
        if not pool.free or not pool.free_rows:
            return False
        self._pending.popleft()
        if fut.set_running_or_notify_cancel() is False:
            return True  # cancelled while queued; slot stays free
        slot_idx = pool.free.pop()
        row = pool.free_rows.pop()
        prefix_len, nodes = 0, []
        if pool.trie is not None:
            # cap below len(prompt): at least one real token must run
            # through prefill so the finishing chunk produces logits
            prefix_len, nodes = pool.trie.match(
                prompt, max_tokens=len(prompt) - 1)
            for j, node in enumerate(nodes):
                pool.staging = self._restore_c(
                    pool.staging, node.kv, self._tensor(row),
                    self._tensor(j * pool.chunk))
            pool.trie.pin(nodes)
        self.metrics.record_admission(len(prompt), prefix_len)
        pool.jobs[row] = _PrefillJob(
            request_id=self._next_request_id, future=fut,
            prompt=prompt, max_new=max_new, eos_id=eos, row=row,
            slot_idx=slot_idx, start=prefix_len,
            prefix_nodes=nodes, t_submit=t_submit)
        self._next_request_id += 1
        return True

    # ----------------------------------------------------- chunked prefill
    def _prefill_round(self, pool: _BucketPool, max_chunks: int) -> int:
        """Run up to `max_chunks` batched chunk calls on `pool`'s staging
        rows; finished jobs commit to the trie, migrate to their slot, and
        free their row.  Returns the number of chunk calls executed."""
        calls = 0
        c_len = pool.chunk
        while pool.jobs and calls < max_chunks:
            tokens = np.full((pool.n_rows, c_len),
                             int(self.config.pad_value), np.int32)
            start = np.zeros((pool.n_rows,), np.int32)
            lengths = np.ones((pool.n_rows,), np.int32)
            for row, job in pool.jobs.items():
                seg = job.prompt[job.start:job.start + c_len]
                tokens[row, :len(seg)] = seg
                start[row] = job.start
                lengths[row] = len(job.prompt)
            args = (pool.staging, self.params, self._tensor(tokens),
                    self._tensor(start), self._tensor(lengths))
            result = self._prefill_chunk_c.get_compiled(*args)
            t0 = time.perf_counter()
            pool.staging, first = result.tree_jitted(*args)
            first = first.cpu().numpy()
            self.metrics.record_prefill_chunk(
                pool.n_rows, c_len, time.perf_counter() - t0)
            calls += 1
            for row in list(pool.jobs):
                job = pool.jobs[row]
                job.start += c_len
                if job.start >= len(job.prompt):
                    self._finish_prefill(pool, row, int(first[row]))
        return calls

    def _finish_prefill(self, pool: _BucketPool, row: int,
                        first_token: int) -> None:
        """One job's last chunk ran: commit its aligned chunks into the
        trie, migrate the staging row into the reserved pool slot, free
        the row, and open the decode slot."""
        job = pool.jobs.pop(row)
        pinned = list(job.prefix_nodes)
        if pool.trie is not None:
            nodes = list(job.prefix_nodes)
            for j in range(len(nodes), len(job.prompt) // pool.chunk):
                chunk_toks = job.prompt[j * pool.chunk:(j + 1) * pool.chunk]
                node = pool.trie.lookup_node(nodes, chunk_toks)
                if node is None:
                    kv = self._extract_for(pool.chunk)(
                        pool.staging, self._tensor(row),
                        self._tensor(j * pool.chunk))
                    node = pool.trie.commit(nodes, chunk_toks, kv)
                if node is None:
                    break  # byte budget exhausted; partial path is fine
                nodes.append(node)
            # hold the full committed path for the slot's lifetime
            pool.trie.unpin(job.prefix_nodes)
            pool.trie.pin(nodes)
            pinned = nodes
        pool.cache = self._migrate_c(pool.cache, pool.staging,
                                     self._tensor(row),
                                     self._tensor(job.slot_idx))
        pool.free_rows.append(row)
        self.metrics.observe("ttft", time.perf_counter() - job.t_submit)

        slot = _Slot(request_id=job.request_id, future=job.future,
                     pos=len(job.prompt), token=first_token,
                     max_new=job.max_new, eos_id=job.eos_id,
                     pinned=pinned, prompt=job.prompt)
        slot.generated.append(slot.token)
        pool.slots[job.slot_idx] = slot
        self._maybe_retire(pool, job.slot_idx)

    # ------------------------------------------------------------- decoding
    def _retire(self, pool: _BucketPool, slot_idx: int, reason: str) -> None:
        slot = pool.slots.pop(slot_idx)
        pool.free.append(slot_idx)
        if pool.trie is not None and slot.pinned:
            pool.trie.unpin(slot.pinned)
        slot.future.set_result({"ids": list(slot.generated),
                                "finish_reason": reason})
        self.metrics.inc("requests_completed")

    def _maybe_retire(self, pool: _BucketPool, slot_idx: int) -> bool:
        slot = pool.slots[slot_idx]
        if slot.eos_id is not None and slot.token == slot.eos_id:
            self._retire(pool, slot_idx, "eos")
        elif len(slot.generated) >= slot.max_new:
            self._retire(pool, slot_idx, "length")
        elif slot.pos >= pool.bucket:
            self._retire(pool, slot_idx, "bucket_full")
        else:
            return False
        return True

    def _decode_round(self, pool: _BucketPool) -> None:
        """One compiled decode step over ALL slots of `pool` (fixed
        shapes: the signature cache stays at one entry per bucket).  Free
        slots decode a dummy token at position 0 (length 1) and their
        output is dropped."""
        live = list(pool.slots)
        token = np.zeros((pool.n_slots,), np.int32)
        pos = np.zeros((pool.n_slots,), np.int32)
        for idx in live:
            token[idx] = pool.slots[idx].token
            pos[idx] = pool.slots[idx].pos
        args = (pool.cache, self.params, self._tensor(token),
                self._tensor(pos))
        result = self._decode_c.get_compiled(*args)
        t0 = time.perf_counter()
        pool.cache, nxt = result.tree_jitted(*args)
        nxt = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        for idx in live:
            slot = pool.slots[idx]
            slot.token = int(nxt[idx])
            slot.pos += 1
            slot.generated.append(slot.token)
            self._maybe_retire(pool, idx)
        self.metrics.record_decode_step(len(live), pool.n_slots, dt)

    # ------------------------------------------------------------- driving
    def step(self) -> int:
        """One serving round: admit pending prompts into free slots/rows,
        run at most `prefill_chunks_per_step` prefill chunk calls, then
        one decode step per bucket with live slots, harvesting
        retirements.  Returns the number of tokens generated this round
        (decode tokens; prefill first-tokens count via `prefills`)."""
        while self._admit_one():
            pass
        budget = self.config.prefill_chunks_per_step
        for pool in self._pools.values():
            if budget <= 0:
                break
            if pool.jobs:
                budget -= self._prefill_round(pool, budget)
        before = self.metrics.counter("tokens_generated")
        for pool in self._pools.values():
            if pool.slots:
                self._decode_round(pool)
        self.metrics.set_gauge("queue_depth", self.queue_depth)
        return self.metrics.counter("tokens_generated") - before

    def run_until_drained(self, max_steps: int = 100000) -> None:
        """Drive `step()` until no request is live or queued."""
        for _ in range(max_steps):
            if self.is_drained:
                return
            self.step()
        raise RuntimeError(f"not drained after {max_steps} steps")

    @property
    def is_drained(self) -> bool:
        """No queued, prefilling, or decoding work left."""
        return not self._pending and not any(
            p.slots or p.jobs for p in self._pools.values())

    def close(self) -> None:
        """Finish every queued and live request, then release the pooled
        device caches.  Idempotent; every submit afterwards raises
        `ReplicaDrainingError`."""
        if self._closed:
            return
        self.run_until_drained()
        self._closed = True
        self._pools.clear()

    # ----------------------------------------------------------- reporting
    def stats(self) -> Dict[str, object]:
        return {
            "queue_depth": self.queue_depth,
            "pending": len(self._pending),
            "buckets": {
                b: {"active": p.n_active, "free": len(p.free),
                    "prefilling": len(p.jobs),
                    "free_rows": len(p.free_rows),
                    "prefix_cache": (p.trie.stats() if p.trie else None)}
                for b, p in self._pools.items()},
            "decode_signatures": self._decode_c.cache_stats(),
            "prefill_signatures": self._prefill_chunk_c.cache_stats(),
            "migrate_signatures": self._migrate_c.cache_stats(),
            "metrics": self.metrics.snapshot(),
        }

    # --------------------------------------------------------- constructors
    @classmethod
    def for_gpt(cls, params, cfg, *, device=None, **kw):
        """Session over models/gpt.py on `device` (default: the card),
        where `params` must already live.  decode_buckets must fit
        cfg.seq (the learned-position-table bound)."""
        from easydist_tpu_torch.models import gpt

        device = resolve_device(device)
        want = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        where = {t.device for t in pytree.tree_leaves(params)}
        if where != {want}:
            raise ValueError(f"params live on {sorted(map(str, where))}, the "
                             f"session runs on {want}; place them there "
                             f"first")
        kw.setdefault("compile_key",
                      ("gpt", dataclasses.astuple(cfg), str(device)))
        return cls(
            params,
            model_prefill_chunk=lambda p, c, t, s, l: gpt.gpt_prefill_chunk(
                p, cfg, c, t, s, l),
            model_decode=lambda p, c, t, pos: gpt.gpt_decode_step(
                p, cfg, c, t, pos),
            init_cache=lambda b, L, dt=None: gpt.init_kv_cache(
                cfg, b, L, dtype=dt, device=device),
            device=device, max_prompt_len=cfg.seq, **kw)

