"""Token-level decode serving: `GenerationSession` (port of
easydist_tpu/serve/generation.py, bucketed and paged KV layouts).

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
  * **paged KV pool** (`ServeConfig.kv_layout="paged"`) — every bucket
    collapses into ONE page-granular pool over a preallocated arena
    (kv/pool.py + kv/table.py): sequences of any length share one
    compiled decode step (the int32 page table, fixed [max_slots,
    max_pages], is the only per-step state that varies), a restored
    prefix is table entries pointing at trie-committed pages (zero
    copies), and prefill writes arena pages directly through the table
    (no staging cache, no migrate).  Admission reserves every page a
    sequence can touch up front; `kv.audit_page_table` checks the
    refcount/table bookkeeping at the first decode and at every retire.
    `kv_quant_dtype="int8"` stores the arena block-scaled int8;
  * **caches updated in place** — pool, staging and arena are positional
    arg 0 and output 0 of every program that changes them, so
    `infer_state_io` pairs them, and the programs write them in place
    (where the JAX package donates the buffers to XLA).

Every program goes through the port's `easydist_compile`.  Greedy
decoding: the argmax runs inside the compiled step, so only int32 ids
cross to the host per token.

Not ported yet (ROADMAP.md lists each): speculative decoding, the host
tier, fleet export/import and drain migration, the `analyze` audits
other than the page-table one, the `faultinject` points, and the
one-shot (non-chunked) prefill path.
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
from easydist_tpu_torch.kv import (PagePool, PageTable, audit_page_table,
                                   is_page_ref)

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


class _PagedPool:
    """The paged layout's single pool: one preallocated page arena, a
    refcounted page allocator, and a fixed [n_slots, max_pages] page
    table shared by every request whatever its length (`bucket` is the
    capacity cap — max(decode_buckets) — not a padding granularity).
    Prefill jobs write arena pages directly through the table, so there
    is no staging cache and no migrate; a restored prefix is table
    entries pointing at trie-committed pages (zero-copy)."""

    def __init__(self, bucket: int, n_slots: int, init_pages,
                 n_rows: int, chunk: int, prefix_bytes: int,
                 n_pages: int, model_itemsize: int = 0):
        self.bucket = bucket
        self.n_slots = n_slots
        self.chunk = chunk                       # page_tokens
        self.max_pages = bucket // chunk
        if n_pages < self.max_pages:
            raise ValueError(
                f"kv_arena_pages {n_pages} cannot hold even one "
                f"full-length sequence ({self.max_pages} pages)")
        self.n_rows = n_rows
        self.arena = init_pages(n_pages, chunk)
        # bytes of one page across the arena's STORAGE leaves (int8
        # payload + f32 scales when quantized); the drop page past the
        # n_pages allocatable ones is not counted
        self.page_bytes = sum(t[:, 0].numel() * t.element_size()
                              for t in self.arena.values())
        # what one page's k/v payload would cost at model precision — the
        # baseline the quant-savings gauge subtracts from
        payload = sum(self.arena[k][:, 0].numel() for k in ("k", "v"))
        self.model_page_bytes = payload * model_itemsize \
            if model_itemsize else self.page_bytes
        self.pool = PagePool(n_pages, chunk, page_bytes=self.page_bytes)
        self.table = PageTable(n_slots, self.max_pages, n_pages)
        self.free: List[int] = list(range(n_slots))
        self.slots: Dict[int, _Slot] = {}
        self.free_rows: List[int] = list(range(n_rows))
        self.jobs: Dict[int, _PrefillJob] = {}
        self.trie: Optional[PrefixCache] = \
            PrefixCache(chunk, prefix_bytes, on_evict=self._release_evicted) \
            if prefix_bytes else None

    def _release_evicted(self, node) -> None:
        # trie eviction drops the trie's hold on the node's arena page;
        # the page frees only when no live slot still maps it
        self.pool.release(node.kv["page"])

    @property
    def n_active(self) -> int:
        return len(self.slots)

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages one sequence touches: prefill writes
        ceil(prompt/chunk) whole pages, decode up to `max_new - 1` more
        positions, everything capped at the bucket (retirement fires at
        pos >= bucket)."""
        cap = min(self.bucket, prompt_len + max_new)
        return -(-cap // self.chunk)

    def make_room(self, n_pages: int) -> bool:
        """Free arena pages until `n_pages` are available, evicting
        unpinned trie nodes LRU-first (an eviction frees a page only when
        no live slot shares it).  Returns availability."""
        if self.trie is not None:
            while self.pool.n_free < n_pages:
                if not self.trie.evict_lru():
                    break
        return self.pool.n_free >= n_pages

    def occupancy(self):
        """(pages_in_use, real tokens held) for the kv gauges: slots
        hold `pos` cached tokens, jobs `start` (restored + prefilled so
        far), trie-only pages a whole chunk each; reserved-but-unwritten
        pages count capacity only — that gap is the fragmentation the
        `kv_page_utilization` gauge measures."""
        tokens = sum(min(s.pos, self.bucket) for s in self.slots.values())
        tokens += sum(j.start for j in self.jobs.values())
        if self.trie is not None:
            mapped = set()
            for idx in self.slots:
                mapped.update(self.table.mapped(idx))
            for job in self.jobs.values():
                mapped.update(self.table.mapped(job.slot_idx))
            for node in self.trie._walk():
                if is_page_ref(node.kv) and node.kv["page"] not in mapped:
                    mapped.add(node.kv["page"])
                    tokens += self.chunk
        return self.pool.in_use, tokens


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
    and, for `kv_layout="paged"`:
    model_prefill_chunk_paged(params, arena, table, tokens, start_pos,
        lengths) -> (arena, logits)
    model_decode_paged(params, arena, table, token, pos)
        -> (arena, logits)
    init_pages(n_pages, page_tokens, dtype=None, **quant) -> arena

    The model functions write `cache` / `arena` in place and return it.
    `submit`
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
                 model_prefill_chunk_paged: Optional[Callable] = None,
                 model_decode_paged: Optional[Callable] = None,
                 init_pages: Optional[Callable] = None,
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
        self._paged = self.config.kv_layout == "paged"
        if self._paged and (model_prefill_chunk_paged is None
                            or model_decode_paged is None
                            or init_pages is None):
            raise ValueError(
                "kv_layout='paged' requires model_prefill_chunk_paged, "
                "model_decode_paged, and init_pages (the for_gpt "
                "constructor wires all three)")
        self._init_pages = init_pages
        self._pending: collections.deque = collections.deque()
        self._pools: Dict[int, object] = {}
        self._next_request_id = 0
        self._audited: set = set()

        def _prefill_chunk(staging, params, tokens, start, lengths):
            staging, logits = model_prefill_chunk(params, staging, tokens,
                                                  start, lengths)
            return staging, torch.argmax(logits, dim=-1).to(torch.int32)

        def _decode(pool, params, token, pos):
            pool, logits = model_decode(params, pool, token, pos)
            return pool, torch.argmax(logits, dim=-1).to(torch.int32)

        # paged programs: the arena first, so it pairs as state; the
        # int32 page table crosses as data every call (fixed shape — the
        # signature stays closed over every per-row length).  Traced on
        # first use via `_paged_c`, so bucketed sessions never pay.
        def _prefill_chunk_paged(arena, params, table, tokens, start,
                                 lengths):
            arena, logits = model_prefill_chunk_paged(
                params, arena, table, tokens, start, lengths)
            return arena, torch.argmax(logits, dim=-1).to(torch.int32)

        def _decode_paged(arena, params, table, token, pos):
            arena, logits = model_decode_paged(params, arena, table, token,
                                               pos)
            return arena, torch.argmax(logits, dim=-1).to(torch.int32)

        self._paged_defs = ({"chunk": _prefill_chunk_paged,
                             "decode": _decode_paged}
                            if model_prefill_chunk_paged is not None else {})

        shared = _COMPILED_MEMO.get(compile_key) \
            if compile_key is not None else None
        if shared is None:
            shared = (easydist_compile(_prefill_chunk),
                      easydist_compile(_restore),
                      easydist_compile(_migrate),
                      easydist_compile(_decode), {}, {})
            if compile_key is not None:
                while len(_COMPILED_MEMO) >= 32:  # live sessions keep refs
                    _COMPILED_MEMO.pop(next(iter(_COMPILED_MEMO)))
                _COMPILED_MEMO[compile_key] = shared
        (self._prefill_chunk_c, self._restore_c, self._migrate_c,
         self._decode_c, self._extract_cs, self._paged_cs) = shared

    def _extract_for(self, chunk_len: int) -> Callable:
        """Compiled chunk extractor for one chunk size (the slice size is
        static, so each chunk length is its own program)."""
        fn = self._extract_cs.get(chunk_len)
        if fn is None:
            fn = easydist_compile(_extract_program(chunk_len))
            self._extract_cs[chunk_len] = fn
        return fn

    def _paged_c(self, name: str) -> Callable:
        """Compiled paged program ("chunk" / "decode"), built on first use
        and shared through the process memo like `_extract_for`."""
        fn = self._paged_cs.get(name)
        if fn is None:
            fn = easydist_compile(self._paged_defs[name])
            self._paged_cs[name] = fn
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
    def _pool_for(self, bucket: int):
        cfg = self.config
        if self._paged:
            # every bucket collapses into the one page-granular pool:
            # lengths are a page-table concern, not a signature concern
            bucket = max(cfg.decode_buckets)
        pool = self._pools.get(bucket)
        if pool is None:
            prefix_bytes = (cfg.prefix_cache_bytes
                            if cfg.enable_prefix_cache else 0)
            if self._paged:
                chunk = cfg.kv_page_tokens or min(cfg.prefill_chunk, bucket)
                n_pages = cfg.kv_arena_pages or \
                    (cfg.max_decode_slots + 1) * (bucket // chunk)
                pool = _PagedPool(
                    bucket, cfg.max_decode_slots, self._pages_factory,
                    n_rows=cfg.prefill_batch, chunk=chunk,
                    prefix_bytes=prefix_bytes, n_pages=n_pages,
                    model_itemsize=self._model_itemsize())
            else:
                pool = _BucketPool(
                    bucket, cfg.max_decode_slots, self._cache_factory,
                    n_rows=cfg.prefill_batch,
                    chunk=min(cfg.prefill_chunk, bucket),
                    prefix_bytes=prefix_bytes)
            self._pools[bucket] = pool
        return pool

    def _cache_factory(self, batch: int, max_len: int):
        dtype = self.config.kv_cache_dtype
        return self._init_cache(batch, max_len,
                                None if dtype == "auto" else dtype)

    def _pages_factory(self, n_pages: int, page_tokens: int):
        cfg = self.config
        dtype = None if cfg.kv_cache_dtype == "auto" else cfg.kv_cache_dtype
        if cfg.kv_quant_dtype != "none":
            return self._init_pages(n_pages, page_tokens, dtype,
                                    quant_dtype=cfg.kv_quant_dtype,
                                    quant_block=cfg.kv_quant_block)
        return self._init_pages(n_pages, page_tokens, dtype)

    def _model_itemsize(self) -> int:
        """Bytes per element at model precision (first param leaf) — the
        baseline `kv_quant_bytes_saved` subtracts the arena's storage
        cost from."""
        leaves = pytree.tree_leaves(self.params)
        return leaves[0].element_size() if leaves else 0

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
        if self._paged:
            return self._admit_one_paged(pool)
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

    def _admit_one_paged(self, pool: _PagedPool) -> bool:
        """Paged admission: reserve EVERY page the sequence can touch up
        front (a decode step crossing into a page must find it mapped — a
        sentinel there would send the token's K/V to the drop page),
        mapping the trie's committed prefix pages in place of the
        bucketed layout's restore copies.  Defers (returns False, the
        request stays queued) when the arena cannot make room."""
        prompt, max_new, eos, fut, t_submit = self._pending[0]
        prefix_len, nodes = 0, []
        if pool.trie is not None:
            # cap below len(prompt): at least one real token must run
            # through prefill so the finishing chunk produces logits
            prefix_len, nodes = pool.trie.match(
                prompt, max_tokens=len(prompt) - 1)
            pool.trie.pin(nodes)  # survive make_room's evictions
        n_need = pool.pages_needed(len(prompt), max_new)
        if not pool.make_room(n_need - len(nodes)):
            if pool.trie is not None:
                pool.trie.unpin(nodes)
            return False
        self._pending.popleft()
        if fut.set_running_or_notify_cancel() is False:
            if pool.trie is not None:
                pool.trie.unpin(nodes)
            return True  # cancelled while queued; nothing reserved yet
        slot_idx = pool.free.pop()
        row = pool.free_rows.pop()
        # zero-copy restore: the slot's leading windows point at the
        # trie's pages (shared, never written — writes land past the
        # prefix); the bucketed layout copies these bytes into staging
        for j, node in enumerate(nodes):
            pid = node.kv["page"]
            pool.pool.share(pid)
            pool.table.map(slot_idx, j, pid)
        for j in range(len(nodes), n_need):
            pool.table.map(slot_idx, j, pool.pool.alloc())
        if nodes:
            self.metrics.record_copy_on_restore_saved(
                len(nodes) * pool.page_bytes)
        self.metrics.record_admission(len(prompt), prefix_len)
        pool.jobs[row] = _PrefillJob(
            request_id=self._next_request_id, future=fut, prompt=prompt,
            max_new=max_new, eos_id=eos, row=row, slot_idx=slot_idx,
            start=prefix_len, prefix_nodes=nodes, t_submit=t_submit)
        self._next_request_id += 1
        return True

    # ----------------------------------------------------- chunked prefill
    def _prefill_round(self, pool, max_chunks: int) -> int:
        """Run up to `max_chunks` batched chunk calls on `pool`'s staging
        rows; finished jobs commit to the trie, migrate to their slot, and
        free their row.  Returns the number of chunk calls executed."""
        if self._paged:
            return self._prefill_round_paged(pool, max_chunks)
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

    def _prefill_round_paged(self, pool: _PagedPool,
                             max_chunks: int) -> int:
        """Paged `_prefill_round`: each chunk writes straight into the
        arena through the job's table row (no staging, no migrate, and a
        restored prefix needed no copy to begin with).  Idle rows get an
        all-sentinel table row, so their writes land in the drop page and
        their logits are garbage nobody reads — one traced signature
        whichever rows are live."""
        calls = 0
        c_len = pool.chunk
        while pool.jobs and calls < max_chunks:
            tokens = np.full((pool.n_rows, c_len),
                             int(self.config.pad_value), np.int32)
            start = np.zeros((pool.n_rows,), np.int32)
            lengths = np.ones((pool.n_rows,), np.int32)
            tbl = np.full((pool.n_rows, pool.max_pages),
                          pool.pool.sentinel, np.int32)
            for row, job in pool.jobs.items():
                seg = job.prompt[job.start:job.start + c_len]
                tokens[row, :len(seg)] = seg
                start[row] = job.start
                lengths[row] = len(job.prompt)
                tbl[row] = pool.table.array[job.slot_idx]
            args = (pool.arena, self.params, self._tensor(tbl),
                    self._tensor(tokens), self._tensor(start),
                    self._tensor(lengths))
            result = self._paged_c("chunk").get_compiled(*args)
            t0 = time.perf_counter()
            pool.arena, first = result.tree_jitted(*args)
            first = first.cpu().numpy()
            self.metrics.record_prefill_chunk(
                pool.n_rows, c_len, time.perf_counter() - t0)
            calls += 1
            for row in list(pool.jobs):
                job = pool.jobs[row]
                job.start += c_len
                if job.start >= len(job.prompt):
                    self._finish_prefill_paged(pool, row, int(first[row]))
        return calls

    def _finish_prefill_paged(self, pool: _PagedPool, row: int,
                              first_token: int) -> None:
        """One paged job's last chunk ran: commit its whole-chunk pages
        into the trie as page REFERENCES (share + {"page": id} — no
        extraction copy), free the row, open the decode slot."""
        job = pool.jobs.pop(row)
        pinned = list(job.prefix_nodes)
        if pool.trie is not None:
            nodes = list(job.prefix_nodes)
            for j in range(len(nodes), len(job.prompt) // pool.chunk):
                chunk_toks = job.prompt[j * pool.chunk:(j + 1) * pool.chunk]
                node = pool.trie.lookup_node(nodes, chunk_toks)
                if node is None:
                    pid = int(pool.table.array[job.slot_idx, j])
                    pool.pool.share(pid)       # the trie's hold
                    node = pool.trie.commit(nodes, chunk_toks,
                                            {"page": pid},
                                            nbytes=pool.page_bytes)
                    if node is None:
                        pool.pool.release(pid)  # budget refused it
                if node is None:
                    break  # byte budget exhausted; partial path is fine
                nodes.append(node)
            pool.trie.unpin(job.prefix_nodes)
            pool.trie.pin(nodes)
            pinned = nodes
        pool.free_rows.append(row)
        self.metrics.observe("ttft", time.perf_counter() - job.t_submit)

        slot = _Slot(request_id=job.request_id, future=job.future,
                     pos=len(job.prompt), token=first_token,
                     max_new=job.max_new, eos_id=job.eos_id,
                     pinned=pinned, prompt=job.prompt)
        slot.generated.append(slot.token)
        pool.slots[job.slot_idx] = slot
        self._maybe_retire(pool, job.slot_idx)

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
    def _retire(self, pool, slot_idx: int, reason: str) -> None:
        slot = pool.slots.pop(slot_idx)
        pool.free.append(slot_idx)
        if self._paged:
            for pid in pool.table.unmap_row(slot_idx):
                pool.pool.release(pid)
        if pool.trie is not None and slot.pinned:
            pool.trie.unpin(slot.pinned)
        if self._paged:
            self._audit_kv(pool, f"retire[{reason}]")
        slot.future.set_result({"ids": list(slot.generated),
                                "finish_reason": reason})
        self.metrics.inc("requests_completed")

    def _maybe_retire(self, pool, slot_idx: int) -> bool:
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

    def _decode_round(self, pool) -> None:
        """One compiled decode step over ALL slots of `pool` (fixed
        shapes: the signature cache stays at one entry per bucket — and
        at ONE entry total for the paged layout, whose only per-step
        variation is page-table DATA).  Free slots decode a dummy token
        at position 0 (length 1) and their output is dropped."""
        live = list(pool.slots)
        token = np.zeros((pool.n_slots,), np.int32)
        pos = np.zeros((pool.n_slots,), np.int32)
        for idx in live:
            token[idx] = pool.slots[idx].token
            pos[idx] = pool.slots[idx].pos
        if self._paged:
            # only decoding rows expose their table row: a reserved but
            # still-prefilling slot's pages (possibly SHARED prefix pages)
            # must not take the dead row's write at pos 0 — sentinel rows
            # send it to the drop page instead
            tbl = np.full((pool.n_slots, pool.max_pages),
                          pool.pool.sentinel, np.int32)
            for idx in live:
                tbl[idx] = pool.table.array[idx]
            args = (pool.arena, self.params, self._tensor(tbl),
                    self._tensor(token), self._tensor(pos))
            compiled = self._paged_c("decode")
        else:
            args = (pool.cache, self.params, self._tensor(token),
                    self._tensor(pos))
            compiled = self._decode_c
        result = compiled.get_compiled(*args)
        if self._paged and pool.bucket not in self._audited:
            self._audited.add(pool.bucket)
            self._audit_kv(pool, "first_decode")
        t0 = time.perf_counter()
        if self._paged:
            pool.arena, nxt = result.tree_jitted(*args)
        else:
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
        if self._paged:
            in_use, held = pool.occupancy()
            self.metrics.record_kv_pool(
                in_use, held, pool.chunk,
                quant_bytes_saved=(pool.model_page_bytes
                                   - pool.page_bytes) * in_use)

    def _audit_kv(self, pool: _PagedPool, where: str) -> None:
        """Page-table/refcount audit (`kv.audit_page_table`, the JAX
        package's KV001) at the transitions where drift would next cause
        a wrong free: the first decode and every retire.  Raises on any
        finding: serving on would hand one sequence another's K/V."""
        problems = audit_page_table(pool.pool, pool.table, trie=pool.trie)
        if problems:
            raise RuntimeError(f"paged KV bookkeeping broken at {where}: "
                               + "; ".join(problems))

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
        paged = {name: self._paged_cs[name].cache_stats()
                 for name in ("decode", "chunk")
                 if self._paged and name in self._paged_cs}
        return {
            "queue_depth": self.queue_depth,
            "pending": len(self._pending),
            "buckets": {
                b: {"active": p.n_active, "free": len(p.free),
                    "prefilling": len(p.jobs),
                    "free_rows": len(p.free_rows),
                    "prefix_cache": (p.trie.stats() if p.trie else None),
                    **({"kv_pool": p.pool.stats(),
                        "kv_table_mapped": int(
                            (p.table.array != p.table.sentinel).sum())}
                       if self._paged else {})}
                for b, p in self._pools.items()},
            "decode_signatures": paged.get(
                "decode", self._decode_c.cache_stats()),
            "prefill_signatures": paged.get(
                "chunk", self._prefill_chunk_c.cache_stats()),
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
            model_prefill_chunk_paged=lambda p, pg, tb, t, s, l:
                gpt.gpt_prefill_chunk_paged(p, cfg, pg, tb, t, s, l),
            model_decode_paged=lambda p, pg, tb, t, pos:
                gpt.gpt_decode_step_paged(p, cfg, pg, tb, t, pos),
            init_pages=lambda n, t, dt=None, **qkw: gpt.init_kv_pages(
                cfg, n, t, dtype=dt, device=device, **qkw),
            device=device, max_prompt_len=cfg.seq, **kw)

