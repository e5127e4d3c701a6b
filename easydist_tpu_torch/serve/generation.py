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
    (where the JAX package donates the buffers to XLA);
  * **speculative decoding** (`ServeConfig.speculate_k`,
    serve/speculate.py) — a drafter proposes k tokens, one verify step
    scores all k+1 positions, and the session commits the longest prefix
    the target's own greedy picks ratify, so the ids are exactly the
    plain-greedy ids.  One verify signature per bucket (bucketed) or in
    total (paged; spill pages past the reservation are released by the
    rollback, and the page-table audit runs after every one);
  * **host tier** (`ServeConfig.kv_host_tier_bytes`, kv/tier.py) — cold
    trie pages of the paged arena demote to host memory instead of being
    evicted, and promote back (manifest-verified, bitwise) on the next
    hit;
  * **lifecycle** — `drain`, `evacuate` (resumable descriptors),
    `snapshot_inflight`, hot-page and prefix-path export/import, and the
    `fleet.replica.crash` fault point at the step boundary.

Every program goes through the port's `easydist_compile`.  Greedy
decoding: the argmax runs inside the compiled step, so only int32 ids
cross to the host per token.  Without `model_prefill_chunk` the session
runs the one-shot prefill (one pow2-padded prefill per prompt).

Over a mesh (`mesh=` a `DeviceMesh`) every program of the session is
compiled by `easydist_compile(mesh=)` with the caches and pages as paired
state: the solver picks their placements (`kv_cache_specs` names the
head-sharded one), every rank runs the same host scheduler on the same
requests, and the ids each program returns reach the host through a
broadcast from the mesh's first rank, so the ranks agree.

The analyzer's audits (`easydist_tpu_torch.analyze`, under
`config.enable_analyze`) run at the JAX package's points: once per
compiled signature, the cache written in place (SERVE001), the chunked
prefill's in-place staging and length mask (SERVE002), the verify
program's (SERVE003), the quant program's dequantization (KVQ002) and
the trie's host references against the buffers the next step writes
(ALIAS004); the prefix trie's accounting after every prefill commit
(SERVE002); the accept walk of every verify commit and the page table
after every rollback that released pages (SERVE003); and the page-table
audit (`kv.audit_page_table`, KV001, raising on any finding) with the
quantized arena's structure (KVQ001) and the host tier's manifests
(KVQ003) at the first decode, every retire and every rollback.
`analyze.hook_tally()` counts the audits run and their findings by rule.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import analyze, resolve_device
from easydist_tpu_torch.fxfront import easydist_compile
from easydist_tpu_torch.kv import (PagePool, PageTable, audit_page_table,
                                   is_host_ref, is_page_ref)
from easydist_tpu_torch.kv.tier import HostTier, TierError
from easydist_tpu_torch.resilience import faultinject

from .admission import ReplicaDrainingError, RequestTooLargeError
from .batcher import select_bucket
from .engine import ServeConfig, storage_dtype
from .metrics import ServeMetrics
from .prefix_cache import PrefixCache
from .speculate import NGramDrafter, accept_length

logger = logging.getLogger(__name__)

# process-level memo of compiled programs, keyed by `compile_key`.  Every
# program is pure over its arguments (cache, params and tokens all cross
# as arguments), so sessions over the same model share traces.
_COMPILED_MEMO: Dict[object, tuple] = {}

# adaptive-speculation throttle (the JAX package's constants): a verify
# row costs ~1.5x a decode row, so drafting pays off only while the
# stream's recent accepted-tokens-per-round stays above the break-even
# (~0.5).  Each request carries an EWMA of its accept counts; below the
# floor it stops drafting and only PROBES every _SPEC_PROBE_EVERY
# scheduling rounds, so a stream the drafter cannot predict decays to
# plain decode while one that turns predictable again is rediscovered
# within one probe interval.
_SPEC_EWMA_ALPHA = 0.3
_SPEC_EWMA_FLOOR = 0.5
_SPEC_PROBE_EVERY = 12
# full-batch verify economics: the verify program is k+1 positions wide
# for EVERY row, drafted or not, so a round beats a decode round only
# when the drafting rows' expected accepts cover the whole batch's share
# of the wider program: sum(ewma) > (cost - 1) * rows.  Rounds that
# close below that line pause speculation for a probe interval.
_SPEC_VERIFY_COST = 2.0


def kv_cache_specs(axis: str = "tp", mesh_dim_names=None):
    """The placements of a KV cache {"k", "v"} of shape [layers,
    batch/slots, heads, max_len, head_dim] sharded on its heads over mesh
    axis `axis`, everything else replicated (the placement consistent
    with a tensor-parallel attention strategy): per leaf, one DTensor
    placement per mesh dim of `mesh_dim_names` (default: the one axis),
    for `torch.distributed.tensor.distribute_tensor`."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_dim_names or (axis,))
    if axis not in names:
        raise ValueError(f"{axis!r} is not an axis of {names}")
    spec = tuple(Shard(2) if n == axis else Replicate() for n in names)
    return {"k": spec, "v": spec}


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
    prompt: List[int] = field(default_factory=list)  # for evacuation


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

    def __init__(self, bucket: int, n_slots: int, init_cache,
                 n_rows: int = 1, chunk: int = 0, prefix_bytes: int = 0):
        self.bucket = bucket
        self.n_slots = n_slots
        self.cache = init_cache(n_slots, bucket)
        self.n_rows = n_rows
        self.staging = init_cache(n_rows, bucket)
        self.chunk = chunk                      # 0 = one-shot prefill path
        self.free: List[int] = list(range(n_slots))
        self.slots: Dict[int, _Slot] = {}          # slot index -> _Slot
        self.free_rows: List[int] = list(range(n_rows))
        self.jobs: Dict[int, _PrefillJob] = {}     # staging row -> job
        self.trie: Optional[PrefixCache] = \
            PrefixCache(chunk, prefix_bytes) if chunk and prefix_bytes \
            else None

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
                 n_pages: int, host_tier_bytes: int = 0,
                 export_page: Optional[Callable] = None,
                 model_itemsize: int = 0):
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
        # host tier (kv/tier.py): demotion target for cold trie pages;
        # `export_page(pool, pid)` is the session's compiled single-page
        # arena read (the program prefix-path export uses too)
        self.tier: Optional[HostTier] = \
            HostTier(host_tier_bytes) \
            if host_tier_bytes and self.trie is not None else None
        self._export_page = export_page
        self._tier_seq = 0
        self.demote_s = 0.0         # host seconds spent demoting
        self.promote_s = 0.0        # host seconds spent promoting

    def _release_evicted(self, node) -> None:
        # trie eviction drops the trie's hold on the node's arena page;
        # the page frees only when no live slot still maps it.  A node
        # already demoted to the host tier owns no arena page — evicting
        # it just forgets the host copy.
        if is_host_ref(node.kv):
            if self.tier is not None:
                self.tier.drop(node.kv["host"])
            return
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
        no live slot shares it).  Returns availability.

        With a host tier, demotion runs FIRST: the coldest unpinned
        device-page node moves its bytes to the host and keeps its trie
        position (the prefix survives device-memory pressure).  Only when
        the tier refuses (paused after host_oom, budget exhausted,
        nothing demotable) does plain eviction run — and then only
        against device-page nodes, because evicting a host-ref node frees
        no arena page and would discard tiered bytes for nothing."""
        if self.trie is not None:
            while self.pool.n_free < n_pages:
                if self.tier is not None:
                    if not self.tier.paused and self._demote_one():
                        continue
                    victim = self.trie.lru_node(
                        lambda n: not n.children and is_page_ref(n.kv))
                    if victim is None \
                            or not self.trie.evict_node(victim):
                        break
                elif not self.trie.evict_lru():
                    break
        return self.pool.n_free >= n_pages

    def _demote_one(self) -> bool:
        """Demote the LRU unpinned device-page trie node to the host
        tier: export the page's tensors, `tier.put` (chunked copy +
        manifest), swap the node's kv to `{"host": key}` at 0 trie bytes,
        release the arena page.  Returns False when nothing is demotable
        or the tier refused the bytes (the caller falls back to
        eviction)."""
        node = self.trie.lru_node(lambda n: is_page_ref(n.kv))
        if node is None or self._export_page is None:
            return False
        t0 = time.perf_counter()
        pid = node.kv["page"]
        key = ("pg", self._tier_seq)
        self._tier_seq += 1
        stored = self.tier.put(key, self._export_page(self, pid))
        self.demote_s += time.perf_counter() - t0
        if not stored:
            return False
        self.trie.reaccount(node, 0, kv={"host": key})
        self.pool.release(pid)
        return True

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
                # host-ref nodes hold no arena page
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


# single-page programs of the paged arena (host-tier demotion and
# promotion, prefix-path export and import).  They move EVERY arena key:
# an int8 arena's scale leaves ride with the payload, so a manifest covers
# both and a scale/payload desync cannot pass a digest check.

def _page_export(arena, page):
    """A copy of arena page `page` (clamped into the arena, as
    `jax.lax.dynamic_index_in_dim` clamps): {key: [layers, heads,
    page_tokens, d]}."""
    return {k: t[:, _index1(page, t.shape[1] - 1)][:, 0]
            for k, t in arena.items()}


def _page_import(arena, chunk_kv, page):
    """Write one page {key: [layers, heads, page_tokens, d]} into arena
    page `page`, in place."""
    for k, t in arena.items():
        t[:, _index1(page, t.shape[1] - 1)] = \
            chunk_kv[k].to(t.dtype).unsqueeze(1)
    return arena


class GenerationSession:
    """Continuous-batching token generation over a cache-carrying model.

    model_prefill_chunk(params, cache, tokens, start_pos, lengths)
        -> (cache, logits) — fixed-chunk window at absolute positions;
        enables the chunked / batched / prefix-reuse prefill scheduler
        (`for_gpt` wires it; without it the session runs the one-shot
        pow2-padded `model_prefill(params, cache, tokens, lengths)`)
    model_decode(params, cache, token, pos) -> (cache, logits)
    init_cache(batch, max_len, dtype=None) -> cache {"k", "v"}
    and, for `kv_layout="paged"`:
    model_prefill_chunk_paged(params, arena, table, tokens, start_pos,
        lengths) -> (arena, logits)
    model_decode_paged(params, arena, table, token, pos)
        -> (arena, logits)
    init_pages(n_pages, page_tokens, dtype=None, **quant) -> arena
    and, for `speculate_k > 0`: model_verify(params, cache, tokens, pos)
    (bucketed) or model_verify_paged(params, arena, table, tokens, pos)
    -> (cache, logits [batch, k+1, vocab]), with `drafter` (default: an
    `NGramDrafter` when `speculate_drafter="ngram"`).

    The model functions write `cache` / `arena` in place and return it.
    `submit` returns a Future resolving to {"ids": [...generated ids...],
    "finish_reason": "eos"|"length"|"bucket_full"|"evacuated"}; drive
    with `step()` (admit + bounded prefill chunks + decode + harvest) or
    `run_until_drained()`.  Host tensors are staged to `device`.

    `compile_key` (any hashable; `for_gpt` derives one from the model
    config and device) opts the session into the process-level memo of
    compiled programs, shared with other sessions of the same key and
    mesh.  `mesh` (a `DeviceMesh`) compiles every program over it; None
    keeps the one-device programs.
    `replica_id` labels the session's metrics (and their PerfDB key).
    """

    def __init__(self, params, *, model_decode: Callable,
                 init_cache: Callable,
                 model_prefill: Optional[Callable] = None,
                 model_prefill_chunk: Optional[Callable] = None,
                 model_prefill_chunk_paged: Optional[Callable] = None,
                 model_decode_paged: Optional[Callable] = None,
                 model_verify: Optional[Callable] = None,
                 model_verify_paged: Optional[Callable] = None,
                 init_pages: Optional[Callable] = None,
                 drafter: Optional[object] = None,
                 device=None, config: Optional[ServeConfig] = None,
                 eos_id: Optional[int] = None,
                 max_prompt_len: Optional[int] = None,
                 replica_id: Optional[str] = None,
                 compile_key: Optional[object] = None, mesh=None):
        self.config = config or ServeConfig()
        self.replica_id = replica_id
        if max_prompt_len is not None:
            bad = [b for b in self.config.decode_buckets
                   if b > max_prompt_len]
            if bad:
                raise ValueError(
                    f"decode_buckets {bad} exceed the model's maximum "
                    f"sequence length {max_prompt_len}; set "
                    f"ServeConfig(decode_buckets=...) within it")
        if model_prefill is None and model_prefill_chunk is None:
            raise ValueError("GenerationSession needs model_prefill_chunk "
                             "(chunked prefill) or model_prefill (one-shot)")
        self.params = params
        self.device = resolve_device(device)
        self.mesh = mesh
        self.eos_id = eos_id
        self.metrics = ServeMetrics(replica_id=replica_id)
        self._draining = False
        self._closed = False
        self._init_cache = init_cache
        self._chunked = model_prefill_chunk is not None
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
        self._audited_prefill: set = set()
        self._audited_verify: set = set()

        # speculative decoding (serve/speculate.py): a drafter proposes k
        # tokens, one verify step scores all k+1 positions, the session
        # commits the longest self-validating prefix.  A speed knob only —
        # committed tokens are exactly the plain-greedy stream.
        self._spec_k = int(self.config.speculate_k or 0)
        self._drafter = None
        if self._spec_k:
            if self._paged and model_verify_paged is None:
                raise ValueError(
                    "speculate_k with kv_layout='paged' requires "
                    "model_verify_paged (the for_gpt constructor wires it)")
            if not self._paged and model_verify is None:
                raise ValueError(
                    "speculate_k requires model_verify (the for_gpt "
                    "constructor wires it)")
            if drafter is not None:
                self._drafter = drafter
            elif self.config.speculate_drafter == "ngram":
                self._drafter = NGramDrafter()
            else:
                raise ValueError(
                    "speculate_drafter='draft_model' needs an explicit "
                    "drafter: pass drafter=..., or draft_model="
                    "(params, cfg) to for_gpt")
        # adaptive speculation (module constants above): per-request
        # accept-rate EWMA + probe counter.  A scheduling knob only —
        # which rounds verify never changes the committed tokens (the
        # accept rule is self-validating).
        self._spec_ewma: Dict[int, float] = {}
        self._spec_idle: Dict[int, int] = {}
        self._spec_gate_idle = 0

        def _prefill(cache, params, tokens, lengths):
            cache, logits = model_prefill(params, cache, tokens, lengths)
            return cache, torch.argmax(logits, dim=-1).to(torch.int32)

        def _prefill_chunk(staging, params, tokens, start, lengths):
            staging, logits = model_prefill_chunk(params, staging, tokens,
                                                  start, lengths)
            return staging, torch.argmax(logits, dim=-1).to(torch.int32)

        def _decode(pool, params, token, pos):
            pool, logits = model_decode(params, pool, token, pos)
            return pool, torch.argmax(logits, dim=-1).to(torch.int32)

        # speculative verify: tokens is [slots, k+1] (committed token then
        # k drafts); the program writes K/V at all k+1 positions and
        # returns the greedy pick at EVERY position — the commit walk runs
        # on the host over int32 ids only
        def _verify(pool, params, tokens, pos):
            pool, logits = model_verify(params, pool, tokens, pos)
            return pool, torch.argmax(logits, dim=-1).to(torch.int32)

        # paged programs: the arena first, so it pairs as state; the
        # int32 page table crosses as data every call (fixed shape — the
        # signature stays closed over every per-row length).  Traced on
        # first use via `_program`, so a session never pays for a program
        # it does not run.
        def _prefill_chunk_paged(arena, params, table, tokens, start,
                                 lengths):
            arena, logits = model_prefill_chunk_paged(
                params, arena, table, tokens, start, lengths)
            return arena, torch.argmax(logits, dim=-1).to(torch.int32)

        def _decode_paged(arena, params, table, token, pos):
            arena, logits = model_decode_paged(params, arena, table, token,
                                               pos)
            return arena, torch.argmax(logits, dim=-1).to(torch.int32)

        def _verify_paged(arena, params, table, tokens, pos):
            arena, logits = model_verify_paged(params, arena, table,
                                               tokens, pos)
            return arena, torch.argmax(logits, dim=-1).to(torch.int32)

        self._program_defs = (
            {"chunk": _prefill_chunk_paged, "decode": _decode_paged,
             "export": _page_export, "import": _page_import}
            if model_prefill_chunk_paged is not None else {})
        if model_verify_paged is not None:
            self._program_defs["verify"] = _verify_paged
        if model_verify is not None:
            self._program_defs["verify_bucketed"] = _verify

        memo_key = (compile_key, mesh) if compile_key is not None \
            else None
        shared = _COMPILED_MEMO.get(memo_key) if memo_key else None
        if shared is None:
            shared = (self._compile(_prefill) if model_prefill else None,
                      self._compile(_prefill_chunk)
                      if model_prefill_chunk else None,
                      self._compile(_restore),
                      self._compile(_migrate),
                      self._compile(_decode), {}, {})
            if memo_key is not None:
                while len(_COMPILED_MEMO) >= 32:  # live sessions keep refs
                    _COMPILED_MEMO.pop(next(iter(_COMPILED_MEMO)))
                _COMPILED_MEMO[memo_key] = shared
        (self._prefill_c, self._prefill_chunk_c, self._restore_c,
         self._migrate_c, self._decode_c, self._extract_cs,
         self._programs) = shared

    def _extract_for(self, chunk_len: int) -> Callable:
        """Compiled chunk extractor for one chunk size (the slice size is
        static, so each chunk length is its own program)."""
        fn = self._extract_cs.get(chunk_len)
        if fn is None:
            fn = self._compile(_extract_program(chunk_len))
            self._extract_cs[chunk_len] = fn
        return fn

    def _program(self, name: str) -> Callable:
        """Compiled program by name (paged "chunk" / "decode" / "verify" /
        "export" / "import", and the bucketed "verify_bucketed"), built on
        first use and shared through the process memo like
        `_extract_for`."""
        fn = self._programs.get(name)
        if fn is None:
            fn = self._compile(self._program_defs[name])
            self._programs[name] = fn
        return fn

    def _compile(self, fn) -> Callable:
        """`fn` compiled on the session's mesh (one device without one)."""
        return easydist_compile(fn, mesh=self.mesh)

    def _host(self, ids) -> np.ndarray:
        """A program's int32 ids on the host.  Over a mesh of several
        ranks, the mesh's first rank's ids, broadcast to every rank."""
        if self.mesh is not None and self.mesh.size() > 1:
            import torch.distributed as dist

            ids = ids.clone()
            group = self.mesh._flatten().get_group() \
                if self.mesh.ndim > 1 else self.mesh.get_group()
            src = int(self.mesh.mesh.flatten()[0])
            dist.broadcast(ids, src=src, group=group)
        return ids.cpu().numpy()

    def _tensor(self, x) -> torch.Tensor:
        """Host ints / int32 arrays as int32 tensors on the device."""
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    # ------------------------------------------------------------ admission
    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Future:
        """Queue one prompt; generation interleaves with every other live
        request (continuous batching) as `step()` is driven."""
        if self._draining or self._closed:
            raise ReplicaDrainingError(
                f"session{f' {self.replica_id}' if self.replica_id else ''} "
                f"is {'closed' if self._closed else 'draining'}: in-flight "
                f"work retires but nothing new is admitted")
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
                    host_tier_bytes=cfg.kv_host_tier_bytes,
                    export_page=self._export_arena_page,
                    model_itemsize=self._model_itemsize())
            elif self._chunked:
                pool = _BucketPool(
                    bucket, cfg.max_decode_slots, self._cache_factory,
                    n_rows=cfg.prefill_batch,
                    chunk=min(cfg.prefill_chunk, bucket),
                    prefix_bytes=prefix_bytes)
            else:
                pool = _BucketPool(bucket, cfg.max_decode_slots,
                                   self._cache_factory)
            self._pools[bucket] = pool
        return pool

    def _storage_dtype(self):
        dtype = self.config.kv_cache_dtype
        return None if dtype == "auto" else storage_dtype(dtype)

    def _cache_factory(self, batch: int, max_len: int):
        return self._init_cache(batch, max_len, self._storage_dtype())

    def _pages_factory(self, n_pages: int, page_tokens: int):
        cfg = self.config
        dtype = self._storage_dtype()
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

    def _export_arena_page(self, pool, pid: int):
        """Compiled single-page arena read (the prefix-path export
        program) — the host tier's demotion source."""
        return self._program("export")(pool.arena, self._tensor(int(pid)))

    def _import_arena_page(self, pool, kv, pid: int) -> None:
        """Compiled single-page arena write of `kv` (tensors anywhere; they
        are moved to the session's device first) into page `pid`."""
        pool.arena = self._program("import")(
            pool.arena, {k: v.to(self.device) for k, v in kv.items()},
            self._tensor(int(pid)))

    @staticmethod
    def _prefill_pad(plen: int, bucket: int) -> int:
        """One-shot path: smallest power of two >= plen (floor 8),
        capped at the decode bucket."""
        t = 8
        while t < plen:
            t *= 2
        return min(t, bucket)

    def _admit_one(self) -> bool:
        """Pop one pending request toward generation.  Chunked path:
        reserve a pool slot + staging row, restore the longest cached
        prefix, and enqueue a prefill job (chunks run in `step()`).
        One-shot path: prefill the whole prompt and migrate it into the
        slot now.  Returns False when nothing is admissible."""
        if not self._pending:
            return False
        prompt, max_new, eos, fut, t_submit = self._pending[0]
        bucket = select_bucket(len(prompt) + 1, self.config.decode_buckets)
        pool = self._pool_for(bucket)
        if not pool.free:
            return False
        if (self._chunked or self._paged) and not pool.free_rows:
            return False
        if self._paged:
            return self._admit_one_paged(pool)
        self._pending.popleft()
        if fut.set_running_or_notify_cancel() is False:
            return True  # cancelled while queued; slot stays free
        slot_idx = pool.free.pop()
        if not self._chunked:
            self._admit_one_shot(pool, slot_idx, prompt, max_new, eos, fut,
                                 t_submit, bucket)
            return True
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

    def _admit_one_shot(self, pool: _BucketPool, slot_idx: int, prompt,
                        max_new: int, eos, fut, t_submit: float,
                        bucket: int) -> None:
        """One-shot prefill of the whole prompt (padded to a power of
        two, one traced signature per padded length) into the staging
        row, migrated into `slot_idx`; the slot decodes from the next
        round."""
        t_pad = self._prefill_pad(len(prompt), bucket)
        tokens = np.full((1, t_pad), int(self.config.pad_value), np.int32)
        tokens[0, :len(prompt)] = prompt
        pool.staging, first = self._prefill_c(
            pool.staging, self.params, self._tensor(tokens),
            self._tensor([len(prompt)]))
        pool.cache = self._migrate_c(pool.cache, pool.staging,
                                     self._tensor(0), self._tensor(slot_idx))
        self.metrics.record_admission(len(prompt), 0)
        self.metrics.observe("ttft", time.perf_counter() - t_submit)
        slot = _Slot(request_id=self._next_request_id, future=fut,
                     pos=len(prompt), token=int(self._host(first)[0]),
                     max_new=max_new, eos_id=eos, prompt=prompt)
        self._next_request_id += 1
        slot.generated.append(slot.token)
        pool.slots[slot_idx] = slot
        self._maybe_retire(pool, slot_idx)

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
            if pool.tier is not None:
                # BEFORE the slot's first decode step: demoted nodes on
                # the matched path come back into arena pages (manifest
                # verified); a tier miss truncates the usable prefix
                nodes, prefix_len = self._promote_path(pool, nodes)
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

    def _promote_path(self, pool: _PagedPool, nodes):
        """Promote host-tier refs along a matched (pinned) path back
        into arena pages: `tier.get` manifest-verifies the host bytes,
        the compiled import program uploads them into a fresh page, and
        the node's kv swaps back to `{"page": id}` at full byte cost.
        The round trip moves exact storage bytes (payload AND scales),
        so it is bitwise.  A missing/corrupt entry truncates the usable
        prefix at that node — the tail unpins and prefill recomputes it
        (never serves unverified KV).  Returns (nodes, prefix_len)."""
        for j, node in enumerate(nodes):
            if is_page_ref(node.kv):
                continue
            key = node.kv["host"]
            t0 = time.perf_counter()
            try:
                host_kv = pool.tier.get(key)
            except (KeyError, TierError) as e:
                logger.warning("[kv.tier] promotion of %r failed (%s); "
                               "prefix truncated, chunk recomputes", key, e)
                host_kv = None
            if host_kv is None or not pool.make_room(1):
                pool.trie.unpin(nodes[j:])
                return nodes[:j], j * pool.chunk
            pid = pool.pool.alloc()
            self._import_arena_page(pool, host_kv, pid)
            pool.tier.drop(key)
            pool.trie.reaccount(node, pool.page_bytes, kv={"page": pid})
            pool.promote_s += time.perf_counter() - t0
        return nodes, len(nodes) * pool.chunk

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
            if pool.bucket not in self._audited_prefill:
                self._audited_prefill.add(pool.bucket)
                self._audit_chunked_prefill(result, pool.bucket)
            t0 = time.perf_counter()
            pool.staging, first = result.tree_jitted(*args)
            first = self._host(first)
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
            result = self._program("chunk").get_compiled(*args)
            if pool.bucket not in self._audited_prefill:
                self._audited_prefill.add(pool.bucket)
                # the paged program writes the arena through the table,
                # which KV001 audits on the host: only the in-place half
                # of SERVE002 applies, as the JAX session has it
                self._audit_donation(
                    result, f"prefill_chunk_paged[cap={pool.bucket}]")
            t0 = time.perf_counter()
            pool.arena, first = result.tree_jitted(*args)
            first = self._host(first)
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
                if node is not None and is_host_ref(node.kv):
                    # heal: this prefill just rewrote the chunk's bytes
                    # into a fresh page, so re-point the demoted node at
                    # it (free re-promotion; also recovers nodes whose
                    # tier entry was lost to host LRU eviction)
                    pid = int(pool.table.array[job.slot_idx, j])
                    pool.pool.share(pid)
                    if pool.tier is not None:
                        pool.tier.drop(node.kv["host"])
                    pool.trie.reaccount(node, pool.page_bytes,
                                        kv={"page": pid})
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
            self._audit_prefix_cache(pool)
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
            self._audit_prefix_cache(pool)
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
        if self._drafter is not None:
            self._drafter.forget(slot.request_id)
            self._spec_ewma.pop(slot.request_id, None)
            self._spec_idle.pop(slot.request_id, None)
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

    def _decode_round(self, pool, only: Optional[set] = None) -> None:
        """One compiled decode step over ALL slots of `pool` (fixed
        shapes: the signature cache stays at one entry per bucket — and
        at ONE entry total for the paged layout, whose only per-step
        variation is page-table DATA).  Free slots decode a dummy token
        at position 0 (length 1) and their output is dropped.

        `only` restricts the round to the given slot indices — PAGED
        layout only (excluded rows keep a sentinel table row so their
        dead-row write drops; the bucketed cache has no sentinel, so an
        excluded bucketed slot would take a garbage write at row 0).
        The speculative scheduler uses it to plain-decode the slots a
        verify round could not carry."""
        live = [i for i in pool.slots if only is None or i in only]
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
            compiled = self._program("decode")
        else:
            args = (pool.cache, self.params, self._tensor(token),
                    self._tensor(pos))
            compiled = self._decode_c
        result = compiled.get_compiled(*args)
        if pool.bucket not in self._audited:
            self._audited.add(pool.bucket)
            self._audit_donation(result, f"decode[bucket={pool.bucket}]")
            self._audit_host_aliases(pool)
            if self._paged:
                self._audit_kv(pool, "first_decode")
                if "k_scale" in pool.arena:
                    self._audit_quant_program(result, "first_decode")
        t0 = time.perf_counter()
        if self._paged:
            pool.arena, nxt = result.tree_jitted(*args)
        else:
            pool.cache, nxt = result.tree_jitted(*args)
        nxt = self._host(nxt)
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

    # ------------------------------------------------ speculative decoding
    def _spec_round(self, pool) -> bool:
        """One speculative draft/verify round over `pool`
        (serve/speculate.py describes the accept rule).  Returns False
        when no slot can ride a verify step this round — the caller
        falls back to a plain decode round, so speculation never stalls
        decode.

        Bucketed pools are all-or-nothing: the verify program writes
        k+1 cache rows for EVERY row, so every live slot needs headroom
        (pos + k + 1 <= bucket) — near the wall the pool rides plain
        decode for its last few tokens.  Slots without a draft ride
        anyway with pad drafts (position 0 of the verify output is the
        plain-greedy token, so they commit at least one token, exactly
        like a decode step).

        Paged pools are per-slot: sentinel table rows drop excluded
        rows' writes, so eligible slots (draft + headroom + speculative
        spill windows mappable) verify while the rest take a plain
        decode call (`_decode_round(only=...)`)."""
        k = self._spec_k
        if self._spec_gate_idle > 0:
            # pacing after a round that closed below the full-batch
            # break-even (_commit_verify) — plain decode rounds until
            # the next attempt, which doubles as the refresh probe
            self._spec_gate_idle -= 1
            return False
        drafts: Dict[int, List[int]] = {}
        for idx, slot in pool.slots.items():
            rid = slot.request_id
            ewma = self._spec_ewma.get(rid)
            if ewma is not None and ewma < _SPEC_EWMA_FLOOR:
                # throttled: recent acceptance below break-even; only
                # probe once per interval to re-detect predictability
                idle = self._spec_idle.get(rid, 0) + 1
                if idle < _SPEC_PROBE_EVERY:
                    self._spec_idle[rid] = idle
                    continue
            self._spec_idle[rid] = 0
            d = self._drafter.propose(
                slot.request_id, slot.prompt + slot.generated, k)
            if d:
                drafts[idx] = (list(int(t) for t in d) + [0] * k)[:k]
        if not drafts:
            return False
        if self._paged:
            return self._verify_round_paged(pool, drafts)
        if any(s.pos + k + 1 > pool.bucket for s in pool.slots.values()):
            return False
        return self._verify_round_bucketed(pool, drafts)

    def _verify_round_bucketed(self, pool: _BucketPool, drafts) -> bool:
        t_round = time.perf_counter()
        k = self._spec_k
        tokens = np.zeros((pool.n_slots, k + 1), np.int32)
        pos = np.zeros((pool.n_slots,), np.int32)
        for idx, slot in pool.slots.items():
            tokens[idx, 0] = slot.token
            tokens[idx, 1:] = drafts.get(idx, [0] * k)
            pos[idx] = slot.pos
        args = (pool.cache, self.params, self._tensor(tokens),
                self._tensor(pos))
        t_trace = time.perf_counter()
        result = self._program("verify_bucketed").get_compiled(*args)
        if ("bucketed", pool.bucket) not in self._audited_verify:
            self._audited_verify.add(("bucketed", pool.bucket))
            self._audit_verify(result, f"verify[bucket={pool.bucket}]")
        t0 = time.perf_counter()
        pool.cache, nxt = result.tree_jitted(*args)
        nxt = self._host(nxt)
        dt = time.perf_counter() - t0
        # rejected rows need no explicit cleanup in the bucketed layout:
        # the pos cursor does not advance past the accepted prefix, the
        # next write at pos overwrites the stale row, and the length
        # mask hides everything past the query position
        proposed, accepted, committed = self._commit_verify(
            pool, drafts, tokens, nxt, list(pool.slots))
        self.metrics.record_speculation(
            proposed, accepted, committed, len(drafts), pool.n_slots, dt)
        self._record_verify_host(time.perf_counter() - t_round
                                 - (t0 - t_trace) - dt)
        return True

    def _verify_round_paged(self, pool: _PagedPool, drafts) -> bool:
        t_round = time.perf_counter()
        k = self._spec_k
        eligible: Dict[int, List[int]] = {}
        for idx, d in drafts.items():
            slot = pool.slots[idx]
            if slot.pos + k + 1 > pool.bucket:
                continue
            # speculative rows may spill past the slot's up-front page
            # reservation; map the spill windows now (the rollback below
            # truncates the row back to the reservation, so outside a
            # verify round live slots map exactly their reservation)
            n_need = (slot.pos + k) // pool.chunk + 1
            n_have = pool.table.n_mapped(idx)
            if n_need > n_have:
                if not pool.make_room(n_need - n_have):
                    continue
                for j in range(n_have, n_need):
                    pool.table.map(idx, j, pool.pool.alloc())
            eligible[idx] = d
        if not eligible:
            return False
        tokens = np.zeros((pool.n_slots, k + 1), np.int32)
        pos = np.zeros((pool.n_slots,), np.int32)
        tbl = np.full((pool.n_slots, pool.max_pages),
                      pool.pool.sentinel, np.int32)
        for idx, d in eligible.items():
            slot = pool.slots[idx]
            tokens[idx, 0] = slot.token
            tokens[idx, 1:] = d
            pos[idx] = slot.pos
            tbl[idx] = pool.table.array[idx]
        args = (pool.arena, self.params, self._tensor(tbl),
                self._tensor(tokens), self._tensor(pos))
        t_trace = time.perf_counter()
        result = self._program("verify").get_compiled(*args)
        if ("paged", pool.bucket) not in self._audited_verify:
            self._audited_verify.add(("paged", pool.bucket))
            self._audit_verify(result, f"verify[paged cap={pool.bucket}]")
        t0 = time.perf_counter()
        pool.arena, nxt = result.tree_jitted(*args)
        nxt = self._host(nxt)
        dt = time.perf_counter() - t0
        # reservation sizes BEFORE the commit walk can retire the slots
        reserved = {idx: pool.pages_needed(len(pool.slots[idx].prompt),
                                           pool.slots[idx].max_new)
                    for idx in eligible}
        rest = [i for i in pool.slots if i not in eligible]
        proposed, accepted, committed = self._commit_verify(
            pool, drafts, tokens, nxt, list(eligible))
        # rollback: spill windows past the reservation only ever hold
        # rejected/uncommitted draft rows (committed positions fit the
        # reservation — pages_needed covers prompt + max_new), so
        # truncating the table tail releases them.  Retired slots were
        # already fully unmapped by _retire.
        released = 0
        for idx in eligible:
            if idx not in pool.slots:
                continue
            for pid in pool.table.unmap_tail(idx, reserved[idx]):
                pool.pool.release(pid)
                released += 1
        self._audit_kv(pool, "verify[rollback]")
        if released:
            self._audit_spec_rollback(pool)
        self.metrics.inc("speculative_rollback_audits")
        self.metrics.record_speculation(
            proposed, accepted, committed, len(eligible), pool.n_slots,
            dt, pages_released=released)
        in_use, held = pool.occupancy()
        self.metrics.record_kv_pool(
            in_use, held, pool.chunk,
            quant_bytes_saved=(pool.model_page_bytes
                               - pool.page_bytes) * in_use)
        self._record_verify_host(time.perf_counter() - t_round
                                 - (t0 - t_trace) - dt)
        if rest:
            self._decode_round(pool, only=set(rest))
        return True

    def _record_verify_host(self, seconds: float) -> None:
        """Host time of one verify round outside its compiled call and its
        trace (drafting, packing, the commit walk, the rollback and its
        audit), in microseconds: the speculative scheduler's own cost."""
        self.metrics.inc("verify_host_us", int(seconds * 1e6))

    def _commit_verify(self, pool, drafts, tokens, nxt, idxs):
        """Commit walk for the slots that rode a verify step: accept the
        longest draft prefix the target's own greedy picks ratify, plus
        the target's correction/bonus token.  Every committed token is
        the exact plain-greedy token (the draft row only decides how
        many commit per round), so retire semantics (eos/length/
        bucket_full) are checked token-by-token exactly as a sequence
        of plain decode rounds would.  Returns (proposed, accepted,
        committed) counts for the speculation metrics."""
        k = self._spec_k
        proposed = accepted = committed = 0
        expect = 0.0
        for idx in idxs:
            d_row = tokens[idx, 1:]
            g_row = nxt[idx]
            # the accept rule is self-validating, so pad drafts on
            # draftless rows are safe — an accidental pad match is a
            # genuine accept; only REAL proposals count toward the rate
            n_acc = accept_length(d_row, g_row[:k])
            self._audit_spec_bookkeeping(d_row, g_row, n_acc, f"slot={idx}")
            if idx in drafts:
                proposed += k
                accepted += n_acc
                rid = pool.slots[idx].request_id
                prev = self._spec_ewma.get(rid, float(n_acc))
                self._spec_ewma[rid] = ((1 - _SPEC_EWMA_ALPHA) * prev
                                        + _SPEC_EWMA_ALPHA * n_acc)
                expect += self._spec_ewma[rid]
            for i in range(n_acc + 1):
                slot = pool.slots[idx]
                slot.token = int(g_row[i])
                slot.pos += 1
                slot.generated.append(slot.token)
                committed += 1
                if self._maybe_retire(pool, idx):
                    break
        # full-batch economics (see _SPEC_VERIFY_COST): expected accepts
        # from the drafting rows' refreshed EWMAs must cover the pad
        # rows' share of the k+1-wide program, else pace speculation
        if drafts and expect < (_SPEC_VERIFY_COST - 1.0) * max(
                1, len(idxs)):
            self._spec_gate_idle = _SPEC_PROBE_EVERY - 1
        return proposed, accepted, committed

    def _audit_kv(self, pool: _PagedPool, where: str) -> None:
        """Page-table/refcount audit (`kv.audit_page_table`, the JAX
        package's KV001) at the transitions where drift would next cause
        a wrong free: the first decode, every retire and every
        speculative rollback.  Raises on any finding: serving on would
        hand one sequence another's K/V.  Layer 13 rides along: KVQ001
        (scale/payload desync) when the arena is quantized, KVQ003 (the
        manifest round trip) when a host tier is up."""
        problems = audit_page_table(pool.pool, pool.table, trie=pool.trie)
        if problems:
            raise RuntimeError(f"paged KV bookkeeping broken at {where}: "
                               + "; ".join(problems))
        if "k_scale" in pool.arena:
            analyze.check_quant_arena(pool.arena, node=f"kv.quant[{where}]")
        if pool.tier is not None:
            analyze.check_tier_roundtrip(pool.tier,
                                         node=f"kv.tier[{where}]")

    def _audit_verify(self, result, node: str) -> None:
        """SERVE003 (program arm): the verify step writes its cache in
        place and length-masks attention past the committed positions —
        audited once per compiled verify signature."""
        analyze.check_speculative_rewind(result=result, node=node)

    def _audit_spec_bookkeeping(self, draft, target, n_accepted: int,
                                node: str) -> None:
        """SERVE003 (bookkeeping arm): the accepted prefix never advances
        past the first draft/target mismatch."""
        analyze.check_speculative_rewind(
            draft=[int(t) for t in draft], target=[int(t) for t in target],
            n_accepted=n_accepted, node=f"verify[{node}]")

    def _audit_spec_rollback(self, pool: _PagedPool) -> None:
        """SERVE003 (paged arm): after a rollback released spill pages,
        no table row still points at a released page."""
        analyze.check_speculative_rewind(
            pool=pool.pool, table=pool.table, trie=pool.trie,
            node="verify[rollback]")

    def _audit_donation(self, result, node: str) -> None:
        """SERVE001: the compiled step writes its cache in place."""
        analyze.check_decode_donation(result, node=node)

    def _audit_chunked_prefill(self, result, bucket: int) -> None:
        analyze.check_chunked_prefill(
            result, node=f"prefill_chunk[bucket={bucket}]")

    def _audit_prefix_cache(self, pool) -> None:
        analyze.check_prefix_cache(
            pool.trie, node=f"prefix_cache[bucket={pool.bucket}]")

    def _audit_host_aliases(self, pool) -> None:
        """ALIAS004: the buffers the next step writes (cache + staging,
        or the paged arena) are not reachable from host-held references
        that outlive the step — trie nodes hold `_extract` copies
        (bucketed) or page references (paged), never the buffers."""
        if self._paged:
            donated = {"arena": pool.arena}
        else:
            donated = {"cache": pool.cache, "staging": pool.staging}
        holders = {}
        if pool.trie is not None:
            holders["trie"] = [node.kv for node in pool.trie._walk()]
        analyze.check_host_aliases(
            donated, holders, node=f"session[bucket={pool.bucket}]")

    def _audit_quant_program(self, result, where: str) -> None:
        """KVQ002: the compiled quant step never feeds int8 K/V into a
        matmul undequantized — once per program."""
        analyze.check_quant_program(result,
                                    node=f"decode.quant[{where}]")

    # ------------------------------------------------------------- driving
    def step(self) -> int:
        """One serving round: admit pending prompts into free slots/rows,
        run at most `prefill_chunks_per_step` prefill chunk calls, then
        one decode (or speculative verify) round per bucket with live
        slots, harvesting retirements.  Returns the number of tokens
        generated this round (decode tokens; prefill first-tokens count
        via `prefills`)."""
        # the replica-death fault point sits at the step boundary: tokens
        # of completed steps were already handed out, this step's are
        # lost — the state a real mid-decode crash leaves
        faultinject.crash_point("fleet.replica.crash")
        while self._admit_one():
            pass
        if self._chunked or self._paged:
            budget = self.config.prefill_chunks_per_step
            for pool in self._pools.values():
                if budget <= 0:
                    break
                if pool.jobs:
                    budget -= self._prefill_round(pool, budget)
        before = self.metrics.counter("tokens_generated")
        for pool in self._pools.values():
            if pool.slots:
                if self._drafter is not None and self._spec_round(pool):
                    continue
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

    # ------------------------------------------------------------ lifecycle
    def drain(self, wait: bool = True, max_steps: int = 100000):
        """Stop admitting (submits raise `ReplicaDrainingError`), let
        in-flight work retire, and export the tries' hot pages for
        re-admission elsewhere.  `wait=False` only flips the flag — the
        caller keeps driving `step()` and calls `export_hot_pages()`
        itself once `is_drained`.  Returns the hot pages (wait=True) or
        None (wait=False).  Idempotent."""
        self._draining = True
        if not wait:
            return None
        self.run_until_drained(max_steps=max_steps)
        return self.export_hot_pages()

    @property
    def is_draining(self) -> bool:
        return self._draining

    @property
    def is_drained(self) -> bool:
        """No queued, prefilling, or decoding work left."""
        return not self._pending and not any(
            p.slots or p.jobs for p in self._pools.values())

    def export_hot_pages(self) -> Dict[int, List[List[tuple]]]:
        """Per-bucket root-to-leaf chunk paths from each trie,
        hottest-first (`PrefixCache.hot_paths`) — what a router
        re-imports into surviving replicas on drain so shared-prefix
        traffic does not re-pay prefill after a scale-down.  Paged
        sessions materialize their page references into tensors."""
        return {b: ([self._materialize_path(p, path)
                     for path in p.trie.hot_paths()]
                    if self._paged else p.trie.hot_paths())
                for b, p in self._pools.items() if p.trie is not None}

    # ------------------------------------------------- fleet trie access
    def _trie_bucket(self, bucket: Optional[int]) -> Optional[int]:
        """The pool key `bucket` maps to: itself, or the single paged
        pool's capacity cap."""
        if bucket is None:
            return None
        return max(self.config.decode_buckets) if self._paged else bucket

    def _materialize_path(self, pool, path: List[tuple]) -> List[tuple]:
        """Transport form of paged trie entries: replace {"page": id}
        references with the page's K/V (the same [layers, heads, chunk,
        head_dim] tensors a bucketed trie commits; an int8 arena's scales
        ride along), so exported paths are layout-agnostic."""
        out = []
        for key, kv in path:
            if is_page_ref(kv):
                kv = self._export_arena_page(pool, kv["page"])
            elif is_host_ref(kv):
                # demoted chunk: serve the manifest-verified host copy
                # (the tier entry stays — an export, not a promotion)
                try:
                    host_kv = pool.tier.get(kv["host"]) \
                        if pool.tier is not None else None
                except (KeyError, TierError):
                    host_kv = None
                if host_kv is None:
                    break  # keep the exportable prefix contiguous
                kv = {k: v.to(self.device) for k, v in host_kv.items()}
            out.append((key, kv))
        return out

    def _import_path_paged(self, pool, path: Sequence[tuple]) -> int:
        """Commit a transported (materialized) chunk path into the paged
        trie: each chunk lands in a freshly allocated arena page, written
        by the compiled import program and committed as a page
        reference.  First-commit-wins like `PrefixCache.import_path`;
        stops when the arena or the trie budget refuses a page."""
        nodes: List[object] = []
        for key, kv in path:
            node = pool.trie.lookup_node(nodes, key)
            if node is None:
                if set(kv) != set(pool.arena):
                    # precision/layout mismatch (e.g. a quantized page
                    # offered to an exact arena): recompute locally
                    # rather than coerce payload without its scales
                    break
                if not pool.make_room(1):
                    break
                pid = pool.pool.alloc()
                self._import_arena_page(pool, kv, pid)
                node = pool.trie.commit(nodes, key, {"page": pid},
                                        nbytes=pool.page_bytes)
                if node is None:
                    pool.pool.release(pid)
                    break
            nodes.append(node)
        return len(nodes)

    def bucket_chunk(self, prompt: Sequence[int]) -> Optional[int]:
        """Trie page size (tokens) for the bucket `prompt` decodes in, or
        None when the prompt fits no bucket / prefix reuse is off."""
        bucket = select_bucket(len(prompt) + 1, self.config.decode_buckets)
        if bucket is None or not (self._chunked or self._paged) \
                or not self.config.enable_prefix_cache \
                or not self.config.prefix_cache_bytes:
            return None
        return min(self.config.prefill_chunk, self._trie_bucket(bucket))

    def prefix_affinity(self, prompt: Sequence[int]) -> int:
        """Tokens of `prompt` already committed in this session's trie —
        non-mutating (`PrefixCache.peek`), so a router can probe every
        replica without disturbing LRU state."""
        bucket = select_bucket(len(prompt) + 1, self.config.decode_buckets)
        pool = self._pools.get(self._trie_bucket(bucket)) \
            if bucket is not None else None
        if pool is None or pool.trie is None:
            return 0
        return pool.trie.peek(prompt, max_tokens=len(prompt) - 1)

    def export_prefix_path(self, prompt: Sequence[int],
                           max_tokens: Optional[int] = None) -> List[tuple]:
        """Committed chunk path for `prompt`'s longest cached prefix, as
        [(chunk_tokens, kv)] for transport to another session (paged
        sessions materialize their page references into tensors)."""
        bucket = select_bucket(len(prompt) + 1, self.config.decode_buckets)
        pool = self._pools.get(self._trie_bucket(bucket)) \
            if bucket is not None else None
        if pool is None or pool.trie is None:
            return []
        path = pool.trie.export_path(prompt, max_tokens=max_tokens)
        return self._materialize_path(pool, path) if self._paged else path

    def import_prefix_path(self, prompt: Sequence[int],
                           path: Sequence[tuple]) -> int:
        """Commit a transported chunk path into the trie of the bucket
        `prompt` will decode in (creating the pool if needed).  Returns
        chunks present along the path afterwards."""
        bucket = select_bucket(len(prompt) + 1, self.config.decode_buckets)
        if bucket is None:
            return 0
        pool = self._pool_for(bucket)
        if pool.trie is None:
            return 0
        if self._paged:
            return self._import_path_paged(pool, path)
        return pool.trie.import_path(path)

    def import_hot_pages(self, pages: Dict[int, List[List[tuple]]]) -> int:
        """Re-admit another session's exported hot pages (drain
        migration): each bucket's paths import into this session's same
        bucket when configured here, falling back to the largest
        configured bucket.  Returns total chunks committed."""
        total = 0
        for bucket, paths in pages.items():
            b = bucket if bucket in self.config.decode_buckets \
                else max(self.config.decode_buckets)
            pool = self._pool_for(b)
            if pool.trie is None:
                continue
            for path in paths:
                total += (self._import_path_paged(pool, path)
                          if self._paged else pool.trie.import_path(path))
        return total

    def snapshot_inflight(self) -> List[Dict[str, object]]:
        """Progress of every live request, keyed by its future (identity
        — the only handle a router shares with this session).  `ids` is
        the tokens already emitted, i.e. what a streaming client has
        already received; resubmitting prompt + ids elsewhere recovers a
        crash of THIS session bitwise.  Read-only."""
        out: List[Dict[str, object]] = []
        for prompt, max_new, eos, fut, _t in self._pending:
            out.append({"future": fut, "prompt": list(prompt), "ids": [],
                        "max_new": max_new, "eos_id": eos,
                        "stage": "queued"})
        for pool in self._pools.values():
            for job in pool.jobs.values():
                out.append({"future": job.future,
                            "prompt": list(job.prompt), "ids": [],
                            "max_new": job.max_new, "eos_id": job.eos_id,
                            "stage": "prefill"})
            for slot in pool.slots.values():
                out.append({"future": slot.future,
                            "prompt": list(slot.prompt),
                            "ids": list(slot.generated),
                            "max_new": slot.max_new,
                            "eos_id": slot.eos_id, "stage": "decode"})
        return out

    def evacuate(self) -> List[Dict[str, object]]:
        """Preemptive drain (grace too short to retire decodes): retire
        EVERY live request now with finish_reason "evacuated" and partial
        ids, returning resume descriptors.  A router resubmits prompt +
        ids with the remaining budget elsewhere; greedy continuation is a
        pure function of the token prefix, so the concatenated output
        equals an uninterrupted run.  An evacuated partial never contains
        eos (eos retires the slot the step it appears) and is always
        shorter than max_new (reaching it retires as "length"), so the
        remaining budget is >= 1.  Draft-model caches are forgotten with
        their slots."""
        self._draining = True
        out: List[Dict[str, object]] = []
        while self._pending:
            prompt, max_new, eos, fut, _ = self._pending.popleft()
            if fut.set_running_or_notify_cancel() is False:
                continue
            fut.set_result({"ids": [], "finish_reason": "evacuated"})
            out.append({"prompt": list(prompt), "ids": [],
                        "max_new": max_new, "eos_id": eos})
        for pool in self._pools.values():
            for row in list(pool.jobs):
                job = pool.jobs.pop(row)
                pool.free_rows.append(row)
                pool.free.append(job.slot_idx)
                if self._paged:
                    for pid in pool.table.unmap_row(job.slot_idx):
                        pool.pool.release(pid)
                if pool.trie is not None:
                    pool.trie.unpin(job.prefix_nodes)
                job.future.set_result(
                    {"ids": [], "finish_reason": "evacuated"})
                out.append({"prompt": list(job.prompt), "ids": [],
                            "max_new": job.max_new, "eos_id": job.eos_id})
            for idx in list(pool.slots):
                slot = pool.slots[idx]
                desc = {"prompt": list(slot.prompt),
                        "ids": list(slot.generated),
                        "max_new": slot.max_new, "eos_id": slot.eos_id}
                self._retire(pool, idx, "evacuated")
                out.append(desc)
        return out

    def close(self) -> None:
        """Drain, then release the pooled device caches.  Idempotent;
        every submit afterwards raises `ReplicaDrainingError`."""
        if self._closed:
            return
        self.drain(wait=True)
        self._closed = True
        self._pools.clear()

    # ----------------------------------------------------------- reporting
    def stats(self) -> Dict[str, object]:
        paged = {name: self._programs[name].cache_stats()
                 for name in ("decode", "chunk", "verify")
                 if self._paged and name in self._programs}
        prefill_c = self._prefill_chunk_c if self._chunked \
            else self._prefill_c
        verify = self._programs.get(
            "verify" if self._paged else "verify_bucketed")
        verify = verify.cache_stats() if verify is not None else None
        return {
            "replica_id": self.replica_id,
            "draining": self._draining,
            "queue_depth": self.queue_depth,
            "pending": len(self._pending),
            "buckets": {
                b: {"active": p.n_active, "free": len(p.free),
                    "prefilling": len(p.jobs),
                    "free_rows": len(p.free_rows),
                    "prefix_cache": (p.trie.stats() if p.trie else None),
                    **({"kv_pool": p.pool.stats(),
                        "kv_table_mapped": int(
                            (p.table.array != p.table.sentinel).sum()),
                        "kv_tier": (p.tier.stats() if p.tier else None)}
                       if self._paged else {})}
                for b, p in self._pools.items()},
            "decode_signatures": paged.get(
                "decode", self._decode_c.cache_stats()),
            "prefill_signatures": paged.get(
                "chunk", prefill_c.cache_stats()),
            "verify_signatures": verify,
            "migrate_signatures": self._migrate_c.cache_stats(),
            "metrics": self.metrics.snapshot(),
        }

    # --------------------------------------------------------- constructors
    @classmethod
    def _wire_draft_model(cls, kw, draft_model, decode_step, init_cache,
                          seq_bound: Optional[int], device) -> None:
        """Turn a `draft_model=(params, cfg)` pair into a
        `SmallModelDrafter` over the family's own decode step (in `kw`
        as `drafter`, unless the caller passed one explicitly)."""
        if draft_model is None or kw.get("drafter") is not None:
            return
        from .speculate import SmallModelDrafter

        dparams, dcfg = draft_model
        scfg = kw.get("config") or ServeConfig()
        max_len = max(scfg.decode_buckets)
        if seq_bound is not None:
            max_len = min(max_len, seq_bound)
        kw["drafter"] = SmallModelDrafter(
            dparams,
            model_decode=lambda p, c, t, pos: decode_step(
                p, dcfg, c, t, pos),
            init_cache=lambda b, L: init_cache(dcfg, b, L, device=device),
            max_len=max_len, device=device)

    @staticmethod
    def _params_device(params, draft_model, device) -> torch.device:
        """The session's device (default: the card); raises unless the
        params (and the draft model's) all live there."""
        device = resolve_device(device)
        want = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        where = {t.device for t in pytree.tree_leaves(params)}
        if draft_model is not None:
            where |= {t.device for t in pytree.tree_leaves(draft_model[0])}
        if where != {want}:
            raise ValueError(f"params live on {sorted(map(str, where))}, the "
                             f"session runs on {want}; place them there "
                             f"first")
        return device

    @classmethod
    def for_gpt(cls, params, cfg, *, device=None, draft_model=None, **kw):
        """Session over models/gpt.py on `device` (default: the card),
        where `params` must already live (whole: over a `mesh=`, each
        rank holds them and each program takes its shards).
        decode_buckets must fit cfg.seq (the learned-position-table
        bound).
        `draft_model=(params, cfg)` wires a `SmallModelDrafter` over a
        second (smaller) gpt, for `speculate_drafter="draft_model"`."""
        from easydist_tpu_torch.models import gpt

        device = cls._params_device(params, draft_model, device)
        kw.setdefault("compile_key",
                      ("gpt", dataclasses.astuple(cfg), str(device)))
        if draft_model is not None:
            cls._wire_draft_model(kw, draft_model, gpt.gpt_decode_step,
                                  gpt.init_kv_cache,
                                  seq_bound=draft_model[1].seq,
                                  device=device)
        return cls(
            params,
            model_prefill=lambda p, c, t, l: gpt.gpt_prefill(p, cfg, c, t, l),
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
            model_verify=lambda p, c, t, pos: gpt.gpt_verify_step(
                p, cfg, c, t, pos),
            model_verify_paged=lambda p, pg, tb, t, pos:
                gpt.gpt_verify_step_paged(p, cfg, pg, tb, t, pos),
            device=device, max_prompt_len=cfg.seq, **kw)

    @classmethod
    def for_llama(cls, params, cfg, *, device=None, draft_model=None, **kw):
        """Session over models/llama.py on `device` (default: the card),
        where `params` must already live.  RoPE has no learned position
        table, so neither the buckets nor the prompts are bound by
        cfg.seq.  `draft_model=(params, cfg)` wires a `SmallModelDrafter`
        over a second (smaller) llama, for
        `speculate_drafter="draft_model"`."""
        from easydist_tpu_torch.models import llama

        device = cls._params_device(params, draft_model, device)
        kw.setdefault("compile_key",
                      ("llama", dataclasses.astuple(cfg), str(device)))
        if draft_model is not None:
            cls._wire_draft_model(kw, draft_model, llama.llama_decode_step,
                                  llama.init_kv_cache, seq_bound=None,
                                  device=device)
        return cls(
            params,
            model_prefill=lambda p, c, t, l: llama.llama_prefill(
                p, cfg, c, t, l),
            model_prefill_chunk=lambda p, c, t, s, l:
                llama.llama_prefill_chunk(p, cfg, c, t, s, l),
            model_decode=lambda p, c, t, pos: llama.llama_decode_step(
                p, cfg, c, t, pos),
            init_cache=lambda b, L, dt=None: llama.init_kv_cache(
                cfg, b, L, dtype=dt, device=device),
            model_prefill_chunk_paged=lambda p, pg, tb, t, s, l:
                llama.llama_prefill_chunk_paged(p, cfg, pg, tb, t, s, l),
            model_decode_paged=lambda p, pg, tb, t, pos:
                llama.llama_decode_step_paged(p, cfg, pg, tb, t, pos),
            init_pages=lambda n, t, dt=None, **qkw: llama.init_kv_pages(
                cfg, n, t, dtype=dt, device=device, **qkw),
            model_verify=lambda p, c, t, pos: llama.llama_verify_step(
                p, cfg, c, t, pos),
            model_verify_paged=lambda p, pg, tb, t, pos:
                llama.llama_verify_step_paged(p, cfg, pg, tb, t, pos),
            device=device, **kw)
