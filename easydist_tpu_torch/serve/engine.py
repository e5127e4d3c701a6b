"""`ServeConfig`: bucketing, batching and admission policy (port of the
config half of easydist_tpu/serve/engine.py).

The dataclass keeps every field name of the JAX package's, so
configurations carry over.  The port serves the bucketed and the paged
KV layouts (exact or block-scaled int8 pages) without speculation so
far: `speculate_k > 0`, `kv_host_tier_bytes > 0` on the paged layout,
and a non-default value of any field only `ServeEngine` (the
request-shaped endpoint, not ported yet) or speculation reads raise
`NotImplementedError`.  Everything else is validated as the JAX package
validates it.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

from easydist_tpu_torch import torch_dtype

# fields no code of the port reads yet: a non-default value raises
# NotImplementedError instead of being silently ignored
_UNPORTED = frozenset({
    "batch_buckets", "seq_buckets", "max_wait_ms", "max_queue",
    "default_deadline_ms", "max_retries", "retry_backoff_ms", "retry_jitter",
    "unpad_outputs", "exec_timeout_ms", "breaker_failure_threshold",
    "breaker_cooldown_ms", "breaker_p99_threshold_ms", "breaker_min_samples",
    "speculate_drafter",
})


@dataclass(frozen=True)
class ServeConfig:
    """Bucketing + batching + admission policy.

    batch_buckets, seq_buckets, max_wait_ms, max_queue,
    default_deadline_ms, max_retries, retry_backoff_ms, retry_jitter,
    unpad_outputs, exec_timeout_ms, breaker_*: `ServeEngine` policy (not
        ported yet; a non-default value raises NotImplementedError).
    pad_value: fill for padded prompt positions (e.g. the pad token id).
    decode_buckets: allowed KV-cache max-lengths for token-level decode;
        each bucket owns one slot pool and exactly one compiled decode
        step.
    kv_cache_dtype: cache storage dtype ("auto" = the model's dtype,
        else a torch dtype name such as "bfloat16").
    max_decode_slots: slots per decode bucket — the fixed decode batch
        width (idle slots show up as occupancy, never as a new signature).
    prefill_chunk: token window of one chunked-prefill pass — prompts run
        in fixed [prefill_batch, prefill_chunk] chunk calls, so ONE
        compiled prefill signature per bucket serves every prompt length;
        also the prefix-cache chunk granularity (reuse is whole chunks).
    prefill_batch: staging rows — how many pending prompts pack into a
        single chunked-prefill call.
    prefill_chunks_per_step: chunk calls interleaved per `step()` before
        the decode rounds run — bounds decode latency under prefill
        pressure.
    enable_prefix_cache: commit/restore prefix KV chunks via the token
        trie (serve/prefix_cache.py); off = every prompt recomputes from
        position 0 (identical outputs either way).
    prefix_cache_bytes: LRU byte budget per decode bucket's trie; 0
        disables committing.
    kv_layout: "bucketed" (one padded slot pool per decode bucket) or
        "paged" (every bucket collapses into one page-granular pool over
        a preallocated arena; one compiled decode step for every length,
        zero-copy prefix restore).
    kv_page_tokens: tokens per arena page (paged; 0 = the effective
        prefill chunk, which it must equal: pages are the trie chunks).
    kv_arena_pages: allocatable arena pages (paged; 0 = (max_decode_slots
        + 1) * max_pages).
    kv_quant_dtype: "none" or "int8" (paged only, exclusive with a
        non-auto kv_cache_dtype): block-scaled int8 pages with f32 scales.
    kv_quant_block: head-dim elements per int8 scale block (0 = one block
        per row).
    kv_host_tier_bytes: the host tier of the paged layout (not ported
        yet: a value > 0 raises NotImplementedError once it is valid).
    speculate_k, speculate_drafter: speculative decoding; only the
        defaults (speculate_k=0) are served so far.
    """
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    seq_buckets: Optional[Tuple[int, ...]] = None
    max_wait_ms: float = 5.0
    max_queue: int = 256
    default_deadline_ms: Optional[float] = None
    max_retries: int = 2
    retry_backoff_ms: float = 10.0
    retry_jitter: float = 0.25
    pad_value: object = 0
    unpad_outputs: bool = True
    exec_timeout_ms: Optional[float] = None
    breaker_failure_threshold: int = 0
    breaker_cooldown_ms: float = 1000.0
    breaker_p99_threshold_ms: Optional[float] = None
    breaker_min_samples: int = 20
    decode_buckets: Tuple[int, ...] = (1024,)
    kv_cache_dtype: str = "auto"
    max_decode_slots: int = 8
    prefill_chunk: int = 64
    prefill_batch: int = 4
    prefill_chunks_per_step: int = 4
    enable_prefix_cache: bool = True
    prefix_cache_bytes: int = 64 * 2**20
    kv_layout: str = "bucketed"
    kv_page_tokens: int = 0
    kv_arena_pages: int = 0
    speculate_k: int = 0
    speculate_drafter: str = "ngram"
    kv_quant_dtype: str = "none"
    kv_quant_block: int = 0
    kv_host_tier_bytes: int = 0

    def __post_init__(self):
        for f in fields(self):
            if f.name in _UNPORTED and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"ServeConfig.{f.name} is not ported yet (it belongs to "
                    f"ServeEngine or speculation); leave "
                    f"it at its default {f.default!r}")
        if not self.decode_buckets or any(b < 1 for b in self.decode_buckets):
            raise ValueError(f"decode_buckets must be non-empty with every "
                             f"bucket >= 1: {self.decode_buckets}")
        if self.kv_cache_dtype != "auto":
            try:
                torch_dtype(self.kv_cache_dtype)
            except ValueError:
                raise ValueError(
                    f"kv_cache_dtype must be 'auto' or a torch dtype name, "
                    f"got {self.kv_cache_dtype!r}") from None
        if self.max_decode_slots < 1:
            raise ValueError(f"max_decode_slots must be >= 1, "
                             f"got {self.max_decode_slots}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {self.prefill_chunk}")
        for b in self.decode_buckets:
            # the effective chunk (min(prefill_chunk, bucket)) must tile
            # the bucket exactly: a chunk write that would spill past the
            # bucket gets its start CLAMPED, silently overwriting earlier
            # cache rows
            eff = min(self.prefill_chunk, b)
            if b % eff != 0:
                raise ValueError(
                    f"decode bucket {b} is not a multiple of the "
                    f"effective prefill chunk {eff} "
                    f"(prefill_chunk={self.prefill_chunk}); chunked "
                    f"prefill windows must tile the bucket exactly")
        if self.prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, "
                             f"got {self.prefill_batch}")
        if self.prefill_chunks_per_step < 1:
            raise ValueError(f"prefill_chunks_per_step must be >= 1, "
                             f"got {self.prefill_chunks_per_step}")
        if self.prefix_cache_bytes < 0:
            raise ValueError(f"prefix_cache_bytes must be >= 0 "
                             f"(0 disables), got {self.prefix_cache_bytes}")
        if self.kv_layout not in ("bucketed", "paged"):
            raise ValueError(f"kv_layout must be 'bucketed' or 'paged', "
                             f"got {self.kv_layout!r}")
        if self.kv_page_tokens < 0:
            raise ValueError(f"kv_page_tokens must be >= 0 (0 = the "
                             f"effective prefill chunk), "
                             f"got {self.kv_page_tokens}")
        if self.kv_arena_pages < 0:
            raise ValueError(f"kv_arena_pages must be >= 0 (0 = auto), "
                             f"got {self.kv_arena_pages}")
        if self.kv_layout == "paged":
            cap = max(self.decode_buckets)
            pt = self.kv_page_tokens or min(self.prefill_chunk, cap)
            if pt != min(self.prefill_chunk, cap):
                # pages ARE the prefix-trie chunks: a paged prefill chunk
                # fills exactly one page, and a restored trie node maps
                # exactly one page
                raise ValueError(
                    f"kv_page_tokens {pt} must equal the effective "
                    f"prefill chunk {min(self.prefill_chunk, cap)} in the "
                    f"paged layout (pages are the trie chunks)")
            if cap % pt != 0:
                raise ValueError(
                    f"max decode bucket {cap} is not a multiple of "
                    f"kv_page_tokens {pt}; pages must tile the sequence "
                    f"capacity exactly")
        if self.kv_quant_dtype not in ("none", "int8"):
            raise ValueError(f"kv_quant_dtype must be 'none' or 'int8', "
                             f"got {self.kv_quant_dtype!r}")
        if self.kv_quant_block < 0:
            raise ValueError(f"kv_quant_block must be >= 0 (0 = one block "
                             f"per row), got {self.kv_quant_block}")
        if self.kv_quant_dtype != "none":
            if self.kv_layout != "paged":
                raise ValueError(
                    f"kv_quant_dtype {self.kv_quant_dtype!r} requires the "
                    f"paged layout (quantize-on-commit lives in the page "
                    f"arena), got kv_layout={self.kv_layout!r}")
            if self.kv_cache_dtype != "auto":
                raise ValueError(
                    f"kv_quant_dtype {self.kv_quant_dtype!r} is mutually "
                    f"exclusive with a non-auto kv_cache_dtype "
                    f"({self.kv_cache_dtype!r}): the quantized arena owns "
                    f"its storage dtype (int8 payload + f32 scales)")
        if self.kv_host_tier_bytes < 0:
            raise ValueError(f"kv_host_tier_bytes must be >= 0 "
                             f"(0 disables), got {self.kv_host_tier_bytes}")
        if self.kv_host_tier_bytes:
            if self.kv_layout != "paged":
                raise ValueError(
                    f"kv_host_tier_bytes requires the paged layout (the "
                    f"tier demotes arena pages), got "
                    f"kv_layout={self.kv_layout!r}")
            if not self.enable_prefix_cache or not self.prefix_cache_bytes:
                raise ValueError(
                    "kv_host_tier_bytes requires the prefix cache (the "
                    "tier holds cold TRIE pages; with no trie there is "
                    "nothing to demote)")
            raise NotImplementedError(
                "the paged layout's host tier (kv_host_tier_bytes > 0) is "
                "not ported yet")
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0 (0 disables "
                             f"speculation), got {self.speculate_k}")
        if self.speculate_k:
            raise NotImplementedError(
                "speculative decoding (speculate_k > 0) is not ported yet")
