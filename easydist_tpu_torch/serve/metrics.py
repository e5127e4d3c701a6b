"""Serving observability: counters, gauges, latency histograms.

Port of easydist_tpu/serve/metrics.py for the generation session's
bucketed and paged paths.  The PerfDB export, the replica label, the
prompt-length histogram and the recorders of layers not ported yet
(request batching, speculation) are left out.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# log-spaced bucket upper bounds, 0.1ms .. ~107s (x2 per bucket)
_DEFAULT_BOUNDS = tuple(1e-4 * (2 ** i) for i in range(21))


class LatencyHistogram:
    """Fixed log-spaced histogram over seconds.  Percentiles resolve to the
    upper bound of the bucket containing the rank — a <=2x overestimate by
    construction, stable under any traffic shape, O(1) memory."""

    def __init__(self, bounds=_DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow bucket
        self.total = 0
        self.sum = 0.0

    def observe(self, seconds: float) -> None:
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if seconds <= b:
                idx = i
                break
        self.counts[idx] += 1
        self.total += 1
        self.sum += seconds

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100] -> seconds (bucket upper bound), None when empty."""
        if self.total == 0:
            return None
        rank = max(1, int(round(p / 100.0 * self.total)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1] * 2
        return self.bounds[-1] * 2

    def mean(self) -> Optional[float]:
        return self.sum / self.total if self.total else None

    def snapshot(self) -> Dict[str, float]:
        out = {"count": self.total}
        if self.total:
            out.update(mean_s=self.mean(),
                       p50_s=self.percentile(50),
                       p95_s=self.percentile(95),
                       p99_s=self.percentile(99))
        return out


class ServeMetrics:
    """Thread-safe counters/gauges/histograms for one generation session.

    Counters (monotonically increasing): requests_submitted /
      requests_completed, tokens_generated (decode steps x active
      slots; a prefill's first token is not counted), decode_steps,
      prefills (admissions), prefill_chunks (batched chunk calls),
      prefill_tokens_real (prompt tokens needing prefill, prefix reuse
      deducted), prefill_tokens_padded (rows x chunk per call),
      prefix_tokens_reused / prefix_tokens_total,
      copy_on_restore_bytes_saved (paged: prefix bytes mapped into a
      page table instead of copied).
    Gauges: queue_depth, decode_slot_occupancy (active / total slots at
      the last decode step), prefill_padding_ratio (executed token slots
      per real prefill token), prefix_cache_hit_rate (fraction of prompt
      tokens restored from the prefix trie); paged: kv_pages_in_use,
      kv_page_utilization (real tokens / capacity of the live pages),
      kv_quant_bytes_saved (int8 arena bytes not spent vs model
      precision on the live pages).
    Histograms: execute (one prefill chunk call), per_token (one decode
      step, all slots), ttft (submit -> first token)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self.execute = LatencyHistogram()
        self.per_token = LatencyHistogram()
        self.ttft = LatencyHistogram()

    # ------------------------------------------------------------- recording
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, hist_name: str, seconds: float) -> None:
        with self._lock:
            getattr(self, hist_name).observe(seconds)

    def record_decode_step(self, n_active: int, n_slots: int,
                           step_s: float) -> None:
        """One token step across the whole slot pool: `n_active` slots
        produced a real token, `n_slots` rows executed either way."""
        with self._lock:
            self._counters["tokens_generated"] = \
                self._counters.get("tokens_generated", 0) + n_active
            self._counters["decode_steps"] = \
                self._counters.get("decode_steps", 0) + 1
            self._gauges["decode_slot_occupancy"] = \
                (n_active / n_slots) if n_slots else 0.0
            self.per_token.observe(step_s)

    def record_admission(self, prompt_len: int, prefix_len: int) -> None:
        """One prompt admitted into the chunked-prefill scheduler:
        `prefix_len` of its `prompt_len` tokens were restored from the
        prefix trie, the rest must run through prefill."""
        with self._lock:
            self._counters["prefills"] = \
                self._counters.get("prefills", 0) + 1
            self._counters["prefill_tokens_real"] = \
                self._counters.get("prefill_tokens_real", 0) \
                + (prompt_len - prefix_len)
            self._counters["prefix_tokens_reused"] = \
                self._counters.get("prefix_tokens_reused", 0) + prefix_len
            total = self._counters["prefix_tokens_total"] = \
                self._counters.get("prefix_tokens_total", 0) + prompt_len
            self._gauges["prefix_cache_hit_rate"] = \
                self._counters["prefix_tokens_reused"] / total

    def record_prefill_chunk(self, n_rows: int, chunk: int,
                             chunk_s: float) -> None:
        """One batched chunk call: `n_rows` staging rows executed `chunk`
        token slots each (idle rows and padded tails included — that IS
        the waste the padding-ratio gauge measures)."""
        with self._lock:
            self._counters["prefill_chunks"] = \
                self._counters.get("prefill_chunks", 0) + 1
            padded = self._counters["prefill_tokens_padded"] = \
                self._counters.get("prefill_tokens_padded", 0) \
                + n_rows * chunk
            real = self._counters.get("prefill_tokens_real", 0)
            if real:
                self._gauges["prefill_padding_ratio"] = padded / real
            self.execute.observe(chunk_s)

    def record_kv_pool(self, pages_in_use: int, mapped_tokens: int,
                       page_tokens: int,
                       quant_bytes_saved: Optional[int] = None) -> None:
        """Paged-KV pool occupancy: `pages_in_use` arena pages are live
        (slot-mapped or trie-held) holding `mapped_tokens` real tokens of
        `pages_in_use * page_tokens` capacity.  `kv_page_utilization` is
        the fill fraction (1 - it is the paged layout's only padding
        waste); `quant_bytes_saved` is the device memory the live pages
        did NOT spend versus model-precision storage."""
        with self._lock:
            self._gauges["kv_pages_in_use"] = pages_in_use
            cap = pages_in_use * page_tokens
            self._gauges["kv_page_utilization"] = \
                (mapped_tokens / cap) if cap else 1.0
            if quant_bytes_saved is not None:
                self._gauges["kv_quant_bytes_saved"] = quant_bytes_saved

    def record_copy_on_restore_saved(self, nbytes: int) -> None:
        """A prefix restore mapped `nbytes` of committed pages into a
        sequence's page table instead of copying them — the zero-copy
        restore, measured."""
        with self._lock:
            self._counters["copy_on_restore_bytes_saved"] = \
                self._counters.get("copy_on_restore_bytes_saved", 0) + nbytes

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # ------------------------------------------------------------- reporting
    def prefill_padding_ratio(self) -> Optional[float]:
        """Executed prefill token slots per real prefill token (>= 1.0;
        1.0 = every executed slot carried a real token)."""
        with self._lock:
            padded = self._counters.get("prefill_tokens_padded", 0)
            real = self._counters.get("prefill_tokens_real", 0)
        return padded / real if real else None

    def prefix_cache_hit_rate(self) -> Optional[float]:
        """Fraction of submitted prompt tokens restored from the prefix
        trie instead of recomputed."""
        with self._lock:
            reused = self._counters.get("prefix_tokens_reused", 0)
            total = self._counters.get("prefix_tokens_total", 0)
        return reused / total if total else None

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {"execute": self.execute.snapshot(),
                     "per_token": self.per_token.snapshot(),
                     "ttft": self.ttft.snapshot()}
        return {"counters": counters, "gauges": gauges,
                "latency": hists,
                "prefill_padding_ratio": self.prefill_padding_ratio(),
                "prefix_cache_hit_rate": self.prefix_cache_hit_rate()}
