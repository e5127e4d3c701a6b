"""Serving observability: counters, gauges, latency histograms (port of
easydist_tpu/serve/metrics.py).

Everything a dashboard needs to judge a serving deployment — queue depth,
batch occupancy (real rows / bucket rows), executable-cache hit rate,
p50/p95/p99 latency — collected lock-cheap in-process and exported through
the existing runtime plumbing (`runtime.perfdb.PerfDB`), so serving history
lands next to the step-time history `EASYDIST_RUNTIME_PROF` already keeps.
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
    """Thread-safe counters/gauges/histograms for one `ServeEngine` or
    `GenerationSession`.

    Counter names (all monotonically increasing):
      requests_submitted / completed / failed / timed_out / rejected /
      shed (circuit open), batches_executed, batch_rows_real,
      batch_rows_padded, compile_cache_hits, compile_cache_misses,
      oom_degradations, transient_retries, exec_timeouts (watchdog),
      tokens_generated (decode steps x active slots).
    Chunked-prefill counters: prefills (admissions), prefill_chunks
      (batched chunk calls), prefill_tokens_real (prompt tokens actually
      needing prefill, prefix reuse already deducted),
      prefill_tokens_padded (executed token slots = rows x chunk per
      call), prefix_tokens_reused / prefix_tokens_total,
      prefix_cache_hits / misses / evictions (trie chunk events).
    Speculative-decoding counters (serve/speculate.py): verify_steps,
      draft_tokens_proposed / draft_tokens_accepted,
      verify_tokens_committed (tokens the verify rounds emitted),
      verify_host_us (the rounds' host time outside the compiled call),
      speculative_rollback_audits (paged page-table audits),
      speculative_rollback_pages_released (paged rollback returns);
      gauge acceptance_rate (lifetime accepted / proposed).
    Paged: copy_on_restore_bytes_saved; gauges kv_pages_in_use,
      kv_page_utilization, kv_quant_bytes_saved.
    Gauges: decode_slot_occupancy (active slots / total slots at the last
      decode step), prefill_padding_ratio (executed token slots per real
      prefill token, 1.0 = zero waste), prefix_cache_hit_rate (fraction
      of prompt tokens restored from the prefix trie).
    Histograms: queue_wait (submit->drain), execute (device time incl.
    host roundtrip), e2e (submit->future resolution), per_token (one
    decode-step wall time, all slots), ttft (submit->first token)."""

    def __init__(self, replica_id: Optional[str] = None):
        # fleet label: stamped into every snapshot and the default PerfDB
        # sub_key so N replicas' histories never collide under one key
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._prompt_hist: Dict[int, int] = {}  # prompt_len -> admissions
        self.queue_wait = LatencyHistogram()
        self.execute = LatencyHistogram()
        self.e2e = LatencyHistogram()
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

    def record_batch(self, n_real: int, bucket: int,
                     execute_s: float) -> None:
        with self._lock:
            self._counters["batches_executed"] = \
                self._counters.get("batches_executed", 0) + 1
            self._counters["batch_rows_real"] = \
                self._counters.get("batch_rows_real", 0) + n_real
            self._counters["batch_rows_padded"] = \
                self._counters.get("batch_rows_padded", 0) + bucket
            self.execute.observe(execute_s)

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

    def record_speculation(self, proposed: int, accepted: int,
                           committed: int, n_ran: int, n_slots: int,
                           step_s: float,
                           pages_released: int = 0) -> None:
        """One speculative verify round (serve/speculate.py): `proposed`
        draft tokens entered the verify step, `accepted` of them were
        ratified, `committed` tokens were emitted in total (accepted
        drafts + one correction/bonus per slot — these count toward
        `tokens_generated` exactly like decode-step tokens, since they
        ARE the plain-greedy tokens).  `n_ran` slots rode the verify
        program out of `n_slots` rows; `pages_released` arena pages were
        returned by the paged rollback.  `acceptance_rate` is the
        lifetime accepted/proposed ratio — the drafter-quality signal
        (speedup ~ committed tokens per verify step)."""
        with self._lock:
            self._counters["verify_steps"] = \
                self._counters.get("verify_steps", 0) + 1
            self._counters["draft_tokens_proposed"] = \
                self._counters.get("draft_tokens_proposed", 0) + proposed
            self._counters["draft_tokens_accepted"] = \
                self._counters.get("draft_tokens_accepted", 0) + accepted
            self._counters["tokens_generated"] = \
                self._counters.get("tokens_generated", 0) + committed
            self._counters["verify_tokens_committed"] = \
                self._counters.get("verify_tokens_committed", 0) + committed
            if pages_released:
                self._counters["speculative_rollback_pages_released"] = \
                    self._counters.get(
                        "speculative_rollback_pages_released", 0) \
                    + pages_released
            total = self._counters["draft_tokens_proposed"]
            if total:
                self._gauges["acceptance_rate"] = \
                    self._counters["draft_tokens_accepted"] / total
            self._gauges["decode_slot_occupancy"] = \
                (n_ran / n_slots) if n_slots else 0.0
            self.per_token.observe(step_s)

    def record_admission(self, prompt_len: int, prefix_len: int) -> None:
        """One prompt admitted into the chunked-prefill scheduler:
        `prefix_len` of its `prompt_len` tokens were restored from the
        prefix trie, the rest must run through prefill."""
        with self._lock:
            self._counters["prefills"] = \
                self._counters.get("prefills", 0) + 1
            # prompt-length histogram (exact counts per length): the
            # prompt distribution a capacity planner reconstructs
            self._prompt_hist[prompt_len] = \
                self._prompt_hist.get(prompt_len, 0) + 1
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
        the intra-page fill fraction — 1.0 means zero fragmentation, and
        (1 - it) is the only padding waste the paged layout CAN have
        (the bucketed pool pads every row to the bucket instead).
        `quant_bytes_saved` is device memory the live pages did NOT spend
        versus model-precision storage (block-scaled int8 payload + scales vs
        model dtype) — the quantized arena's density win, exported to
        the PerfDB with every snapshot."""
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
        restore contract, measured."""
        with self._lock:
            self._counters["copy_on_restore_bytes_saved"] = \
                self._counters.get("copy_on_restore_bytes_saved", 0) + nbytes

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # ------------------------------------------------------------- reporting
    def batch_occupancy(self) -> Optional[float]:
        """Mean fraction of bucket rows carrying real requests — the
        padding waste signal (1.0 = every executed row was real work)."""
        with self._lock:
            padded = self._counters.get("batch_rows_padded", 0)
            real = self._counters.get("batch_rows_real", 0)
        return real / padded if padded else None

    def compile_cache_hit_rate(self) -> Optional[float]:
        with self._lock:
            h = self._counters.get("compile_cache_hits", 0)
            m = self._counters.get("compile_cache_misses", 0)
        return h / (h + m) if (h + m) else None

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
            prompt_hist = dict(self._prompt_hist)
            hists = {"queue_wait": self.queue_wait.snapshot(),
                     "execute": self.execute.snapshot(),
                     "e2e": self.e2e.snapshot(),
                     "per_token": self.per_token.snapshot(),
                     "ttft": self.ttft.snapshot()}
        return {"replica_id": self.replica_id,
                "counters": counters, "gauges": gauges,
                "prompt_hist": prompt_hist,
                "latency": hists,
                "batch_occupancy": self.batch_occupancy(),
                "compile_cache_hit_rate": self.compile_cache_hit_rate(),
                "prefill_padding_ratio": self.prefill_padding_ratio(),
                "prefix_cache_hit_rate": self.prefix_cache_hit_rate()}

    def export(self, db=None, key: str = "serving",
               sub_key: Optional[str] = None, persist: bool = True):
        """Record the snapshot into the persistent PerfDB (the same store
        runtime profiling uses), appended to a bounded history list.  The
        default sub_key carries the replica label ("engine[r1]") so fleet
        replicas keep separate histories."""
        if db is None:
            from easydist_tpu_torch.runtime.perfdb import PerfDB

            db = PerfDB()
        if sub_key is None:
            sub_key = (f"engine[{self.replica_id}]" if self.replica_id
                       else "engine")
        db.append_history(key, sub_key, self.snapshot())
        if persist:
            try:
                db.persist()
            except Exception:  # metrics export must never fail serving
                pass
        return db
