"""Communication accounting for the gradient collectives: the port of
easydist_tpu/comm/counters.py.

Every reduction the `easydist_tpu_torch.comm` wrappers issue is recorded
here when it is issued (eagerly, or once while `make_fx` traces a
step: shapes and dtypes are static, so the byte arithmetic is exact).
Wire bytes use the ring closed forms of `autoflow/cost_model.py`, so the
counters and the solver agree on what a collective costs:

  all_reduce       2 * payload * (n-1)/n      (reduce-scatter + all-gather)
  reduce_scatter   payload * (n-1)/n
  all_gather       payload * (n-1)/n

`bytes_fp32_equiv` is what the same reductions would move at full
precision without bucketing (the denominator of the compression ratio;
equal to `bytes_on_wire` for f32 gradients while quantization is not
ported).  Counters export to the port's PerfDB under ``comm_stats``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


def ring_all_reduce_bytes(payload_bytes: float, n: int) -> float:
    return 2.0 * payload_bytes * (n - 1) / n if n > 1 else 0.0


def ring_reduce_scatter_bytes(payload_bytes: float, n: int) -> float:
    return payload_bytes * (n - 1) / n if n > 1 else 0.0


def ring_all_gather_bytes(payload_bytes: float, n: int) -> float:
    return payload_bytes * (n - 1) / n if n > 1 else 0.0


class CommCounters:
    """Accumulates collective launches and bytes; thread-safe."""

    _FIELDS = ("launches", "quantized_launches", "fallback_launches",
               "bytes_on_wire", "bytes_fp32_equiv", "bucketed_leaves")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.quantized_launches = 0
            self.fallback_launches = 0
            self.bytes_on_wire = 0.0
            self.bytes_fp32_equiv = 0.0
            self.bucketed_leaves = 0

    def record(self, *, launches: int = 1, bytes_on_wire: float = 0.0,
               bytes_fp32_equiv: float = 0.0, quantized: bool = False,
               fallback: bool = False, bucketed_leaves: int = 0) -> None:
        with self._lock:
            self.launches += launches
            if quantized:
                self.quantized_launches += launches
            if fallback:
                self.fallback_launches += launches
            self.bytes_on_wire += bytes_on_wire
            self.bytes_fp32_equiv += bytes_fp32_equiv
            self.bucketed_leaves += bucketed_leaves

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            snap = {k: getattr(self, k) for k in self._FIELDS}
        wire, full = snap["bytes_on_wire"], snap["bytes_fp32_equiv"]
        snap["compression_ratio"] = (wire / full) if full > 0 else 1.0
        return snap

    def export_to_perfdb(self, sub_key: str = "comm",
                         db: Optional[object] = None) -> Dict[str, float]:
        """Persist the current snapshot under ("comm_stats", sub_key)."""
        from easydist_tpu_torch.runtime.perfdb import PerfDB

        snap = self.snapshot()
        db = db or PerfDB()
        db.record_op_perf("comm_stats", sub_key, snap)
        try:
            db.persist()
        except OSError:  # a read-only DB path must not break the step
            pass
        return snap


# the one instance the wrappers record into (one process, one accounting
# stream, as in the JAX package; reset() per scenario)
comm_counters = CommCounters()
