"""Circuit breaker for the serving engine (port of
easydist_tpu/resilience/breaker.py, which imports nothing of JAX).

When the executor starts failing persistently (device wedged, tunnel down,
every batch timing out), retrying each request individually multiplies the
damage: every queued request burns a full watchdog timeout before failing,
latency explodes, and the queue stays pinned at capacity.  The breaker
converts persistent failure into FAST, structured rejection at the door —
clients see `CircuitOpenError` with a retry-after hint instead of a
timeout, and the engine probes recovery on its own schedule.

Classic three-state machine, clock-injectable for deterministic tests:

    CLOSED     normal admission; failures/latency tracked
    OPEN       everything shed until `cooldown_s` elapses
    HALF_OPEN  a limited number of probe requests admitted; one success
               closes the circuit, one failure re-opens it

Trip conditions (either):
  * `failure_threshold` consecutive executor failures, or
  * observed p99 execute latency above `p99_threshold_s` once at least
    `min_samples` executions were seen (the brownout trip: the device is
    answering, but so slowly that admitting more load only digs deeper).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Thread-safe; all transitions under one lock (serving hot path does
    one lock acquisition per admit/record — negligible next to dispatch)."""

    def __init__(self, failure_threshold: int = 5,
                 cooldown_s: float = 1.0,
                 p99_threshold_s: Optional[float] = None,
                 min_samples: int = 20,
                 half_open_probes: int = 1,
                 p99: Optional[Callable[[], Optional[float]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 replica_id: Optional[str] = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        if half_open_probes < 1:
            raise ValueError(
                f"half_open_probes must be >= 1, got {half_open_probes}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.p99_threshold_s = p99_threshold_s
        self.min_samples = min_samples
        self.half_open_probes = half_open_probes
        self._p99 = p99  # callable returning current p99 seconds (or None)
        self.clock = clock
        # fleet label: stamped into snapshot() so per-replica breaker
        # states aggregate without key collisions
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._samples = 0
        self._opened_t: Optional[float] = None
        self._probes_in_flight = 0
        self._times_opened = 0

    # -------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._state == OPEN and self._opened_t is not None \
                and self.clock() - self._opened_t >= self.cooldown_s:
            self._state = HALF_OPEN
            self._probes_in_flight = 0
        return self._state

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN or self._opened_t is None:
                return 0.0
            return max(0.0, self.cooldown_s
                       - (self.clock() - self._opened_t))

    def snapshot(self) -> dict:
        with self._lock:
            return {"replica_id": self.replica_id,
                    "state": self._state_locked(),
                    "consecutive_failures": self._consecutive_failures,
                    "times_opened": self._times_opened}

    # ---------------------------------------------------------- transitions
    def allow(self) -> bool:
        """Admission decision.  CLOSED -> True; OPEN -> False; HALF_OPEN ->
        True for up to `half_open_probes` in-flight probes."""
        with self._lock:
            state = self._state_locked()
            if state == CLOSED:
                return True
            if state == OPEN:
                return False
            if self._probes_in_flight >= self.half_open_probes:
                return False
            self._probes_in_flight += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            self._samples += 1
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probes_in_flight = 0
            # brownout trip: healthy completions but pathological latency
            if self._state == CLOSED and self.p99_threshold_s is not None \
                    and self._p99 is not None \
                    and self._samples >= self.min_samples:
                p99 = self._p99()
                if p99 is not None and p99 > self.p99_threshold_s:
                    self._trip_locked()

    def record_failure(self) -> None:
        with self._lock:
            self._samples += 1
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._trip_locked()
            elif self._state == CLOSED \
                    and self._consecutive_failures >= self.failure_threshold:
                self._trip_locked()

    def _trip_locked(self) -> None:
        self._state = OPEN
        self._opened_t = self.clock()
        self._probes_in_flight = 0
        self._times_opened += 1
