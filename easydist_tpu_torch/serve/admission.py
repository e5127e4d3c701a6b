"""Admission control and robustness policies for the serving engine
(port of easydist_tpu/serve/admission.py).

Three concerns live here, all independent of how batches are packed or run:

- backpressure: a bounded queue rejects (`QueueFullError`) instead of
  buffering unboundedly — the caller sheds load or retries upstream;
- deadlines: every request carries an absolute expiry; an expired request
  surfaces `DeadlineExceededError` instead of occupying a batch slot;
- failure policy: transient executor failures are retried with jittered
  exponential backoff (`retry_transient`) that never sleeps past the
  request's deadline, and a bucket whose compile exhausts device memory is
  classified by `is_oom_error` so the engine can degrade to smaller batch
  buckets rather than failing every request routed to it;
- degradation signals: `ExecTimeoutError` (the execute watchdog fired) and
  `CircuitOpenError` (the breaker is shedding load, with a retry-after
  hint) give clients STRUCTURED failure they can route on, instead of a
  hang or an opaque stack.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

import torch


class ServeError(Exception):
    """Base class for serving-layer failures."""


class QueueFullError(ServeError):
    """Backpressure: the bounded request queue is at capacity."""


class DeadlineExceededError(ServeError):
    """The request's deadline expired before a result was produced."""


class EngineStoppedError(ServeError):
    """The engine was stopped while the request was still pending."""


class RequestTooLargeError(ServeError):
    """A request dimension exceeds the largest configured bucket."""


class ReplicaDrainingError(ServeError):
    """The session is draining (scale-down in progress): it retires its
    in-flight work but admits nothing new.  A fleet router routes the
    request to another replica; a direct caller should back off."""


class ExecTimeoutError(ServeError):
    """One device execution exceeded the per-batch watchdog deadline.
    The dispatch itself cannot be cancelled (a launched CUDA kernel runs
    to its end); the engine abandons the wedged call on its worker thread
    and fails the batch so clients stop waiting."""


class CircuitOpenError(ServeError):
    """The engine's circuit breaker is OPEN: the executor is persistently
    failing (or browned out on latency) and load is shed at the door.
    `retry_after_s` hints when the breaker will next admit a probe."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        self.retry_after_s = retry_after_s
        super().__init__(msg)


def is_oom_error(exc: BaseException) -> bool:
    """Device-memory exhaustion during tracing or execution: PyTorch's
    `torch.cuda.OutOfMemoryError` ("CUDA out of memory"), and the
    messages the JAX package classifies (RESOURCE_EXHAUSTED, allocators'
    "out of memory", "allocation failure")."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc).lower()
    return ("resource_exhausted" in msg or "out of memory" in msg
            or "allocation failure" in msg or type(exc).__name__ == "OomError")


def is_transient_error(exc: BaseException) -> bool:
    """Failures worth retrying: runtime hiccups (UNAVAILABLE/ABORTED RPC
    states, connection resets), never programming errors or OOM — retrying
    an OOM at the same shape just re-exhausts the device."""
    if is_oom_error(exc):
        return False
    if isinstance(exc, (TypeError, ValueError, KeyError, AttributeError,
                        ServeError)):
        return False
    msg = str(exc).lower()
    return any(tok in msg for tok in (
        "unavailable", "aborted", "deadline_exceeded", "connection reset",
        "transient", "cancelled", "socket closed"))


def retry_transient(fn: Callable, *, max_retries: int, backoff_s: float,
                    is_transient: Callable[[BaseException], bool]
                    = is_transient_error,
                    sleep: Callable[[float], None] = time.sleep,
                    jitter: float = 0.0,
                    deadline_t: Optional[float] = None,
                    clock: Callable[[], float] = time.monotonic,
                    rng: Callable[[], float] = random.random):
    """Call `fn()` retrying transient failures with jittered exponential
    backoff (backoff_s, 2*backoff_s, 4*backoff_s, ..., each stretched by up
    to `jitter` fraction — synchronized retry storms from many batchers
    hitting one wedged device are worse than the failure itself).

    Non-transient failures and the final attempt's failure propagate.  With
    `deadline_t` (absolute `clock()` seconds), a retry whose backoff would
    land past the deadline is NOT taken: the prior failure propagates
    immediately — sleeping through the caller's deadline to deliver a
    result nobody is waiting for helps no one."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classification decides
            if attempt >= max_retries or not is_transient(e):
                raise
            delay = backoff_s * (2 ** attempt)
            if jitter:
                delay *= 1.0 + jitter * rng()
            if deadline_t is not None and clock() + delay >= deadline_t:
                raise
            sleep(delay)
            attempt += 1


class AdmissionController:
    """Admission decision at submit time: assign the absolute deadline and
    enforce queue-depth backpressure.  Kept separate from the queue so the
    policy is unit-testable without threads."""

    def __init__(self, max_queue: int,
                 default_deadline_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.default_deadline_ms = default_deadline_ms
        self.clock = clock

    def resolve_deadline(self, deadline_ms: Optional[float]) -> Optional[float]:
        """Relative deadline (ms, or None for the config default) ->
        absolute monotonic expiry seconds (None = no deadline)."""
        ms = deadline_ms if deadline_ms is not None else self.default_deadline_ms
        if ms is None:
            return None
        return self.clock() + ms / 1e3

    def check_depth(self, depth: int) -> None:
        if depth >= self.max_queue:
            raise QueueFullError(
                f"request queue at capacity ({self.max_queue}); shed load "
                f"or raise ServeConfig.max_queue")
