"""SIGTERM preemption handling for the training loop: the port of
easydist_tpu/resilience/preempt.py (which imports nothing of JAX; the
port keeps its own copy).

Preemptible machines deliver SIGTERM with a grace window before the
kill.  The handler turns the signal into a FLAG; the elastic loop checks
it at the next step boundary, takes one synchronous final checkpoint
inside the grace budget, and exits through `PreemptedError`, which
carries the step it persisted.  The previous handler is restored on
exit.

Signal handlers install only from the main thread; elsewhere the handler
degrades to flag-only mode and `request()` stays available.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


class PreemptedError(RuntimeError):
    """The loop exited because preemption was requested; `step` is the last
    step whose state was checkpointed before exit."""

    def __init__(self, step: int, checkpoint_s: float):
        self.step = step
        self.checkpoint_s = checkpoint_s
        super().__init__(
            f"preempted: final checkpoint at step {step} took "
            f"{checkpoint_s:.2f}s; exiting for restart-resume")


class PreemptionHandler:
    """Context manager: arms a SIGTERM-to-flag handler for the loop body.

        with PreemptionHandler(grace_s=30.0) as pre:
            for step in ...:
                if pre.requested:
                    <final checkpoint>; raise PreemptedError(...)
    """

    def __init__(self, grace_s: float = 30.0):
        if grace_s <= 0:
            raise ValueError(f"grace_s must be > 0, got {grace_s}")
        self.grace_s = grace_s
        self._event = threading.Event()
        self._prev = None
        self._installed = False
        self._requested_t: Optional[float] = None

    def __enter__(self) -> "PreemptionHandler":
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        except ValueError:
            logger.warning(
                "preempt: not on the main thread, SIGTERM handler not "
                "installed (flag-only mode)")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False

    def _on_signal(self, signum, frame) -> None:
        self.request()

    def request(self) -> None:
        """Mark preemption requested (signal handler or embedder call)."""
        if not self._event.is_set():
            self._requested_t = time.monotonic()
            logger.warning(
                "preempt: termination requested; final checkpoint at the "
                "next step boundary (grace budget %.1fs)", self.grace_s)
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def grace_remaining(self) -> float:
        """Seconds left of the grace budget (inf before any request)."""
        if self._requested_t is None:
            return float("inf")
        return self.grace_s - (time.monotonic() - self._requested_t)
