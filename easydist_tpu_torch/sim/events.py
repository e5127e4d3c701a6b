"""Discrete-event substrate for the performance simulator (port of
easydist_tpu/sim/events.py, which imports nothing of JAX).

Three small pieces, all deterministic and host-only:

  `EventLog`     an append-only trace of (time, kind, payload) records —
                 the replay artifact audits and tests inspect.
  `Stream`       one serially-occupied execution resource (a compute
                 stream, a comm stream, one replica's decode loop).
                 `reserve(ready, dur)` places work at the earliest
                 instant both the work and the stream are ready, exactly
                 like a CUDA stream executes enqueued kernels in order
                 (and the host issues them one after another).
  `ServerPool`   c identical FCFS servers with least-loaded dispatch —
                 the open-loop queueing layer the capacity planner runs
                 arrivals through.  Least-loaded mirrors the fleet
                 router's occupancy scoring term: a new request lands on
                 the replica that frees up first.

DistIR (arXiv:2111.05426) frames distributed-performance prediction as
trace replay over per-op costs on per-device timelines; this module is
that timeline machinery, with the costs supplied by `sim.simulate`.
Events are pure python, so the planner can sweep hundreds of
configurations in milliseconds.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Event", "EventLog", "Stream", "ServerPool", "percentile"]


@dataclass(frozen=True)
class Event:
    time: float
    kind: str
    payload: Dict[str, Any] = field(default_factory=dict)


class EventLog:
    """Append-only, time-ordered-on-read trace of simulation events."""

    def __init__(self):
        self._events: List[Event] = []

    def record(self, time: float, kind: str, **payload) -> Event:
        ev = Event(float(time), kind, dict(payload))
        self._events.append(ev)
        return ev

    def events(self, kind: Optional[str] = None) -> List[Event]:
        evs = [e for e in self._events if kind is None or e.kind == kind]
        return sorted(evs, key=lambda e: (e.time, e.kind))

    def makespan(self) -> float:
        return max((e.time for e in self._events), default=0.0)

    def __len__(self) -> int:
        return len(self._events)


class Stream:
    """One serially-occupied resource: enqueued work runs in order, each
    unit starting when both its inputs and the stream are free."""

    def __init__(self, name: str, log: Optional[EventLog] = None):
        self.name = name
        self.log = log
        self.free_at = 0.0
        self.busy_s = 0.0

    def reserve(self, ready: float, duration: float,
                label: str = "") -> Tuple[float, float]:
        """Place `duration` seconds of work that becomes ready at time
        `ready`; returns (start, end)."""
        if duration < 0.0:
            raise ValueError(f"negative duration {duration} on {self.name}")
        start = max(float(ready), self.free_at)
        end = start + float(duration)
        self.free_at = end
        self.busy_s += float(duration)
        if self.log is not None and duration > 0.0:
            self.log.record(end, f"{self.name}.done", label=label,
                            start=start, duration=float(duration))
        return start, end

    def utilization(self, horizon: Optional[float] = None) -> float:
        h = horizon if horizon is not None else self.free_at
        return self.busy_s / h if h > 0 else 0.0


class ServerPool:
    """`c` identical FCFS servers with least-loaded (earliest-free)
    dispatch.  `submit` returns (start, end, server_idx); sojourn values
    accumulate for percentile queries afterwards."""

    def __init__(self, c: int, log: Optional[EventLog] = None,
                 name: str = "server"):
        if c < 1:
            raise ValueError(f"need at least one server, got {c}")
        self.name = name
        self.log = log
        # (free_at, idx) heap: ties broken by index, so identical traffic
        # on identical pools dispatches identically — determinism is what
        # lets the autoscale drill assert decisions against the planner
        self._free: List[Tuple[float, int]] = [(0.0, i) for i in range(c)]
        heapq.heapify(self._free)
        self.waits: List[float] = []
        self.sojourns: List[float] = []

    @property
    def size(self) -> int:
        return len(self._free)

    def submit(self, arrival: float, service_s: float
               ) -> Tuple[float, float, int]:
        free_at, idx = heapq.heappop(self._free)
        start = max(float(arrival), free_at)
        end = start + float(service_s)
        heapq.heappush(self._free, (end, idx))
        self.waits.append(start - float(arrival))
        self.sojourns.append(end - float(arrival))
        if self.log is not None:
            self.log.record(end, f"{self.name}.served", server=idx,
                            arrival=float(arrival), start=start,
                            service=float(service_s))
        return start, end, idx

    def drain_time(self) -> float:
        return max(t for t, _ in self._free)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over a plain list — the
    planner's p99 on simulated sojourns.  Empty input -> 0.0."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      int(round(q / 100.0 * (len(ordered) - 1)))))
    return float(ordered[rank])
