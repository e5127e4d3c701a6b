"""Replica failure detection: step-liveness heartbeats + stall probes
(port of easydist_tpu/fleet/health.py, which imports nothing of JAX).

A crashed replica is easy — its `step()` raises and the router fails over
on the spot.  The dangerous failure is the WEDGED replica: the process is
alive, `step()` returns, but no work retires (device hang, deadlocked
host thread, runaway collective).  Requests parked there starve silently
while the breaker — which only counts *exceptions* — stays CLOSED.

`HealthMonitor` closes that gap with a liveness heartbeat derived from
the counters every session already keeps (`ServeMetrics.decode_steps`,
`prefill_chunks`, `requests_completed`): a probe is a MISS when the
replica holds live work (`queue_depth > 0`) but none of its progress
counters advanced since the previous probe.  `miss_budget` consecutive
misses mark the replica DEAD — ineligible exactly like an OPEN breaker,
and the router then treats it as crashed (removes it and resumes its
in-flight requests elsewhere from their `ResumeDescriptor`s).

Probes are clock-gated by `probe_interval_ms` (0 = probe on every call —
the deterministic CI setting); the clock is injectable so tests drive
time explicitly.  `fleet.probe.flap` injects a FALSE miss into one
probe evaluation: a single flap must be absorbed by the miss budget
(no state change beyond SUSPECT), while a persistent flap must escalate
to DEAD and a successful failover — both are tested contracts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from easydist_tpu_torch.resilience import faultinject

__all__ = ["ALIVE", "SUSPECT", "DEAD", "HealthConfig", "HealthMonitor"]

ALIVE = "alive"
SUSPECT = "suspect"   # >=1 consecutive miss, budget not exhausted
DEAD = "dead"

# progress counters whose sum forms the liveness heartbeat
_PROGRESS_COUNTERS = ("decode_steps", "prefill_chunks",
                      "requests_completed")


@dataclass(frozen=True)
class HealthConfig:
    """probe_interval_ms: min wall-clock between probe rounds (0 probes
    every call — deterministic tests/CI).  miss_budget: consecutive
    missed probes before a replica is declared DEAD (>=1; a budget of 1
    tolerates zero flaps, so keep it >=2 where probes can race work)."""
    probe_interval_ms: float = 0.0
    miss_budget: int = 3

    def __post_init__(self):
        if self.miss_budget < 1:
            raise ValueError(
                f"miss_budget must be >= 1, got {self.miss_budget}")
        if self.probe_interval_ms < 0:
            raise ValueError("probe_interval_ms must be >= 0")


class _ReplicaHealth:
    __slots__ = ("state", "misses", "last_progress")

    def __init__(self):
        self.state = ALIVE
        self.misses = 0
        self.last_progress: Optional[int] = None


class HealthMonitor:
    """Tracks ALIVE/SUSPECT/DEAD per replica id.

    The router drives `probe()` once per fleet step; `mark_dead()` is the
    immediate path for replicas whose step() raised.  DEAD is sticky
    until `revive()` (the router calls it from `add_replica`, so
    re-registering a replica id is the revive operation)."""

    def __init__(self, config: Optional[HealthConfig] = None, *,
                 clock: Callable[[], float] = None):
        import time

        self.config = config or HealthConfig()
        self._clock = clock or time.monotonic
        self._replicas: Dict[str, _ReplicaHealth] = {}
        self._last_probe_t: Optional[float] = None
        # bounded transition log: (replica_id, state, reason)
        self.events: List[Dict[str, str]] = []
        self._event_cap = 256

    # ------------------------------------------------------------ tracking
    def track(self, replica_id: str) -> None:
        self._replicas.setdefault(replica_id, _ReplicaHealth())

    def drop(self, replica_id: str) -> None:
        """Forget a replica (clean removal after drain or crash
        recovery); its DEAD tombstone is recorded in `events`."""
        self._replicas.pop(replica_id, None)

    def revive(self, replica_id: str) -> None:
        """Reset state for a re-registered replica id (a fresh session
        joining under a previously-crashed id)."""
        prev = self._replicas.get(replica_id)
        if prev is not None and prev.state != ALIVE:
            self._event(replica_id, ALIVE, "revived")
        self._replicas[replica_id] = _ReplicaHealth()

    def state(self, replica_id: str) -> str:
        h = self._replicas.get(replica_id)
        return h.state if h is not None else ALIVE

    def mark_dead(self, replica_id: str, reason: str = "crash") -> None:
        self.track(replica_id)
        h = self._replicas[replica_id]
        if h.state != DEAD:
            h.state = DEAD
            self._event(replica_id, DEAD, reason)

    # -------------------------------------------------------------- probing
    def probe(self, replicas) -> List[str]:
        """One probe round over `replicas` (objects exposing
        `.replica_id` and `.session`); returns replica ids newly DEAD
        this round.  Clock-gated by probe_interval_ms; 0 never skips."""
        now = self._clock()
        interval = self.config.probe_interval_ms / 1e3
        if interval > 0 and self._last_probe_t is not None \
                and now - self._last_probe_t < interval:
            return []
        self._last_probe_t = now
        newly_dead: List[str] = []
        for rep in sorted(replicas, key=lambda r: r.replica_id):
            rid = rep.replica_id
            self.track(rid)
            h = self._replicas[rid]
            if h.state == DEAD:
                continue
            progress = sum(rep.session.metrics.counter(c)
                           for c in _PROGRESS_COUNTERS)
            advanced = (h.last_progress is None
                        or progress > h.last_progress)
            h.last_progress = progress
            # flap: the probe itself lies about progress this one time
            if faultinject.fire("fleet.probe.flap"):
                advanced = False
            if advanced or rep.session.queue_depth == 0:
                # progressing, or idle (an idle replica SHOULD not move)
                if h.misses and h.state == SUSPECT:
                    self._event(rid, ALIVE, "progress resumed")
                h.misses = 0
                h.state = ALIVE
                continue
            h.misses += 1
            if h.misses >= self.config.miss_budget:
                h.state = DEAD
                self._event(rid, DEAD,
                            f"{h.misses} consecutive missed probes "
                            f"with queue_depth > 0")
                newly_dead.append(rid)
            elif h.state != SUSPECT:
                h.state = SUSPECT
                self._event(rid, SUSPECT, "missed probe")
        return newly_dead

    # ------------------------------------------------------------ reporting
    def _event(self, rid: str, state: str, reason: str) -> None:
        self.events.append(
            {"replica_id": rid, "state": state, "reason": reason})
        del self.events[:-self._event_cap]

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        return {rid: {"state": h.state, "misses": h.misses}
                for rid, h in self._replicas.items()}

    def transitions(self) -> List[Dict[str, str]]:
        """The state-transition event stream, oldest first — the
        layer-12 conformance surface `analyze.modelcheck.
        replay_health_events` validates against the HealthSpec's
        admitted relation (PROTO003).  Every replica starts ALIVE
        (track()), so the events alone determine each step's
        (from, to) edge."""
        return list(self.events)
