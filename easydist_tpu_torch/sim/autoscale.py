"""SLO autoscaler (port of easydist_tpu/sim/autoscale.py, which imports
nothing of JAX): a control loop that watches fleet ServeMetrics
through PerfDB snapshots, asks the capacity planner for a target replica
count, and actuates with machinery that already exists — `FleetRouter`
drain for scale-down (hot pages migrate to survivors), replica spin-up
via a caller-supplied factory for scale-up.

Safety properties, in priority order:

  * zero dropped requests: scale-down is a graceful (or evacuate) drain,
    never a kill; the bitwise-parity spine means committed tokens are
    identical to a fixed-fleet run whatever the scaler does;
  * hysteresis: a move needs `confirm_evals` consecutive agreeing
    observations, and the opposite direction is suppressed for
    `cooldown_evals` after any actuation — A-B-A flapping is the SIM002
    finding of `analyze.audit_scale_decisions` over `decision_log`;
  * graceful degradation: frozen metrics (`autoscale.metrics.stale`) or
    a failing spin-up (`autoscale.scaleup.fail`) hold the current N with
    a loud warning instead of acting on bad data — both are catalogued
    fault points (resilience/faultinject.py) the ramp drill arms.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from easydist_tpu_torch.resilience.faultinject import fire

logger = logging.getLogger(__name__)

__all__ = ["AutoscaleConfig", "MetricsView", "Autoscaler"]


@dataclass(frozen=True)
class MetricsView:
    """One observation of fleet load, parsed out of a PerfDB snapshot."""

    n_live: int                 # non-draining decode replicas
    occupancy: float            # mean decode-slot occupancy across them
    ttft_p99_s: float
    per_token_p99_s: float
    queue_depth: int
    inflight: int
    marker: tuple               # progress counters; frozen == stale feed
    stale_injected: bool = False


@dataclass
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    # threshold policy (used when no planner/traffic hint is wired)
    scale_up_occupancy: float = 0.85
    scale_down_occupancy: float = 0.30
    # hysteresis: consecutive agreeing evals before acting, and evals the
    # OPPOSITE direction stays suppressed after any actuation
    confirm_evals: int = 2
    cooldown_evals: int = 2
    # consecutive frozen-marker observations (with work in flight) before
    # the loop declares its metrics feed stale and degrades to hold
    stale_evals: int = 2
    drain_mode: str = "graceful"
    replica_prefix: str = "as"


class Autoscaler:
    """One instance per fleet.  Call `evaluate()` once per control tick;
    it observes, decides, and (maybe) actuates, appending one entry to
    `decision_log` either way — the SIM002 audit surface."""

    def __init__(self, router, spawn: Callable[[str], Any],
                 config: Optional[AutoscaleConfig] = None,
                 planner=None, slo=None, db=None):
        self.router = router
        self.spawn = spawn
        self.config = config or AutoscaleConfig()
        self.planner = planner
        self.slo = slo
        self.db = db
        self.traffic_hint = None
        self.decision_log: List[Dict[str, Any]] = []
        self.degraded = False
        self._tick = 0
        self._spawned = 0
        self._pending_dir = 0
        self._pending_count = 0
        self._cooldown = 0
        self._cooldown_dir = 0
        self._stale_count = 0
        self._last_view: Optional[MetricsView] = None

    # ------------------------------------------------------------ observe

    def set_traffic_hint(self, traffic) -> None:
        """Feed the planner the current arrival spec (a `TrafficSpec`).
        Open-loop drills know their own rate; production would estimate
        it from the admission counters."""
        self.traffic_hint = traffic

    def observe(self) -> MetricsView:
        """Export the fleet's ServeMetrics into a PerfDB and read them
        back through `snapshot()` — the loop consumes the same metrics
        surface an external dashboard would, not private router state."""
        if fire("autoscale.metrics.stale") and self._last_view is not None:
            # the injected failure mode: the feed keeps serving the LAST
            # exported sample (a wedged exporter), not an error
            view = dataclasses.replace(self._last_view,
                                       stale_injected=True)
            self._last_view = view
            return view

        import os

        from easydist_tpu_torch.runtime.perfdb import PerfDB

        # scratch store unless the caller wired a real one: devnull never
        # unpickles, so the DB starts empty and persist is never called
        db = self.db if self.db is not None else PerfDB(path=os.devnull)
        self.router.export_metrics(db=db, persist=False)
        snap = db.snapshot().get("serving", {})

        # snapshot-only-metrics contract (PROTO004): the autoscaler is
        # an observer — it reads the router's published snapshot, never
        # its private structures
        live = self.router.live_decode_snapshot()
        occs: List[float] = []
        ttfts: List[float] = []
        toks: List[float] = []
        marker: List[int] = []
        for rep in live:
            hist = snap.get(f"engine[{rep['replica_id']}]") or []
            if not hist:
                continue
            last = hist[-1]
            occs.append(float(last.get("gauges", {})
                              .get("decode_slot_occupancy", 0.0)))
            counters = last.get("counters", {})
            marker.append(int(counters.get("tokens_generated", 0)))
            lat = last.get("latency", {})
            ttfts.append(self._hist_p99(lat.get("ttft")))
            toks.append(self._hist_p99(lat.get("per_token")))
        fleet_hist = snap.get("engine[fleet]") or snap.get("fleet") or []
        fleet_gauges = (fleet_hist[-1].get("gauges", {})
                        if fleet_hist else {})
        view = MetricsView(
            n_live=len(live),
            occupancy=sum(occs) / len(occs) if occs else 0.0,
            ttft_p99_s=max(ttfts) if ttfts else 0.0,
            per_token_p99_s=max(toks) if toks else 0.0,
            queue_depth=int(fleet_gauges.get(
                "queue_depth", self.router.total_queue_depth)),
            inflight=int(fleet_gauges.get(
                "router_inflight", self.router.inflight_count)),
            marker=tuple(sorted(marker)))
        self._last_view = view
        return view

    @staticmethod
    def _hist_p99(hist_snap) -> float:
        """p99 out of an exported LatencyHistogram snapshot dict."""
        if not hist_snap:
            return 0.0
        for key in ("p99_s", "p99"):
            if key in hist_snap:
                return float(hist_snap[key])
        return 0.0

    # ------------------------------------------------------------- decide

    def _desired(self, view: MetricsView) -> int:
        cfg = self.config
        if self.planner is not None and self.traffic_hint is not None \
                and self.slo is not None:
            target = self.planner.target_replicas(self.traffic_hint,
                                                  self.slo)
        else:
            target = view.n_live
            busy = view.occupancy >= cfg.scale_up_occupancy \
                or view.queue_depth > 0
            if busy and view.occupancy >= cfg.scale_up_occupancy:
                target = view.n_live + 1
            elif view.occupancy <= cfg.scale_down_occupancy \
                    and view.queue_depth == 0 and view.inflight == 0:
                target = view.n_live - 1
        return max(cfg.min_replicas, min(cfg.max_replicas, target))

    def evaluate(self) -> Dict[str, Any]:
        """One control tick.  Returns (and logs) the decision record."""
        cfg = self.config
        self._tick += 1
        prev_marker = (self._last_view.marker
                       if self._last_view is not None else None)
        view = self.observe()

        entry: Dict[str, Any] = {
            "tick": self._tick, "n_live": view.n_live,
            "occupancy": round(view.occupancy, 4),
            "ttft_p99_s": round(view.ttft_p99_s, 6),
            "queue_depth": view.queue_depth,
        }

        # staleness detector: the progress marker must move while work is
        # in flight; a frozen feed means every number below is fiction
        if prev_marker is not None and view.marker == prev_marker \
                and (view.queue_depth > 0 or view.inflight > 0):
            self._stale_count += 1
        else:
            self._stale_count = 0
            if self.degraded:
                logger.info("[autoscale] metrics feed recovered")
            self.degraded = False
        if self._stale_count >= cfg.stale_evals:
            self.degraded = True
            logger.warning(
                "[autoscale] metrics feed is STALE (%d frozen "
                "observations with work in flight) — holding %d "
                "replicas, refusing to act on dead numbers",
                self._stale_count, view.n_live)
            entry.update(action="hold", target=view.n_live,
                         reason="metrics_stale", degraded=True)
            self.decision_log.append(entry)
            return entry

        target = self._desired(view)
        entry["target"] = target
        direction = (1 if target > view.n_live
                     else -1 if target < view.n_live else 0)

        if direction == 0:
            # idempotence: target == current never actuates and clears
            # any half-confirmed move
            self._pending_dir = 0
            self._pending_count = 0
            entry.update(action="hold", reason="at_target")
        elif self._cooldown > 0 and direction == -self._cooldown_dir:
            self._cooldown -= 1
            entry.update(action="hold", reason="cooldown_suppressed")
        else:
            if self._cooldown > 0:
                self._cooldown -= 1
            if direction == self._pending_dir:
                self._pending_count += 1
            else:
                self._pending_dir = direction
                self._pending_count = 1
            if self._pending_count < cfg.confirm_evals:
                entry.update(action="hold", reason="hysteresis_pending",
                             pending=self._pending_count)
            else:
                self._pending_dir = 0
                self._pending_count = 0
                if direction > 0:
                    added = self._scale_up(target - view.n_live)
                    entry.update(action="scale_up" if added else "hold",
                                 added=added,
                                 reason="planner_target" if added
                                 else "scaleup_failed")
                else:
                    drained = self._scale_down(view.n_live - target)
                    entry.update(action="scale_down" if drained
                                 else "hold", drained=drained,
                                 reason="planner_target" if drained
                                 else "no_drain_candidate")
                if entry["action"] != "hold":
                    self._cooldown = cfg.cooldown_evals
                    self._cooldown_dir = direction
        self.decision_log.append(entry)
        return entry

    # ------------------------------------------------------------ actuate

    def _scale_up(self, n: int) -> List[str]:
        """Spin up `n` replicas via the factory.  A spin-up failure
        mid-ramp (`autoscale.scaleup.fail`) keeps what already joined,
        warns, and holds — the fleet stays consistent."""
        added: List[str] = []
        for _ in range(n):
            self._spawned += 1
            rid = f"{self.config.replica_prefix}{self._spawned}"
            try:
                if fire("autoscale.scaleup.fail"):
                    raise RuntimeError(
                        f"injected spin-up failure for {rid!r}")
                session = self.spawn(rid)
                self.router.add_replica(session, role="decode")
            except Exception as e:
                self.degraded = True
                logger.warning(
                    "[autoscale] replica spin-up FAILED mid-ramp (%s) — "
                    "holding at current fleet size; in-flight work is "
                    "unaffected", e)
                break
            added.append(rid)
        return added

    def _scale_down(self, n: int) -> List[str]:
        """Drain the `n` least-loaded eligible decode replicas.  Draining
        is zero-drop by construction: the router keeps stepping the
        leaving replica until its in-flight work retires, then migrates
        its hot pages to survivors."""
        live = self.router.live_decode_snapshot(eligible_only=True)
        keep = self.config.min_replicas
        n = min(n, max(0, len(live) - keep))
        live.sort(key=lambda r: (r["queue_depth"], r["hot_pools"],
                                 r["replica_id"]))
        drained: List[str] = []
        for rep in live[:n]:
            rid = rep["replica_id"]
            try:
                self.router.drain(rid, mode=self.config.drain_mode)
            except Exception as e:
                # the target went ineligible/away mid-decision: skip it,
                # the next tick re-plans against the new fleet
                logger.warning("[autoscale] drain of %s failed (%s); "
                               "re-planning next tick", rid, e)
                continue
            drained.append(rid)
        return drained

    # ------------------------------------------------------------ summary

    def stats(self) -> Dict[str, Any]:
        actions = [d for d in self.decision_log
                   if d.get("action") in ("scale_up", "scale_down")]
        return {"ticks": self._tick,
                "actions": len(actions),
                "scale_ups": sum(1 for d in actions
                                 if d["action"] == "scale_up"),
                "scale_downs": sum(1 for d in actions
                                   if d["action"] == "scale_down"),
                "degraded": self.degraded,
                "decision_log": list(self.decision_log)}
