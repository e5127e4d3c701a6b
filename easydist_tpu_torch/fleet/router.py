"""`FleetRouter`: N `GenerationSession` replicas behind one submit()
(port of easydist_tpu/fleet/router.py, which imports nothing of JAX; on
one card the replicas are sessions in one process, each on the card).

Scales serve/ from one host to a fleet without touching the bitwise
spine: every replica runs the same params and the same compiled programs,
prefix restore is bitwise-equal to recompute, and greedy continuation is
a pure function of the token prefix — so WHICH replica serves a request
(or whether its prefill ran on a different replica, or it migrated
mid-stream during a drain) never changes a single output token.

Routing is a scored policy over live signals:

  * **prefix-cache affinity** — `PrefixCache.peek` (non-mutating) probes
    how many prompt tokens each replica's trie already holds; requests
    sharing a system prefix converge on the replica that warmed it and
    skip that prefill entirely;
  * **occupancy** — free decode-slot fraction from the session's
    `queue_depth`, so affinity never piles everything onto one replica;
  * **breaker/health** — a replica whose `CircuitBreaker` is OPEN is
    ineligible (routing to it anyway is the FLEET001 error);
  * **consistent-hash fallback** — a cold prefix (zero affinity
    everywhere) routes by `HashRing` over its page-aligned prefix, so
    identical cold prefixes co-locate and BUILD affinity instead of
    scattering.

Prefill/decode disaggregation: with dedicated prefill replicas, the
page-aligned prompt prefix runs chunked prefill there, the committed
pages hand off through a `KVTransport` (sha256 page manifest, FLEET002),
and the decode replica restores them on admission — computing only the
unaligned tail.  Elastic drain: `drain(rid)` stops new admits, keeps
stepping the replica until in-flight work retires (other replicas never
stall — zero downtime) and migrates its hot trie pages to the
survivors in byte-bounded waves.  `evacuate`
mode retires live decodes immediately with partial ids and the router
resubmits prompt+partial elsewhere, bitwise-seamlessly.

Fault tolerance (fleet/failover.py + fleet/health.py): a replica whose
`step()` raises — or that a `HealthMonitor` probe declares DEAD (alive
but making no progress with live work) — is removed on the spot and its
stranded requests resume on survivors from their `ResumeDescriptor`s:
the router syncs each request's already-emitted ids from the live
session after every successful step (what a streaming client has
already received), so recovery resubmits prompt+ids with the remaining
budget and the bitwise spine guarantees the continuation is
token-for-token identical.  A request
that crashes `quarantine_after` distinct replicas is poison — its
future fails with `PoisonRequestError` instead of rolling through the
fleet.  Re-registering a crashed replica id via `add_replica` is the
revive operation (the chaos drill's schedule does exactly that).

The decision, drain, crash and protocol logs are the surfaces the
analyzer's fleet audits read (`analyze.fleet_rules`, the JAX package's
FLEET001-005): every routing decision passes `check_fleet_routing`
(FLEET001/004), every resume descriptor `check_resume_descriptor`
before its resubmit (FLEET005), every drained session
`check_fleet_drain` (FLEET003); `analyze.check_protocol_conformance`
replays `transitions()` against the RouterSpec (PROTO003).
"""

from __future__ import annotations

import logging
import random
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from easydist_tpu_torch.analyze import (check_fleet_drain,
                                        check_fleet_routing,
                                        check_resume_descriptor)
from easydist_tpu_torch.resilience.breaker import OPEN, CircuitBreaker
from easydist_tpu_torch.serve.admission import (AdmissionController,
                                          CircuitOpenError,
                                          DeadlineExceededError,
                                          RequestTooLargeError)
from easydist_tpu_torch.serve.batcher import select_bucket
from easydist_tpu_torch.serve.metrics import ServeMetrics

from .failover import PoisonRequestError, ResumeDescriptor
from .hashring import HashRing, prefix_hash_key
from .health import DEAD, HealthConfig, HealthMonitor
from .transport import InProcessTransport, KVTransport, TransportError

logger = logging.getLogger(__name__)

__all__ = ["FleetConfig", "FleetRouter", "Replica"]


@dataclass(frozen=True)
class FleetConfig:
    """Routing policy knobs.

    affinity_weight / occupancy_weight: the scored policy is
        w_aff * (cached prefix tokens / prompt tokens)
        + w_occ * (free decode-slot fraction); affinity dominating means
        a warm trie wins unless the replica is nearly full.
    policy: "affinity" (scored + hash fallback) or "random" (uniform —
        the bench's comparison arm, never the production setting).
    vnodes: virtual points per replica on the consistent-hash ring.
    max_queue: fleet-wide bound on live requests; submits beyond it
        raise QueueFullError (the admission layer's check).
    default_deadline_ms: deadline stamped on submits that pass none.
    seed: rng seed for the "random" policy (deterministic benches).
    probe_interval_ms / miss_budget: HealthMonitor knobs — min wall-clock
        between liveness probe rounds (0 probes every step) and
        consecutive missed probes before a replica is declared DEAD.
    quarantine_after: distinct replicas one request may crash before its
        future fails with PoisonRequestError instead of resubmitting.
    handoff_retries / handoff_backoff_ms / handoff_deadline_ms: transport
        send_pages retry policy for prefill handoff and drain migration
        (deadline None = retries alone bound the attempt count).
    migrate_wave_bytes: byte ceiling per drain-migration WAVE — hot-page
        paths are batched by the reshard chunk planner (reshard.chunk_waves)
        so in-flight migration bytes stay bounded regardless of how much
        warm trie a draining replica holds (0 = one unbounded wave).
    """
    affinity_weight: float = 2.0
    occupancy_weight: float = 1.0
    policy: str = "affinity"
    vnodes: int = 64
    max_queue: int = 1024
    default_deadline_ms: Optional[float] = None
    seed: int = 0
    probe_interval_ms: float = 0.0
    miss_budget: int = 3
    quarantine_after: int = 3
    handoff_retries: int = 2
    handoff_backoff_ms: float = 5.0
    handoff_deadline_ms: Optional[float] = None
    migrate_wave_bytes: int = 8 << 20

    def __post_init__(self):
        if self.policy not in ("affinity", "random"):
            raise ValueError(f"unknown routing policy {self.policy!r}")
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {self.vnodes}")
        if self.affinity_weight < 0 or self.occupancy_weight < 0:
            raise ValueError("routing weights must be >= 0")
        if self.quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got "
                f"{self.quarantine_after}")
        if self.handoff_retries < 0:
            raise ValueError("handoff_retries must be >= 0")
        if self.migrate_wave_bytes < 0:
            raise ValueError("migrate_wave_bytes must be >= 0")


@dataclass
class Replica:
    """One registered session + its health surface."""
    replica_id: str
    session: object                      # GenerationSession
    breaker: Optional[CircuitBreaker] = None
    role: str = "decode"                 # "decode" | "prefill"

    def eligible(self) -> bool:
        return (not self.session.is_draining
                and (self.breaker is None or self.breaker.state != OPEN))


@dataclass
class _Inflight:
    """Router-side record of one request across replica hops.

    `resume` is the live ResumeDescriptor: its `ids` mirror what the
    serving session has emitted so far (synced after every successful
    step), which is exactly the recovery state a crash needs.
    `hop_base` is the `ids` snapshot at the current submission — the
    tokens emitted by PREVIOUS hops, which the current session's partial
    output concatenates onto."""
    resume: ResumeDescriptor
    future: Future                       # the caller's future
    hop_base: List[int] = field(default_factory=list)
    replica_id: Optional[str] = None
    inner: Optional[Future] = None       # current session future
    deadline_t: Optional[float] = None
    t_submit: float = 0.0

    @property
    def request_id(self) -> int:
        return self.resume.request_id


@dataclass
class _Handoff:
    """One disaggregated prefill awaiting page transfer."""
    request_id: int
    prefill_replica: str
    decode_replica: str
    aligned: List[int]                   # page-aligned prompt prefix
    inner: Future                        # prefill session future


class FleetRouter:
    """Multi-replica serving front: route, disaggregate, drain."""

    def __init__(self, replicas: Sequence, *,
                 prefill_replicas: Sequence = (),
                 config: Optional[FleetConfig] = None,
                 transport: Optional[KVTransport] = None,
                 health: Optional[HealthMonitor] = None):
        self.config = config or FleetConfig()
        self.transport = transport or InProcessTransport()
        self.health = health or HealthMonitor(HealthConfig(
            probe_interval_ms=self.config.probe_interval_ms,
            miss_budget=self.config.miss_budget))
        self._replicas: Dict[str, Replica] = {}
        self._ring = HashRing(vnodes=self.config.vnodes)
        self._prefill_ring = HashRing(vnodes=self.config.vnodes)
        for sess in replicas:
            self.add_replica(sess, role="decode")
        for sess in prefill_replicas:
            self.add_replica(sess, role="prefill")
        if not any(r.role == "decode" for r in self._replicas.values()):
            raise ValueError("fleet needs at least one decode replica")
        self.admission = AdmissionController(
            self.config.max_queue,
            default_deadline_ms=self.config.default_deadline_ms)
        self.metrics = ServeMetrics(replica_id="fleet")
        self._rng = random.Random(self.config.seed)
        self._inflight: Dict[int, _Inflight] = {}
        self._handoffs: List[_Handoff] = []
        self._next_request_id = 0
        # audit surfaces: FLEET001/004 read the decision log, FLEET003
        # the drain log; all bounded so a long-lived router stays O(1)
        self.decision_log: List[Dict[str, object]] = []
        self.drain_log: List[Dict[str, object]] = []
        self.crash_log: List[Dict[str, object]] = []
        self._log_cap = 1024
        # layer-12 conformance surface: the request-lifecycle event
        # stream `analyze.modelcheck.replay_router_protocol` replays
        # against the RouterSpec (PROTO003).  Bounded like the other
        # logs; `protocol_events_dropped` counts truncation so a capped
        # log is never mistaken for a complete (and seemingly drifting)
        # protocol history
        self.protocol_log: List[Dict[str, object]] = []
        self.protocol_events_dropped = 0
        self._proto_cap = 4096

    # ------------------------------------------------------------ replicas
    def add_replica(self, session, role: str = "decode") -> Replica:
        rid = session.replica_id
        if not rid:
            raise ValueError("fleet sessions need a replica_id")
        if rid in self._replicas:
            raise ValueError(f"duplicate replica_id {rid!r}")
        cfg = session.config
        breaker = None
        if cfg.breaker_failure_threshold > 0:
            breaker = CircuitBreaker(
                failure_threshold=cfg.breaker_failure_threshold,
                cooldown_s=cfg.breaker_cooldown_ms / 1e3,
                p99_threshold_s=(cfg.breaker_p99_threshold_ms / 1e3
                                 if cfg.breaker_p99_threshold_ms is not None
                                 else None),
                min_samples=cfg.breaker_min_samples,
                p99=lambda m=session.metrics: m.execute.percentile(99),
                replica_id=rid)
        rep = Replica(replica_id=rid, session=session, breaker=breaker,
                      role=role)
        self._replicas[rid] = rep
        (self._ring if role == "decode" else self._prefill_ring).add(rid)
        # re-registering a previously-crashed id is the REVIVE operation:
        # clear its DEAD tombstone so routing sees the fresh session
        self.health.revive(rid)
        return rep

    def replica(self, replica_id: str) -> Replica:
        return self._replicas[replica_id]

    def _decode_replicas(self) -> List[Replica]:
        return [r for r in self._replicas.values() if r.role == "decode"]

    def _prefill_replicas(self) -> List[Replica]:
        return [r for r in self._replicas.values() if r.role == "prefill"]

    def _eligible(self, rep: Replica) -> bool:
        """Replica-level eligibility (draining/breaker) AND health: a
        DEAD replica is ineligible exactly like an OPEN breaker."""
        return rep.eligible() \
            and self.health.state(rep.replica_id) != DEAD

    # ------------------------------------------------------------- routing
    def _aligned_prefix(self, prompt: Sequence[int]) -> List[int]:
        """Longest trie-page-aligned strict-prefix of `prompt` — the
        affinity/hash identity AND the disaggregated-prefill unit (the
        unaligned tail plus at least one token always prefills on the
        decode replica, matching the trie's max_tokens=len-1 cap)."""
        chunk = None
        for rep in self._decode_replicas():
            chunk = rep.session.bucket_chunk(prompt)
            if chunk:
                break
        if not chunk:
            return list(prompt)
        aligned = ((len(prompt) - 1) // chunk) * chunk
        return list(prompt[:aligned]) if aligned else list(prompt)

    def _route(self, prompt: Sequence[int],
               request_id: int) -> Replica:
        """Pick the decode replica; logs the decision for FLEET001/004."""
        eligible = [r for r in self._decode_replicas()
                    if self._eligible(r)]
        if not eligible:
            waits = [r.breaker.retry_after_s()
                     for r in self._decode_replicas() if r.breaker]
            raise CircuitOpenError(
                "no eligible decode replica (all draining or circuit-"
                "open)", retry_after_s=max([0.0] + waits))
        if self.config.policy == "random":
            chosen = self._rng.choice(eligible)
            affinity = 0
        else:
            aff = {r.replica_id: r.session.prefix_affinity(prompt)
                   for r in eligible}
            if max(aff.values()) == 0:
                key = prefix_hash_key(self._aligned_prefix(prompt))
                rid = self._ring.route(
                    key, eligible=[r.replica_id for r in eligible])
                chosen = self._replicas[rid] if rid else eligible[0]
            else:
                def score(r: Replica) -> Tuple[float, int, str]:
                    occ_free = 1.0 - (
                        r.session.queue_depth
                        / max(1, r.session.config.max_decode_slots))
                    s = (self.config.affinity_weight
                         * aff[r.replica_id] / len(prompt)
                         + self.config.occupancy_weight
                         * max(0.0, occ_free))
                    # deterministic tie-break: least loaded, then id
                    return (-s, r.session.queue_depth, r.replica_id)
                chosen = min(eligible, key=score)
            affinity = aff.get(chosen.replica_id, 0) \
                if self.config.policy == "affinity" else 0
        decision = {
            "request_id": request_id,
            "replica_id": chosen.replica_id,
            "breaker_state": (chosen.breaker.state if chosen.breaker
                              else "closed"),
            "draining": chosen.session.is_draining,
            "health": self.health.state(chosen.replica_id),
            "affinity_tokens": affinity,
            "prompt_tokens": len(prompt),
            "policy": self.config.policy,
        }
        self._log(self.decision_log, decision)
        # FLEET001/004: the decision as observed; raises under
        # config.analyze_raise before the request reaches the replica
        check_fleet_routing([decision], node=f"route[{request_id}]")
        if affinity:
            self.metrics.inc("routed_warm")
        self.metrics.inc("routed")
        return chosen

    def _log(self, log: List, entry: Dict) -> None:
        log.append(entry)
        del log[:-self._log_cap]

    def _proto(self, request_id: int, event: str) -> None:
        """One request-lifecycle protocol event (layer-12 conformance)."""
        self.protocol_log.append(
            {"request_id": request_id, "event": event})
        if len(self.protocol_log) > self._proto_cap:
            dropped = len(self.protocol_log) - self._proto_cap
            del self.protocol_log[:dropped]
            self.protocol_events_dropped += dropped

    def transitions(self) -> List[Dict[str, object]]:
        """The protocol event stream, oldest first — the surface
        `replay_router_protocol` (PROTO003) validates against the
        RouterSpec.  Check `protocol_events_dropped` before treating it
        as a complete history."""
        return list(self.protocol_log)

    # ------------------------------------------------------------ admission
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Route one prompt into the fleet; the returned future resolves
        to the same {"ids", "finish_reason"} a single session produces,
        plus "replica_id" (the LAST replica that decoded it)."""
        prompt = [int(t) for t in prompt_ids]
        any_fit = any(
            select_bucket(len(prompt) + 1,
                          r.session.config.decode_buckets) is not None
            for r in self._decode_replicas())
        if prompt and not any_fit:
            raise RequestTooLargeError(
                f"prompt of {len(prompt)} tokens fits no replica's decode "
                f"buckets")
        self.admission.check_depth(self.total_queue_depth)
        deadline_t = self.admission.resolve_deadline(deadline_ms)
        rid = self._next_request_id
        self._next_request_id += 1
        rec = _Inflight(resume=ResumeDescriptor(
                            request_id=rid, prompt=prompt,
                            max_new=max_new_tokens, eos_id=eos_id),
                        future=Future(), deadline_t=deadline_t,
                        t_submit=time.perf_counter())
        chosen = self._route(prompt, rid)
        # "admitted" lands only once a route exists: a submit() that
        # raises CircuitOpenError never entered the protocol, so the
        # zero-drop replay must not expect a terminal for it
        self._proto(rid, "admitted")
        self._inflight[rid] = rec
        if not self._start_disaggregated(rec, chosen):
            rec.replica_id = chosen.replica_id
            self._proto(rid, "routed")
            rec.inner = chosen.session.submit(
                prompt, max_new_tokens=max_new_tokens, eos_id=eos_id)
        else:
            self._proto(rid, "handoff_started")
        self.metrics.inc("requests_submitted")
        self.metrics.set_gauge("queue_depth", self.total_queue_depth)
        self.metrics.set_gauge("router_inflight", len(self._inflight))
        return rec.future

    def _start_disaggregated(self, rec: _Inflight,
                             decode_rep: Replica) -> bool:
        """Run the page-aligned prefix on a dedicated prefill replica when
        that saves decode-side prefill; returns False to submit directly
        (no prefill tier, prompt under one page, decode trie already
        warm, or page sizes disagree across tiers)."""
        prefill = [r for r in self._prefill_replicas()
                   if self._eligible(r)]
        if not prefill:
            return False
        prompt = rec.resume.prompt
        aligned = self._aligned_prefix(prompt)
        chunk = decode_rep.session.bucket_chunk(prompt)
        if not chunk or len(aligned) < chunk \
                or len(aligned) == len(prompt):
            return False
        if decode_rep.session.prefix_affinity(prompt) >= len(aligned):
            return False  # decode trie already holds everything aligned
        src = prefill[0]
        if len(prefill) > 1:
            rid = self._prefill_ring.route(
                prefix_hash_key(aligned),
                eligible=[r.replica_id for r in prefill])
            src = self._replicas[rid] if rid else prefill[0]
        if src.session.bucket_chunk(aligned) != chunk:
            return False  # page sizes disagree; handoff would be refused
        rec.replica_id = decode_rep.replica_id
        inner = src.session.submit(aligned, max_new_tokens=1)
        self._handoffs.append(_Handoff(
            request_id=rec.request_id, prefill_replica=src.replica_id,
            decode_replica=decode_rep.replica_id, aligned=aligned,
            inner=inner))
        self.metrics.inc("prefill_handoffs")
        return True

    @property
    def total_queue_depth(self) -> int:
        return sum(r.session.queue_depth
                   for r in self._replicas.values()) + len(self._handoffs)

    @property
    def inflight_count(self) -> int:
        """Router-tracked in-flight requests — the observer-safe read
        the autoscaler's MetricsView uses (PROTO004: observers never
        reach `_inflight` directly)."""
        return len(self._inflight)

    def live_decode_snapshot(self, eligible_only: bool = False
                             ) -> List[Dict[str, object]]:
        """Read-only per-replica view of the non-draining decode tier
        for observer code (autoscaler metrics/drain planning).  This is
        the snapshot-only-metrics contract layer 12 enforces: observers
        consume value snapshots like this one, never the router's live
        `_replicas`/`_inflight` structures — those become remote state
        the moment replicas live in another process."""
        out: List[Dict[str, object]] = []
        for r in self._decode_replicas():
            if r.session.is_draining:
                continue
            if eligible_only and not self._eligible(r):
                continue
            out.append({
                "replica_id": r.replica_id,
                "queue_depth": int(r.session.queue_depth),
                "hot_pools": len(getattr(r.session, "_pools", None)
                                 or ()),
            })
        return out

    # -------------------------------------------------------------- driving
    def step(self) -> int:
        """One fleet round: step EVERY replica (draining ones included —
        their in-flight work retires while the others keep serving; that
        is the zero-downtime property), sync per-request progress into
        resume descriptors, run the health probe, then harvest handoffs,
        replica hops, completions, and finished drains.  A replica whose
        step raises — or that the probe declares DEAD — fails over on
        the spot (`_on_replica_crash`): the fleet keeps serving.
        Returns decode tokens generated across the fleet this round."""
        tokens = 0
        for rep in list(self._replicas.values()):
            sess = rep.session
            had_work = not sess.is_drained
            try:
                tokens += sess.step()
            except Exception as e:
                if rep.breaker is not None:
                    rep.breaker.record_failure()
                self._on_replica_crash(rep, e)
                continue
            if had_work and rep.breaker is not None:
                rep.breaker.record_success()
            self._sync_progress(rep)
        for rid in self.health.probe(list(self._replicas.values())):
            # alive-but-wedged: no counter progress with live work for
            # miss_budget consecutive probes — treat exactly as a crash
            self._on_replica_crash(
                self._replicas[rid],
                RuntimeError(f"health probe declared {rid} dead "
                             f"(no progress with live work)"))
        self._poll_handoffs()
        self._poll_inflight()
        self._poll_drains()
        self._gc_inflight()
        self.metrics.set_gauge("queue_depth", self.total_queue_depth)
        self.metrics.set_gauge("router_inflight", len(self._inflight))
        return tokens

    def _sync_progress(self, rep: Replica) -> None:
        """Mirror the session's per-request emitted ids into the router's
        resume descriptors — the state a streaming client has already
        received, and therefore the exact prefix recovery must continue
        from if this replica dies before its next step."""
        live = {id(e["future"]): e
                for e in rep.session.snapshot_inflight()}
        for rec in self._inflight.values():
            if rec.replica_id != rep.replica_id or rec.inner is None:
                continue
            entry = live.get(id(rec.inner))
            if entry is not None:
                rec.resume.ids = rec.hop_base + list(entry["ids"])

    # ------------------------------------------------------------- failover
    def _on_replica_crash(self, rep: Replica, exc: Exception) -> None:
        """Remove a dead replica and recover its stranded work: pending
        prefill handoffs fall back to direct prefill, every in-flight
        request resumes on a survivor from its ResumeDescriptor (or is
        quarantined once it has crashed `quarantine_after` distinct
        replicas).  The dead session's trie pages are NOT migrated —
        unlike a drain, nothing it holds can be trusted."""
        rid = rep.replica_id
        logger.error("replica %s crashed (%s); failing over", rid, exc)
        self.health.mark_dead(rid, reason=str(exc))
        (self._ring if rep.role == "decode"
         else self._prefill_ring).remove(rid)
        self._replicas.pop(rid, None)
        self.metrics.inc("replica_crashes")
        self._log(self.crash_log, {
            "replica_id": rid, "role": rep.role, "error": repr(exc)})
        for h in list(self._handoffs):
            if h.prefill_replica != rid:
                continue  # dead decode targets re-route at harvest
            self._handoffs.remove(h)
            rec = self._inflight.get(h.request_id)
            if rec is not None:
                self.metrics.inc("handoff_fallbacks")
                self._recover_request(rec, rid)
        for rec in list(self._inflight.values()):
            if rec.replica_id != rid:
                continue
            if rec.inner is not None and rec.inner.done():
                continue  # retired before the crash; harvests normally
            if any(h.request_id == rec.request_id
                   for h in self._handoffs):
                continue  # prefill still running; harvest re-routes
            self._recover_request(rec, rid)

    def _recover_request(self, rec: _Inflight, crashed_rid: str) -> None:
        """Quarantine-or-resume one request stranded by a crash."""
        rec.resume.crashed_on.add(crashed_rid)
        if len(rec.resume.crashed_on) >= self.config.quarantine_after:
            del self._inflight[rec.request_id]
            self._proto(rec.request_id, "quarantined")
            rec.future.set_exception(PoisonRequestError(
                rec.request_id, rec.resume.crashed_on))
            self.metrics.inc("requests_quarantined")
            self.metrics.inc("requests_failed")
            logger.error("request %d quarantined after crashing "
                         "replicas %s", rec.request_id,
                         sorted(rec.resume.crashed_on))
            return
        self._proto(rec.request_id, "recovered")
        self._resubmit(rec)
        self.metrics.inc("requests_recovered")

    def _resubmit(self, rec: _Inflight) -> None:
        """Continue `rec` on a surviving replica from its descriptor:
        resubmit prompt + emitted ids with the remaining budget.  Audited
        first (FLEET005): a descriptor that would change tokens fails
        loudly, never resumes silently wrong."""
        desc = rec.resume
        resume_prompt = desc.resume_prompt()
        check_resume_descriptor(desc.as_dict(), resume_prompt,
                                node=f"resume[{desc.request_id}]")
        try:
            nxt = self._route(resume_prompt, rec.request_id)
        except CircuitOpenError as e:
            self._inflight.pop(rec.request_id, None)
            self._proto(rec.request_id, "failed")
            rec.future.set_exception(e)
            self.metrics.inc("requests_failed")
            return
        self._proto(rec.request_id, "routed")
        rec.replica_id = nxt.replica_id
        rec.hop_base = list(desc.ids)
        rec.inner = nxt.session.submit(
            resume_prompt, max_new_tokens=desc.remaining(),
            eos_id=desc.eos_id)

    def _gc_inflight(self) -> None:
        """Bound `_inflight`: drop externally-cancelled entries, fail
        deadline-expired ones, and resume orphans whose replica vanished
        without a crash record (defense in depth — the crash path
        normally resubmits immediately)."""
        now = time.monotonic()
        for rid, rec in list(self._inflight.items()):
            if rec.future.done():
                # only an external cancel/resolution leaves a done future
                # tracked; the router deletes before resolving otherwise
                del self._inflight[rid]
                self._proto(rid, "failed")
                self.metrics.inc("inflight_gc")
                continue
            if rec.deadline_t is not None and now > rec.deadline_t:
                del self._inflight[rid]
                self._proto(rid, "failed")
                rec.future.set_exception(DeadlineExceededError(
                    f"request {rid} exceeded its deadline in flight"))
                self.metrics.inc("requests_timed_out")
                self.metrics.inc("requests_failed")
                continue
            if rec.inner is None and rec.replica_id is not None \
                    and rec.replica_id not in self._replicas \
                    and not any(h.request_id == rid
                                for h in self._handoffs):
                self.metrics.inc("inflight_orphans_recovered")
                self._proto(rid, "recovered")
                self._resubmit(rec)

    def _poll_handoffs(self) -> None:
        for h in list(self._handoffs):
            if not h.inner.done():
                continue
            self._handoffs.remove(h)
            rec = self._inflight.get(h.request_id)
            if rec is None:
                continue
            result = h.inner.result()
            prompt = rec.resume.prompt
            dst = self._replicas.get(h.decode_replica)
            src = self._replicas.get(h.prefill_replica)
            handed_off = False
            if result["finish_reason"] != "length":
                # prefill replica was evacuated under us: nothing
                # committed for sure — decode replica prefills from zero
                logger.warning("prefill handoff %s interrupted (%s); "
                               "falling back to direct prefill",
                               h.request_id, result["finish_reason"])
            elif src is not None and dst is not None:
                path = src.session.export_prefix_path(h.aligned)
                cfg = self.config
                try:
                    moved = self.transport.send_pages(
                        path, dst.session, prompt,
                        src=h.prefill_replica, dst=h.decode_replica,
                        deadline_s=(cfg.handoff_deadline_ms / 1e3
                                    if cfg.handoff_deadline_ms is not None
                                    else None),
                        retries=cfg.handoff_retries,
                        backoff_s=cfg.handoff_backoff_ms / 1e3)
                    self.metrics.inc("pages_handed_off", moved)
                    handed_off = True
                except TransportError as e:
                    # permanent transport failure is never fatal to the
                    # REQUEST: the decode replica prefills from zero and
                    # parity holds (restore == recompute)
                    logger.warning(
                        "page handoff %s->%s failed permanently (%s); "
                        "falling back to direct prefill",
                        h.prefill_replica, h.decode_replica, e)
                    self.metrics.inc("handoff_transport_failures")
            self._proto(rec.request_id,
                        "handoff_committed" if handed_off
                        else "handoff_fallback")
            if dst is None or not self._eligible(dst):
                # decode target crashed or started draining while
                # prefill ran: re-route; restore == recompute keeps
                # parity either way
                try:
                    dst = self._route(prompt, rec.request_id)
                except CircuitOpenError as e:
                    del self._inflight[rec.request_id]
                    self._proto(rec.request_id, "failed")
                    rec.future.set_exception(e)
                    self.metrics.inc("requests_failed")
                    continue
                self._proto(rec.request_id, "routed")
            rec.replica_id = dst.replica_id
            rec.inner = dst.session.submit(
                prompt, max_new_tokens=rec.resume.max_new,
                eos_id=rec.resume.eos_id)

    def _poll_inflight(self) -> None:
        for rid, rec in list(self._inflight.items()):
            if rec.inner is None or not rec.inner.done():
                continue
            result = rec.inner.result()
            if result["finish_reason"] == "evacuated":
                # mid-stream migration: greedy continuation is a pure
                # function of the prefix, so prompt+partial resumed on
                # any replica concatenates bitwise-identically
                rec.resume.ids = rec.hop_base + list(result["ids"])
                self._proto(rid, "migrated")
                self._resubmit(rec)
                self.metrics.inc("migrations")
                continue
            del self._inflight[rid]
            self._proto(rid, "completed")
            rec.future.set_result({
                "ids": rec.hop_base + list(result["ids"]),
                "finish_reason": result["finish_reason"],
                "replica_id": rec.replica_id,
            })
            self.metrics.inc("requests_completed")
            self.metrics.observe(
                "e2e", time.perf_counter() - rec.t_submit)

    def _poll_drains(self) -> None:
        for rep in list(self._replicas.values()):
            if not rep.session.is_draining or not rep.session.is_drained:
                continue
            if any(h.prefill_replica == rep.replica_id
                   or h.decode_replica == rep.replica_id
                   for h in self._handoffs):
                continue  # let pending handoffs clear first
            self._finish_drain(rep)

    # --------------------------------------------------------------- drain
    def drain(self, replica_id: str, mode: str = "graceful") -> None:
        """Begin removing one replica with zero dropped requests.

        "graceful": stop new admits, keep stepping until its in-flight
        decodes retire naturally.  "evacuate": retire live work NOW with
        partial ids (SIGTERM-grace semantics — resilience/preempt.py);
        the inflight poller resubmits each prompt+partial elsewhere.
        Either way the replica's hot trie pages migrate to the survivors
        before it is removed (next step() after it empties)."""
        rep = self._replicas[replica_id]
        (self._ring if rep.role == "decode"
         else self._prefill_ring).remove(replica_id)
        if mode == "evacuate":
            rep.session.evacuate()
        elif mode == "graceful":
            rep.session.drain(wait=False)
        else:
            raise ValueError(f"unknown drain mode {mode!r}")
        self.metrics.inc("drains_started")

    def _finish_drain(self, rep: Replica) -> None:
        pages = rep.session.export_hot_pages()
        survivors = [r for r in self._decode_replicas()
                     if r.replica_id != rep.replica_id
                     and self._eligible(r)]
        cfg = self.config
        migrated = 0
        for bucket, paths in pages.items():
            for dst in survivors:
                # wave-batched through the shared reshard chunk planner:
                # in-flight bytes stay under migrate_wave_bytes however
                # warm the draining trie is.  Each path is still a
                # manifest-verified + retried handoff (FLEET002);
                # migration is best-effort — a path that fails
                # permanently is dropped (survivors recompute the prefix
                # on demand), never half-committed
                def _drop(i, e, _dst=dst):
                    logger.warning(
                        "drain migration %s->%s dropped a path: %s",
                        rep.replica_id, _dst.replica_id, e)
                    self.metrics.inc("pages_migration_failed")

                res = self.transport.send_paths_chunked(
                    paths, dst.session, bucket=bucket,
                    max_wave_bytes=cfg.migrate_wave_bytes,
                    on_drop=_drop,
                    src=rep.replica_id, dst=dst.replica_id,
                    deadline_s=(cfg.handoff_deadline_ms / 1e3
                                if cfg.handoff_deadline_ms
                                is not None else None),
                    retries=cfg.handoff_retries,
                    backoff_s=cfg.handoff_backoff_ms / 1e3)
                migrated += res["chunks"]
        # FLEET003: a drained session must hold no pinned trie page
        check_fleet_drain(rep.session, node=f"drain[{rep.replica_id}]")
        del self._replicas[rep.replica_id]
        self.metrics.inc("drains_completed")
        self.metrics.inc("pages_migrated", migrated)
        self._log(self.drain_log, {
            "replica_id": rep.replica_id, "role": rep.role,
            "pages_migrated": migrated,
            "survivors": [r.replica_id for r in survivors],
        })

    # -------------------------------------------------------------- runners
    def run_until_drained(self, max_steps: int = 100000) -> None:
        """Drive `step()` until every submitted request resolved and no
        replica holds live work."""
        for _ in range(max_steps):
            if not self._inflight and not self._handoffs and all(
                    r.session.is_drained for r in self._replicas.values()):
                return
            self.step()
        raise RuntimeError(f"fleet not drained after {max_steps} steps")

    # ------------------------------------------------------------ reporting
    def stats(self) -> Dict[str, object]:
        return {
            "replicas": {
                rid: {"role": r.role,
                      "draining": r.session.is_draining,
                      "queue_depth": r.session.queue_depth,
                      "breaker": (r.breaker.snapshot() if r.breaker
                                  else None)}
                for rid, r in self._replicas.items()},
            "inflight": len(self._inflight),
            "handoffs": len(self._handoffs),
            "decisions": len(self.decision_log),
            "drains": list(self.drain_log),
            "crashes": list(self.crash_log),
            "health": self.health.snapshot(),
            "metrics": self.metrics.snapshot(),
            "protocol_events": len(self.protocol_log),
            "protocol_events_dropped": self.protocol_events_dropped,
        }

    def export_metrics(self, db=None, persist: bool = True):
        """Fleet gauges + every replica's metrics into PerfDB, each under
        its own replica-labeled sub_key (no collisions)."""
        db = self.metrics.export(db=db, key="serving",
                                 sub_key="fleet", persist=False)
        for rep in self._replicas.values():
            rep.session.metrics.export(db=db, persist=False)
        db.append_history("serving", "fleet_routing", {
            "decisions": list(self.decision_log)[-64:],
            "drains": list(self.drain_log),
            "crashes": list(self.crash_log),
            "health_events": list(self.health.events)[-64:],
            "protocol_events": list(self.protocol_log)[-256:],
            "protocol_events_dropped": self.protocol_events_dropped,
        })
        if persist:
            try:
                db.persist()
            except Exception:
                pass
        return db
