"""Analyze layer 12a (the port of easydist_tpu/analyze/modelcheck.py,
whole): small-scope explicit-state model checker for the fleet protocols (DistIR-style, arXiv:2111.05426 — replace "run the chaos
drill and hope" with exhaustive replay over an explicit model).

Each protocol is a `Spec`: a deterministic transition system of states
(canonical hashable tuples), guarded actions, a safety `invariant`, and
a `is_goal` predicate.  `explore()` runs BFS over ALL interleavings at
small scope (>=2 replicas x >=2 in-flight requests, crash / duplicate /
reorder / stall actions drawn from the fault catalog) with canonical
state hashing and a committed state-count budget — no wall clock, no
randomness, so the state counts in `COMMITTED_STATES` are reproducible
bit-for-bit and CI fails loudly when the explored space drifts >20%
from the committed budget (coverage silently shrinking is itself a bug).

Violations surface as findings:

- PROTO001 (safety): a reachable state violates the invariant — a
  dropped admitted request, a token position committed twice, a corrupt
  chunk accepted.  The shortest counterexample interleaving is attached
  (BFS discovery order IS shortest-trace order).
- PROTO002 (stuck): a reachable state has no path to the goal — either
  no enabled action, or a livelock cycle.  Detected by a reverse
  reachability pass from the goal set; only meaningful when the
  exploration was exhaustive.

The four shipped specs mirror `fleet/health.py`, `fleet/router.py`,
`fleet/failover.py`, and `fleet/transport.py`; each takes a `bug=`
seed that re-introduces a representative defect (flap-storm false DEAD,
dropped handoff, stale resume watermark, non-idempotent chunk commit)
so the goldens prove the checker actually catches what it claims to.

Layer 12b is the conformance bridge (PROTO003): the live classes expose
`transitions()` event streams and the `replay_*` validators below check
every observed drill transition against what the spec admits — the
model checker is a *checked* abstraction, not parallel documentation.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from easydist_tpu_torch.analyze.findings import Finding, make_finding

__all__ = [
    "Spec", "ExplorationResult", "explore", "audit_spec",
    "HealthSpec", "RouterSpec", "ResumeSpec", "TransportSpec",
    "ALL_SPECS", "COMMITTED_STATES", "BUDGET_DRIFT_FRAC",
    "replay_health_events", "replay_router_protocol",
    "replay_transport_commits", "replay_restore_attempts",
]

State = Tuple
Action = Tuple[str, State]  # (action name, successor state)

# Committed exhaustive state counts per spec at the shipped scope.
# tests/test_analyze/test_modelcheck.py asserts EXACT equality and
# scripts/static_checks.sh fails on >BUDGET_DRIFT_FRAC drift — a spec
# edit that shrinks (or explodes) the explored space must re-commit its
# budget consciously, never silently.
COMMITTED_STATES: Dict[str, int] = {
    "health": 40,
    "router": 1048,
    "resume": 48,
    "transport": 552,
}
BUDGET_DRIFT_FRAC = 0.20

# exploration ceiling: comfortably above every committed budget, small
# enough that a runaway spec edit fails fast instead of eating CI
MAX_STATES_DEFAULT = 200_000


class Spec:
    """A deterministic protocol transition system.

    Subclasses define `initial_states()`, `enabled(state)` (guarded
    actions as `(name, successor)` pairs), `invariant(state)` (safety —
    a list of violation messages, empty when safe), and `is_goal(state)`
    (the quiescent "every request accounted for" predicate reverse
    reachability targets).  States must be canonical hashable tuples:
    two interleavings reaching the same protocol configuration MUST
    produce equal tuples, or the explorer double-counts."""

    name = "spec"

    def initial_states(self) -> Iterable[State]:
        raise NotImplementedError

    def enabled(self, state: State) -> List[Action]:
        raise NotImplementedError

    def invariant(self, state: State) -> List[str]:
        return []

    def is_goal(self, state: State) -> bool:
        raise NotImplementedError


@dataclass
class ExplorationResult:
    spec_name: str
    states: int
    transitions: int
    exhausted: bool
    # (trace of action names, violation messages) — at most one each,
    # the shortest counterexample, so seeded goldens fire exactly once
    safety: Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]] = None
    stuck: Optional[Tuple[Tuple[str, ...], str]] = None
    goal_states: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "spec": self.spec_name,
            "states": self.states,
            "transitions": self.transitions,
            "exhausted": self.exhausted,
            "goal_states": self.goal_states,
            "committed": COMMITTED_STATES.get(self.spec_name),
            "safety_violation": (None if self.safety is None
                                 else list(self.safety[0])),
            "stuck_state": (None if self.stuck is None
                            else list(self.stuck[0])),
        }


def _trace(preds: Dict[State, Optional[Tuple[State, str]]],
           state: State) -> Tuple[str, ...]:
    """Action-name path from an initial state to `state` (shortest, by
    BFS construction)."""
    names: List[str] = []
    cur: Optional[State] = state
    while cur is not None:
        entry = preds[cur]
        if entry is None:
            break
        cur, act = entry
        names.append(act)
    return tuple(reversed(names))


def explore(spec: Spec,
            max_states: int = MAX_STATES_DEFAULT) -> ExplorationResult:
    """Exhaustive BFS over all interleavings of `spec` up to
    `max_states` distinct states.  Deterministic: action successors are
    sorted by (name, repr(state)), the queue is FIFO, and nothing reads
    a clock or an RNG — the same spec always yields the same counts,
    which is what lets `COMMITTED_STATES` be a committed contract.

    Safety-violating states are recorded and NOT expanded (everything
    past a violation is already broken).  The stuck check is a reverse
    BFS from the goal set over recorded edges; it only runs when the
    exploration was exhaustive (a truncated frontier would look stuck)."""
    preds: Dict[State, Optional[Tuple[State, str]]] = {}
    order: List[State] = []
    queue: deque = deque()
    for s in spec.initial_states():
        if s not in preds:
            preds[s] = None
            order.append(s)
            queue.append(s)
    edges: Dict[State, List[Action]] = {}
    bad: List[State] = []
    n_transitions = 0
    exhausted = True
    while queue:
        s = queue.popleft()
        if spec.invariant(s):
            bad.append(s)
            continue
        succs = sorted(spec.enabled(s), key=lambda a: (a[0], repr(a[1])))
        edges[s] = succs
        n_transitions += len(succs)
        for act, ns in succs:
            if ns in preds:
                continue
            if len(preds) >= max_states:
                exhausted = False
                continue
            preds[ns] = (s, act)
            order.append(ns)
            queue.append(ns)

    result = ExplorationResult(spec_name=spec.name, states=len(preds),
                               transitions=n_transitions,
                               exhausted=exhausted)
    bad_set = set(bad)
    if bad:
        # order[] is BFS order, so the first violating state found when
        # scanning discovery order has the shortest trace
        first = next(s for s in order if s in bad_set)
        result.safety = (_trace(preds, first),
                         tuple(spec.invariant(first)))

    goals = [s for s in order if s not in bad_set and spec.is_goal(s)]
    result.goal_states = len(goals)
    if exhausted and not bad:
        # reverse reachability: which states can still reach a goal?
        rev: Dict[State, List[State]] = {}
        for s, succs in edges.items():
            for _act, ns in succs:
                rev.setdefault(ns, []).append(s)
        can_reach = set(goals)
        rq: deque = deque(goals)
        while rq:
            s = rq.popleft()
            for p in rev.get(s, ()):
                if p not in can_reach:
                    can_reach.add(p)
                    rq.append(p)
        for s in order:  # BFS order -> shortest stuck trace
            if s not in can_reach:
                kind = ("no enabled action" if not edges.get(s)
                        else "livelock: goal unreachable")
                result.stuck = (_trace(preds, s), kind)
                break
    return result


def audit_spec(spec: Spec, node: Optional[str] = None,
               max_states: int = MAX_STATES_DEFAULT,
               ) -> Tuple[List[Finding], ExplorationResult]:
    """Explore `spec` and convert violations to findings: at most one
    PROTO001 (shortest safety counterexample) and one PROTO002
    (shortest stuck state) per spec."""
    node = node or f"protocol:{spec.name}"
    res = explore(spec, max_states=max_states)
    findings: List[Finding] = []
    if res.safety is not None:
        trace, msgs = res.safety
        findings.append(make_finding(
            "PROTO001", node,
            f"safety violated after [{' -> '.join(trace)}]: "
            f"{'; '.join(msgs)}"))
    if res.stuck is not None:
        trace, kind = res.stuck
        findings.append(make_finding(
            "PROTO002", node,
            f"stuck state ({kind}) reached via "
            f"[{' -> '.join(trace)}]: goal unreachable"))
    return findings, res


# ===================================================================
# Spec 1: HealthMonitor — fleet/health.py
# ===================================================================

class HealthSpec(Spec):
    """ALIVE/SUSPECT/DEAD per replica under honest probes, wedges,
    `fleet.probe.flap` false misses, and revives.

    State: (per-replica (truth, mon, misses) ..., flaps_used) where
    truth in {h(ealthy), w(edged)} and mon in {a, s, d}.

    Safety (PROTO001): no false DEAD — mon == DEAD implies the replica
    truly wedged inside the liveness window.  Holds because the flap
    budget (`fleet.probe.flap` fires once per plan occurrence) is
    strictly below the miss budget, the same contract health.py's
    docstring commits to.  `bug="flap_storm"` lifts the flap budget to
    the miss budget and the false-DEAD counterexample appears.

    Liveness (PROTO002): SUSPECT always resolves — every reachable
    state can reach "all replicas ALIVE-or-DEAD" (goal reachability
    covers both terminal resolution and the revive path)."""

    name = "health"

    def __init__(self, n_replicas: int = 2, miss_budget: int = 2,
                 bug: Optional[str] = None):
        self.n = n_replicas
        self.miss_budget = miss_budget
        # one false miss is absorbable; miss_budget of them is the bug
        self.max_flaps = miss_budget if bug == "flap_storm" else 1
        self.bug = bug

    def initial_states(self):
        yield tuple(("h", "a", 0) for _ in range(self.n)) + (0,)

    def enabled(self, state):
        reps, flaps = state[:-1], state[-1]
        out: List[Action] = []

        def with_rep(i, rep, df=0):
            new = list(reps)
            new[i] = rep
            return tuple(new) + (flaps + df,)

        for i, (truth, mon, misses) in enumerate(reps):
            if truth == "h" and mon != "d":
                out.append((f"wedge[{i}]", with_rep(i, ("w", mon, misses))))
            if mon != "d":
                # honest probe: progress iff truly healthy
                if truth == "h":
                    out.append((f"probe[{i}]", with_rep(i, ("h", "a", 0))))
                else:
                    m = misses + 1
                    nm = "d" if m >= self.miss_budget else "s"
                    out.append((f"probe[{i}]",
                                with_rep(i, (truth, nm, m))))
                # fleet.probe.flap: the probe lies about progress once
                if truth == "h" and flaps < self.max_flaps:
                    m = misses + 1
                    nm = "d" if m >= self.miss_budget else "s"
                    out.append((f"probe_flap[{i}]",
                                with_rep(i, ("h", nm, m), df=1)))
            if mon == "d":
                # add_replica under the old id: fresh session, revive()
                out.append((f"revive[{i}]", with_rep(i, ("h", "a", 0))))
        return out

    def invariant(self, state):
        msgs = []
        for i, (truth, mon, _misses) in enumerate(state[:-1]):
            if mon == "d" and truth == "h":
                msgs.append(f"replica {i} declared DEAD while healthy "
                            f"(false positive inside the liveness window)")
        return msgs

    def is_goal(self, state):
        return all(mon in ("a", "d") for _t, mon, _m in state[:-1])


# ===================================================================
# Spec 2: FleetRouter drain + handoff — fleet/router.py
# ===================================================================

_Q_TERMINAL = ("done", "failed", "quarantined")


class RouterSpec(Spec):
    """Zero-drop routing: every admitted request is completed exactly
    once on some replica — or fails/quarantines LOUDLY — under any
    interleaving of crashes, drains, evacuations, disaggregated
    prefill handoffs, and revives.

    State: (replica statuses, per-request (phase, n_crashes, n_done)).
    Phases: pending | ("prefill", p, d) | ("running", r) | done |
    failed | quarantined | lost (bug only).

    Safety (PROTO001): n_done <= 1 always, and phase == done implies
    n_done == 1 (completed-exactly-once).
    Stuck (PROTO002): a request stranded where no action can retire it.
    `bug="dropped_handoff"` makes a prefill-replica crash silently drop
    the in-flight handoff instead of resubmitting — the stranded `lost`
    phase is exactly the stuck state the checker reports."""

    name = "router"

    def __init__(self, n_replicas: int = 2, n_requests: int = 2,
                 quarantine_after: int = 2, bug: Optional[str] = None):
        self.n = n_replicas
        self.m = n_requests
        self.quarantine_after = quarantine_after
        self.bug = bug

    def initial_states(self):
        yield (tuple("up" for _ in range(self.n)),
               tuple(("pending", 0, 0) for _ in range(self.m)))

    def enabled(self, state):
        status, reqs = state
        out: List[Action] = []

        def with_status(r, st, reqs2=None):
            s2 = list(status)
            s2[r] = st
            return (tuple(s2), reqs if reqs2 is None else tuple(reqs2))

        def with_req(q, req):
            r2 = list(reqs)
            r2[q] = req
            return (status, tuple(r2))

        any_up = any(s == "up" for s in status)

        # ---- replica actions
        for r, st in enumerate(status):
            if st != "crashed":
                # fleet.replica.crash: every in-flight request on r is
                # recovered from its ResumeDescriptor (or quarantined
                # past the crash budget); prefill handoffs involving r
                # are resubmitted — unless the seeded bug drops them
                reqs2 = []
                for phase, nc, nd in reqs:
                    if phase == ("running", r):
                        nc += 1
                        phase = ("quarantined"
                                 if nc >= self.quarantine_after
                                 else "pending")
                    elif (isinstance(phase, tuple) and phase[0] == "prefill"
                          and r in phase[1:]):
                        if self.bug == "dropped_handoff" and phase[1] == r:
                            phase = "lost"   # handoff vanishes silently
                        else:
                            nc += 1
                            phase = ("quarantined"
                                     if nc >= self.quarantine_after
                                     else "pending")
                    reqs2.append((phase, nc, nd))
                out.append((f"crash[{r}]",
                            with_status(r, "crashed", reqs2)))
            if st == "up" and any(s == "up" for i, s in enumerate(status)
                                  if i != r):
                # the autoscaler never drains the last live replica
                out.append((f"drain[{r}]", with_status(r, "draining")))
            if st == "crashed":
                out.append((f"revive[{r}]", with_status(r, "up")))
            if st == "draining" and not any(
                    phase == ("running", r)
                    or (isinstance(phase, tuple) and phase[0] == "prefill"
                        and r in phase[1:])
                    for phase, _nc, _nd in reqs):
                # drain complete: the empty replica leaves the fleet
                out.append((f"drain_done[{r}]",
                            with_status(r, "crashed")))

        # ---- request actions
        for q, (phase, nc, nd) in enumerate(reqs):
            if phase == "pending":
                for r, st in enumerate(status):
                    if st == "up":
                        out.append((f"route[{q}->{r}]",
                                    with_req(q, (("running", r), nc, nd))))
                        for d, std in enumerate(status):
                            if d != r and std == "up":
                                out.append(
                                    (f"route_disagg[{q}:{r}->{d}]",
                                     with_req(q, (("prefill", r, d),
                                                  nc, nd))))
                if not any_up:
                    # admission failure is loud, never a silent drop
                    out.append((f"fail[{q}]",
                                with_req(q, ("failed", nc, nd))))
            elif isinstance(phase, tuple) and phase[0] == "prefill":
                _tag, p, d = phase
                if status[d] != "crashed":
                    out.append((f"handoff_commit[{q}]",
                                with_req(q, (("running", d), nc, nd))))
                if status[p] != "crashed":
                    # manifest mismatch / breaker: decode locally on p
                    out.append((f"handoff_fallback[{q}]",
                                with_req(q, (("running", p), nc, nd))))
            elif isinstance(phase, tuple) and phase[0] == "running":
                r = phase[1]
                if status[r] != "crashed":
                    out.append((f"complete[{q}]",
                                with_req(q, ("done", nc, nd + 1))))
                if status[r] == "draining":
                    # drain migration: evacuate and re-route
                    out.append((f"evacuate[{q}]",
                                with_req(q, ("pending", nc, nd))))
        return out

    def invariant(self, state):
        msgs = []
        for q, (phase, _nc, nd) in enumerate(state[1]):
            if nd > 1:
                msgs.append(f"request {q} completed {nd} times "
                            f"(exactly-once broken)")
            if phase == "done" and nd != 1:
                msgs.append(f"request {q} done with {nd} completions")
        return msgs

    def is_goal(self, state):
        return all(phase in _Q_TERMINAL for phase, _nc, _nd in state[1])


# ===================================================================
# Spec 3: ResumeDescriptor failover — fleet/failover.py
# ===================================================================

class ResumeSpec(Spec):
    """No double-commit of a token position across crash/resume.

    A stream of M positions: the serving replica emits tokens past
    `base` (its resume point), the router syncs emitted tokens to the
    client watermark `d`, and a crash replaces the replica with one
    resuming from the descriptor.  State:
    (per-position delivery counts, base, emitted-past-base, d,
    crashes_left).

    Correct resume: the descriptor carries prompt + ALL delivered ids,
    so the replacement resumes from the watermark (`base = d`) and
    re-emits only undelivered positions.  `bug="stale_resume"` resumes
    from the stale base and REWINDS the watermark — the next sync
    re-delivers positions the client already streamed, and PROTO001
    reports the double-committed position."""

    name = "resume"

    def __init__(self, n_positions: int = 3, crash_budget: int = 2,
                 bug: Optional[str] = None):
        self.m = n_positions
        self.crash_budget = crash_budget
        self.bug = bug

    def initial_states(self):
        yield ((0,) * self.m, 0, 0, 0, self.crash_budget)

    def enabled(self, state):
        deliv, base, s, d, crashes = state
        out: List[Action] = []
        if base + s < self.m:
            out.append(("emit", (deliv, base, s + 1, d, crashes)))
        if base + s > d:
            nd = list(deliv)
            for i in range(d, base + s):
                nd[i] = min(nd[i] + 1, 2)  # cap: 2 already violates
            out.append(("sync", (tuple(nd), base, s, base + s, crashes)))
        if crashes > 0 and base + s < self.m:
            if self.bug == "stale_resume":
                # resume from the stale base; watermark rewinds with it
                out.append(("crash_resume",
                            (deliv, base, 0, base, crashes - 1)))
            else:
                out.append(("crash_resume",
                            (deliv, d, 0, d, crashes - 1)))
        return out

    def invariant(self, state):
        deliv = state[0]
        return [f"position {i} delivered {c} times"
                for i, c in enumerate(deliv) if c > 1]

    def is_goal(self, state):
        deliv, base, s, d, _crashes = state
        return base + s == self.m and d == self.m


# ===================================================================
# Spec 4: KVTransport chunked idempotent commit — fleet/transport.py
# ===================================================================

class TransportSpec(Spec):
    """send_paths_chunked under duplicate / reordered / stalled /
    corrupted delivery converges to exactly one manifest-verified copy
    per path.

    State: per-path (in-flight deliveries as a sorted tuple of
    'ok'/'corrupt', sends_left, committed, commit_count, failed), plus
    a global corruption budget (`fleet.transport.page_corrupt`).
    Reordering across paths is free: BFS explores every delivery
    interleaving.

    Safety (PROTO001): commit_count <= 1 per path (the `_committed`
    manifest-key dedup), and a corrupt delivery never commits (the
    manifest verify precedes the commit).  `bug="nonidempotent_commit"`
    commits every ok delivery — the duplicate-final-chunk double-commit
    appears immediately.
    Stuck (PROTO002): every path ends committed or LOUDLY failed even
    when stalls eat the whole retry budget."""

    name = "transport"

    def __init__(self, n_paths: int = 2, retries: int = 2,
                 max_inflight: int = 2, corrupt_budget: int = 1,
                 bug: Optional[str] = None):
        self.k = n_paths
        self.retries = retries
        self.max_inflight = max_inflight
        self.corrupt_budget = corrupt_budget
        self.bug = bug

    def initial_states(self):
        yield (tuple(((), self.retries, False, 0, False)
                     for _ in range(self.k)), self.corrupt_budget)

    def enabled(self, state):
        paths, corrupt = state
        out: List[Action] = []

        def with_path(p, path, dc=0):
            np_ = list(paths)
            np_[p] = path
            return (tuple(np_), corrupt + dc)

        for p, (flight, sends, committed, count, failed) in \
                enumerate(paths):
            room = len(flight) < self.max_inflight
            if sends > 0 and not committed and not failed and room:
                out.append((f"send[{p}]", with_path(
                    p, (tuple(sorted(flight + ("ok",))), sends - 1,
                        committed, count, failed))))
                if corrupt > 0:
                    # fleet.transport.page_corrupt flips this copy
                    out.append((f"send_corrupt[{p}]", with_path(
                        p, (tuple(sorted(flight + ("corrupt",))),
                            sends - 1, committed, count, failed),
                        dc=-1)))
            if flight and room:
                # the network duplicates an in-flight copy
                for kind in sorted(set(flight)):
                    out.append((f"duplicate[{p}:{kind}]", with_path(
                        p, (tuple(sorted(flight + (kind,))), sends,
                            committed, count, failed))))
            for kind in sorted(set(flight)):
                rest = list(flight)
                rest.remove(kind)
                rest = tuple(sorted(rest))
                # fleet.transport.stall: the copy is lost in flight
                out.append((f"stall[{p}:{kind}]", with_path(
                    p, (rest, sends, committed, count, failed))))
                if kind == "corrupt":
                    # manifest verify rejects; nothing commits
                    out.append((f"deliver[{p}:corrupt]", with_path(
                        p, (rest, sends, committed, count, failed))))
                else:
                    if committed and self.bug != "nonidempotent_commit":
                        # _committed dedup: duplicate delivery after a
                        # successful commit is a no-op
                        out.append((f"deliver[{p}:ok]", with_path(
                            p, (rest, sends, True, count, failed))))
                    else:
                        out.append((f"deliver[{p}:ok]", with_path(
                            p, (rest, sends, True, min(count + 1, 2),
                                failed))))
            if (sends == 0 and not flight and not committed
                    and not failed):
                # retry budget exhausted: fail loudly, never hang
                out.append((f"report_failed[{p}]", with_path(
                    p, (flight, sends, committed, count, True))))
        return out

    def invariant(self, state):
        msgs = []
        for p, (_f, _s, _c, count, _failed) in enumerate(state[0]):
            if count > 1:
                msgs.append(f"path {p} committed {count} times "
                            f"(idempotent retry broken)")
        return msgs

    def is_goal(self, state):
        return all((committed or failed) and not flight
                   for flight, _s, committed, _n, failed in state[0])


def ALL_SPECS() -> List[Spec]:
    """The four shipped protocol specs at committed scope."""
    return [HealthSpec(), RouterSpec(), ResumeSpec(), TransportSpec()]


# ===================================================================
# Layer 12b: conformance replay (PROTO003 — spec drift)
# ===================================================================

# transitions the HealthMonitor spec admits (see health.py: probe,
# mark_dead, revive); anything else observed in a drill log is drift
_HEALTH_ADMITTED = {
    ("alive", "suspect"),    # missed probe inside the budget
    ("suspect", "alive"),    # progress resumed / revived
    ("suspect", "dead"),     # budget exhausted
    ("alive", "dead"),       # mark_dead fast path (step() raised)
    ("dead", "alive"),       # revive via add_replica
}


def replay_health_events(events: Sequence[Dict[str, str]],
                         node: str = "drill:health") -> List[Finding]:
    """Replay a HealthMonitor event log (`monitor.events` /
    `monitor.transitions()`) against the spec's admitted transition
    relation.  Initial state per replica is ALIVE (track())."""
    findings: List[Finding] = []
    cur: Dict[str, str] = {}
    for i, ev in enumerate(events):
        rid = str(ev.get("replica_id"))
        state = str(ev.get("state"))
        prev = cur.get(rid, "alive")
        if state not in ("alive", "suspect", "dead"):
            findings.append(make_finding(
                "PROTO003", node,
                f"event {i}: unknown health state {state!r} for "
                f"replica {rid}"))
            continue
        if (prev, state) not in _HEALTH_ADMITTED:
            findings.append(make_finding(
                "PROTO003", node,
                f"event {i}: transition {prev} -> {state} for replica "
                f"{rid} ({ev.get('reason', '')!r}) is not admitted by "
                f"the health spec"))
        cur[rid] = state
    return findings


# router protocol automaton: NEW -admitted-> OPEN; OPEN cycles through
# routing/recovery events or enters HANDOFF; exactly one terminal.
_ROUTER_OPEN_EVENTS = {"routed", "migrated", "recovered"}
_ROUTER_TERMINAL = {"completed", "quarantined", "failed"}
_ROUTER_HANDOFF_CLOSE = {"handoff_committed", "handoff_fallback"}
_ROUTER_KNOWN = ({"admitted", "handoff_started"} | _ROUTER_OPEN_EVENTS
                 | _ROUTER_TERMINAL | _ROUTER_HANDOFF_CLOSE)


def replay_router_protocol(events: Sequence[Dict[str, Any]],
                           node: str = "drill:router",
                           expect_terminal: bool = True) -> List[Finding]:
    """Replay a FleetRouter protocol event log (`router.transitions()`)
    through the request-lifecycle automaton the RouterSpec models:
    admitted first, then routing/handoff/recovery events, then exactly
    one terminal (completed / quarantined / failed) and silence.  With
    `expect_terminal`, an admitted request that never reaches a
    terminal is a dropped completion — the zero-drop property PROTO001
    proves in the model, checked here against reality."""
    findings: List[Finding] = []
    phase: Dict[str, str] = {}  # request_id -> NEW/OPEN/HANDOFF/DONE
    for i, ev in enumerate(events):
        rid = str(ev.get("request_id"))
        name = str(ev.get("event"))
        st = phase.get(rid, "NEW")
        if name not in _ROUTER_KNOWN:
            findings.append(make_finding(
                "PROTO003", node,
                f"event {i}: unknown protocol event {name!r} for "
                f"request {rid}"))
            continue
        if st == "NEW":
            if name == "admitted":
                phase[rid] = "OPEN"
            else:
                findings.append(make_finding(
                    "PROTO003", node,
                    f"event {i}: request {rid} saw {name!r} before "
                    f"'admitted'"))
                phase[rid] = "OPEN"  # resync: report once, keep going
        elif st == "OPEN":
            if name in _ROUTER_OPEN_EVENTS:
                pass
            elif name == "handoff_started":
                phase[rid] = "HANDOFF"
            elif name in _ROUTER_TERMINAL:
                phase[rid] = "DONE"
            else:
                findings.append(make_finding(
                    "PROTO003", node,
                    f"event {i}: request {rid} saw {name!r} outside a "
                    f"handoff"))
        elif st == "HANDOFF":
            if name in _ROUTER_HANDOFF_CLOSE or name == "recovered":
                phase[rid] = "OPEN"
            elif name in _ROUTER_TERMINAL:
                # CircuitOpenError inside _poll_handoffs fails the
                # request; a crash-recovery can quarantine it
                phase[rid] = "DONE"
            else:
                findings.append(make_finding(
                    "PROTO003", node,
                    f"event {i}: request {rid} saw {name!r} with a "
                    f"handoff in flight"))
        elif st == "DONE":
            findings.append(make_finding(
                "PROTO003", node,
                f"event {i}: request {rid} saw {name!r} after its "
                f"terminal event"))
    if expect_terminal:
        for rid, st in phase.items():
            if st != "DONE":
                findings.append(make_finding(
                    "PROTO003", node,
                    f"request {rid} was admitted but never reached a "
                    f"terminal event (dropped completion)"))
    return findings


def replay_transport_commits(events: Sequence[Dict[str, Any]],
                             node: str = "drill:transport"
                             ) -> List[Finding]:
    """Replay a KVTransport commit event log (`transport.transitions()`)
    against the idempotence relation: per manifest key, at most one
    'committed'; 'deduped' only after a commit; 'rejected' never
    commits (it carries no commit)."""
    findings: List[Finding] = []
    committed: Dict[Any, int] = {}
    for i, ev in enumerate(events):
        name = str(ev.get("event"))
        key = ev.get("key")
        if name == "committed":
            committed[key] = committed.get(key, 0) + 1
            if committed[key] > 1:
                findings.append(make_finding(
                    "PROTO003", node,
                    f"event {i}: manifest key {key!r} committed "
                    f"{committed[key]} times (idempotent commit broken)"))
        elif name == "deduped":
            if committed.get(key, 0) < 1:
                findings.append(make_finding(
                    "PROTO003", node,
                    f"event {i}: dedup for manifest key {key!r} with no "
                    f"prior commit"))
        elif name == "rejected":
            pass  # verification rejection commits nothing, by shape
        else:
            findings.append(make_finding(
                "PROTO003", node,
                f"event {i}: unknown transport event {name!r}"))
    return findings


def replay_restore_attempts(attempts: Sequence[Dict[str, Any]],
                            node: str = "drill:restore") -> List[Finding]:
    """Replay the elastic-restore halve-and-replan attempt trail
    (checkpoint._restore `attempts`): every OOM must be followed by a
    replan at half the chunk budget, and exactly the final attempt
    lands."""
    findings: List[Finding] = []
    if not attempts:
        findings.append(make_finding(
            "PROTO003", node, "restore report carries no attempt trail"))
        return findings
    for i, att in enumerate(attempts):
        outcome = att.get("outcome")
        last = i == len(attempts) - 1
        if outcome == "landed":
            if not last:
                findings.append(make_finding(
                    "PROTO003", node,
                    f"attempt {i} landed but {len(attempts) - 1 - i} "
                    f"more attempts follow"))
        elif outcome == "oom":
            if last:
                findings.append(make_finding(
                    "PROTO003", node,
                    f"attempt {i} hit OOM with no replan after it"))
            else:
                want = max(1, int(att.get("chunk_bytes", 0)) // 2)
                got = int(attempts[i + 1].get("chunk_bytes", -1))
                if got != want:
                    findings.append(make_finding(
                        "PROTO003", node,
                        f"attempt {i + 1} replanned at {got} bytes, "
                        f"expected half of {att.get('chunk_bytes')} "
                        f"= {want}"))
        else:
            findings.append(make_finding(
                "PROTO003", node,
                f"attempt {i}: unknown outcome {outcome!r}"))
    return findings
