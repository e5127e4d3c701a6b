"""Deterministic fault-injection harness (port of
easydist_tpu/resilience/faultinject.py, which imports nothing of JAX; the
port keeps its own copy with the same plan grammar and point names).

Every recovery path of the port's serving and training layers is
exercised by NAMED fault points armed from a schedule string — the same
code path a real failure takes, reproduced on the CPU.  A fault point is a call site like::

    if faultinject.fire("kv.tier.fetch_corrupt"):
        <site-specific corruption>

or, for sites whose fault is simply "the process died here"::

    faultinject.crash_point("fleet.replica.crash")   # raises InjectedFault

Schedule syntax (``arm()`` / ``fault_plan()``):

    "serve.oom_bucket@7"              fire on the 7th hit of that point
    "serve.oom_bucket@2,kv.tier.host_oom@1"   multiple points, comma-separated
    "serve.exec_timeout@*"            fire on EVERY hit
    "fleet.replica.crash@3,fleet.replica.crash@9"   fire on hits 3 AND 9

Counting is per-point and 1-based: ``name@N`` fires exactly once, when the
Nth execution of that fault point is reached; repeating a name schedules a
SET of occurrences.  Disarmed (the default), every fault point is a single
attribute check + ``False``.

The catalog below is closed and holds the points the port instruments:
arming an unknown point name raises immediately with a closest-match
suggestion (a typo'd plan must not silently test nothing).
"""

from __future__ import annotations

import difflib
import os
import threading
from typing import Dict, List, Optional, Tuple

# closed catalog: every instrumented fault point, with the recovery
# contract it exercises
FAULT_POINTS = frozenset({
    # checkpoint commit protocol (runtime/checkpoint.py)
    "ckpt.write.partial",     # crash mid-write: tempdir left, no commit
    "ckpt.manifest.corrupt",  # bit rot in a COMMITTED checkpoint's data
    # training loop (runtime/elastic.py + resilience/guard.py)
    "preempt.sigterm",        # host preemption signal at a step boundary
    "step.nan_grad",          # poisoned batch -> non-finite gradients
    "data.stall",             # input pipeline stops producing
    "elastic.restore.chunk_corrupt",  # bit rot in the checkpoint restored
    # the world shrank: SIGTERM at a step boundary, restart on fewer ranks
    "elastic.mesh.shrink",
    # a chunked restore exceeds its memory budget: halve the chunk, replan
    "elastic.restore.oom",
    # serving (serve/engine.py)
    "serve.exec_timeout",     # executable dispatch exceeds the watchdog
    "serve.oom_bucket",       # batch-bucket execution exhausts device memory
    # a replica dies mid-decode (serve/generation.py, at the step boundary)
    "fleet.replica.crash",
    # host KV tier (kv/tier.py)
    "kv.tier.fetch_corrupt",  # demotion fetch corrupt: manifest catch+refetch
    "kv.tier.host_oom",       # host allocation fails: hold-and-warn pause
})


class InjectedFault(RuntimeError):
    """Raised by `crash_point` sites: the deterministic stand-in for "the
    process died here".  Deliberately a RuntimeError so generic
    `except Exception` recovery paths treat it like any real failure."""

    def __init__(self, point: str):
        self.point = point
        super().__init__(f"injected fault at {point!r}")


class FaultPlanError(ValueError):
    """The schedule string is malformed or names an uncatalogued point."""


_lock = threading.Lock()
# None = disarmed (the zero-overhead fast path checks only this);
# else {point: occurrence int or "*"}
_plan: Optional[Dict[str, object]] = None
_hits: Dict[str, int] = {}
_fired: Dict[str, int] = {}


def parse_plan(spec: str) -> Dict[str, object]:
    """``"a@2,b@*"`` -> ``{"a": 2, "b": "*"}`` and ``"a@2,a@5"`` ->
    ``{"a": frozenset({2, 5})}``; raises
    FaultPlanError on unknown names / malformed entries, with a
    closest-match suggestion for typos.  Repeated entries for one point
    accumulate into a set of occurrences (a kill SCHEDULE); ``@*``
    anywhere for a point means every hit and absorbs numeric entries."""
    out: Dict[str, object] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        name, sep, occ = entry.partition("@")
        if not sep:
            raise FaultPlanError(
                f"fault plan entry {entry!r} missing '@occurrence' "
                f"(use 'name@N' or 'name@*')")
        if name not in FAULT_POINTS:
            close = difflib.get_close_matches(name, sorted(FAULT_POINTS),
                                              n=1, cutoff=0.4)
            hint = f" — did you mean {close[0]!r}?" if close else ""
            raise FaultPlanError(
                f"unknown fault point {name!r}{hint}; catalogued points: "
                f"{sorted(FAULT_POINTS)}")
        if occ == "*":
            out[name] = "*"
            continue
        try:
            n = int(occ)
        except ValueError:
            raise FaultPlanError(
                f"fault plan occurrence {occ!r} for {name!r} is not an "
                f"integer or '*'") from None
        if n < 1:
            raise FaultPlanError(
                f"fault occurrence must be >= 1 (1-based), got {n} "
                f"for {name!r}")
        prev = out.get(name)
        if prev == "*":
            continue  # every-hit already covers n
        if prev is None:
            out[name] = n
        else:
            prevs = {prev} if isinstance(prev, int) else set(prev)
            out[name] = frozenset(prevs | {n})
    return out


def arm(spec: str) -> None:
    """Arm the harness with a schedule string; empty string disarms."""
    global _plan
    plan = parse_plan(spec) if spec else None
    with _lock:
        _plan = plan or None
        _hits.clear()
        _fired.clear()


def disarm() -> None:
    arm("")


def armed() -> bool:
    return _plan is not None


def fire(point: str) -> bool:
    """Count a hit of `point`; True iff the armed schedule says this hit
    is the faulty one.  Disarmed: a single load + compare, no locking."""
    if _plan is None:  # fast path: production / faults-off CI
        return False
    if point not in FAULT_POINTS:
        raise FaultPlanError(f"uncatalogued fault point {point!r} in code")
    with _lock:
        if _plan is None:
            return False
        _hits[point] = _hits.get(point, 0) + 1
        occ = _plan.get(point)
        hit = (occ == "*" or _hits[point] == occ
               or (isinstance(occ, frozenset) and _hits[point] in occ))
        if hit:
            _fired[point] = _fired.get(point, 0) + 1
        return hit


def crash_point(point: str) -> None:
    """`fire` + raise: for sites whose injected fault is process death."""
    if fire(point):
        raise InjectedFault(point)


def stats() -> Dict[str, Dict[str, int]]:
    """{"hits": {...}, "fired": {...}} snapshot (bench/test reporting)."""
    with _lock:
        return {"hits": dict(_hits), "fired": dict(_fired)}


def unfired() -> List[Tuple[str, object]]:
    """Scheduled (point, occurrence) pairs the run never reached — a drill
    that "passed" without firing its faults tested nothing, so drills gate
    on this being empty.  ``@*`` entries count as unfired until the point
    fired at least once."""
    out: List[Tuple[str, object]] = []
    with _lock:
        if _plan is None:
            return out
        for point, occ in sorted(_plan.items()):
            hits = _hits.get(point, 0)
            if occ == "*":
                if _fired.get(point, 0) == 0:
                    out.append((point, "*"))
            elif isinstance(occ, frozenset):
                out.extend((point, n) for n in sorted(occ) if hits < n)
            elif hits < occ:  # single int occurrence
                out.append((point, occ))
    return out


def export_stats(db=None, key: str = "resilience",
                 sub_key: str = "fault_plan", persist: bool = False):
    """Append the armed plan + hit/fired/unfired counters to the PerfDB
    (the store serving metrics already land in), so a chaos drill's
    record proves every scheduled fault actually fired."""
    if db is None:
        from easydist_tpu_torch.runtime.perfdb import PerfDB

        db = PerfDB()
    with _lock:
        plan = {p: (occ if occ == "*" else sorted(occ)
                    if isinstance(occ, frozenset) else occ)
                for p, occ in (_plan or {}).items()}
    db.append_history(key, sub_key, {
        "plan": plan, **stats(),
        "unfired": [[p, occ] for p, occ in unfired()]})
    if persist:
        try:
            db.persist()
        except Exception:  # stats export must never fail a drill
            pass
    return db


class fault_plan:
    """Context manager for tests: arm on enter, restore on exit.

        with faultinject.fault_plan("step.nan_grad@3"):
            run_training(...)
    """

    def __init__(self, spec: str):
        self.spec = spec
        self._saved: Optional[Dict[str, object]] = None

    def __enter__(self) -> "fault_plan":
        global _plan
        self._saved = _plan
        arm(self.spec)
        return self

    def __exit__(self, *exc) -> None:
        global _plan
        with _lock:
            _plan = self._saved
            _hits.clear()
            _fired.clear()


def arm_from_config() -> None:
    """Arm from `config.fault_plan` (the EASYDIST_FAULT_PLAN schedule).
    Called by the entry points that own a process lifetime (the elastic
    loop); library code never arms implicitly."""
    from easydist_tpu_torch import config as edconfig

    if edconfig.fault_plan:
        arm(edconfig.fault_plan)


# the env plan is validated at import (a typo'd plan fails before a run)
if os.environ.get("EASYDIST_FAULT_PLAN"):
    parse_plan(os.environ["EASYDIST_FAULT_PLAN"])
