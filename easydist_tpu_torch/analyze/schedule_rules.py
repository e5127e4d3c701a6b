"""Layer 3b: static verifier over pipeline tick-schedule tables (the port
of easydist_tpu/analyze/schedule_rules.py).

Works on the host-side supertick tables every rank walks
(`parallel/pipeline.py::schedule_tables`: 1F1B, interleaved, and the
fill-drain tables of gpipe / remat with their mirrored backward;
`gpipe_schedule_tables` below re-derives the plain GPipe forward clock
`u = s + m` in the same table form).  A schedule bug here does not
always crash: a unit consuming an activation that has not arrived yet,
or a residual overwritten before its backward reads it, surfaces as
wrong gradients or a rank waiting forever on a P2P receive.

  SCHED001  dependency-DAG consistency (deadlock check): the dependency
            graph — fwd(j,m) needs fwd(j-1,m) one tick earlier (ppermute
            latency), bwd(j,m) needs bwd(j+1,m) one tick earlier and its
            own fwd(j,m) — is acyclic by construction, so the schedule is
            deadlock-free iff its tick assignment is a topological order;
            a unit scheduled twice or never scheduled also fires;
  SCHED002  per-stage in-flight activation stash: the max number of
            microbatches a (device, chunk) holds between forward and
            backward must fit both the declared residual ring (an
            overflow overwrites a live vjp residual) and the 1F1B
            theoretical bound min(2*(J-j)-1, M) of stage depth J-j;
  SCHED003  static bubble fraction (warning-level report): idle fwd/bwd
            slots over total slots, against
            `edconfig.analyze_bubble_warn_frac`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .findings import Finding, make_finding

_MAX_PER_CHECK = 8


def gpipe_schedule_tables(n_stages: int, n_microbatches: int) -> Dict:
    """The plain GPipe forward clock `fwd(s, m) at u = s + m` in the same
    table form `_1f1b_schedule_tables` emits, so one verifier covers both
    schedule families (`parallel/pipeline.py::spmd_pipeline` and the
    auto-split `parallel/auto_pipeline.py::pipeline_forward`)."""
    S, M = n_stages, n_microbatches
    U = M + S - 1
    m_f = np.zeros((U, S), np.int32)
    k_f = np.zeros((U, S), np.int32)
    f_ok = np.zeros((U, S), bool)
    for s in range(S):
        for m in range(M):
            m_f[s + m, s], f_ok[s + m, s] = m, True
    zeros = np.zeros((U, S), np.int32)
    return {"m_f": m_f, "k_f": k_f, "f_ok": f_ok,
            "m_b": zeros, "k_b": zeros.copy(),
            "b_ok": np.zeros((U, S), bool),
            "n_superticks": U, "ring": 1}


def _collect_units(tables: Dict, S: int, fwd: bool
                   ) -> Tuple[Dict[Tuple[int, int], int], List]:
    """(global stage j, microbatch m) -> supertick, plus duplicate sites."""
    ok_k, m_k, k_k = (("f_ok", "m_f", "k_f") if fwd
                      else ("b_ok", "m_b", "k_b"))
    ok = np.asarray(tables[ok_k])
    mm = np.asarray(tables[m_k])
    kk = np.asarray(tables[k_k])
    units: Dict[Tuple[int, int], int] = {}
    dups = []
    for u in range(ok.shape[0]):
        for s in range(S):
            if not ok[u, s]:
                continue
            unit = (int(kk[u, s]) * S + s, int(mm[u, s]))
            if unit in units:
                dups.append((unit, units[unit], u))
            else:
                units[unit] = u
    return units, dups


def schedule_stats(tables: Dict, fwd_only: bool = False) -> Dict:
    """Static occupancy numbers for the SCHED003 report / PerfDB export."""
    f_ok = np.asarray(tables["f_ok"])
    useful = int(f_ok.sum())
    total = int(f_ok.size)
    if not fwd_only:
        useful += int(np.asarray(tables["b_ok"]).sum())
        total *= 2
    return {
        "bubble_fraction": 1.0 - useful / max(total, 1),
        "useful_slots": useful,
        "total_slots": total,
        "n_superticks": int(tables["n_superticks"]),
        "ring": int(tables.get("ring", 1)),
    }


def verify_schedule_tables(tables: Dict, n_stages: int, n_virtual: int,
                           n_microbatches: int, fwd_only: bool = False,
                           node: str = "pipeline",
                           bubble_warn_frac: Optional[float] = None,
                           stash_bound: bool = True) -> List[Finding]:
    """SCHED001/002/003 over one schedule-table set.  `stash_bound=False`
    holds the in-flight stash to the residual ring only: a fill-drain
    (gpipe / remat) schedule keeps every microbatch by design, so the
    1F1B bound does not apply to it."""
    findings: List[Finding] = []
    S, V, M = n_stages, max(1, n_virtual), n_microbatches
    J = V * S

    u_fwd, fdups = _collect_units(tables, S, fwd=True)
    u_bwd, bdups = _collect_units(tables, S, fwd=False)

    # ---- SCHED001: scheduled exactly once
    for unit, u0, u1 in (fdups + bdups)[:_MAX_PER_CHECK]:
        j, m = unit
        findings.append(make_finding(
            "SCHED001", f"{node}/stage{j}/mb{m}",
            f"unit scheduled twice (superticks {u0} and {u1}) — one "
            f"execution clobbers the other's slot"))
    missing_f = [(j, m) for j in range(J) for m in range(M)
                 if (j, m) not in u_fwd]
    if missing_f:
        findings.append(make_finding(
            "SCHED001", node,
            f"{len(missing_f)} forward unit(s) never scheduled "
            f"(starvation): {missing_f[:6]}"
            f"{'...' if len(missing_f) > 6 else ''}"))
    if not fwd_only:
        missing_b = [(j, m) for j in range(J) for m in range(M)
                     if (j, m) not in u_bwd]
        if missing_b:
            findings.append(make_finding(
                "SCHED001", node,
                f"{len(missing_b)} backward unit(s) never scheduled: "
                f"{missing_b[:6]}{'...' if len(missing_b) > 6 else ''}"))

    # ---- SCHED001: the tick assignment must topologically order the
    # dependency DAG (activations ride one ppermute tick up the ring,
    # gradients one tick down; the last stage turns around in-tick)
    n_dep = 0
    for (j, m), u in sorted(u_fwd.items()):
        if j == 0 or (j - 1, m) not in u_fwd or n_dep >= _MAX_PER_CHECK:
            continue
        if u <= u_fwd[(j - 1, m)]:
            n_dep += 1
            findings.append(make_finding(
                "SCHED001", f"{node}/stage{j}/mb{m}",
                f"fwd at supertick {u} but its input activation leaves "
                f"stage {j - 1} at supertick {u_fwd[(j - 1, m)]} (+1 tick "
                f"ppermute) — consumes a value that has not arrived"))
    if not fwd_only:
        for (j, m), u in sorted(u_bwd.items()):
            if n_dep >= _MAX_PER_CHECK:
                break
            if j < J - 1 and (j + 1, m) in u_bwd \
                    and u <= u_bwd[(j + 1, m)]:
                n_dep += 1
                findings.append(make_finding(
                    "SCHED001", f"{node}/stage{j}/mb{m}",
                    f"bwd at supertick {u} but its cotangent leaves stage "
                    f"{j + 1} at supertick {u_bwd[(j + 1, m)]} (+1 tick "
                    f"ppermute)"))
            elif (j, m) in u_fwd and u < u_fwd[(j, m)]:
                n_dep += 1
                findings.append(make_finding(
                    "SCHED001", f"{node}/stage{j}/mb{m}",
                    f"bwd at supertick {u} precedes its own fwd at "
                    f"{u_fwd[(j, m)]}"))

    # ---- SCHED002: in-flight stash vs ring and the 1F1B bound (units
    # missing a fwd or bwd tick are skipped here — SCHED001 already fired)
    if not fwd_only:
        ring = int(tables.get("ring", 1))
        over_ring: List[Tuple[int, int, int]] = []   # (live, j, bound)
        over_bound: List[Tuple[int, int, int]] = []
        for k in range(V):
            for s in range(S):
                j = k * S + s
                mbs = [m for m in range(M)
                       if (j, m) in u_fwd and (j, m) in u_bwd]
                if not mbs:
                    continue
                live = max(
                    sum(1 for m2 in mbs
                        if u_fwd[(j, m2)] <= u_bwd[(j, m1)]) - i1
                    for i1, m1 in enumerate(mbs))
                bound = min(2 * (J - j) - 1, M)
                if live > ring:
                    over_ring.append((live, j, ring))
                elif stash_bound and live > bound:
                    over_bound.append((live, j, bound))
        if over_ring:
            live, j, ring = max(over_ring)
            findings.append(make_finding(
                "SCHED002", f"{node}/stage{j}",
                f"{live} microbatches in flight but the residual ring "
                f"holds {ring} slot(s) ({len(over_ring)} stage(s) "
                f"affected) — a live vjp residual is overwritten before "
                f"its backward reads it"))
        elif over_bound:
            live, j, bound = max(over_bound)
            findings.append(make_finding(
                "SCHED002", f"{node}/stage{j}",
                f"{live} microbatches in flight exceeds the 1F1B "
                f"theoretical stash bound min(2*(J-j)-1, M) = {bound} "
                f"({len(over_bound)} stage(s) affected) — the schedule "
                f"keeps gpipe-class activation memory"))

    # ---- SCHED003: bubble-fraction report
    if bubble_warn_frac is None:
        from easydist_tpu_torch import config as edconfig

        bubble_warn_frac = edconfig.analyze_bubble_warn_frac
    stats = schedule_stats(tables, fwd_only=fwd_only)
    if stats["bubble_fraction"] > bubble_warn_frac:
        findings.append(make_finding(
            "SCHED003", node,
            f"static bubble fraction {stats['bubble_fraction']:.2f} "
            f"exceeds {bubble_warn_frac:.2f} "
            f"({stats['useful_slots']}/{stats['total_slots']} useful "
            f"slots over {stats['n_superticks']} superticks) — raise "
            f"n_microbatches or n_virtual"))
    return findings
