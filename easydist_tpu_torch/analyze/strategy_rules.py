"""Layer 1: static verifier over solved MetaIR strategies (one mesh axis);
the port of easydist_tpu/analyze/strategy_rules.py over the port's
MetaIR, whose op keys are aten packet names ("aten.mm").

Runs after `SpmdSolver.solve` (`fxfront.api.solve_axes`) and before
emission, on exactly the
(MetaGraph, chosen strategies) pair the solver produced for that axis.  The
invariants are the redistribution-typing rules of arXiv:2112.01075 applied
to our placement vocabulary:

  * R -> R/S and S -> R/S/S' edges are priced reshards (local slice,
    all_gather, all_to_all) — always realizable;
  * nothing materializes a PARTIAL from whole values: an edge whose
    consumer expects P while the producer emits R/S has no collective
    realization (STRAT001);
  * S(dim) must address a real tensor dim and divide it by the axis size,
    or the emitted PartitionSpec is meaningless (STRAT002);
  * a PARTIAL is resolved by a matching reduction (all_reduce /
    reduce_scatter at a priced edge or a region fence) before any
    non-linear consumer, never rides both operands of a bilinear op or a
    divisor, never changes reduction kind mid-flight, and never escapes at
    a graph output (STRAT003/STRAT004);
  * the solver's reported edge-communication objective must match an
    independent recomputation through `assignment_comm_cost` — a drift
    means the pick -> strategy-table mapping is corrupted (STRAT005).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from easydist_tpu_torch.metashard.metair import MetaGraph, NodeStrategy

from .findings import Finding, make_finding

# ops through which a pending PARTIAL propagates linearly:
# f(sum_i x_i) == sum_i f(x_i) when every other operand is replicated.
# The pool-injection sets of the interpreter
# (`fxfront.interpreter._PARTIAL_LINEAR_*`) plus the additive combiners;
# `make_fx` unrolls control flow, so the JAX set's composites have no
# counterpart.
_P_LINEAR_OPS = frozenset((
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.t",
    "aten.transpose", "aten.permute", "aten.squeeze", "aten.unsqueeze",
    "aten.expand", "aten.neg", "aten.clone", "aten._to_copy", "aten.sum",
    "aten.mul", "aten.div", "aten.mm", "aten.bmm", "aten.add", "aten.sub",
    "aten.cat", "aten.slice",
))

# bilinear in their operand pair: P may ride exactly ONE side
_P_BILINEAR_OPS = frozenset(("aten.mul", "aten.mm", "aten.bmm"))

# objective audit tolerance: reported and recomputed costs walk the same
# float32-ish matrices, so anything beyond rounding noise is a real drift
_AUDIT_RTOL = 1e-6
_AUDIT_ATOL = 1e-9


def _placement_str(p) -> str:
    return "None" if p is None else repr(p)


def _node_loc(node) -> str:
    return f"{node.name}({node.op_key})"


def verify_axis(graph: MetaGraph, chosen: Dict[str, NodeStrategy],
                axis) -> List[Finding]:
    """Check one axis's solved strategy assignment.  `axis` needs `.name`
    and `.size` (a MeshAxisSpec).  Returns findings (empty = clean)."""
    findings: List[Finding] = []
    ax = f"axis {axis.name}"

    # ---- STRAT002: S(dim) rank / divisibility, every placement slot
    for node in graph.all_nodes():
        s = chosen.get(node.name)
        if s is None:
            continue
        slots = []
        if not node.is_input:
            slots.extend(zip(node.invars, s.in_placements))
        slots.extend(zip(node.outvars, s.out_placements))
        seen_var_slots = set()
        for v, p in slots:
            if v is None or p is None or not p.is_shard():
                continue
            key = (id(v), p.dim)
            if key in seen_var_slots:
                continue  # one finding per (var, dim), not per slot
            seen_var_slots.add(key)
            if p.dim < 0 or p.dim >= len(v.shape):
                findings.append(make_finding(
                    "STRAT002", f"{_node_loc(node)}/{v.name}",
                    f"{ax}: S({p.dim}) addresses dim {p.dim} of rank-"
                    f"{len(v.shape)} tensor {v.name}{list(v.shape)}"))
            elif axis.size > 0 and v.shape[p.dim] % axis.size != 0:
                findings.append(make_finding(
                    "STRAT002", f"{_node_loc(node)}/{v.name}",
                    f"{ax}: S({p.dim}) shards dim of size "
                    f"{v.shape[p.dim]} across {axis.size} devices "
                    f"(not divisible)"))

    # ---- edge rules: STRAT001 (unrealizable P edge) + STRAT004 (reduction
    # mismatch, P into non-linear consumer, P on both bilinear operands)
    for node in graph.ops:
        s = chosen.get(node.name)
        if s is None:
            continue
        n_p_in = 0
        for in_idx, v in enumerate(node.invars):
            if v is None or in_idx >= len(s.in_placements):
                continue
            dn_p = s.in_placements[in_idx]
            if dn_p is None or not dn_p.is_partial():
                continue
            n_p_in += 1
            loc = f"{_node_loc(node)}/in{in_idx}"
            if node.op_key not in _P_LINEAR_OPS:
                findings.append(make_finding(
                    "STRAT004", loc,
                    f"{ax}: PARTIAL({dn_p.reduction.value}) rides into "
                    f"non-linear op {node.op_key!r} without a reduction "
                    f"fence"))
            if node.op_key == "aten.div" and in_idx == 1:
                findings.append(make_finding(
                    "STRAT004", loc,
                    f"{ax}: PARTIAL in the divisor of a div (linear in "
                    f"the numerator only)"))
            up = v.producer
            if up is None:
                continue
            up_s = chosen.get(up.name)
            if up_s is None or v.producer_idx >= len(up_s.out_placements):
                continue
            up_p = up_s.out_placements[v.producer_idx]
            if up_p is None or not up_p.is_partial():
                findings.append(make_finding(
                    "STRAT001", loc,
                    f"{ax}: consumer expects "
                    f"{_placement_str(dn_p)} but producer "
                    f"{_node_loc(up)} emits {_placement_str(up_p)} on "
                    f"{v.name} — no collective materializes a partial "
                    f"from whole values"))
            elif up_p.reduction != dn_p.reduction:
                findings.append(make_finding(
                    "STRAT004", loc,
                    f"{ax}: reduction mismatch on {v.name}: producer "
                    f"P({up_p.reduction.value}) vs consumer "
                    f"P({dn_p.reduction.value})"))
        if n_p_in >= 2 and node.op_key in _P_BILINEAR_OPS:
            findings.append(make_finding(
                "STRAT004", _node_loc(node),
                f"{ax}: PARTIAL on {n_p_in} operands of bilinear op "
                f"{node.op_key!r} (sum-of-products != product-of-sums)"))

    # ---- STRAT003: P never escapes at graph outputs.  Non-state outputs
    # are handed back replicated and state outputs thread into next-step
    # placeholders (whose pools are R/S only); either way a PARTIAL here is
    # an unreduced value crossing the program boundary.
    for v in graph.outputs:
        if v.producer is None:
            continue
        s = chosen.get(v.producer.name)
        if s is None or v.producer_idx >= len(s.out_placements):
            continue
        p = s.out_placements[v.producer_idx]
        if p is not None and p.is_partial():
            kind = "state" if v.name in graph.state_io else "plain"
            findings.append(make_finding(
                "STRAT003", f"output/{v.name}",
                f"{ax}: {kind} graph output {v.name} carries "
                f"P({p.reduction.value}) — pending reduction escapes the "
                f"program"))
    return findings


def audit_solver_objective(solver, chosen: Dict[str, NodeStrategy]
                           ) -> Tuple[Optional[Finding], Dict[str, float]]:
    """STRAT005: recompute the chosen assignment's edge-communication cost
    through `assignment_comm_cost` (which independently re-derives each
    cluster's pick by matching node strategies) and compare against the
    cost the solver reported from its own pick indices.

    Returns (finding or None, audit record).  The record is kept either
    way so clean runs carry affirmative evidence of the match."""
    reported = getattr(solver, "last_comm_cost", None)
    record: Dict[str, float] = {"axis": solver.axis.name}
    if reported is None:
        # beam/native path that predates the attribute, or no solve ran
        return None, record
    recomputed = solver.assignment_comm_cost(chosen)
    record["reported"] = float(reported)
    record["recomputed"] = float(recomputed)
    tol = _AUDIT_RTOL * max(abs(reported), abs(recomputed), 1.0) + _AUDIT_ATOL
    if not math.isfinite(recomputed) or abs(recomputed - reported) > tol:
        return make_finding(
            "STRAT005", f"solver/{solver.axis.name}",
            f"axis {solver.axis.name}: solver reported edge-comm cost "
            f"{reported:.6e} but independent recomputation gives "
            f"{recomputed:.6e} (tolerance {tol:.1e}) — strategy table and "
            f"solution picks disagree"), record
    return None, record
