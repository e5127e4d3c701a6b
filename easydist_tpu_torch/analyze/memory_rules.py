"""Layer 3a: static verifier over the graph memory plan and remat rewrite
(the port of easydist_tpu/analyze/memory_rules.py).

Runs on the `(MetaGraph, MemoryPlan)` pair the planner produced
(`schedule/memory_planner.py`) plus the remat rewrite plan
(`schedule/remat.py`, over the FX program) — the whole memory pipeline
whose errors otherwise surface only as out-of-memory errors on the card.
DistIR-style: everything here is pure Python over already-built
structures, no device execution.

  MEM001  independent liveness recomputation: every interval's
          (start, end) must match a producer/last-consumer audit done by a
          DIFFERENT traversal (operand scan vs the planner's edge lists),
          graph outputs pinned live to the program end;
  MEM002  sharded-bytes sizing: every interval's bytes must equal the
          placement-divided tensor size, element-aligned and rounded UP on
          non-divisible shard dims (the widest device's share);
  MEM003  skyline soundness: `offsets` overlap-free while live
          (`native.check_plan`), `peak_bytes` >= the sum-of-live lower
          bound, and `peak_bytes` == the packed extent max(offset+size);
  MEM004  HBM budget gate: the predicted per-device peak must fit the
          card's memory (`edconfig.analyze_hbm_budget`; `torch.cuda` answers,
          `hbm_capacity_default` where no CUDA device does) —
          the finding carries a structured remat advisory naming which
          candidates, in `schedule/remat.py`'s largest-bytes-per-
          recompute-second order, would bring the program under budget;
  MEM005  remat-rewrite audit: every recomputed chain is pure flat
          aten calls that read only values existing before its consumer
          (a chain is shared by its far consumers, so a node of it may
          stand after one of them), the post-rewrite planned
          peak is strictly lower, and the emitted program carries the
          recomputed clones.  The JAX package also requires an
          `optimization_barrier` read of the chain sources against XLA's
          CSE; the port replays its program op by op with no CSE pass,
          so that check has no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from easydist_tpu_torch import native
from easydist_tpu_torch.metashard.metair import _DTYPE_BYTES, MetaGraph

from .findings import Finding, make_finding

# op-key namespaces that are never remat-chain material (the same
# exclusion as remat.py's _BANNED_NAMESPACES, in op_key vocabulary: the
# port's kernels and composites, the collectives)
_UNRECOMPUTABLE_PREFIXES = (
    "easydist_tpu_torch.", "_c10d_functional.", "c10d_functional.",
    "_c10d_functional_autograd.", "c10d.", "_dtensor.",
)

# cap repeated-findings floods: each seeded fixture fires exactly once, and
# a systematically-broken plan does not drown the report
_MAX_PER_CHECK = 8


# ------------------------------------------------------ MEM001: lifetimes

def recompute_liveness(graph: MetaGraph
                       ) -> Dict[str, Tuple[int, int]]:
    """Producer/last-consumer intervals recomputed independently of
    `plan_graph_memory`: last uses come from a REVERSE operand scan over
    `node.invars` (the planner walks the forward `var.consumers` edge
    lists), so a corrupted edge list and a corrupted plan cannot agree by
    construction.  Graph outputs (op- or input-produced) are pinned live
    to the final op."""
    n_ops = len(graph.ops)
    out_names = {v.name for v in graph.outputs}
    last_use: Dict[str, int] = {}
    for i in range(n_ops - 1, -1, -1):
        for v in graph.ops[i].invars:
            if v is not None and v.name not in last_use:
                last_use[v.name] = i
    intervals: Dict[str, Tuple[int, int]] = {}
    for i, node in enumerate(graph.ops):
        for v in node.outvars:
            if v is None or v.name in intervals:
                continue
            end = max(i, last_use.get(v.name, i))
            if v.name in out_names:
                end = n_ops - 1
            intervals[v.name] = (i, end)
    for node in graph.inputs:
        for v in node.outvars:
            if v is None or v.name in intervals:
                continue
            end = last_use.get(v.name, 0)
            if v.name in out_names:
                end = n_ops - 1
            intervals[v.name] = (0, end)
    return intervals


def _vars_by_name(graph: MetaGraph) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for node in graph.ops + graph.inputs:
        for v in node.outvars:
            if v is not None and v.name not in out:
                out[v.name] = v
    return out


def _plan_placements(var, per_axis: Sequence[Dict]):
    """The placement slots `plan_graph_memory` sizes a var by (its
    producer's out placement per axis)."""
    node = var.producer
    out = []
    for chosen in per_axis:
        s = chosen.get(node.name) if node is not None else None
        if s is None or var.producer_idx >= len(s.out_placements):
            out.append(None)
        else:
            out.append(s.out_placements[var.producer_idx])
    return out


def _expected_sharded_bytes(var, per_axis, axis_sizes) -> int:
    """Independent re-derivation of the interval's per-device bytes:
    element-aligned, shard dims rounded up (ceil) per axis."""
    shape = list(var.shape)
    for p, n in zip(_plan_placements(var, per_axis), axis_sizes):
        if p is not None and p.is_shard() and n > 0 and p.dim < len(shape):
            shape[p.dim] = -(-int(shape[p.dim]) // int(n))
    elems = 1
    for d in shape:
        elems *= int(d)
    return max(elems * _DTYPE_BYTES.get(var.dtype, 4), 1)


def verify_memory_plan(graph: MetaGraph, plan, per_axis: Sequence[Dict],
                       axis_sizes: Sequence[int]) -> List[Finding]:
    """MEM001 + MEM002 + MEM003 over one (graph, MemoryPlan) pair."""
    findings: List[Finding] = []

    # ---- MEM001: interval audit
    expected = recompute_liveness(graph)
    plan_iv = {name: (int(plan.starts[i]), int(plan.ends[i]))
               for i, name in enumerate(plan.var_names)}
    missing = sorted(set(expected) - set(plan_iv))
    extra = sorted(set(plan_iv) - set(expected))
    if missing:
        findings.append(make_finding(
            "MEM001", "memory-plan",
            f"{len(missing)} graph var(s) have no plan interval: "
            f"{missing[:6]}{'...' if len(missing) > 6 else ''}"))
    if extra:
        findings.append(make_finding(
            "MEM001", "memory-plan",
            f"{len(extra)} plan interval(s) name no graph var: "
            f"{extra[:6]}{'...' if len(extra) > 6 else ''}"))
    n_drift = 0
    for name in plan_iv:
        if name not in expected or n_drift >= _MAX_PER_CHECK:
            continue
        if plan_iv[name] != expected[name]:
            n_drift += 1
            findings.append(make_finding(
                "MEM001", f"memory-plan/{name}",
                f"interval {plan_iv[name]} but the independent "
                f"producer/last-consumer audit gives {expected[name]}"))

    # ---- MEM002: sizing audit
    vars_by_name = _vars_by_name(graph)
    n_size = 0
    for i, name in enumerate(plan.var_names):
        v = vars_by_name.get(name)
        if v is None or n_size >= _MAX_PER_CHECK:
            continue
        want = _expected_sharded_bytes(v, per_axis, axis_sizes)
        got = int(plan.sizes[i])
        if got != want:
            n_size += 1
            findings.append(make_finding(
                "MEM002", f"memory-plan/{name}",
                f"interval sized {got} bytes but the placement-divided "
                f"size of {v!r} is {want} (shard dims rounded up to whole "
                f"elements)"))

    # ---- MEM003: skyline soundness
    for i, j in plan.validate()[:_MAX_PER_CHECK]:
        findings.append(make_finding(
            "MEM003", f"memory-plan/{plan.var_names[i]}",
            f"offset range overlaps {plan.var_names[j]} while both are "
            f"live (offsets {int(plan.offsets[i])}+{int(plan.sizes[i])} "
            f"vs {int(plan.offsets[j])}+{int(plan.sizes[j])})"))
    if plan.peak_bytes < plan.peak_live_bytes:
        findings.append(make_finding(
            "MEM003", "memory-plan/peak",
            f"skyline peak {plan.peak_bytes} below the sum-of-live lower "
            f"bound {plan.peak_live_bytes} — a packing cannot beat "
            f"simultaneous liveness"))
    if len(plan.sizes):
        extent = int(np.max(plan.offsets + plan.sizes))
        if plan.peak_bytes != extent:
            findings.append(make_finding(
                "MEM003", "memory-plan/peak",
                f"declared peak {plan.peak_bytes} != packed extent "
                f"{extent} (max offset+size)"))
    return findings


# ------------------------------------------------- MEM004: HBM budget gate

def resolve_hbm_budget(mesh=None, device=None) -> int:
    """Per-device memory the MEM004 gate verifies against.
    `edconfig.analyze_hbm_budget` wins when set (>0); 0 disables; the
    default (-1) asks the card: the total memory of the mesh's CUDA
    device (its device type, this rank's current device) or of `device`,
    and falls back to `hbm_capacity_default` where no CUDA device
    answers (a CPU mesh, a CPU tensor, no card)."""
    import torch

    from easydist_tpu_torch import config as edconfig

    cap = edconfig.analyze_hbm_budget
    if cap >= 0:
        return int(cap)
    dev = None
    if mesh is not None and hasattr(mesh, "device_type"):
        dev = torch.device(mesh.device_type)
    elif device is not None:
        dev = torch.device(device)
    if dev is not None and dev.type == "cuda" and torch.cuda.is_available():
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(index).total_memory)
    return int(edconfig.hbm_capacity_default)


def _node_recompute_seconds(node) -> float:
    """FLOP-proxy recompute cost of re-executing one producer node —
    the same cost dimension remat.py prices chains in (exact bridge-
    recorded MACs when available, output elements otherwise, at
    `peak_flops`)."""
    from easydist_tpu_torch import config as edconfig

    flops = node.flops
    if flops is None:
        flops = 0.0
        for v in node.outvars:
            if v is not None:
                n = 1
                for d in v.shape:
                    n *= int(d)
                flops += float(n)
    return float(flops) / max(edconfig.peak_flops, 1.0)


def remat_advisory(graph: MetaGraph, plan, budget: int,
                   predicted: Optional[int] = None,
                   max_names: int = 6) -> str:
    """Which vars, taken in `schedule/remat.py`'s largest-bytes-per-
    recompute-second order, would bring the predicted peak under `budget`.
    Candidates must span the peak step strictly (their eviction moves the
    peak) and have a flat, re-executable producer."""
    from easydist_tpu_torch.schedule.remat import candidate_score

    predicted = plan.peak_bytes if predicted is None else int(predicted)
    overshoot = predicted - budget
    profile = native.live_profile(plan.starts, plan.ends, plan.sizes)
    if profile.size == 0:
        return "no live intervals to rematerialize"
    t_star = int(profile.argmax())
    vars_by_name = _vars_by_name(graph)
    cands: List[Tuple[float, str, int]] = []
    for i, name in enumerate(plan.var_names):
        if not (int(plan.starts[i]) < t_star < int(plan.ends[i])):
            continue
        v = vars_by_name.get(name)
        node = v.producer if v is not None else None
        if node is None or node.is_input \
                or node.op_key.startswith(_UNRECOMPUTABLE_PREFIXES):
            continue
        nbytes = int(plan.sizes[i])
        cands.append((candidate_score(nbytes,
                                      _node_recompute_seconds(node)),
                      name, nbytes))
    cands.sort(key=lambda c: (-c[0], c[1]))
    picked, cum = [], 0
    for _, name, nbytes in cands:
        if cum >= overshoot:
            break
        picked.append(f"{name}({nbytes}B)")
        cum += nbytes
    if not picked:
        return (f"over budget by {overshoot} bytes with no "
                f"rematerializable candidate spanning peak step {t_star}")
    shown = ", ".join(picked[:max_names])
    if len(picked) > max_names:
        shown += f", ... +{len(picked) - max_names} more"
    verdict = ("sufficient to fit" if cum >= overshoot else
               f"covers only {cum} of the {overshoot}-byte overshoot")
    return (f"remat advisory (largest bytes-per-recompute-second first): "
            f"recompute {shown} — {verdict}")


def check_hbm_budget(graph: Optional[MetaGraph], plan, budget: int,
                     remat_plan=None,
                     predicted: Optional[int] = None) -> List[Finding]:
    """MEM004: the predicted per-device peak of the program that ships
    (the remat plan's post-rewrite peak when a rewrite was applied, the
    graph skyline otherwise; `predicted` when the caller sized the
    program itself, `fxfront.api.CompileResult._memory_findings`) must
    fit `budget`."""
    if budget <= 0 or plan is None:
        return []
    if predicted is None:
        predicted = (int(remat_plan.predicted_peak) if remat_plan
                     else int(plan.peak_bytes))
    if predicted <= budget:
        return []
    advisory = (remat_advisory(graph, plan, budget, predicted=predicted)
                if graph is not None else "no MetaGraph for an advisory")
    return [make_finding(
        "MEM004", "memory-plan/budget",
        f"predicted per-device peak {predicted} bytes "
        f"({predicted / 2**20:.2f} MiB) exceeds the HBM budget {budget} "
        f"bytes ({budget / 2**20:.2f} MiB); {advisory}")]


# -------------------------------------------------- MEM005: remat rewrite

def audit_remat_plan(source, remat_plan, program=None) -> List[Finding]:
    """MEM005 over one (FX program the planner read, RematPlan) pair.
    `source` is the GraphModule `schedule.remat.plan_remat` planned over
    (chain and consumer names are its node names); `program`, when
    given, is the rewritten program that ships: it must carry the
    recomputed clones (`meta["remat_of"]`), or the rewrite was dropped
    and the planned peak no longer describes it."""
    from easydist_tpu_torch.schedule.remat import recomputable

    findings: List[Finding] = []
    nodes = list(source.graph.nodes)
    index = {n.name: i for i, n in enumerate(nodes)}
    by_name = {n.name: n for n in nodes}
    n = len(nodes)
    chain_nodes = sorted({c for ch in remat_plan.recompute.values()
                          for c in ch}, key=lambda c: index.get(c, -1))
    n_flat = 0
    for name in chain_nodes:
        if name not in index:
            findings.append(make_finding(
                "MEM005", f"remat/{name}",
                f"chain node {name!r} is not a node of the planned "
                f"program ({n} nodes)"))
            continue
        node = by_name[name]
        if not recomputable(node) and n_flat < _MAX_PER_CHECK:
            n_flat += 1
            findings.append(make_finding(
                "MEM005", f"remat/{name}:{node.target}",
                f"recompute chain re-executes {node.target} (a kernel, "
                f"collective, in-place, random or Python-helper call) — "
                f"chains must be pure flat aten calls"))
    # a record's chain is cloned once, before its first far consumer, and
    # shared by the others, so a chain node may stand after one of its
    # consumers in program order (a view the backward made of the value):
    # the recompute is topological when every value the chain reads from
    # outside itself exists before the consumer, and the chain is in
    # program order (the JAX package, whose chains are the consumer's
    # own ancestors, asks every chain equation to precede the consumer)
    for consumer in sorted(remat_plan.recompute,
                           key=lambda c: index.get(c, -1)):
        at = index.get(consumer)
        if at is None:
            findings.append(make_finding(
                "MEM005", f"remat/consumer:{consumer}",
                f"far consumer {consumer!r} is not a node of the planned "
                f"program"))
            continue
        chain = [c for c in remat_plan.recompute[consumer] if c in index]
        members = set(chain)
        late = sorted({a.name for c in chain
                       for a in by_name[c].all_input_nodes
                       if a.name not in members and index[a.name] >= at},
                      key=index.__getitem__)
        unordered = [c for c, d in zip(chain, chain[1:])
                     if index[c] >= index[d]]
        if late or unordered:
            findings.append(make_finding(
                "MEM005", f"remat/consumer:{consumer}",
                (f"chain reads {late[:4]} made at or after its consumer "
                 f"{consumer}" if late else
                 f"chain {chain[:6]} is not in program order")
                + " — not a topological recompute"))
    if remat_plan.recompute and \
            remat_plan.predicted_peak >= remat_plan.base_peak:
        findings.append(make_finding(
            "MEM005", "remat/peak",
            f"rewrite does not lower the planned peak "
            f"({remat_plan.base_peak} -> {remat_plan.predicted_peak} "
            f"bytes) — recompute cost with no memory win"))
    if program is not None and remat_plan.recompute and not any(
            "remat_of" in nd.meta for nd in program.graph.nodes):
        findings.append(make_finding(
            "MEM005", "remat/emission",
            "the shipped program carries no recomputed clone: the "
            "rewrite was dropped, and the planned peak does not "
            "describe the program"))
    return findings
