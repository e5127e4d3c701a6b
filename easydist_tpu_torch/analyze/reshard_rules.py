"""Layer 8: redistribution auditor — chunked-plan byte bounds and
restored-placement agreement (the port of
easydist_tpu/analyze/reshard_rules.py, over `easydist_tpu_torch.reshard`).

The reshard substrate's whole contract is "never the global tensor":
every plan promises peak live bytes of O(max(src_shard, dst_shard) +
chunk).  These rules make that promise checkable BEFORE bytes move and
verifiable AFTER a restore lands:

  RESHARD001 (error)  a plan's `peak_live_bytes()` exceeds its
                      `chunked_bound()`: a chunk ceiling silently ignored,
                      or a planner change that regressed to
                      replicate-then-slice.  Peak bytes at model scale IS
                      the OOM that kills an elastic restart.
  RESHARD002 (error)  a restored leaf's (mesh, placements) disagrees with
                      the restore template's.  A leaf that came back
                      replicated (or on the wrong mesh dim) costs n x its
                      byte budget and a re-layout on every step —
                      bitwise-invisible, so only an audit catches it.

Both audit plain data (a `ReshardPlan`, a pair of trees).
"""

from __future__ import annotations

from typing import Any, List

from .findings import Finding, make_finding

__all__ = ["audit_reshard_plan", "audit_restored_state"]


def audit_reshard_plan(plan, node: str = "reshard") -> List[Finding]:
    """RESHARD001 over one redistribution plan (`reshard.plan.ReshardPlan`
    or anything exposing peak_live_bytes()/chunked_bound())."""
    findings: List[Finding] = []
    peak = int(plan.peak_live_bytes())
    bound = int(plan.chunked_bound())
    if peak > bound:
        n_chunks = len(getattr(plan, "chunks", ()) or ())
        findings.append(make_finding(
            "RESHARD001", node,
            f"plan peak live bytes {peak} exceed the chunked bound "
            f"{bound} (src_shard={getattr(plan, 'src_shard_bytes', '?')}, "
            f"dst_shard={getattr(plan, 'dst_shard_bytes', '?')}, "
            f"chunk_limit={getattr(plan, 'chunk_limit_bytes', '?')}, "
            f"{n_chunks} chunk(s)) — the plan degenerated toward global "
            f"materialization"))
    return findings


def _layout(x):
    """(mesh shape, mesh dim names, ranks, placements) of a DTensor leaf;
    None for a leaf that carries no layout of its own."""
    mesh = getattr(x, "device_mesh", None)
    if mesh is None:
        return None
    return (tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names or ()),
            tuple(int(r) for r in mesh.mesh.flatten()),
            tuple(x.placements))


def audit_restored_state(restored: Any, template: Any,
                         node: str = "restore") -> List[Finding]:
    """RESHARD002: every leaf whose template is laid out over a mesh of
    more than one rank (a DTensor) must have come back on exactly that
    mesh and those placements.  Template leaves without one (plain
    per-rank tensors, whose layout the restore's `layout=` states) are
    unconstrained."""
    from torch.utils import _pytree as pytree

    findings: List[Finding] = []
    got_leaves, got_def = pytree.tree_flatten(restored)
    want_leaves, want_def = pytree.tree_flatten(template)
    if got_def != want_def:
        findings.append(make_finding(
            "RESHARD002", node,
            f"restored tree structure {got_def} differs from the "
            f"template {want_def}"))
        return findings
    for i, (got, want) in enumerate(zip(got_leaves, want_leaves)):
        want_l = _layout(want)
        if want_l is None or len(want_l[2]) <= 1:
            continue
        got_l = _layout(got)
        if got_l != want_l:
            findings.append(make_finding(
                "RESHARD002", f"{node}.leaf[{i}]",
                f"restored layout {got_l} disagrees with the template's "
                f"{want_l} — the leaf will be re-laid-out (or held "
                f"replicated) on every step"))
    return findings
