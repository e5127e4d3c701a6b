"""Layer 2b: overlapped-flush verifier, the OVL rule family (the port of
easydist_tpu/analyze/overlap_rules.py).

`comm.overlap` reorders gradient buckets into backward emission order and
issues each bucket's collective from the backward.  Two things can
silently go wrong with that transformation:

  OVL001  the emission order is not a permutation of the flat leaves —
          a reordered flush would then drop some gradients and duplicate
          others at unpack;
  OVL002  the issue order is not the plan's.  The JAX package pins its
          chain with `optimization_barrier` tokens and lints the
          traced flush for two consecutive collectives with no ordering
          dependency.  The port has no barrier: a process group's stream
          runs collectives in the order they are issued, and the order
          comes from the hooked flush (`comm.overlap._hooked_grads`),
          which logs the order in which it issues its units.  Every unit
          must be issued exactly once, and no unit before the unit the
          plan puts ahead of it; with `pin_chain` the flush holds a
          complete unit back until then, so an inverted pair means the
          pin was dropped and the schedule is not the one the cost model
          priced.

OVL003 (warning) is emitted by the compile pipeline (`fxfront.api`), not
here: it flags an overlap prediction on the flat config guess rather
than a `runtime.calibrate.calibrate_overlap` measurement.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .findings import Finding, make_finding
from .fx_rules import lint_bucket_plan


def lint_overlap_plan(leaves: Sequence, order: Sequence[int],
                      buckets: Optional[Sequence] = None,
                      node: str = "overlap") -> List[Finding]:
    """Validate an overlapped-flush plan: the emission order must permute
    the leaves (OVL001) and, when given, the bucket plan over the ORDERED
    leaves must tile exactly (COLL003 via `lint_bucket_plan`)."""
    findings: List[Finding] = []
    n = len(leaves)
    try:
        perm = sorted(int(i) for i in order) == list(range(n))
    except (TypeError, ValueError):
        perm = False
    if not perm:
        findings.append(make_finding(
            "OVL001", node,
            f"order {list(order)[:16]}"
            f"{'...' if len(list(order)) > 16 else ''} "
            f"is not a permutation of range({n})"))
        return findings  # bucket indices are meaningless under a bad order
    if buckets is not None:
        findings.extend(lint_bucket_plan(leaves, buckets))
    return findings


def lint_issue_log(log, node: str = "overlap") -> List[Finding]:
    """OVL002 over one flush's issue log (`{"units": n, "issued": [unit
    index, ...], "pin_chain": bool}`, as `comm.overlap.record_issues`
    collects it): a unit issued twice or never, and every pair of plan
    neighbours (k, k+1) issued k+1 first, is one finding each."""
    n = int(log["units"])
    issued = [int(k) for k in log["issued"]]
    pinned = "pinned" if log.get("pin_chain") else "unpinned"
    findings: List[Finding] = []
    counts = [issued.count(k) for k in range(n)]
    for k, c in enumerate(counts):
        if c != 1:
            findings.append(make_finding(
                "OVL002", node,
                f"{pinned} flush issued unit {k} {c} times (of {n} units): "
                f"each bucket's collective must be issued exactly once"))
    first = {k: issued.index(k) for k in range(n) if counts[k]}
    for k in range(n - 1):
        if k in first and k + 1 in first and first[k + 1] < first[k]:
            findings.append(make_finding(
                "OVL002", node,
                f"{pinned} flush issued unit {k + 1} before unit {k} "
                f"(issue order {issued[:16]}"
                f"{'...' if len(issued) > 16 else ''}): the collectives "
                f"do not run in the plan's order"))
    return findings


def lint_overlap_fn(fn, *args, node: str = "overlap",
                    **kwargs) -> List[Finding]:
    """Run `fn(*args, **kwargs)` (a step or flush that goes through the
    hooked flush) and lint every issue log it left (OVL002)."""
    from easydist_tpu_torch.comm.overlap import record_issues

    with record_issues() as logs:
        fn(*args, **kwargs)
    findings: List[Finding] = []
    for i, log in enumerate(logs):
        findings.extend(lint_issue_log(log, node=f"{node}[{i}]"))
    return findings
