"""Layer 10: pruned-discovery auditor — representative-transfer soundness
(`easydist_tpu_torch.fxfront.discovery`; the port of
easydist_tpu/analyze/discovery_rules.py).

The pruned discovery pipeline reuses one discovered rule across a whole
propagation group (and across compiles via the persistent rule cache).
Rules are dim-indexed, so a transfer is sound exactly when the member
could have discovered the same rule itself.  `rule_transferable` gates
every transfer up front; this layer re-audits the transfer log after the
trace so a gating bug surfaces as a finding instead of a miscompile:

  DISC001 (error)    a group/cache transfer instantiated a rule the
                     member's shapes cannot carry: the rule's shard space
                     has a different tensor-row count or per-row rank
                     than the member, a halo is as wide as (or wider
                     than) the member's shard along the halo'd dim, or a
                     size-sensitive rule (block-cyclic sharding, or a
                     priced composite "strategies" rule whose costs embed
                     absolute shapes) was transferred across non-identical
                     shapes.
  DISC002 (warning)  execution discovery ran for a primitive that has an
                     analytic preset — the preset declined the instance.
                     Not a soundness problem (discovery still produces a
                     correct rule), but the compile pays the probe
                     harness for an op the preset bank claims to cover;
                     emitted at the decline site in the interpreter, not
                     here, because the audit log only sees transfers.

Both rules audit plain data rows (the interpreter's transfer records), so
goldens are cheap fixtures — the same property every other late-layer
auditor in this package keeps.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from easydist_tpu_torch import config as edconfig

from .findings import Finding, make_finding

__all__ = ["audit_rule_transfer"]


def _rank(shape) -> int:
    return len(tuple(shape))


def audit_rule_transfer(records: Sequence[Dict[str, Any]],
                        node: str = "discovery") -> List[Finding]:
    """Audit representative->member rule transfers (DISC001).

    Each record is one transfer the interpreter performed:
      {"sig": member exact signature, "prim": primitive name,
       "rep_sig": representative signature (or "<cache>"),
       "rep_shapes": tensor shapes the rule was discovered on,
       "member_shapes": tensor shapes it was instantiated for,
       "rule": the rule dict ({"space", "recombines"} or
               {"strategies", ...})}
    """
    findings: List[Finding] = []
    nshards = max(int(edconfig.discovery_nshards), 1)

    for rec in records:
        sig = rec.get("sig", "?")
        prim = rec.get("prim", "?")
        rule = rec.get("rule") or {}
        rep_shapes = [tuple(s) for s in rec.get("rep_shapes", [])]
        member_shapes = [tuple(s) for s in rec.get("member_shapes", [])]
        where = f"{node}.{prim}"

        def bad(msg: str) -> None:
            findings.append(make_finding(
                "DISC001", where,
                f"{msg} (member {sig[:96]!r} <- rep "
                f"{rec.get('rep_sig', '?')[:96]!r})"))

        space = rule.get("space")
        if "strategies" in rule or space is None:
            # priced composite rules (and space-less fallbacks) embed
            # absolute shapes in their costs — exact-shape transfer only
            if member_shapes != rep_shapes:
                bad("size-sensitive rule transferred across non-identical "
                    "shapes")
            continue

        if len(space.table) != len(member_shapes):
            bad(f"rule space has {len(space.table)} tensor rows but the "
                f"member has {len(member_shapes)}")
            continue

        for t_idx, row in enumerate(space.table):
            mshape = member_shapes[t_idx]
            if len(row) != _rank(mshape):
                bad(f"rule row {t_idx} has rank {len(row)} but the member "
                    f"tensor has rank {_rank(mshape)}")
                break
            row_bad = False
            for dim_idx, d in enumerate(row):
                if d.block > 1 and member_shapes != rep_shapes:
                    bad(f"block-cyclic sharding (block={d.block}) "
                        f"transferred across non-identical shapes")
                    row_bad = True
                    break
                if d.halo is not None:
                    shard = mshape[dim_idx] // nshards
                    if d.halo.width >= max(shard, 1):
                        bad(f"halo width {d.halo.width} >= member shard "
                            f"size {shard} along dim {dim_idx}")
                        row_bad = True
                        break
            if row_bad:
                break

    return findings
