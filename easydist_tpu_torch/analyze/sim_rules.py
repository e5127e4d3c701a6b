"""Layer 9: simulator/autoscaler auditor — prediction fidelity and
control-loop stability (`easydist_tpu_torch.sim`).

The sim stack closes a loop: the simulator predicts, the planner ranks,
the autoscaler actuates.  Two failure shapes poison the whole loop:

  SIM001 (error)  a simulator prediction whose relative error against a
                  measured bench actual exceeds the committed bound
                  (`sim.simulate.SIM_REL_ERROR_BOUND`).  The planner and
                  the autoscaler both consume these predictions; drift
                  past the bound means the fleet is being sized on
                  numbers the hardware no longer agrees with — a stale
                  calibration datasheet, a residual domain that was
                  never fit, or a cost-model regression.  `bench.py
                  --simulate` gates on zero SIM001 findings.
  SIM002 (error)  autoscaler flap: a scale actuation in one direction
                  followed by an actuation in the OPPOSITE direction
                  within the hysteresis window (cooldown + confirm
                  ticks).  Every reversal pays a full drain +
                  hot-page-migration + spin-up round trip for zero
                  steady-state change.  The confirm/cooldown gates exist
                  precisely to make this impossible; an A-B-A sequence
                  in the decision log means they are mis-tuned or
                  bypassed.  `bench.py --autoscale` gates on zero SIM002
                  findings over the ramp drill's decision log.

Both rules audit plain data surfaces (a list of prediction rows, the
autoscaler's decision log), so goldens are cheap fixtures — the same
property every other late-layer auditor in this package keeps.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from .findings import Finding, make_finding

__all__ = ["audit_prediction", "audit_scale_decisions"]


def audit_prediction(rows: Sequence[Dict[str, Any]],
                     bound: float = None,
                     node: str = "sim") -> List[Finding]:
    """SIM001 over validation rows, each
    ``{"preset": str, "predicted_s": float, "measured_s": float}``
    (extra keys pass through untouched).  A row whose relative error
    ``|predicted - measured| / measured`` exceeds `bound` fires; a row
    with a non-positive or missing measurement also fires, because an
    unmeasurable preset cannot have been validated at all."""
    if bound is None:
        from easydist_tpu_torch.sim.simulate import SIM_REL_ERROR_BOUND
        bound = SIM_REL_ERROR_BOUND
    findings: List[Finding] = []
    for row in rows:
        preset = row.get("preset", "?")
        where = f"{node}.preset[{preset}]"
        predicted = row.get("predicted_s")
        measured = row.get("measured_s")
        if predicted is None or measured is None or float(measured) <= 0.0:
            findings.append(make_finding(
                "SIM001", where,
                f"preset {preset!r} has no usable measurement "
                f"(predicted={predicted!r}, measured={measured!r}) — an "
                f"unmeasured preset cannot count as validated"))
            continue
        rel = abs(float(predicted) - float(measured)) / float(measured)
        if rel > bound:
            findings.append(make_finding(
                "SIM001", where,
                f"prediction {float(predicted):.6g}s vs measured "
                f"{float(measured):.6g}s: relative error {rel:.3f} "
                f"exceeds the committed bound {bound:.3f} — recalibrate "
                f"(bench.py --simulate refits the residual) or fix the "
                f"cost-model regression"))
    return findings


def audit_scale_decisions(decisions: Sequence[Dict[str, Any]],
                          window: int = None,
                          node: str = "autoscale") -> List[Finding]:
    """SIM002 over an `Autoscaler.decision_log`: entries carry ``tick``
    and ``action`` ("scale_up" / "scale_down" / "hold").  A pair of
    opposite-direction actuations FEWER than `window` ticks apart is a
    flap.  `window` defaults to confirm + cooldown of the default
    `AutoscaleConfig`: the gates force cooldown suppressions then fresh
    confirmations, so the earliest legitimate reversal is exactly
    `window` ticks after the prior actuation — anything strictly inside
    means the gates were mis-tuned or bypassed."""
    if window is None:
        from easydist_tpu_torch.sim.autoscale import AutoscaleConfig
        cfg = AutoscaleConfig()
        window = cfg.confirm_evals + cfg.cooldown_evals
    findings: List[Finding] = []
    last_dir = 0
    last_tick = None
    for d in decisions:
        action = d.get("action")
        if action not in ("scale_up", "scale_down"):
            continue
        direction = 1 if action == "scale_up" else -1
        tick = int(d.get("tick", 0))
        if (last_dir != 0 and direction == -last_dir
                and last_tick is not None
                and tick - last_tick < window):
            findings.append(make_finding(
                "SIM002", f"{node}.tick[{tick}]",
                f"{action} at tick {tick} reverses the "
                f"{'scale_up' if last_dir > 0 else 'scale_down'} at tick "
                f"{last_tick} within the {window}-tick hysteresis "
                f"window — an A-B-A flap; each reversal pays a drain + "
                f"page-migration + spin-up round trip for nothing"))
        last_dir = direction
        last_tick = tick
    return findings
