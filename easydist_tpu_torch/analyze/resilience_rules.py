"""Analyze layer 4: resilience auditor (the port of
easydist_tpu/analyze/resilience_rules.py).

RES001 — guard trace parity.  The NaN-step guard is a strict opt-in: with
``step_guard`` off, a dp/zero builder MUST emit the same traced program as
a build that never heard of the guard (the skip-and-hold select, the guard
state, everything must vanish — not just be "inactive").  The audit traces
two builds that claim to be equivalent with `make_fx` and compares their
programs' code literally; any drift means the guard leaked into the off
path.

RES002/RES003 — checkpoint commit-protocol integrity, over the port's
per-rank manifest / COMMITTED layout (`runtime/checkpoint.py`).  A
checkpoint root is audited directory by directory: every COMMITTED
checkpoint must pass manifest verification (RES002 error — resuming from
it would poison training state), and dead write debris (.tmp_* dirs,
torn step_N dirs without a COMMITTED marker) is reported as RES003 so
operators see GC lag before the disk fills.
"""

from __future__ import annotations

import os
import re
from typing import Callable, List, Sequence

from .findings import Finding, make_finding


def guard_off_program(step: Callable, example_args: Sequence) -> str:
    """Canonical trace of a step build (the parity comparand): the code of
    its `make_fx` GraphModule, traced on fake tensors."""
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(step, tracing_mode="fake")(*example_args).code


def audit_guard_parity(step_a: Callable, step_b: Callable,
                       example_args: Sequence,
                       node: str = "step") -> List[Finding]:
    """RES001: `step_a` and `step_b` claim to emit the same program (a
    guard-off build vs a build predating the guard argument, or the
    knob-default build vs an explicit step_guard=False build).  Trace both
    and compare literally — program identity, not allclose."""
    ja = guard_off_program(step_a, example_args)
    jb = guard_off_program(step_b, example_args)
    if ja != jb:
        n = next((i for i, (a, b) in enumerate(zip(ja, jb)) if a != b),
                 min(len(ja), len(jb)))
        return [make_finding(
            "RES001", node,
            f"guard-off traced programs differ (lengths {len(ja)} vs "
            f"{len(jb)}, first divergence at char {n}: "
            f"...{ja[max(0, n - 30):n + 30]!r}... vs "
            f"...{jb[max(0, n - 30):n + 30]!r}...)")]
    return []


def audit_checkpoint_root(path: str) -> List[Finding]:
    """RES002/RES003 over every entry of a checkpoint root directory."""
    from easydist_tpu_torch.runtime.checkpoint import (COMMITTED_NAME,
                                                       verify_checkpoint)

    findings: List[Finding] = []
    try:
        entries = sorted(os.listdir(path))
    except FileNotFoundError:
        return findings

    committed_steps = []
    uncommitted = []
    for d in entries:
        m = re.fullmatch(r"step_(\d+)", d)
        if not m:
            continue
        full = os.path.join(path, d)
        if os.path.isfile(os.path.join(full, COMMITTED_NAME)):
            committed_steps.append((int(m.group(1)), full))
        else:
            uncommitted.append((int(m.group(1)), d))

    for step, full in committed_steps:
        for p in verify_checkpoint(full):
            findings.append(make_finding("RES002", f"{path}/step_{step}", p))

    newest = max((s for s, _ in committed_steps), default=None)
    for step, d in uncommitted:
        if newest is not None and step <= newest:
            findings.append(make_finding(
                "RES003", f"{path}/{d}",
                f"torn uncommitted checkpoint superseded by committed "
                f"step {newest} (awaiting GC)"))
        else:
            findings.append(make_finding(
                "RES003", f"{path}/{d}",
                "uncommitted checkpoint with no newer committed step — a "
                "write died mid-commit; resume will use the previous "
                "committed step"))
    for d in entries:
        if d.startswith(".tmp_step_"):
            findings.append(make_finding(
                "RES003", f"{path}/{d}",
                "dead in-flight write directory (crash debris; GC'd by "
                "the next save once aged out)"))
    return findings
