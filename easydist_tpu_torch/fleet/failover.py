"""Bitwise in-flight recovery: resume descriptors + poison quarantine
(port of easydist_tpu/fleet/failover.py, which imports nothing of JAX).

The recovery contract rides the bitwise spine: greedy continuation is a
pure function of the token prefix, so a request that lost its replica
mid-stream resumes EXACTLY by resubmitting ``prompt + already-emitted
ids`` with the remaining budget to any surviving replica — the
concatenated stream is token-for-token identical to an uninterrupted
run.  This generalizes the evacuate path (serve/generation.py
`evacuate()` returns the same shape cooperatively); the crash path
cannot ask the dead session anything, so the ROUTER keeps each request's
`ResumeDescriptor` current by syncing emitted tokens from the live
session after every successful step — mirroring what a streaming client
would already have received when the replica died.

Quarantine: a request that has now crashed `quarantine_after` DISTINCT
replicas is overwhelmingly likely to be the *cause* (a poison request —
some input that deterministically kills whatever serves it).  Rolling it
through the fleet would take every replica down in sequence; instead its
future fails with the structured `PoisonRequestError` naming the
replicas it took down, and the fleet keeps serving everyone else.

FLEET005 (`analyze.check_resume_descriptor`, called by
`FleetRouter._resubmit`) audits every resume before it is submitted: the resubmitted prompt must be exactly original-prompt
+ emitted-ids, the budget must have room left, and the emitted ids must
not already contain eos.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set

from easydist_tpu_torch.serve.admission import ServeError

__all__ = ["ResumeDescriptor", "PoisonRequestError"]


class PoisonRequestError(ServeError):
    """Request rejected after crashing `quarantine_after` distinct
    replicas; carries the evidence a client/operator needs."""

    def __init__(self, request_id: int, replicas: Set[str]):
        self.request_id = request_id
        self.replicas = set(replicas)
        super().__init__(
            f"request {request_id} quarantined: crashed "
            f"{len(self.replicas)} distinct replica(s) "
            f"({sorted(self.replicas)}); refusing further resubmission")


@dataclass
class ResumeDescriptor:
    """Everything needed to continue one request on another replica.

    `ids` is the stream already emitted to the caller (synced from the
    serving session after each successful step, or harvested from a
    cooperative evacuate); `resume_prompt()` is the exact token prefix a
    surviving replica continues from, and `remaining()` the budget left.
    `crashed_on` accumulates replica ids this request was on when they
    died — the quarantine signal."""
    request_id: int
    prompt: List[int]
    max_new: int
    eos_id: Optional[int]
    ids: List[int] = field(default_factory=list)
    crashed_on: Set[str] = field(default_factory=set)

    def resume_prompt(self) -> List[int]:
        return list(self.prompt) + list(self.ids)

    def remaining(self) -> int:
        return self.max_new - len(self.ids)

    def finished(self) -> bool:
        """Nothing left to resume: budget exhausted or eos emitted."""
        return self.remaining() <= 0 or (
            self.eos_id is not None and self.eos_id in self.ids)

    def as_dict(self) -> dict:
        return {"request_id": self.request_id,
                "prompt": list(self.prompt), "ids": list(self.ids),
                "max_new": self.max_new, "eos_id": self.eos_id,
                "crashed_on": sorted(self.crashed_on)}
