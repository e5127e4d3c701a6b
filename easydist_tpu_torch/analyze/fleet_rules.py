"""Layer 6: fleet auditor — routing health, KV handoff integrity, drain
hygiene, failover correctness (`easydist_tpu_torch.fleet`).

Failure shapes a multi-replica serving fleet adds on top of the
single-session audits:

  FLEET001 (error)   a request routed to a replica whose circuit breaker
                     was OPEN or that was already draining.  The router's
                     eligibility filter exists precisely to prevent this;
                     a decision that slipped through means load is being
                     steered into a replica that is shedding or leaving —
                     the request will burn a timeout or an admission error
                     instead of being served.
  FLEET002 (error)   a KV page handoff whose payload disagrees with its
                     sha256 manifest (token ids, digest, or byte count).
                     A corrupt page committed into a live trie poisons
                     every future request sharing that prefix — bitwise-
                     silently, because restore skips recompute.
  FLEET003 (warning) a drained replica's trie still holds pinned pages.
                     Drain retires every slot and every retirement unpins;
                     leftover refcounts mean a pin/unpin imbalance — the
                     pages can never be evicted and the drained session's
                     device memory never fully releases.
  FLEET004 (error)   a request dispatched to a replica the health monitor
                     had marked DEAD.  DEAD must gate eligibility exactly
                     like an OPEN breaker; a decision showing "dead" means
                     load was steered onto a corpse and the request
                     strands until some other layer times it out.
  FLEET005 (error)   a crash/evacuate resume descriptor that disagrees
                     with its original request: the resubmitted prefix is
                     not exactly prompt + already-emitted ids, the emitted
                     ids already exhaust the budget, or they already
                     contain eos.  Any of these means the "recovered"
                     continuation would differ from the uninterrupted
                     run — a silent bitwise break, the one thing the
                     failover layer exists to prevent.

All of these audit plain data surfaces (the router's decision log, a
transfer manifest + payload, a drained session's tries, a resume
descriptor), so goldens are cheap fixtures, not compiled programs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .findings import Finding, make_finding

__all__ = ["audit_routing", "audit_page_handoff", "audit_drained_session",
           "audit_resume"]


def audit_routing(decisions: Sequence[Dict[str, object]],
                  node: str = "fleet") -> List[Finding]:
    """FLEET001 over a router decision log: every entry names the chosen
    replica and the breaker/drain state OBSERVED at decision time."""
    findings: List[Finding] = []
    for d in decisions:
        rid = d.get("replica_id")
        where = f"{node}.request[{d.get('request_id')}]"
        if d.get("breaker_state") == "open":
            findings.append(make_finding(
                "FLEET001", where,
                f"routed to replica {rid!r} whose circuit breaker was "
                f"OPEN — the eligibility filter must exclude tripped "
                f"replicas"))
        if d.get("draining"):
            findings.append(make_finding(
                "FLEET001", where,
                f"routed to replica {rid!r} that was already draining — "
                f"its session rejects the submit and the request "
                f"bounces"))
        if d.get("health") == "dead":
            findings.append(make_finding(
                "FLEET004", where,
                f"dispatched to replica {rid!r} the health monitor had "
                f"marked DEAD — eligibility must exclude dead replicas "
                f"exactly like OPEN breakers"))
    return findings


def audit_resume(descriptor: Dict[str, object],
                 resume_prompt: Optional[Sequence[int]] = None,
                 node: str = "resume") -> List[Finding]:
    """FLEET005 over one resume descriptor (fleet/failover.py
    `ResumeDescriptor.as_dict()` shape) and optionally the exact token
    prefix about to be resubmitted.  The bitwise-recovery contract:
    resubmit == prompt + already-emitted ids, with budget left and no
    eos in the emitted stream."""
    findings: List[Finding] = []
    where = f"{node}.request[{descriptor.get('request_id')}]"
    prompt = [int(t) for t in descriptor.get("prompt", [])]
    ids = [int(t) for t in descriptor.get("ids", [])]
    max_new = descriptor.get("max_new")
    eos_id = descriptor.get("eos_id")
    if resume_prompt is not None \
            and [int(t) for t in resume_prompt] != prompt + ids:
        findings.append(make_finding(
            "FLEET005", where,
            f"resubmitted prefix ({len(list(resume_prompt))} tokens) is "
            f"not prompt + emitted ids ({len(prompt)}+{len(ids)} "
            f"tokens) — the continuation would diverge from the "
            f"uninterrupted run"))
    if isinstance(max_new, int) and len(ids) >= max_new:
        findings.append(make_finding(
            "FLEET005", where,
            f"descriptor resumes with no budget left ({len(ids)} emitted "
            f">= max_new {max_new}) — the request already finished as "
            f"'length' and must not resubmit"))
    if eos_id is not None and eos_id in ids:
        findings.append(make_finding(
            "FLEET005", where,
            f"emitted ids already contain eos {eos_id} — the request "
            f"already finished and a resume would generate tokens past "
            f"the stop"))
    return findings


def audit_page_handoff(manifest: Dict[str, object], path,
                       node: str = "handoff") -> List[Finding]:
    """FLEET002 over one transfer: recompute every page digest against
    the manifest (fleet.transport.verify_manifest does the hashing)."""
    from easydist_tpu_torch.fleet.transport import verify_manifest

    return [make_finding("FLEET002", node, problem)
            for problem in verify_manifest(manifest, path)]


def audit_drained_session(session, node: str = "drain") -> List[Finding]:
    """FLEET003 over a drained session's tries: with no live slots left,
    every page must be unpinned (refcount 0) — pinned leftovers are
    unevictable orphans.  Also folds in the trie's own bookkeeping audit
    (`check_invariants`) since drain is the natural audit point."""
    findings: List[Finding] = []
    if not session.is_drained:
        return [make_finding(
            "FLEET003", node,
            "drain audit ran on a session that still holds live work "
            "(queued/prefilling/decoding) — audit after is_drained")]
    for bucket, pool in getattr(session, "_pools", {}).items():
        trie = getattr(pool, "trie", None)
        if trie is None:
            continue
        where = f"{node}.bucket[{bucket}]"
        for n in trie._walk():
            if n.refcount > 0:
                findings.append(make_finding(
                    "FLEET003", where,
                    f"orphaned pinned page at depth {n.depth} "
                    f"(refcount {n.refcount} with zero live slots): "
                    f"pin/unpin imbalance leaves it unevictable"))
        for problem in trie.check_invariants():
            findings.append(make_finding("FLEET003", where, problem))
    return findings
