"""Layer 7: paged-KV auditor (the port of
easydist_tpu/analyze/kv_rules.py).

KV001 — the page-table/refcount consistency audit over the paged decode
cache (kv/pool.py + kv/table.py + serve/generation.py's `_PagedPool`).
The paged layout's safety rests entirely on host bookkeeping: the device
only ever sees an int32 table and a flat arena, so a bookkeeping bug does
not crash — it silently serves one sequence another sequence's K/V, or
writes a live page after it was handed to someone else.  This audit
cross-checks the three structures against each other:

  * every table entry points at a LIVE page (refcount >= 1) inside the
    arena — an entry at a freed page means attention is reading memory
    the allocator may hand out again mid-generation;
  * no page is mapped by more holders than its refcount — two sequences
    mapping one page with refcount 1 means the first retire frees it
    under the second (the "two live sequences without refcount >= 2"
    failure);
  * every trie-committed page reference is live, and counts toward the
    page's refcount alongside its table occurrences;
  * the pool's own free-list/byte-conservation invariants hold
    (`PagePool.check_invariants`: double frees, leaked pages, arena
    bytes != mapped + free bytes), and the table's shape/contiguity
    invariants hold (`PageTable.check_invariants`: a hole inside a row's
    live prefix gathers an unmasked garbage page).

Wired through `kv.audit_page_table`, which returns these findings'
messages: `GenerationSession` runs it at the first decode round, at every
retire and after every speculative rollback — the transitions where
refcount drift would next cause a wrong free — and raises on any.
"""

from __future__ import annotations

from typing import List

from .findings import Finding, make_finding


def audit_page_table(pool, table, trie=None,
                     node: str = "kv") -> List[Finding]:
    """KV001 over a live (`PagePool`, `PageTable`[, `PrefixCache` of
    {"page": id} references]) triple.  Returns one finding per violated
    invariant; [] when the bookkeeping is consistent."""
    findings: List[Finding] = []
    for problem in pool.check_invariants():
        findings.append(make_finding("KV001", node, f"pool: {problem}"))
    for problem in table.check_invariants():
        findings.append(make_finding("KV001", node, f"table: {problem}"))

    # holders per page: table occurrences across all slots + trie refs
    holders = {}
    for slot in range(table.max_slots):
        for pid in table.mapped(slot):
            holders.setdefault(pid, []).append(f"slot{slot}")
    if trie is not None:
        for tnode in trie._walk():
            pid = tnode.kv.get("page") if isinstance(tnode.kv, dict) \
                else None
            if pid is None:
                continue  # bucketed-style array commit; nothing to audit
            holders.setdefault(pid, []).append(f"trie@depth{tnode.depth}")

    for pid, who in sorted(holders.items()):
        if not 0 <= pid < pool.n_pages:
            findings.append(make_finding(
                "KV001", node,
                f"page {pid} (held by {', '.join(who)}) is outside the "
                f"arena [0, {pool.n_pages})"))
            continue
        rc = pool.refcount(pid)
        if rc < 1:
            findings.append(make_finding(
                "KV001", node,
                f"page {pid} is mapped by {', '.join(who)} but has "
                f"refcount {rc} (freed under a live holder — the "
                f"allocator can hand it to another sequence)"))
        elif rc < len(who):
            findings.append(make_finding(
                "KV001", node,
                f"page {pid} has {len(who)} holders "
                f"({', '.join(who)}) but refcount {rc}: the first "
                f"release frees it under the remaining holders"))
    return findings
