"""Paged KV bookkeeping: a refcounted page-pool allocator over one
preallocated device arena plus an int32 page-table indirection per live
sequence (port of easydist_tpu/kv/{__init__,pool,table}.py, which are
jax-free; the port keeps its own copies).

  * `pool.PagePool` — host-side free-list allocator with per-page
    refcounts.  A restored prefix MAPS the trie's committed pages into
    the sequence's page table (refcount bump) instead of copying bytes,
    and serving never writes a shared page.
  * `table.PageTable` — per-slot int32 page indices of fixed shape
    [max_slots, max_pages], so the compiled decode step keeps one
    signature whatever the sequence lengths.  Unmapped entries hold the
    sentinel `n_pages`.

Arena layout ({"k", "v"}: [layers, n_pages + 1, heads, page_tokens,
head_dim], see `models.gpt.init_kv_pages`): the pool allocates pages
[0, n_pages); index `n_pages` is the arena's drop page, which the pool
never hands out.  Writes through a sentinel entry land there (the JAX
package drops them with `mode="drop"`, which torch's indexed writes do
not have), and every read clips page ids into [0, n_pages - 1], so the
drop page is never read.

`audit_page_table` cross-checks pool, table and prefix trie (the JAX
package's analyze rule KV001) and returns its findings as strings.
"""

from __future__ import annotations

from typing import List

from .pool import PagePool
from .table import PageTable

__all__ = ["PagePool", "PageTable", "audit_page_table", "is_page_ref"]


def is_page_ref(kv) -> bool:
    """True iff a trie-committed kv value is a page REFERENCE
    (`{"page": id}`) rather than tensors: the paged layout's trie holds
    indices into the arena, never the arena's storage."""
    return isinstance(kv, dict) and set(kv) == {"page"}


def audit_page_table(pool: PagePool, table: PageTable,
                     trie=None) -> List[str]:
    """Consistency audit of a live (pool, table[, prefix trie of
    {"page": id} references]) triple — the checks of the JAX package's
    KV001 (`easydist_tpu/analyze/kv_rules.py`).  A bookkeeping slip here
    does not crash: it serves one sequence another's K/V, or writes a
    page after it was handed to someone else.  Returns one message per
    violated invariant; [] when the bookkeeping is consistent:

      * the pool's free-list and byte-conservation invariants, and the
        table's shape, range and hole-free-prefix invariants;
      * every table entry and trie reference names a live page inside
        the arena;
      * no page has more holders (table occurrences + trie references)
        than its refcount."""
    problems = [f"pool: {p}" for p in pool.check_invariants()]
    problems += [f"table: {p}" for p in table.check_invariants()]
    holders = {}
    for slot in range(table.max_slots):
        for pid in table.mapped(slot):
            holders.setdefault(pid, []).append(f"slot{slot}")
    if trie is not None:
        for node in trie._walk():
            if is_page_ref(node.kv):
                holders.setdefault(node.kv["page"], []).append(
                    f"trie@depth{node.depth}")
    for pid, who in sorted(holders.items()):
        if not 0 <= pid < pool.n_pages:
            problems.append(f"page {pid} (held by {', '.join(who)}) is "
                            f"outside the arena [0, {pool.n_pages})")
            continue
        rc = pool.refcount(pid)
        if rc < 1:
            problems.append(
                f"page {pid} is mapped by {', '.join(who)} but has "
                f"refcount {rc} (freed under a live holder — the "
                f"allocator can hand it to another sequence)")
        elif rc < len(who):
            problems.append(
                f"page {pid} has {len(who)} holders ({', '.join(who)}) "
                f"but refcount {rc}: the first release frees it under the "
                f"remaining holders")
    return problems
