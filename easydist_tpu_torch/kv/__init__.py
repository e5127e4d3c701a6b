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

`tier.HostTier` is the host memory tier below the arena: cold trie
pages demote to host memory as `{"host": key}` references and promote
back into arena pages on the next hit (`is_host_ref`).

`audit_page_table` cross-checks pool, table and prefix trie (the
analyzer's KV001, `analyze.kv_rules`) and returns its findings as
strings.
"""

from __future__ import annotations

from typing import List

from .pool import PagePool
from .table import PageTable
from .tier import HostTier, TierError

__all__ = ["HostTier", "PagePool", "PageTable", "TierError",
           "audit_page_table", "is_host_ref", "is_page_ref"]


def is_page_ref(kv) -> bool:
    """True iff a trie-committed kv value is a page REFERENCE
    (`{"page": id}`) rather than tensors: the paged layout's trie holds
    indices into the arena, never the arena's storage."""
    return isinstance(kv, dict) and set(kv) == {"page"}


def is_host_ref(kv) -> bool:
    """True iff a trie-committed kv value was DEMOTED to the host tier
    (`{"host": key}`, `tier.HostTier` holding the bytes).  Host refs own
    no arena page: the trie node charges 0 bytes against its budget, and
    promotion (tier.get + arena import) swaps the value back to a
    `{"page": id}` ref before the slot's first decode step."""
    return isinstance(kv, dict) and set(kv) == {"host"}


def audit_page_table(pool: PagePool, table: PageTable,
                     trie=None, tier=None) -> List[str]:
    """Consistency audit of a live (pool, table[, prefix trie of
    {"page": id} references]) triple: the messages of the analyzer's KV001
    findings (`analyze.kv_rules.audit_page_table`).  A bookkeeping slip
    here does not crash: it serves one sequence another's K/V, or writes
    a page after it was handed to someone else.  Returns one message per
    violated invariant; [] when the bookkeeping is consistent:

      * the pool's free-list and byte-conservation invariants, and the
        table's shape, range and hole-free-prefix invariants;
      * every table entry and trie reference names a live page inside
        the arena;
      * no page has more holders (table occurrences + trie references)
        than its refcount;
      * with a host `tier`: its byte accounting and manifests hold (the
        JAX package's KVQ003)."""
    from easydist_tpu_torch.analyze.kv_rules import \
        audit_page_table as kv001

    problems = [f.message for f in kv001(pool, table, trie=trie)]
    if tier is not None:
        problems += [f"tier: {p}" for p in tier.check_invariants()]
    return problems
