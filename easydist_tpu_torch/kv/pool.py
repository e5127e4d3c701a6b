"""Refcounted page-pool allocator over one preallocated device arena
(port of easydist_tpu/kv/pool.py).

`PagePool` is pure host bookkeeping: the arena (`models.gpt.init_kv_pages`)
is allocated once by its owner and written in place by the compiled
steps; the pool tracks which of its `n_pages` pages are free, how many
holders reference each live page, and the counters serving reports.
The arena's drop page (index `n_pages`) is outside the pool: it is never
allocated.

Refcount semantics: a page's count is (# live sequences whose page table
maps it) + (1 if the prefix trie holds a committed node for it).
`alloc` hands out a free page at refcount 1; `share` bumps (trie commit,
prefix restore); `release` drops and reclaims at zero.  Shared pages are
never written by serving (restored prefixes are whole aligned pages;
writes land past the prefix, in pages the sequence allocated itself), so
sharing needs no device copy — `ensure_exclusive` is the copy-on-write
fault point for callers that do intend to write.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["PagePool"]


class PagePool:
    """Free-list allocator for `n_pages` fixed `page_tokens`-token KV
    pages of `page_bytes` bytes each (k + v, all layers)."""

    def __init__(self, n_pages: int, page_tokens: int, page_bytes: int = 0):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        if page_bytes < 0:
            raise ValueError(f"page_bytes must be >= 0, got {page_bytes}")
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.page_bytes = page_bytes
        # LIFO free list: recently freed pages are reused first
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refcount: List[int] = [0] * n_pages
        self.allocs = 0
        self.frees = 0
        self.shares = 0
        self.peak_in_use = 0

    # ---------------------------------------------------------- allocation
    @property
    def sentinel(self) -> int:
        """The page id tables use for unmapped entries: one past the
        allocatable pages, which is the arena's drop page."""
        return self.n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self) -> int:
        """Pop a free page at refcount 1.  Raises when the arena is
        exhausted — admission reserves a sequence's pages up front and
        gates on `n_free`, so hitting this is a bookkeeping bug."""
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted: all {self.n_pages} pages live "
                f"(admission should have reserved before allocating)")
        page = self._free.pop()
        self._refcount[page] = 1
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return page

    def share(self, page: int) -> int:
        """Add a holder to a live page; returns the new refcount."""
        self._check_live(page, "share")
        self._refcount[page] += 1
        self.shares += 1
        return self._refcount[page]

    def release(self, page: int) -> int:
        """Drop one holder; the page returns to the free list when the
        last holder releases.  Returns the remaining refcount."""
        self._check_live(page, "release")
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            self._free.append(page)
            self.frees += 1
        return self._refcount[page]

    def refcount(self, page: int) -> int:
        if not 0 <= page < self.n_pages:
            raise ValueError(f"page {page} out of range [0, {self.n_pages})")
        return self._refcount[page]

    def ensure_exclusive(self, page: int) -> Optional[int]:
        """Copy-on-write fault point: if `page` is shared (refcount > 1),
        allocate a fresh page for the caller to copy into, drop the
        caller's hold on the shared one, and return the new id; None
        when the page is already exclusive.  Serving never triggers
        this."""
        self._check_live(page, "ensure_exclusive")
        if self._refcount[page] == 1:
            return None
        fresh = self.alloc()
        self.release(page)
        return fresh

    def _check_live(self, page: int, op: str) -> None:
        if not 0 <= page < self.n_pages:
            raise ValueError(
                f"{op}: page {page} out of range [0, {self.n_pages})")
        if self._refcount[page] <= 0:
            raise ValueError(f"{op}: page {page} is free (refcount "
                             f"{self._refcount[page]}) — use-after-free")

    # ----------------------------------------------------------- reporting
    def stats(self) -> Dict[str, int]:
        return {"n_pages": self.n_pages, "page_tokens": self.page_tokens,
                "page_bytes": self.page_bytes, "in_use": self.in_use,
                "free": self.n_free, "allocs": self.allocs,
                "frees": self.frees, "shares": self.shares,
                "peak_in_use": self.peak_in_use}

    def check_invariants(self) -> List[str]:
        """Refcount/byte audit: free-list entries are unique in-range
        pages at refcount 0, live pages hold positive counts, and the
        arena's bytes equal mapped + free page bytes."""
        problems: List[str] = []
        seen = set()
        for page in self._free:
            if not 0 <= page < self.n_pages:
                problems.append(f"free list holds out-of-range page {page}")
                continue
            if page in seen:
                problems.append(f"free list holds page {page} twice "
                                f"(double free)")
            seen.add(page)
            if self._refcount[page] != 0:
                problems.append(
                    f"free page {page} has refcount {self._refcount[page]} "
                    f"(freed while still referenced)")
        for page in range(self.n_pages):
            if page not in seen and self._refcount[page] <= 0:
                problems.append(
                    f"page {page} has refcount {self._refcount[page]} but "
                    f"is not on the free list (leaked page)")
        arena_bytes = self.n_pages * self.page_bytes
        accounted = (self.in_use + self.n_free) * self.page_bytes
        if arena_bytes != accounted:
            problems.append(
                f"byte conservation drift: arena {arena_bytes} != "
                f"mapped+free {accounted}")
        return problems
