"""Int32 page-table indirection: which arena page holds each
`page_tokens`-token window of each live sequence (port of
easydist_tpu/kv/table.py).

The table is a host-side numpy array of fixed shape
[max_slots, max_pages]; the compiled decode step takes it as an int32
tensor every step, and the FIXED shape keeps the step's signature closed
over every sequence length.  Unmapped entries hold the sentinel
`n_pages`: writes through it land in the arena's drop page, and reads
clip it to the last allocatable page, whose rows the length mask keeps
out of the softmax.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["PageTable"]


class PageTable:
    """[max_slots, max_pages] int32 page indices, sentinel `n_pages` for
    unmapped entries.  Pure host bookkeeping — callers send `self.array`
    to the device each step (a few KiB; the arena never moves)."""

    def __init__(self, max_slots: int, max_pages: int, n_pages: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {max_pages}")
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.max_slots = max_slots
        self.max_pages = max_pages
        self.n_pages = n_pages
        self.sentinel = n_pages
        self.array = np.full((max_slots, max_pages), self.sentinel,
                             dtype=np.int32)

    # ------------------------------------------------------------- mapping
    def map(self, slot: int, idx: int, page: int) -> None:
        """Point `slot`'s window `idx` (tokens [idx*pt, (idx+1)*pt)) at
        arena `page`.  A window is mapped at most once — remapping a live
        entry would leak its page's refcount."""
        if not 0 <= page < self.n_pages:
            raise ValueError(f"page {page} out of range [0, {self.n_pages})")
        if self.array[slot, idx] != self.sentinel:
            raise ValueError(
                f"slot {slot} window {idx} already maps page "
                f"{int(self.array[slot, idx])} (unmap before remapping)")
        self.array[slot, idx] = page

    def unmap_row(self, slot: int) -> List[int]:
        """Clear `slot`'s row back to sentinel, returning the pages it
        mapped (the caller releases each against the pool)."""
        row = self.array[slot]
        pages = [int(p) for p in row[row != self.sentinel]]
        row[:] = self.sentinel
        return pages

    def unmap_tail(self, slot: int, from_idx: int) -> List[int]:
        """Clear `slot`'s windows >= `from_idx` back to sentinel,
        returning the pages they mapped.  A suffix clear cannot open a
        hole inside the live prefix."""
        if from_idx < 0:
            raise ValueError(f"from_idx must be >= 0, got {from_idx}")
        tail = self.array[slot, from_idx:]
        pages = [int(p) for p in tail[tail != self.sentinel]]
        tail[:] = self.sentinel
        return pages

    def mapped(self, slot: int) -> List[int]:
        """Pages `slot` currently maps, in window order."""
        row = self.array[slot]
        return [int(p) for p in row[row != self.sentinel]]

    def n_mapped(self, slot: int) -> int:
        return int((self.array[slot] != self.sentinel).sum())

    # ----------------------------------------------------------- reporting
    def check_invariants(self) -> List[str]:
        """Shape/range audit; `audit_page_table` cross-checks the entries
        against the pool's refcounts."""
        problems: List[str] = []
        if self.array.shape != (self.max_slots, self.max_pages):
            problems.append(
                f"table shape drifted to {self.array.shape} (compiled-step "
                f"signature no longer closed)")
        bad = (self.array < 0) | (self.array > self.sentinel)
        if bad.any():
            problems.append(
                f"{int(bad.sum())} entries outside [0, {self.sentinel}]")
        for slot in range(self.max_slots):
            live = self.array[slot] != self.sentinel
            # mapped windows must be a contiguous prefix of the row: a
            # hole means attention reads an unrelated page INSIDE the
            # live length, where the mask does not cover for it
            if live.any():
                last = int(np.max(np.nonzero(live)[0]))
                if not live[:last + 1].all():
                    problems.append(
                        f"slot {slot} has unmapped window before window "
                        f"{last} (hole inside the live prefix)")
        return problems
