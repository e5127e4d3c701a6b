"""Consistent-hash ring for cold-prefix placement (port of
easydist_tpu/fleet/hashring.py, which imports nothing of JAX; the port
keeps its own copy so every key lands on the same replica as there).

A prompt whose prefix no replica's trie holds yet has no affinity signal;
routing it uniformly at random would scatter identical system prefixes
across the fleet and every replica would pay the same prefill.  Hashing
the trie-page-aligned prefix onto a ring instead makes COLD placement
sticky: the second request sharing the prefix lands on the same replica
the first one warmed, and from then on affinity scoring takes over.

Classic ring: each replica owns `vnodes` points (sha256 of
"replica_id#i"), a key routes to the first point clockwise from its own
hash, and adding/removing one replica only remaps the ~1/N of keyspace
adjacent to its points — a drain does not reshuffle every other replica's
warm prefixes.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import List, Optional, Sequence, Tuple

__all__ = ["HashRing", "prefix_hash_key"]


def _point(label: str) -> int:
    return int.from_bytes(
        hashlib.sha256(label.encode("utf-8")).digest()[:8], "big")


def prefix_hash_key(tokens: Sequence[int]) -> int:
    """Ring position of a token prefix (exact over the ids — two prompts
    share a key iff they share the whole aligned prefix)."""
    h = hashlib.sha256()
    for t in tokens:
        h.update(int(t).to_bytes(8, "big", signed=True))
    return int.from_bytes(h.digest()[:8], "big")


class HashRing:
    """Sorted virtual-point ring over replica ids."""

    def __init__(self, replica_ids: Sequence[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: List[Tuple[int, str]] = []
        for rid in replica_ids:
            self.add(rid)

    def add(self, replica_id: str) -> None:
        for i in range(self.vnodes):
            bisect.insort(self._points,
                          (_point(f"{replica_id}#{i}"), replica_id))

    def remove(self, replica_id: str) -> None:
        self._points = [(p, r) for p, r in self._points if r != replica_id]

    def replicas(self) -> List[str]:
        return sorted({r for _, r in self._points})

    def route(self, key: int,
              eligible: Optional[Sequence[str]] = None) -> Optional[str]:
        """First eligible replica clockwise from `key`; None when the
        ring is empty or nothing eligible remains."""
        if not self._points:
            return None
        allowed = None if eligible is None else set(eligible)
        start = bisect.bisect_left(self._points, (key, ""))
        n = len(self._points)
        seen = set()
        for off in range(n):
            point, rid = self._points[(start + off) % n]
            if rid in seen:
                continue
            seen.add(rid)
            if allowed is None or rid in allowed:
                return rid
        return None
