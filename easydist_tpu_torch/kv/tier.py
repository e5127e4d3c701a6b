"""Host memory tier for cold prefix-trie KV pages (port of
easydist_tpu/kv/tier.py).

Device memory caps the prefix trie's working set: every committed page
the trie holds is an arena page a live sequence cannot use, so under
memory pressure the trie evicts — and the next prompt sharing that prefix
pays full prefill again.  This module adds the layer below the card's
memory: cold unpinned trie pages DEMOTE to host memory through a chunked
device-to-host copy (no transfer stages more than `chunk_bytes` at a
time), and PROMOTE back into a freshly allocated arena page on the next
trie hit, before the slot's first decode step.

Integrity contract:

  * every demoted page carries a sha256 **manifest** over its fetched
    bytes (per leaf: name, dtype, shape, raw buffer).  The digest is
    computed from the first clean fetch while the device page still
    exists, so a corrupt host copy detected at verification time can
    simply be **refetched** (drilled by the `kv.tier.fetch_corrupt` fault
    point);
  * promotion re-verifies the manifest before any byte re-enters the
    arena — a mismatch drops the entry and surfaces as a trie miss, never
    as silently corrupt KV;
  * demotion and promotion move EXACT bytes (int8 pages ship payload AND
    scales; a bfloat16 page keeps its 16-bit patterns), so a tier round
    trip is bitwise.

Host copies are CPU tensors in the page's own dtype (numpy has no
bfloat16).  `page_digest` takes numpy arrays or tensors and names each
leaf's dtype as numpy does ("float32", "int8"; "bfloat16" for bf16), so
for float32 and int8 pages it equals the JAX package's digest.

Degradation: a failed host allocation (`kv.tier.host_oom` fault point)
pauses demotion hold-and-warn style — serving continues with plain trie
eviction, losing capacity, never correctness.  The host store itself is
LRU-evicted under `byte_budget`.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from easydist_tpu_torch.resilience import faultinject

logger = logging.getLogger(__name__)

__all__ = ["HostTier", "TierError", "page_digest"]

class TierError(RuntimeError):
    """A tier entry failed its manifest check (callers treat as a miss)."""


def _leaf_bytes(a) -> bytes:
    """Raw buffer of a numpy array or a CPU tensor, in memory order."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return str(np.asarray(a).dtype)


def page_digest(arrays: Dict[str, object]) -> str:
    """sha256 over a page's host leaves in sorted-key order (name, dtype,
    shape, raw bytes per leaf) — the per-page manifest.  Quantized pages
    include their scale leaves, so a scale/payload desync cannot
    verify."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = arrays[name]
        h.update(name.encode())
        h.update(_dtype_name(a).encode())
        h.update(str(tuple(int(n) for n in a.shape)).encode())
        h.update(_leaf_bytes(a))
    return h.hexdigest()


class _Entry:
    __slots__ = ("arrays", "digest", "nbytes", "tick")

    def __init__(self, arrays, digest, nbytes, tick):
        self.arrays = arrays
        self.digest = digest
        self.nbytes = nbytes
        self.tick = tick


class HostTier:
    """LRU host store of demoted KV pages under `byte_budget` bytes.

    `put` copies each leaf to the host in chunks of `chunk_bytes`,
    manifests the result, and verifies the host copy against the manifest
    while the source page still exists — a corrupt copy refetches once
    (`kv.tier.fetch_corrupt` drill) before giving up.  `get` re-verifies
    the manifest and raises `TierError` on mismatch (the entry is dropped;
    the caller recomputes).  All methods are thread-safe for the
    session's single-writer use."""

    def __init__(self, byte_budget: int, chunk_bytes: Optional[int] = None):
        if byte_budget < 0:
            raise ValueError(f"byte_budget must be >= 0, got {byte_budget}")
        self.byte_budget = byte_budget
        self.chunk_bytes = chunk_bytes
        self.paused = False
        self._lock = threading.Lock()
        self._entries: Dict[object, _Entry] = {}
        self._tick = 0
        self.bytes_used = 0
        self.demotions = 0
        self.promotions = 0
        self.fetch_retries = 0
        self.manifest_failures = 0
        self.host_evictions = 0

    # ------------------------------------------------------------- demote
    def _copy_to_host(self, x, label: str) -> torch.Tensor:
        """One leaf as a CPU tensor of its own dtype and shape: a tensor
        through `reshard.fetch_chunked` (no read stages more than
        `chunk_bytes`; RESHARD001 names the node `kv.tier[<label>]`, as
        the JAX package's tier does), a numpy leaf copied as it is."""
        if not isinstance(x, torch.Tensor):
            return torch.from_numpy(np.array(x, copy=True))
        from easydist_tpu_torch.reshard import fetch_chunked

        return fetch_chunked(x.detach().contiguous(),
                             chunk_bytes=self.chunk_bytes,
                             node=f"kv.tier[{label}]")

    def _fetch_leaf(self, x, label: str) -> torch.Tensor:
        """One leaf device -> host with the corrupt-fetch drill: the
        manifest digest comes from the transfer, the verification
        re-check catches an injected post-transfer corruption, and the
        refetch succeeds because the device page is still live at
        demotion time."""
        for attempt in (1, 2):
            host = self._copy_to_host(x, label)
            digest = hashlib.sha256(_leaf_bytes(host)).hexdigest()
            if faultinject.fire("kv.tier.fetch_corrupt"):
                # simulated in-flight corruption of the host copy (bad
                # DMA / bit rot between transfer and store)
                host = host.clone()
                flat = host.reshape(-1).view(torch.uint8)
                flat[0] ^= 0xFF
            check = hashlib.sha256(_leaf_bytes(host)).hexdigest()
            if check == digest:
                return host
            self.fetch_retries += 1
            logger.warning("[kv.tier] corrupt fetch of %s caught by "
                           "manifest (attempt %d); refetching", label,
                           attempt)
        raise TierError(f"leaf {label} failed manifest verification "
                        f"twice during demotion")

    def put(self, key, arrays: Dict[str, object]) -> bool:
        """Demote one page (dict of tensors or numpy arrays) under `key`.
        Returns False without storing when the tier is paused, the budget
        is 0, the page exceeds the whole budget, or a host allocation
        fails (which also pauses the tier hold-and-warn style)."""
        if self.paused or self.byte_budget == 0:
            return False
        try:
            if faultinject.fire("kv.tier.host_oom"):
                raise MemoryError("injected host allocation failure")
            host = {name: self._fetch_leaf(arrays[name], f"{key}:{name}")
                    for name in sorted(arrays)}
        except MemoryError as e:
            self.paused = True
            logger.warning("[kv.tier] host allocation failed (%s); "
                           "demotion PAUSED — serving continues with "
                           "plain trie eviction", e)
            return False
        nbytes = sum(t.numel() * t.element_size() for t in host.values())
        if nbytes > self.byte_budget:
            return False
        with self._lock:
            self._evict_to(self.byte_budget - nbytes)
            if self.bytes_used + nbytes > self.byte_budget:
                return False
            self._tick += 1
            self._entries[key] = _Entry(host, page_digest(host), nbytes,
                                        self._tick)
            self.bytes_used += nbytes
            self.demotions += 1
        return True

    def _evict_to(self, budget: int) -> None:
        while self.bytes_used > budget and self._entries:
            victim = min(self._entries, key=lambda k: self._entries[k].tick)
            self.bytes_used -= self._entries.pop(victim).nbytes
            self.host_evictions += 1

    # ------------------------------------------------------------ promote
    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key) -> Dict[str, torch.Tensor]:
        """Promote-read one page: manifest-verify and return the host
        tensors (the entry stays until `drop`).  Raises `KeyError` for an
        unknown key and `TierError` (after dropping the entry) when the
        stored bytes no longer match the manifest."""
        with self._lock:
            entry = self._entries[key]
            self._tick += 1
            entry.tick = self._tick
        if page_digest(entry.arrays) != entry.digest:
            with self._lock:
                if key in self._entries:
                    self.bytes_used -= self._entries.pop(key).nbytes
                self.manifest_failures += 1
            raise TierError(f"tier entry {key!r} failed manifest "
                            f"verification at promotion")
        self.promotions += 1
        return entry.arrays

    def drop(self, key) -> None:
        """Forget one entry (after promotion moved it back to the device,
        or when its trie node is evicted outright)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self.bytes_used -= entry.nbytes

    def resume(self) -> None:
        """Lift a `host_oom` pause (operator action after freeing RAM)."""
        self.paused = False

    # ---------------------------------------------------------- reporting
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes_used": self.bytes_used,
                    "byte_budget": self.byte_budget,
                    "demotions": self.demotions,
                    "promotions": self.promotions,
                    "fetch_retries": self.fetch_retries,
                    "manifest_failures": self.manifest_failures,
                    "host_evictions": self.host_evictions,
                    "paused": self.paused}

    def check_invariants(self) -> List[str]:
        """Byte-accounting + manifest audit."""
        problems: List[str] = []
        with self._lock:
            entries = dict(self._entries)
            counted = self.bytes_used
        seen = 0
        for key, entry in entries.items():
            seen += entry.nbytes
            if page_digest(entry.arrays) != entry.digest:
                problems.append(
                    f"tier entry {key!r}: stored bytes disagree with the "
                    f"sha256 manifest (host corruption — promotion would "
                    f"serve wrong KV)")
        if seen != counted:
            problems.append(
                f"tier byte accounting drift: counter {counted} != sum "
                f"of entries {seen}")
        return problems
