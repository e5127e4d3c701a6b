"""Prefix-reuse KV cache: a reference-counted token trie over committed
KV chunks (port of easydist_tpu/serve/prefix_cache.py).

Each node is one aligned chunk — the K/V a finished prefill produced for
positions [depth*C, (depth+1)*C) — keyed by the chunk's token ids, so a
prompt sharing a prefix restores the longest cached run of whole chunks
and resumes prefill at `prefix_len` instead of 0.  Chunk alignment from
position 0 is what makes reuse sound: a chunk's K/V depends only on the
tokens at and before it.  Admission pins the nodes a slot uses,
retirement unpins them, and commits evict unpinned leaves LRU-first to
stay under the byte budget.

The paged layout's trie commits page REFERENCES ({"page": id}) at the
arena page's byte cost (`commit(..., nbytes=)`); `on_evict` hands an
evicted node's page back to the pool, and `evict_lru` evicts on demand
when admission needs arena room.  The host tier picks its demotion
victim with `lru_node`, swaps a node's value in place with `reaccount`
and evicts a specific node with `evict_node`; drain migration and
prefix transport use `peek`, `export_path`, `hot_paths` and
`import_path`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "chunk_key"]


def chunk_key(tokens: Sequence[int]) -> Tuple[int, ...]:
    """Hashable identity of one chunk: the token-id tuple itself."""
    return tuple(int(t) for t in tokens)


class _Node:
    """One committed chunk: `kv` is {"k", "v"} of shape
    [layers, heads, chunk, head_dim] (tensors the trie owns; bucketed
    layout) or {"page": id} (an arena page; paged layout)."""

    __slots__ = ("key", "parent", "children", "kv", "nbytes", "refcount",
                 "last_used", "depth")

    def __init__(self, key, parent, kv, nbytes, depth, tick):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.kv = kv
        self.nbytes = nbytes
        self.refcount = 0
        self.last_used = tick
        self.depth = depth


class PrefixCache:
    """Token-trie index over committed KV chunks of `chunk` tokens each,
    LRU-evicted under `byte_budget` (0 disables committing entirely)."""

    def __init__(self, chunk: int, byte_budget: int, on_evict=None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if byte_budget < 0:
            raise ValueError(f"byte_budget must be >= 0, got {byte_budget}")
        self.chunk = chunk
        self.byte_budget = byte_budget
        # called with each evicted node AFTER unlinking — the paged
        # session releases the node's arena page here, so trie eviction
        # is what returns shared pages to the pool
        self.on_evict = on_evict
        self._root = _Node(key=None, parent=None, kv=None, nbytes=0,
                           depth=-1, tick=0)
        self._tick = 0
        self.bytes_used = 0
        self.n_nodes = 0
        self.hits = 0            # chunks served from the trie
        self.misses = 0          # lookups that stopped short of max_chunks
        self.evictions = 0

    # -------------------------------------------------------------- lookup
    def match(self, prompt: Sequence[int],
              max_tokens: Optional[int] = None) -> Tuple[int, List[_Node]]:
        """Longest cached whole-chunk prefix of `prompt`, capped at
        `max_tokens` (callers cap below len(prompt) so at least one real
        token always runs through prefill to produce logits).  Returns
        (prefix_len, nodes) with prefix_len == len(nodes) * chunk; bumps
        LRU ticks on every matched node."""
        limit = len(prompt) if max_tokens is None else min(
            len(prompt), max_tokens)
        max_chunks = limit // self.chunk
        node = self._root
        nodes: List[_Node] = []
        self._tick += 1
        for j in range(max_chunks):
            key = chunk_key(prompt[j * self.chunk:(j + 1) * self.chunk])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            nodes.append(child)
            node = child
        self.hits += len(nodes)
        if len(nodes) < max_chunks:
            self.misses += max_chunks - len(nodes)
        return len(nodes) * self.chunk, nodes

    def peek(self, prompt: Sequence[int],
             max_tokens: Optional[int] = None) -> int:
        """Length (tokens) of the longest cached whole-chunk prefix of
        `prompt` WITHOUT touching LRU ticks or hit/miss counters — the
        fleet router probes every replica's trie per request, and a probe
        that mutated recency would let routing decisions evict pages the
        chosen replica is about to restore."""
        limit = len(prompt) if max_tokens is None else min(
            len(prompt), max_tokens)
        node = self._root
        matched = 0
        for j in range(limit // self.chunk):
            child = node.children.get(
                chunk_key(prompt[j * self.chunk:(j + 1) * self.chunk]))
            if child is None:
                break
            matched += 1
            node = child
        return matched * self.chunk

    def lookup_node(self, nodes: List[_Node],
                    chunk_tokens: Sequence[int]) -> Optional[_Node]:
        """Child of the path `nodes` (empty = root) for `chunk_tokens`,
        or None — lets the scheduler skip device extraction for chunks
        that are already committed."""
        parent = nodes[-1] if nodes else self._root
        return parent.children.get(chunk_key(chunk_tokens))

    # -------------------------------------------------------------- commit
    def commit(self, nodes: List[_Node], chunk_tokens: Sequence[int],
               kv, nbytes: Optional[int] = None) -> Optional[_Node]:
        """Commit one chunk's KV under the path `nodes` (the contiguous
        prefix path from the root).  Returns the (existing or new) node,
        or None when the budget is 0, the chunk is partial, or everything
        evictable is pinned.  Evicts LRU unpinned leaves to make room; a
        chunk larger than the whole budget is not committed.  `nbytes`
        overrides the size computed from `kv`'s tensors — the paged
        session commits page references, whose cost is the arena page's
        bytes."""
        if self.byte_budget == 0 or len(chunk_tokens) != self.chunk:
            return None
        parent = nodes[-1] if nodes else self._root
        key = chunk_key(chunk_tokens)
        existing = parent.children.get(key)
        if existing is not None:
            existing.last_used = self._tick
            return existing
        if nbytes is None:
            nbytes = sum(t.numel() * t.element_size() for t in kv.values())
        if nbytes > self.byte_budget:
            return None
        # the path being extended must survive this commit's eviction:
        # its tail is an unpinned leaf until the caller pins the full path
        self.pin(nodes)
        try:
            self._evict_to(self.byte_budget - nbytes)
        finally:
            self.unpin(nodes)
        if self.bytes_used + nbytes > self.byte_budget:
            return None  # everything evictable is pinned
        node = _Node(key=key, parent=parent, kv=kv, nbytes=nbytes,
                     depth=parent.depth + 1, tick=self._tick)
        parent.children[key] = node
        self.bytes_used += nbytes
        self.n_nodes += 1
        return node

    def _evict_to(self, budget: int) -> None:
        while self.bytes_used > budget:
            victim = None
            for node in self._walk():
                if node.children or node.refcount > 0:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                return
            del victim.parent.children[victim.key]
            self.bytes_used -= victim.nbytes
            self.n_nodes -= 1
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(victim)

    def evict_lru(self) -> bool:
        """Evict the least-recently-used unpinned leaf on demand — the
        paged session calls this when admission needs arena room, to hand
        trie-held pages back to the pool (via `on_evict`).  Returns True
        when something was evicted."""
        before = self.n_nodes
        self._evict_to(self.bytes_used - 1)
        return self.n_nodes < before

    def evict_node(self, node: _Node) -> bool:
        """Evict one SPECIFIC unpinned childless node.  `evict_lru`'s
        byte-driven walk cannot express "only victims holding a device
        page", which the host tier's eviction fallback needs (evicting a
        demoted node frees no arena page), so the tier picks its victim
        via `lru_node` and unlinks it here."""
        if node.children or node.refcount > 0:
            return False
        del node.parent.children[node.key]
        self.bytes_used -= node.nbytes
        self.n_nodes -= 1
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(node)
        return True

    def _walk(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    # ----------------------------------------------------------- refcounts
    # ------------------------------------------------------- export/import
    def export_path(self, prompt: Sequence[int],
                    max_tokens: Optional[int] = None) -> List[Tuple[
                        Tuple[int, ...], Dict[str, object]]]:
        """Hand the longest cached whole-chunk prefix of `prompt` out as
        [(chunk_tokens, kv)] pairs for transfer to another trie (drain
        page migration, disaggregated-prefill handoff).  Does not evict or
        unpin anything — the pages stay committed here; the caller decides
        the source trie's fate."""
        limit = len(prompt) if max_tokens is None else min(
            len(prompt), max_tokens)
        node = self._root
        out: List[Tuple[Tuple[int, ...], Dict[str, object]]] = []
        for j in range(limit // self.chunk):
            key = chunk_key(prompt[j * self.chunk:(j + 1) * self.chunk])
            child = node.children.get(key)
            if child is None:
                break
            out.append((key, child.kv))
            node = child
        return out

    def hot_paths(self, min_refcount: int = 0) -> List[List[Tuple[
            Tuple[int, ...], Dict[str, object]]]]:
        """Root-to-leaf chunk paths worth migrating on drain: every path
        ending at a leaf whose refcount > `min_refcount`, plus (with the
        default 0) all leaves — ordered hottest-first by the leaf's LRU
        tick so a byte-budget-limited importer keeps the most recent."""
        paths = []
        for node in self._walk():
            if node.children or node.refcount < min_refcount:
                continue
            path = []
            cur = node
            while cur is not self._root:
                path.append((cur.key, cur.kv))
                cur = cur.parent
            paths.append((node.last_used, list(reversed(path))))
        paths.sort(key=lambda t: -t[0])
        return [p for _, p in paths]

    def import_path(self, path: Sequence[Tuple[Tuple[int, ...],
                                               Dict[str, object]]]) -> int:
        """Commit a chunk path exported from another trie, root-first.
        First-commit-wins exactly like `commit` (an existing node keeps
        its kv — both sides computed bitwise-identical pages, so either
        copy serves).  Returns the number of chunks now present along the
        path (existing + newly committed); stops early when the byte
        budget refuses a chunk (children without their parent would be
        unreachable)."""
        nodes: List[_Node] = []
        for key, kv in path:
            node = self.commit(nodes, key, kv)
            if node is None:
                break
            nodes.append(node)
        return len(nodes)

    # ----------------------------------------------------------- refcounts
    def pin(self, nodes: Sequence[_Node]) -> None:
        """Hold `nodes` against eviction for a slot's lifetime."""
        for node in nodes:
            node.refcount += 1

    def unpin(self, nodes: Sequence[_Node]) -> None:
        for node in nodes:
            node.refcount -= 1

    # ----------------------------------------------------------- reporting
    # ---------------------------------------------------------- tier hooks
    def lru_node(self, predicate=None) -> Optional[_Node]:
        """Least-recently-used unpinned node matching `predicate`,
        INTERIOR nodes included — the host tier's demotion victim
        selector.  Unlike eviction (which must unlink childless nodes to
        keep the trie connected), demotion swaps a node's kv in place and
        leaves it in the trie, so any unpinned node still holding a
        device page is fair game even when its descendants do too."""
        victim = None
        for node in self._walk():
            if node.refcount > 0:
                continue
            if predicate is not None and not predicate(node):
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        return victim

    def reaccount(self, node: _Node, nbytes: int, kv=None) -> None:
        """Atomically swap a node's kv value and re-charge its byte cost
        (demotion: `{"page": id}` -> `{"host": key}` at 0 bytes;
        promotion: back to the arena page's bytes).  Keeping `node.nbytes`
        and `self.bytes_used` in one motion is what keeps
        `check_invariants`' byte audit sound across tier moves."""
        self.bytes_used += nbytes - node.nbytes
        node.nbytes = nbytes
        if kv is not None:
            node.kv = kv

    # ----------------------------------------------------------- reporting
    def stats(self) -> Dict[str, int]:
        total = self.hits + self.misses
        return {"nodes": self.n_nodes, "bytes_used": self.bytes_used,
                "byte_budget": self.byte_budget, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0}

    def check_invariants(self) -> List[str]:
        """Refcount/byte-accounting audit: byte counter vs actual node sum,
        non-negative refcounts, parent/child link consistency, node
        count."""
        problems: List[str] = []
        seen_bytes = 0
        seen_nodes = 0
        for node in self._walk():
            seen_nodes += 1
            seen_bytes += node.nbytes
            if node.refcount < 0:
                problems.append(
                    f"node depth={node.depth} has negative refcount "
                    f"{node.refcount} (unbalanced pin/unpin)")
            if node.parent.children.get(node.key) is not node:
                problems.append(
                    f"node depth={node.depth} not linked from its parent "
                    f"(trie structure corrupted)")
        if seen_bytes != self.bytes_used:
            problems.append(
                f"byte accounting drift: counter {self.bytes_used} != "
                f"sum of node bytes {seen_bytes}")
        if seen_nodes != self.n_nodes:
            problems.append(
                f"node count drift: counter {self.n_nodes} != walked "
                f"{seen_nodes}")
        return problems
