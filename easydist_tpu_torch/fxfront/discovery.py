"""Pruned ShardCombine discovery: the port of
easydist_tpu/jaxfront/discovery.py over aten nodes.

Most op signatures of a step are role-equivalent: the discovered rule
depends on each dimension's role (which dims are equal, which are size 1,
which divide the shard count), not on its absolute size.  This module
gives the interpreter

  canonical_signature  a dim-role-normalized node key; nodes that agree
                       on it form one propagation group, discovered once;
  DiscoveryCache       a persistent canonical-signature -> rule store
                       (atomic tempfile + os.replace writes, one pickle per
                       salt), so warm runs skip the probes;
  DiscoveryCounters    the per-trace accounting the summary line prints.

A transferred rule is dim-indexed and the solver re-checks divisibility
against each member's shapes, so role-equivalence only has to guarantee
identical discovery outcomes.  Rules with absolute-size artifacts (halo
widths, block-cyclic blocks) transfer only between identical shapes.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import re
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import torch

from easydist_tpu_torch import config as edconfig

logger = logging.getLogger(__name__)

# bump to invalidate every persisted rule (schema or semantics change)
CACHE_VERSION = "fx-disc-v1"

# memory addresses in repr() would make signatures process-unique
_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


class DiscoveryCounters:
    """Per-trace discovery accounting."""

    _INT_FIELDS = ("probes_compiled", "rules_preset", "rules_from_group",
                   "rules_from_cache", "rules_discovered", "groups",
                   "crosscheck_checked", "crosscheck_failures")

    def __init__(self):
        for f in self._INT_FIELDS:
            setattr(self, f, 0)
        self.discovery_seconds = 0.0

    def snapshot(self) -> Dict[str, float]:
        out = {f: getattr(self, f) for f in self._INT_FIELDS}
        out["discovery_seconds"] = self.discovery_seconds
        return out


def node_tensor_shapes(node) -> List[Tuple[int, ...]]:
    """Shapes of the inputs that occupy discovery rows, in row order."""
    from .interpreter import node_tensor_inputs

    return [tuple(n.meta["val"].shape) for n in node_tensor_inputs(node)]


def canonical_signature(node, world_size: int) -> str:
    """Dim-role-normalized cache key: two nodes with the same canonical
    signature drive execution discovery to the same rule.

    Per dimension: size 1 and small sizes (at or below 2 x nshards, where
    divisibility decides by absolute size) stay literal; larger sizes map
    to (size-equality class, divisible by nshards, divisible by
    world_size).  Non-tensor arguments stay verbatim, except that an exact
    restatement of an input or output shape is tokenized the same way, so
    role-equivalent views still share a group."""
    from .interpreter import _is_tensor_node, hash_tensor_bytes, node_leaves

    nshards = edconfig.discovery_nshards
    small_cutoff = max(8, 2 * nshards)
    size_classes: Dict[int, int] = {}

    def tok(size: int) -> str:
        if size <= small_cutoff:
            return str(size)
        cls = size_classes.setdefault(size, len(size_classes))
        return (f"D{cls}.{int(size % nshards == 0)}"
                f"{int(size % world_size == 0)}")

    shape_toks: Dict[str, str] = {}

    def shape_part(shape) -> str:
        dims = ",".join(tok(d) for d in shape)
        if shape and any(d > small_cutoff for d in shape):
            shape_toks[repr(list(shape))] = f"[{dims}]"
        return dims

    parts, params = [], []
    for a in node_leaves(node):
        if _is_tensor_node(a):
            v = a.meta["val"]
            parts.append(f"{str(v.dtype).removeprefix('torch.')}"
                         f"[{shape_part(v.shape)}]")
        elif isinstance(a, torch.Tensor):
            parts.append(f"lit:{list(a.shape)}:{hash_tensor_bytes(a)}")
        else:
            params.append(repr(a))
    for v in torch.utils._pytree.tree_leaves(node.meta.get("val")):
        if isinstance(v, torch.Tensor):
            parts.append(f"->{str(v.dtype).removeprefix('torch.')}"
                         f"[{shape_part(v.shape)}]")
    params_s = _ADDR_RE.sub("", ";".join(params))
    for exact, tokd in sorted(shape_toks.items(), key=lambda kv: -len(kv[0])):
        params_s = params_s.replace(exact, tokd)
    raw = f"{';'.join(parts)}|{params_s}"
    digest = hashlib.sha256(raw.encode()).hexdigest()[:24]
    return f"{node.target}|w{world_size}|{digest}"


def _space_has_size_artifacts(space) -> bool:
    return any(d.halo is not None or d.block > 1
               for row in space.table for d in row)


def rule_transferable(rule: dict, rep_shapes: List[Tuple[int, ...]],
                      node) -> bool:
    """Cheap soundness gate before a representative's rule serves a group
    member: row count and ranks line up, and the space is free of
    absolute-size artifacts unless the shapes are identical."""
    member = node_tensor_shapes(node)
    space = rule.get("space")
    if space is None:
        return member == rep_shapes
    if len(member) != len(rep_shapes) or len(space.table) != len(member):
        return False
    if any(len(m) != len(r) for m, r in zip(member, rep_shapes)):
        return False
    if any(len(row) != len(m) for row, m in zip(space.table, member)):
        return False
    if _space_has_size_artifacts(space) and member != rep_shapes:
        return False
    return True


def cache_salt() -> str:
    """Digest of what a persisted rule depends on: the discovery knobs,
    torch's version and the discovery device type (rules found on the CPU
    and on the card do not mix)."""
    knobs = ("discovery_nshards", "extend_space", "allclose_rtol",
             "allclose_atol", "discovery_max_candidates",
             "discovery_hint_numel", "discovery_batch_probes")
    parts = [CACHE_VERSION, torch.__version__,
             torch.device(edconfig.discovery_device).type]
    parts += [f"{k}={getattr(edconfig, k)}" for k in knobs]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


class DiscoveryCache:
    """Persistent canonical-signature -> rule store: one pickle dict per
    salt, loaded lazily, written atomically after merging with whatever a
    concurrent process persisted meanwhile.  Entries: {"rule", "shapes"
    (the row shapes it was discovered on), "target"}."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._mem: Optional[Dict[str, dict]] = None
        self._dirty = False

    def _read_disk(self) -> Dict[str, dict]:
        if os.path.exists(self.path):
            try:
                with open(self.path, "rb") as f:
                    loaded = pickle.load(f)
                if isinstance(loaded, dict):
                    return loaded
            except Exception:
                logger.warning("discovery cache read failed for %s",
                               self.path)
        return {}

    def _load(self) -> None:
        if self._mem is None:
            self._mem = self._read_disk()

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            self._load()
            return self._mem.get(key)

    def put(self, key: str, entry: dict) -> None:
        with self._lock:
            self._load()
            self._mem[key] = entry
            self._dirty = True

    def __len__(self) -> int:
        with self._lock:
            self._load()
            return len(self._mem)

    def flush(self) -> None:
        with self._lock:
            if not self._dirty or self._mem is None:
                return
            merged = self._read_disk()
            merged.update(self._mem)
            tmp = None
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(self.path),
                    prefix=os.path.basename(self.path) + ".", suffix=".tmp")
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(merged, f)
                os.replace(tmp, self.path)
                tmp = None
                self._mem = merged
                self._dirty = False
            except Exception:
                logger.warning("discovery cache write failed for %s",
                               self.path)
                if tmp is not None:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass


_caches: Dict[str, DiscoveryCache] = {}
_caches_lock = threading.Lock()


def get_cache() -> Optional[DiscoveryCache]:
    """The DiscoveryCache for the current salt and directory (each path
    gets its own instance), or None when persistence is off."""
    if not edconfig.discovery_persistent_cache:
        return None
    base = edconfig.discovery_cache_dir or os.path.join(
        edconfig.compile_cache_dir, "discovery")
    path = os.path.join(base, f"rules_{cache_salt()}.pkl")
    with _caches_lock:
        cache = _caches.get(path)
        if cache is None:
            cache = _caches[path] = DiscoveryCache(path)
        return cache


def clear_cache_instances() -> None:
    """Drop the in-process instances so the next get_cache() re-reads its
    file (a true warm start)."""
    with _caches_lock:
        _caches.clear()
