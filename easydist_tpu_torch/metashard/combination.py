"""Recombination library: how sharded outputs re-form the global output.

`Recombine.*` are the recombination functions; `match_*` are checkers that
numerically compare a candidate recombination of the sharded outputs against
the global output and return the matching `functools.partial` on success.
The recombination kind directly names the SPMD placement of the output:

    identity      -> REPLICATE  (no collective)
    reduce(op)    -> PARTIAL    (all_reduce on the mesh axis)
    concat(dim)   -> SHARD(dim) (all_gather to reconstruct)

Reference semantics: easydist/metashard/combination.py:76-310.
"""

from __future__ import annotations

import functools
from enum import Enum
from typing import List, Optional

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch import platform


class Reduction(Enum):
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    AVG = "avg"


class HaloHint:
    """Raised (as a return value) when the outputs look gatherable after halo
    padding of the *inputs* — signals the discovery loop to retry with halo."""

    def __init__(self, width: int, dim: int, out_idx: Optional[int] = None):
        self.width = width
        self.dim = dim
        self.out_idx = out_idx


class Recombine:

    @staticmethod
    def identity(parts):
        first = parts[0]
        for p in parts[1:]:
            if not platform.equal(first, p):
                return None
        return first

    @staticmethod
    def reduce(parts, op: Reduction = Reduction.SUM):
        if op in (Reduction.SUM, Reduction.AVG):
            acc = platform.zeros_like(parts[0])
            for p in parts:
                acc = platform.add(acc, p)
            if op is Reduction.AVG:
                acc = acc * (1.0 / len(parts))
            return acc
        fold = platform.maximum if op is Reduction.MAX else platform.minimum
        acc = parts[0]
        for p in parts[1:]:
            acc = fold(acc, p)
        return acc

    @staticmethod
    def concat(parts, dim: int, halo: int = 0, block: int = 1):
        """Concatenate along `dim`.

        halo > 0: adjacent shards share `halo` overlapping elements that must
        be summed (conv-style partial windows).
        halo < 0: each shard contributes `|halo|` too-few elements; drop the
        overlap symmetrically (gather of valid-conv outputs).
        block > 1: inverse of block-cyclic sharding — interleave the blocks.
        """
        if halo == 0:
            if block == 1:
                return platform.concatenate(parts, dim=dim)
            sub = [platform.chunk(p, block, dim) for p in parts]
            ordered = [sub[p][b] for b in range(block) for p in range(len(parts))]
            return platform.concatenate(ordered, dim=dim)

        acc = parts[0]
        for nxt in parts[1:]:
            a, b = acc.shape[dim], nxt.shape[dim]
            if halo > 0:
                overlap = platform.add(
                    platform.narrow(acc, dim, a - halo, halo),
                    platform.narrow(nxt, dim, 0, halo))
                acc = platform.concatenate(
                    [platform.narrow(acc, dim, 0, a - halo), overlap,
                     platform.narrow(nxt, dim, halo, b - halo)], dim=dim)
            else:
                acc = platform.concatenate(
                    [platform.narrow(acc, dim, 0, a + halo),
                     platform.narrow(nxt, dim, -halo, b + halo)], dim=dim)
        return acc


def _common_prefix_len(t1, t2, dim: int) -> int:
    """Length of the longest matching prefix of t1/t2 along `dim`
    (reference combination.py:48-58, vectorized to O(n))."""
    import numpy as np

    a, b = platform.to_numpy(t1), platform.to_numpy(t2)
    n = min(a.shape[dim], b.shape[dim])
    idx = np.arange(n)
    a, b = np.take(a, idx, axis=dim), np.take(b, idx, axis=dim)
    close = np.isclose(a, b, rtol=edconfig.allclose_rtol,
                       atol=edconfig.allclose_atol)
    other_axes = tuple(i for i in range(close.ndim) if i != dim)
    per_index = close.all(axis=other_axes) if other_axes else close
    if per_index.all():
        return n
    return int(np.argmax(~per_index))


def match_identity(parts, target):
    for p in parts:
        if p.shape != target.shape:
            return None
    got = Recombine.identity(parts)
    if got is not None and platform.allclose(got, target):
        return functools.partial(Recombine.identity)
    return None


def match_reduce(parts, target):
    for p in parts:
        if p.shape != target.shape:
            return None
    for op in (Reduction.SUM, Reduction.MAX, Reduction.MIN, Reduction.AVG):
        fn = functools.partial(Recombine.reduce, op=op)
        if platform.allclose(fn(parts), target):
            return fn
    return None


def match_concat(parts, target):
    """Try concat along the single differing dim; with `extend_space` also try
    block-cyclic interleave and halo overlap, and emit HaloHint when the
    mismatch pattern suggests the *inputs* need halo padding
    (reference combination.py:178-265)."""
    if len(target.shape) == 0:
        return None
    nparts = len(parts)
    pshape = parts[0].shape

    # exactly one dim may differ from the target, same dim on every part
    cat_dim = next((i for i in range(len(pshape)) if pshape[i] != target.shape[i]),
                   len(pshape) - 1)
    for p in parts:
        diff = [i for i in range(len(target.shape)) if p.shape[i] != target.shape[i]]
        if diff not in ([cat_dim], []):
            return None
        if diff == [] and p.shape[cat_dim] == target.shape[cat_dim] and nparts > 1:
            # parts same size as target on every dim: concat can't shrink them
            if pshape[cat_dim] * nparts != target.shape[cat_dim]:
                return None

    total = sum(p.shape[cat_dim] for p in parts)
    gap = total - target.shape[cat_dim]

    if gap == 0:
        fn = functools.partial(Recombine.concat, dim=cat_dim)
        if platform.allclose(fn(parts), target):
            return fn
        if edconfig.extend_space:
            # maybe the shards are block-cyclic: find how much of part 0
            # matches a plain first chunk of the target
            ref = platform.chunk(target, nparts, cat_dim)[0]
            prefix = _common_prefix_len(parts[0], ref, cat_dim)
            if prefix > 0 and pshape[cat_dim] % prefix == 0:
                block = pshape[cat_dim] // prefix
                fn = functools.partial(Recombine.concat, dim=cat_dim, block=block)
                if platform.allclose(fn(parts), target):
                    return fn
            # mostly-matching prefix: input halo padding may fix the tail
            if prefix > pshape[cat_dim] // 2:
                return HaloHint(pshape[cat_dim] - prefix, cat_dim)
        return None

    if not edconfig.extend_space:
        return None

    # parts overlap: neighbouring shards share `halo` summed elements
    if gap > 0 and nparts > 1 and gap % (nparts - 1) == 0:
        halo = gap // (nparts - 1)
        if halo < total // nparts:
            fn = functools.partial(Recombine.concat, dim=cat_dim, halo=halo)
            got = fn(parts)
            if got.shape == target.shape and platform.allclose(got, target):
                return fn

    # parts overhang: drop |halo| elements from BOTH sides of each of the
    # nparts-1 seams, so gap = 2*|halo|*(nparts-1)
    if gap > 0 and nparts > 1 and gap % (2 * (nparts - 1)) == 0:
        halo = -(gap // (2 * (nparts - 1)))
        if -halo < total // (2 * nparts):
            fn = functools.partial(Recombine.concat, dim=cat_dim, halo=halo)
            got = fn(parts)
            if got.shape == target.shape and platform.allclose(got, target):
                return fn

    # parts too small (valid convolution): ask for input halo padding; the
    # hinted width is positive (|gap| split over seams, half per side)
    if gap < 0 and nparts > 1 and gap % (nparts - 1) == 0:
        width = (-gap // (nparts - 1)) // 2
        if width < total // nparts:
            return HaloHint(max(width, 1), cat_dim)
    return None


def _aux_equal(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:
        try:
            import numpy as np

            return bool(np.array_equal(np.asarray(a), np.asarray(b)))
        except Exception:
            return False


_MATCHERS = (match_identity, match_reduce, match_concat)


def _match_single(parts, target):
    for p in parts:
        if len(p.shape) != len(target.shape):
            return None
    for matcher in _MATCHERS:
        fn = matcher(parts, target)
        if fn is not None:
            return fn  # may be a HaloHint
    return None


def match_recombine(sharded_outputs, global_output):
    """Match recombination for a (possibly multi-output) op execution.

    `sharded_outputs` is a list over shards; each element mirrors the structure
    of `global_output` (a tensor, or tuple/list of tensors and aux values).
    Returns a recombine fn, a list of them (multi-output), a HaloHint, or None.
    Reference: combination.py:283-310.
    """
    if isinstance(global_output, platform.Tensor):
        return _match_single(sharded_outputs, global_output)

    if isinstance(global_output, (tuple, list)):
        lens = [len(s) for s in sharded_outputs]
        if not lens or min(lens) != max(lens) or lens[0] != len(global_output):
            return None
        fns = []
        for i, glob in enumerate(global_output):
            if isinstance(glob, platform.Tensor):
                fn = _match_single([s[i] for s in sharded_outputs], glob)
                if fn is None:
                    return None
                if isinstance(fn, HaloHint):
                    fn.out_idx = i
                    return fn
                fns.append(fn)
            else:
                # non-tensor outputs must agree across shards; comparison must
                # never raise (array-likes that aren't the backend Tensor)
                for s in sharded_outputs:
                    if not _aux_equal(glob, s[i]):
                        return None
        return fns if fns else None
    return None
