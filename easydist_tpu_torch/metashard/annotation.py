"""Sharding-space annotations for ShardCombine discovery.

A `ShardSpace` assigns every dimension of every tensor argument of an op a
`DimSharding`.  Dimensions that carry the same nonzero `group` id must be
sharded *together* (e.g. the contraction dims of a matmul); group 0 means the
dimension cannot be sharded.  A `DimSharding` can additionally carry

- `halo`: each shard is padded with `halo.width` rows of its neighbours along
  `halo.dim` (needed by convolution/pooling windows), and
- `block`: a block-cyclic factor — the dim is first split into `block` blocks
  and each shard takes the matching slice of every block.

Reference semantics: easydist/metashard/annotation.py:22-131 (ShardDim /
ShardAnnotation) and halo.py:20-55.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional

from easydist_tpu_torch import platform


@dataclass
class HaloSpec:
    width: int
    dim: int

    def __repr__(self) -> str:
        return f"halo({self.width}@{self.dim})"


@dataclass
class DimSharding:
    """Sharding assignment of one tensor dimension inside a ShardSpace."""

    group: int = 0  # 0 = not shardable; dims sharing a group shard together
    block: int = 1  # block-cyclic factor
    halo: Optional[HaloSpec] = None

    def shardable(self) -> bool:
        return self.group > 0

    def __repr__(self) -> str:
        if self.group == 0:
            return "-"
        parts = [str(self.group)]
        if self.block > 1:
            parts.append(f"block={self.block}")
        if self.halo is not None:
            parts.append(repr(self.halo))
        return f"S({', '.join(parts)})"


class ShardSpace:
    """Per-tensor-per-dim `DimSharding` table describing an op's shard space.

    Example spaces discovered by the engine:
      matmul [m,k]x[k,n]:  [[S(1), S(2)], [S(2), S(3)]]
      relu   [a,b]:        [[S(1), S(2)]]
      layernorm [a,b,h]:   [[S(1), S(2), -]]
    """

    def __init__(self, table: List[List[DimSharding]]):
        self.table = table

    @staticmethod
    def for_tensors(tensors) -> "ShardSpace":
        return ShardSpace([[DimSharding() for _ in t.shape] for t in tensors])

    @staticmethod
    def for_args(flat_args) -> "ShardSpace":
        tensors = [a for a in flat_args if isinstance(a, platform.Tensor)]
        return ShardSpace.for_tensors(tensors)

    def max_group(self) -> int:
        return max((d.group for row in self.table for d in row), default=0)

    def truncate(self, max_group: int) -> "ShardSpace":
        """Copy with every group id above `max_group` reset to unshardable."""
        out = copy.deepcopy(self)
        for row in out.table:
            for i, d in enumerate(row):
                if d.group > max_group:
                    row[i] = DimSharding()
        return out

    def attach_halo(self, halo: Optional[HaloSpec], group: int) -> None:
        if halo is None:
            return
        for row in self.table:
            for d in row:
                if d.group == group:
                    d.halo = halo

    def group_dim(self, tensor_idx: int, group: int) -> Optional[int]:
        """First dim of tensor `tensor_idx` assigned to `group`, or None."""
        for dim_idx, d in enumerate(self.table[tensor_idx]):
            if d.group == group:
                return dim_idx
        return None

    def compatible_with_args(self, flat_args) -> bool:
        """True if this space's ranks line up with the tensor args (used to
        validate a cached/prompt space against new shapes)."""
        tensors = [a for a in flat_args if isinstance(a, platform.Tensor)]
        if len(tensors) != len(self.table):
            return False
        return all(t.ndim == len(row) for t, row in zip(tensors, self.table))

    def __len__(self) -> int:
        return len(self.table)

    def __getitem__(self, idx: int) -> List[DimSharding]:
        return self.table[idx]

    def __add__(self, other: "ShardSpace") -> "ShardSpace":
        return ShardSpace(self.table + other.table)

    def __repr__(self) -> str:
        return f"ShardSpace({self.table!r})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, ShardSpace) or len(self.table) != len(other.table):
            return False
        for r1, r2 in zip(self.table, other.table):
            if len(r1) != len(r2):
                return False
            for d1, d2 in zip(r1, r2):
                if (d1.group, d1.block) != (d2.group, d2.block):
                    return False
        return True


def halo_pad(shards, halo: Optional[HaloSpec]):
    """Pad each shard with `halo.width` elements from its neighbours along
    `halo.dim` (reference halo.py:33-55).  Interior shards get both sides."""
    if halo is None or len(shards) < 2:
        return shards
    w, dim = halo.width, halo.dim
    padded = []
    for i, shard in enumerate(shards):
        pieces = [shard]
        if i > 0:
            prev = shards[i - 1]
            size = prev.shape[dim]
            if size < w:
                raise RuntimeError("halo width exceeds neighbour shard size")
            pieces.insert(0, platform.narrow(prev, dim, size - w, w))
        if i < len(shards) - 1:
            pieces.append(platform.narrow(shards[i + 1], dim, 0, w))
        padded.append(platform.concatenate(pieces, dim=dim))
    return padded
