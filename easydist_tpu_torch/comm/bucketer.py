"""Gradient bucketing: the port of easydist_tpu/comm/bucketer.py.

Fuses many small per-leaf collectives into few large ones: the leaves
are partitioned into buckets of at most `comm_bucket_bytes`, grouped by
(dtype, quantize) so packing is cast-free and the opt-out leaves never
share a quantized wire; each bucket is packed into one 1-D vector,
reduced with ONE collective, and unpacked into the leaves' shapes.
Packing is pure data movement and the reduction is elementwise, so a
bucketed f32 all_reduce is value-identical to the per-leaf ones it
replaces (at world 2; see `comm.overlap` for wider worlds).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Sequence

import torch

from easydist_tpu_torch.analyze import check_bucket_plan


@dataclass
class Bucket:
    """One fused collective: which flat-leaf indices ride it."""

    indices: List[int] = field(default_factory=list)
    nbytes: int = 0
    quantize: bool = False
    dtype: object = None


def plan_buckets(leaves: Sequence, bucket_bytes: int,
                 quantize_flags: Sequence[bool]) -> List[Bucket]:
    """Greedy fixed-size packing in leaf order, grouped by
    (dtype, quantize).  `bucket_bytes <= 0` means no fusion: every leaf
    gets its own bucket (quantization may still apply)."""
    buckets: List[Bucket] = []
    open_by_group = {}
    for i, (leaf, qz) in enumerate(zip(leaves, quantize_flags)):
        nbytes = leaf.numel() * leaf.element_size()
        group = (leaf.dtype, bool(qz))
        cur = open_by_group.get(group)
        if (bucket_bytes <= 0 or cur is None
                or (cur.nbytes + nbytes > bucket_bytes and cur.indices)):
            cur = Bucket(quantize=bool(qz), dtype=group[0])
            buckets.append(cur)
            if bucket_bytes > 0:
                open_by_group[group] = cur
        cur.indices.append(i)
        cur.nbytes += nbytes
    return buckets


def pack(leaves: Sequence, bucket: Bucket) -> torch.Tensor:
    """Concatenate the bucket's raveled leaves into one 1-D vector."""
    if len(bucket.indices) == 1:
        return leaves[bucket.indices[0]].reshape(-1)
    return torch.cat([leaves[i].reshape(-1) for i in bucket.indices])


def unpack(flat: torch.Tensor, bucket: Bucket, leaves: Sequence) -> dict:
    """Split a reduced bucket vector back into {leaf index: leaf} with the
    leaves' shapes."""
    out = {}
    offset = 0
    for i in bucket.indices:
        n = leaves[i].numel()
        out[i] = flat[offset:offset + n].reshape(leaves[i].shape)
        offset += n
    return out


def bucketed_reduce(leaves: Sequence, quantize_flags: Sequence[bool],
                    bucket_bytes: int, reduce_fn: Callable) -> List:
    """Reduce `leaves` bucket by bucket; `reduce_fn(flat_1d, bucket)`
    issues the collective.  The plan is linted first (COLL003,
    `analyze.check_bucket_plan`).  Returns the reduced leaves in flat
    order."""
    buckets = plan_buckets(leaves, bucket_bytes, quantize_flags)
    # COLL003: a plan whose slices do not tile the flat buffer silently
    # corrupts gradients at unpack; O(leaves) on the host
    check_bucket_plan(leaves, buckets)
    reduced: List = [None] * len(leaves)
    for b in buckets:
        out = reduce_fn(pack(leaves, b), b)
        for i, leaf in unpack(out, b, leaves).items():
            reduced[i] = leaf
    return reduced
