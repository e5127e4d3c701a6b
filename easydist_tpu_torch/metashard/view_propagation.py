"""Analytic sharding rule for reshape/view ops — no execution needed.

Aligns input and output shapes by scanning both left-to-right, accumulating
products until they agree; a dim that maps through the reshape intact (or is
the leftmost of a merged/split run) is shardable, and the output recombines by
concat on the aligned output dim.  Reference: metashard/view_propagation.py:33-129.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

from .annotation import DimSharding, ShardSpace
from .combination import Recombine


def _skip_ones(shape, idx):
    while idx < len(shape) and shape[idx] == 1:
        idx += 1
    return idx


def view_rule(input_shape: List[int], output_shape: List[int], world_size: int = 1):
    """Sharding space + recombinations for reshape(input_shape -> output_shape).

    Returns {"space": ShardSpace (one row), "recombines": {group: fn}}.
    A dim is only made shardable when its size is at least `world_size`.
    """
    input_shape = list(input_shape)
    output_shape = list(output_shape)
    if -1 in output_shape:
        known = -math.prod(output_shape)
        output_shape[output_shape.index(-1)] = math.prod(input_shape) // known

    row = [DimSharding() for _ in input_shape]
    recombines: Dict[int, object] = {}
    group = 1

    i = _skip_ones(input_shape, 0)
    o = _skip_ones(output_shape, 0)

    def emit(in_dim: int, out_dim: int):
        nonlocal group
        if input_shape[in_dim] >= world_size \
                and input_shape[in_dim] % world_size == 0:
            row[in_dim] = DimSharding(group=group)
            recombines[group] = functools.partial(Recombine.concat, dim=out_dim)
            group += 1

    while i < len(input_shape) and o < len(output_shape):
        isz, osz = input_shape[i], output_shape[o]
        if isz == osz:
            # [.., A, ..] -> [.., A, ..]
            emit(i, o)
            i = _skip_ones(input_shape, i + 1)
            o = _skip_ones(output_shape, o + 1)
        elif isz > osz:
            # [.., A, ..] -> [.., a1, a2, ..] : shard A iff a1 (leftmost) big
            # enough; the shard boundary then falls between a1 slices
            acc, o_end = osz, o
            while acc < isz and o_end + 1 < len(output_shape):
                o_end += 1
                acc *= output_shape[o_end]
            if acc != isz:
                raise RuntimeError(
                    f"view_rule cannot align {input_shape} -> {output_shape}")
            # sharding input dim A = a1*a2*... maps to sharding a1 (leftmost of
            # the split run), so a1 itself must divide evenly across devices
            if output_shape[o] >= world_size and output_shape[o] % world_size == 0:
                emit(i, o)
            i = _skip_ones(input_shape, i + 1)
            o = _skip_ones(output_shape, o_end + 1)
        else:
            # [.., a1, a2, ..] -> [.., A, ..] : shard a1 (leftmost of run)
            acc, i_end = isz, i
            while acc < osz and i_end + 1 < len(input_shape):
                i_end += 1
                acc *= input_shape[i_end]
            if acc != osz:
                raise RuntimeError(
                    f"view_rule cannot align {input_shape} -> {output_shape}")
            emit(i, o)
            i = _skip_ones(input_shape, i_end + 1)
            o = _skip_ones(output_shape, o + 1)

    return {"space": ShardSpace([row]), "recombines": recombines}


def view_rule_for_space(input_shape: List[int], output_shape: List[int],
                        preset_row) -> Optional[object]:
    """Given a *preset* input sharding (first sharded dim of `preset_row`),
    find the matching output concat dim analytically
    (reference view_propagation.py:107-129)."""
    lead = 1
    for idx, d in enumerate(preset_row):
        if d.group != 0:
            break
        lead *= input_shape[idx]
    else:
        return None

    out_acc, out_idx = 1, 0
    while out_acc < lead and out_idx < len(output_shape):
        out_acc *= output_shape[out_idx]
        out_idx += 1
    if out_acc != lead:
        return None

    block = preset_row[idx].block
    acc_block = 1
    for o_idx in range(out_idx, len(output_shape) + 1):
        if block == acc_block:
            return functools.partial(Recombine.concat, dim=o_idx)
        if o_idx < len(output_shape):
            acc_block *= output_shape[o_idx]
    return None
