"""Graph-level memory planning from liveness + solved strategies.

Reference counterparts: schedule/lifetime_info.py (ASAP/ALAP lifetimes),
schedule/efficient_memory_scheduler.py (skyline addresses), and the
runtime ownership checker (compile_auto.py:269-351).  Sizes honor the solved
per-axis placements: a tensor sharded on an axis of size n costs 1/n of its
bytes per device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from easydist_tpu_torch import native
from easydist_tpu_torch.metashard.metair import (_DTYPE_BYTES, MetaGraph,
                                           NodeStrategy)


@dataclass
class MemoryPlan:
    var_names: List[str]
    starts: np.ndarray
    ends: np.ndarray
    sizes: np.ndarray  # per-device bytes under the solved placements
    offsets: np.ndarray
    peak_bytes: int  # skyline peak (achievable packing)
    peak_live_bytes: int  # sum-of-live lower bound

    def validate(self) -> List:
        return native.check_plan(self.starts, self.ends, self.sizes,
                                 self.offsets)


def _sharded_bytes(var, placements, axis_sizes) -> int:
    """Per-device bytes under the given per-axis placements, in exact
    integer bytes: shard dims divide in ELEMENTS, rounded UP per shard (a
    non-divisible dim leaves ceil(d/n) elements on the widest device — the
    one whose peak matters), so skyline offsets stay element-aligned and
    never drift through fractional float accumulation."""
    shape = list(var.shape)
    for p, n in zip(placements, axis_sizes):
        if p is not None and p.is_shard() and n > 0 and p.dim < len(shape):
            shape[p.dim] = -(-shape[p.dim] // n)  # ceil division
    elems = 1
    for d in shape:
        elems *= int(d)
    return elems * _DTYPE_BYTES.get(var.dtype, 4)


def plan_graph_memory(graph: MetaGraph,
                      per_axis: Sequence[Dict[str, NodeStrategy]],
                      axis_sizes: Sequence[int]) -> MemoryPlan:
    """Compute buffer lifetimes over the op schedule and a skyline packing.

    `per_axis` is the solver output per mesh axis (may be empty dicts);
    tensor sizes are divided by each axis that shards them.
    """
    # lifetime: producer op index -> last consumer op index
    op_index = {node.name: i for i, node in enumerate(graph.ops)}
    intervals = []  # (var, start, end)
    out_names = {v.name for v in graph.outputs}
    n_ops = len(graph.ops)

    def var_placements(var):
        node = var.producer
        if node is None:
            return [None] * len(axis_sizes)
        out = []
        for chosen in per_axis:
            s = chosen.get(node.name)
            if s is None or var.producer_idx >= len(s.out_placements):
                out.append(None)
            else:
                out.append(s.out_placements[var.producer_idx])
        return out

    seen = set()
    for i, node in enumerate(graph.ops):
        for var in node.outvars:
            if var is None or var.name in seen:
                continue
            seen.add(var.name)
            last = i
            for consumer, _ in var.consumers:
                last = max(last, op_index.get(consumer.name, i))
            if var.name in out_names:
                last = n_ops - 1
            intervals.append((var, i, last))
    # graph inputs live from step 0 until their last consumer (pinned to
    # the end when they escape directly as graph outputs)
    for node in graph.inputs:
        for var in node.outvars:
            if var is None or var.name in seen:
                continue
            seen.add(var.name)
            last = 0
            for consumer, _ in var.consumers:
                last = max(last, op_index.get(consumer.name, 0))
            if var.name in out_names:
                last = n_ops - 1
            intervals.append((var, 0, last))

    names = [v.name for v, _, _ in intervals]
    starts = np.array([s for _, s, _ in intervals], dtype=np.int64)
    ends = np.array([e for _, _, e in intervals], dtype=np.int64)
    sizes = np.array([max(_sharded_bytes(v, var_placements(v), axis_sizes),
                          1)
                      for v, _, _ in intervals], dtype=np.int64)

    offsets, peak = native.skyline_plan(starts, ends, sizes)
    lower = native.peak_live(starts, ends, sizes)
    return MemoryPlan(names, starts, ends, sizes, offsets, peak, lower)
