"""Benchmark timing: the port of easydist_tpu/utils/timer.py (reference:
easydist/utils/timer.py:24-56).

One timing discipline for every host-clock measurement: completion is
forced before the clock stops (`host_sync`: a device synchronize where
the output lives on a card, else one scalar read back to the host), and
every measurement is two-point — time(n2 calls) - time(n1 calls) over
(n2 - n1) — which cancels the fixed dispatch and read-back overhead.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree


def host_sync(out) -> None:
    """Wait until `out`'s producers have run: synchronize the card its
    last tensor lives on, or read one scalar of it back (CPU tensors)."""
    leaves = [x for x in pytree.tree_leaves(out)
              if isinstance(x, torch.Tensor)]
    if not leaves:
        return
    last = leaves[-1]
    if last.device.type == "cuda":
        torch.cuda.synchronize(last.device)
    else:
        float(last.detach().float().sum())


def two_point_time(fn: Callable, args=(), n1: int = 3, n2: int = 12,
                   retries: int = 2) -> float:
    """Seconds per call of `fn(*args)`, free of the fixed dispatch and
    synchronisation overhead.  Retries an inverted sample (t2 <= t1)
    rather than report an impossible rate; degenerate timing falls back
    to the bounded t2/n2."""
    def run(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        host_sync(out)
        return time.perf_counter() - t0

    run(2)  # warm (allocator, first launches)
    t1 = t2 = 0.0
    for _ in range(retries):
        t1, t2 = run(n1), run(n2)
        if t2 > t1:
            return (t2 - t1) / (n2 - n1)
    return max(t2, 1e-9) / n2


class EDTimer:
    """Seconds per call of a zero-argument function (`time()`), timed
    two-point over `trials` calls."""

    def __init__(self, func: Callable, trials: int = 12,
                 warmup_trials: int = 3):
        self.func = func
        self.trials = trials
        self.warmup_trials = warmup_trials

    def time(self) -> float:
        """Seconds per call (two-point; see the module docstring)."""
        return two_point_time(self.func, n1=max(2, self.trials // 4),
                              n2=self.trials)
