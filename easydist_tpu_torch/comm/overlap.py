"""K-microbatch gradient accumulation: the port of
`accumulate_gradients` in easydist_tpu/comm/overlap.py, sequential
variant (the double-buffered overlapped flush comes with ROADMAP queue A
item 7, and `config.comm_overlap` raises in `comm.reduce`)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch.models.optim import value_and_grad


def _split_microbatches(batch, n_micro: int):
    split = []
    for x in batch:
        if x.shape[0] % n_micro:
            raise ValueError(
                f"grad_accum_microbatches={n_micro} does not divide the "
                f"local batch dimension {x.shape[0]}")
        split.append(x.reshape(n_micro, x.shape[0] // n_micro,
                               *x.shape[1:]))
    return tuple(split)


def accumulate_gradients(loss_fn: Callable, params, batch: Sequence,
                         *, group, axis_size: int, n_micro: int,
                         reduce_tree: Optional[Callable] = None,
                         op: str = "pmean"):
    """Split each batch tensor's leading dim into `n_micro` slices, take
    each slice's gradients, reduce them with `reduce_tree` (default: one
    all_reduce per leaf over `group`) and accumulate, in the JAX
    package's fold order: acc = 0 + reduce(g_0), then acc + reduce(g_k)
    for k = 1..K-1, then acc / K.  ZeRO callers pass their own
    `reduce_tree` (reduce_scatter shrinks the leaves).

    Returns ``(mean_grads, mean_loss)``, both averaged over the K
    microbatches after reduction."""
    if n_micro < 1:
        raise ValueError(f"n_micro={n_micro}; expected >= 1")
    if reduce_tree is None:
        from .reduce import reduce_gradients

        def reduce_tree(g):  # noqa: F811 - the default binding
            return reduce_gradients(g, group, axis_size, op=op)

    mbs = _split_microbatches(batch, n_micro)
    loss0, g0 = value_and_grad(loss_fn, params, *(x[0] for x in mbs))
    if n_micro == 1:
        return reduce_tree(g0), loss0
    red0 = reduce_tree(g0)
    acc = pytree.tree_map(lambda r: torch.zeros_like(r) + r, red0)
    loss_acc = loss0
    for k in range(1, n_micro):
        loss_k, g_k = value_and_grad(loss_fn, params, *(x[k] for x in mbs))
        acc = pytree.tree_map(torch.add, acc, reduce_tree(g_k))
        loss_acc = loss_acc + loss_k
    grads = pytree.tree_map(lambda a: a / n_micro, acc)
    return grads, loss_acc / n_micro
