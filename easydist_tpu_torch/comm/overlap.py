"""Overlapped gradient collectives and K-microbatch accumulation: the port
of easydist_tpu/comm/overlap.py.

  * `grad_emission_order` / `schedulable_overlap_fraction` read the FX
    graph of `make_fx(value_and_grad)`: a gradient's emission index is the
    position of its producing node, and the backward produces the last
    layer's gradients first.
  * `overlapped_value_and_grad` plans buckets over the gradients in
    emission order and issues each bucket's collective from a tensor hook
    as soon as the last gradient of the bucket exists, while the backward
    goes on; the exact and bf16 routes wait at first use, after the
    backward.  Under `make_fx` the collective nodes come out interleaved
    with the backward nodes.  `overlapped_reduce_gradients` is the same
    plan over gradients that already exist (issued back to back, waited
    after the last).
  * `chain_leaf_reduces` / `overlapped_leaf_grads` are the per-leaf
    chains of the ZeRO paths.
  * `accumulate_gradients(overlapped=True)` issues the reduction of
    microbatch k-1's gradients before microbatch k's backward and waits
    after it; the fold order of the accumulator is the sequential one.

`pin_chain`: JAX pins the bucket collectives into a chain with
`optimization_barrier` so XLA neither merges them nor reorders them.
Here the process group's stream already runs collectives in the order
they are issued, so `pin_chain=True` means: a bucket that is complete is
held back until every bucket before it in the plan has been issued (the
plan's order on every rank); `pin_chain=False` issues each bucket the
moment it is complete.  The hooked flush logs the order in which it
issues its units (`record_issues` collects the logs); with `pin_chain`
the analyzer's OVL002 checks that order against the plan
(`analyze.check_issue_log`).  A bad emission order raises OVL001
(`analyze.check_overlap_plan`) before the flush falls back to flat
order, and every reordered bucket plan is linted (COLL003).

Values: quantization off, the overlapped flush packs the same leaves in a
different order than the sequential one, so an element can sit in a
different chunk of the ring.  At world 2 a sum of two is one IEEE add
either way and the two flushes are bitwise equal; at 3 or more ranks
gloo and NCCL sum a chunk in an order that depends on its position, so
they are bitwise equal where both plans pack the same.
"""

from __future__ import annotations

import contextlib
import logging
import operator
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.analyze import (check_issue_log,
                                        check_overlap_plan)
from easydist_tpu_torch.models.optim import value_and_grad

from .bucketer import pack, plan_buckets, unpack
from .quant import leaf_quantizable, quant_mode

logger = logging.getLogger(__name__)

__all__ = ["grad_emission_order", "schedulable_overlap_fraction",
           "overlapped_reduce_gradients", "overlapped_value_and_grad",
           "chain_leaf_reduces", "overlapped_leaf_grads",
           "accumulate_gradients", "record_issues"]

# the open `record_issues` collections: every hooked flush appends its
# issue log to each
_ISSUE_LOGS: List[list] = []


@contextlib.contextmanager
def record_issues():
    """Collect the issue log of every hooked flush run inside the block:
    a list of {"units": n, "issued": [unit index in issue order],
    "pin_chain": bool}, one per flush (`analyze.lint_overlap_fn`)."""
    logs: list = []
    _ISSUE_LOGS.append(logs)
    try:
        yield logs
    finally:
        _ISSUE_LOGS.remove(logs)


# ----------------------------------------------------------- emission order

def _backward_graph(loss_fn: Callable, params, *batch):
    """(FX graph of value_and_grad, per-leaf emission index, node count):
    the index is the position, among the graph's call_function nodes, of
    the node producing that leaf's gradient (-1 for an input)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, spec = pytree.tree_flatten(params)

    def grads_of(*flat):
        ps = pytree.tree_unflatten(list(flat[:len(leaves)]), spec)
        _, g = value_and_grad(loss_fn, ps, *flat[len(leaves):])
        return tuple(pytree.tree_leaves(g))

    gm = make_fx(grads_of, tracing_mode="fake")(*leaves, *batch)
    index = {}
    for node in gm.graph.nodes:
        if node.op == "call_function" and node.target is not operator.getitem:
            index[node] = len(index)
        elif node.op == "call_function":  # a getitem: its source's index
            index[node] = index.get(node.args[0], -1)
    out = next(n for n in gm.graph.nodes if n.op == "output")
    keys = [index.get(a, -1) if isinstance(a, torch.fx.Node) else -1
            for a in pytree.tree_leaves(out.args[0])]
    return keys, len(index)


def grad_emission_order(loss_fn: Callable, params, *batch) -> List[int]:
    """Flat-leaf permutation (torch pytree order) of the gradients of
    `loss_fn(params, *batch)` sorted by emission order in the backward.
    Traced with fake tensors (no FLOPs spent); the identity when the
    trace fails."""
    n = len(pytree.tree_leaves(params))
    identity = list(range(n))
    try:
        keys, _ = _backward_graph(loss_fn, params, *batch)
    except Exception as exc:
        logger.warning("grad_emission_order: trace failed (%s); "
                       "falling back to flat tree order", exc)
        return identity
    if len(keys) != n:
        return identity
    return sorted(identity, key=lambda k: (keys[k], k))


def schedulable_overlap_fraction(loss_fn: Callable, params, *batch) -> float:
    """Byte-weighted share of the gradient flush that the emission-ordered
    flush launches while backward work is still outstanding: leaf i's
    gradient is emitted at node e_i of the E-node graph, so a
    (E-1-e_i)/(E-1) share of it is still to run.  A bound from the
    program's structure, no timing; 0.0 when the trace fails."""
    leaves = pytree.tree_leaves(params)
    try:
        keys, n_nodes = _backward_graph(loss_fn, params, *batch)
    except Exception as exc:
        logger.warning("schedulable_overlap_fraction: trace failed (%s)",
                       exc)
        return 0.0
    if n_nodes <= 1 or not leaves or len(keys) != len(leaves):
        return 0.0
    total = hideable = 0.0
    for leaf, key in zip(leaves, keys):
        nbytes = float(leaf.numel() * leaf.element_size())
        remaining = (n_nodes - 1 - key) / (n_nodes - 1)
        total += nbytes
        hideable += nbytes * min(max(remaining, 0.0), 1.0)
    return hideable / total if total else 0.0


def _valid_order(order, n: int) -> bool:
    try:
        return sorted(int(i) for i in order) == list(range(n))
    except (TypeError, ValueError):
        return False


def _checked_order(order, leaves, what: str) -> List[int]:
    n = len(leaves)
    if order is None:
        return list(range(n))
    if not _valid_order(order, n):
        # OVL001 raises under analyze_raise before the safe fallback, so a
        # corrupt plan cannot silently reorder
        check_overlap_plan(leaves, order)
        logger.warning("%s: order is not a permutation of %d leaves; "
                       "using flat tree order", what, n)
        return list(range(n))
    return [int(i) for i in order]


# --------------------------------------------------------- overlapped flush

def _plan(leaves, paths, order, mode):
    ordered = [leaves[i] for i in order]
    flags = [leaf_quantizable(paths[i], leaves[i].numel(), mode)
             for i in order]
    buckets = plan_buckets(ordered, edconfig.comm_bucket_bytes, flags)
    check_overlap_plan(ordered, order, buckets)
    return ordered, buckets


def overlapped_reduce_gradients(grads, group, axis_size: int,
                                op: str = "pmean",
                                emission_order: Optional[Sequence[int]] = None,
                                pin_chain: bool = True):
    """Emission-ordered bucket flush of a gradient tree that already
    exists: buckets planned over the leaves reordered by `emission_order`
    (torch flat indices; identity when None), every bucket's collective
    issued in plan order, each waited after the last was issued.
    Value-identical to the sequential `reduce_gradients` flush (see the
    module docstring for bitwise), within the quantization error with it
    on.  `pin_chain` is accepted for the JAX signature: the buckets are
    issued in plan order either way."""
    del pin_chain
    if op not in ("pmean", "psum"):
        raise ValueError(f"op={op!r}; expected pmean|psum")
    return issue_tree(grads, group, axis_size, op=op,
                      emission_order=emission_order)()


def _hooked_grads(loss_fn: Callable, params, batch, units: List[List[int]],
                  issue: Callable, pin_chain: bool):
    """value_and_grad with a tensor hook on every leaf: unit k (a list of
    flat indices) is issued with `issue(k, {i: grad})`, which returns a
    function giving {i: reduced}, as soon as its last gradient exists
    (after every earlier unit with `pin_chain`).  Returns (loss, [reduced
    leaves]), each unit waited after the backward."""
    leaves, spec = pytree.tree_flatten(params)
    unit_of = {i: k for k, u in enumerate(units) for i in u}
    got: dict = {}
    left = [len(u) for u in units]
    issued: dict = {}
    log = {"units": len(units), "issued": [], "pin_chain": bool(pin_chain)}

    def launch(k):
        log["issued"].append(k)
        issued[k] = issue(k, {i: got.pop(i) for i in units[k]})

    def ready(k):
        return left[k] == 0 and k not in issued

    def on_grad(i):
        def hook(g):
            got[i] = g
            k = unit_of[i]
            left[k] -= 1
            if pin_chain:
                nxt = len(issued)
                while nxt < len(units) and ready(nxt):
                    launch(nxt)
                    nxt += 1
            elif ready(k):
                launch(k)
            return g
        return hook

    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        handles = [t.register_hook(on_grad(i)) for i, t in enumerate(live)]
        try:
            loss = loss_fn(pytree.tree_unflatten(live, spec), *batch)
            torch.autograd.grad(loss, live)
        finally:
            for h in handles:
                h.remove()
    for k in range(len(units)):  # units no gradient reached stay unissued
        if k not in issued:
            launch(k)
    for logs in _ISSUE_LOGS:
        logs.append(log)
    if pin_chain:
        check_issue_log(log)
    out: List = [None] * len(leaves)
    for k in range(len(units)):
        for i, r in issued[k]().items():
            out[i] = r
    return loss.detach(), out


def overlapped_value_and_grad(loss_fn: Callable, params, *batch, group,
                              axis_size: int, op: str = "pmean",
                              emission_order: Optional[Sequence[int]] = None,
                              pin_chain: bool = True):
    """(loss, reduced gradient tree) with each bucket's collective issued
    from the backward, as soon as the bucket's last gradient exists.
    Buckets are planned as `overlapped_reduce_gradients` plans them (the
    emission order from `grad_emission_order` when None is given)."""
    from .reduce import issue_bucket, keyed_leaves

    if op not in ("pmean", "psum"):
        raise ValueError(f"op={op!r}; expected pmean|psum")
    mode = quant_mode()
    leaves, paths, spec, _ = keyed_leaves(params)
    if emission_order is None:
        emission_order = grad_emission_order(loss_fn, params, *batch)
    order = _checked_order(emission_order, leaves,
                           "overlapped_value_and_grad")
    _, buckets = _plan(leaves, paths, order, mode)
    units = [[order[j] for j in b.indices] for b in buckets]

    def issue(k, grads):
        b = buckets[k]
        ordered = {j: grads[order[j]] for j in b.indices}
        finish = issue_bucket(pack(ordered, b), b, group, axis_size,
                              op == "pmean", mode)
        return lambda: {order[j]: leaf for j, leaf in
                        unpack(finish(), b, ordered).items()}

    loss, out = _hooked_grads(loss_fn, params, batch, units, issue,
                              pin_chain)
    return loss, pytree.tree_unflatten(out, spec)


def chain_leaf_reduces(flat_leaves: Sequence, order: Sequence[int],
                       reduce_leaf_fn: Callable, pin_chain: bool = True):
    """Per-leaf reductions (the ZeRO paths, where each leaf takes its own
    reduce_scatter or all_reduce) issued in `order`; returns the reduced
    leaves in their original positions."""
    del pin_chain  # issued in `order` either way
    order = _checked_order(order, list(flat_leaves), "chain_leaf_reduces")
    reduced: List = [None] * len(flat_leaves)
    for i in order:
        reduced[i] = reduce_leaf_fn(i, flat_leaves[i])
    return reduced


def overlapped_leaf_grads(loss_fn: Callable, params, *batch,
                          reduce_leaf_fn: Callable,
                          pin_chain: bool = True):
    """(loss, reduced flat leaves): `reduce_leaf_fn(i, grad)` runs from
    the backward as soon as leaf i's gradient exists, in emission
    order."""
    def issue(k, grads):
        (i, g), = grads.items()
        out = reduce_leaf_fn(i, g)
        return lambda: {i: out}

    order = grad_emission_order(loss_fn, params, *batch)
    return _hooked_grads(loss_fn, params, batch, [[i] for i in order],
                         issue, pin_chain)


# ------------------------------------------ K-microbatch accumulation

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
                         overlapped: Optional[bool] = None,
                         op: str = "pmean",
                         emission_order: Optional[Sequence[int]] = None,
                         pin_chain: bool = True):
    """Split each batch tensor's leading dim into `n_micro` slices, take
    each slice's gradients, reduce them with `reduce_tree` (default: the
    sequential `reduce_gradients`, or the emission-ordered flush when
    overlapped) and accumulate in the JAX package's fold order:
    acc = 0 + reduce(g_0), then acc + reduce(g_k), then acc / K.

    `overlapped` (default `config.comm_overlap`): the reduction of
    microbatch k-1's gradients is issued before microbatch k's backward
    and waited after it (`reduce_tree` may return a zero-argument
    function that waits, as `issue_tree` does; a tree is taken as
    already reduced).  Same fold, so bitwise equal to the sequential
    variant.  Returns ``(mean_grads, mean_loss)``."""
    if n_micro < 1:
        raise ValueError(f"n_micro={n_micro}; expected >= 1")
    if overlapped is None:
        overlapped = bool(edconfig.comm_overlap)
    mbs = _split_microbatches(batch, n_micro)
    if reduce_tree is None:
        from .reduce import reduce_gradients

        order = emission_order
        if overlapped and order is None:
            order = grad_emission_order(loss_fn, params,
                                        *(x[0] for x in mbs))

        def reduce_tree(g):  # noqa: F811 - the default binding
            if overlapped:
                return issue_tree(g, group, axis_size, op=op,
                                  emission_order=order)
            return reduce_gradients(g, group, axis_size, op=op)

    def waited(r):
        return r() if callable(r) else r

    loss0, g0 = value_and_grad(loss_fn, params, *(x[0] for x in mbs))
    if n_micro == 1:
        return waited(reduce_tree(g0)), loss0
    loss_acc = loss0
    if overlapped:
        acc, inflight = None, g0
        for k in range(1, n_micro):
            pending = reduce_tree(inflight)
            loss_k, inflight = value_and_grad(loss_fn, params,
                                              *(x[k] for x in mbs))
            red = waited(pending)
            acc = (pytree.tree_map(lambda r: torch.zeros_like(r) + r, red)
                   if acc is None else pytree.tree_map(torch.add, acc, red))
            loss_acc = loss_acc + loss_k
        acc = pytree.tree_map(torch.add, acc, waited(reduce_tree(inflight)))
    else:
        red0 = waited(reduce_tree(g0))
        acc = pytree.tree_map(lambda r: torch.zeros_like(r) + r, red0)
        for k in range(1, n_micro):
            loss_k, g_k = value_and_grad(loss_fn, params,
                                         *(x[k] for x in mbs))
            acc = pytree.tree_map(torch.add, acc, waited(reduce_tree(g_k)))
            loss_acc = loss_acc + loss_k
    grads = pytree.tree_map(lambda a: a / n_micro, acc)
    return grads, loss_acc / n_micro


def issue_tree(grads, group, axis_size: int, op: str = "pmean",
               emission_order: Optional[Sequence[int]] = None):
    """The emission-ordered flush of `grads`, issued now; returns the
    zero-argument function that waits and gives the reduced tree."""
    from .reduce import issue_bucket, keyed_leaves

    mode = quant_mode()
    leaves, paths, spec, _ = keyed_leaves(grads)
    order = _checked_order(emission_order, leaves, "issue_tree")
    ordered, buckets = _plan(leaves, paths, order, mode)
    pending = [(b, issue_bucket(pack(ordered, b), b, group, axis_size,
                                op == "pmean", mode)) for b in buckets]

    def finish():
        reduced: List = [None] * len(leaves)
        for b, fin in pending:
            for j, leaf in unpack(fin(), b, ordered).items():
                reduced[order[j]] = leaf
        return pytree.tree_unflatten(reduced, spec)
    return finish
