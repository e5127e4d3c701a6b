"""Manual data-parallel and ZeRO modes: the port of
easydist_tpu/parallel/dp.py (reference easydist/torch/compile_dp.py).

The explicit `parallel_mode="ddp" / "zero2" / "zero3"` steps.  The JAX
package builds each as one SPMD program (`shard_map` over the dp axis);
here each rank runs its own step, a plain function of its local state
and the global batch, with functional collectives on the axis's process
group (`comm.reduce`), so a rank's step runs eagerly or traces with
`make_fx` into a graph whose collective nodes can be counted.

  ddp    batch sharded, params replicated, gradients all_reduce'd (mean)
  zero2  + Adam moments sharded over dp: reduce_scatter the gradients,
         update the local block, all_gather the updated params
  zero3  params AND moments live as dim-0 blocks: the forward
         all_gathers each param as it reads it, the backward gathers
         again what it reads (no gathered copy lives from one to the
         other), each gradient is reduce_scattered when complete and the
         local block updated

A leaf whose dim 0 does not divide the axis stays replicated, with its
gradient all_reduce'd (mean).  Every rank passes the same global batch;
a step takes its rank's dim-0 block.  Per-rank state holds what the JAX
package's shard_map hands each device: zero2's moments of a sharded leaf
are [1, d0/n, ...], zero3's params and moments [d0/n, ...].

`grad_accum_microbatches=K` (or `config.grad_accum_microbatches`)
accumulates K microbatches in the JAX fold order (`comm.overlap`).

Every gradient reduction goes through `easydist_tpu_torch.comm`: with the
default config one exact collective per leaf; with `comm_quant_dtype` /
`comm_bucket_bytes` set, block-quantized and / or bucketed (ddp buckets
the tree; the ZeRO paths quantize per leaf, by the leaf's keystr path).
`comm_overlap` issues the reductions from the backward in emission order
(ddp's buckets and zero2's leaves from tensor hooks; zero3 already
reduce_scatters each gradient in the backward as soon as it is
complete).

`step_guard=True` (or `config.resilience_step_guard`) folds the NaN/Inf
skip-and-hold guard (`resilience.guard`) into the step: the state
becomes `(state, guard_state)` (seed the second with
`resilience.init_guard_state()`), the finite flag is the minimum over
the axis's ranks, and a non-finite step holds the previous state.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import comm
from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.models.optim import value_and_grad

from ._axes import local_block, mesh_axis


def _accum_k(grad_accum_microbatches: Optional[int]) -> int:
    """Effective microbatch count: the kwarg wins, else the config knob;
    0 and 1 both mean no accumulation."""
    k = (edconfig.grad_accum_microbatches if grad_accum_microbatches is None
         else grad_accum_microbatches)
    return int(k) if k else 0


def _maybe_guard(step: Callable, step_guard: Optional[bool], ax):
    """The step with the skip-and-hold guard folded in when asked; off
    returns `step` itself."""
    on = (edconfig.resilience_step_guard if step_guard is None
          else bool(step_guard))
    if not on:
        return step
    from easydist_tpu_torch.resilience.guard import guard_train_step

    return guard_train_step(step, group=ax.group)


class _Orders:
    """Emission orders of the gradients, traced once per signature of the
    parameters and the batch (`comm.grad_emission_order`)."""

    def __init__(self, loss_fn):
        self.loss_fn, self.cache = loss_fn, {}

    def __call__(self, params, *batch):
        leaves, spec = pytree.tree_flatten((params, batch))
        key = (spec, tuple((tuple(x.shape), x.dtype) if isinstance(
            x, torch.Tensor) else x for x in leaves))
        if key not in self.cache:
            self.cache[key] = comm.grad_emission_order(self.loss_fn, params,
                                                       *batch)
        return self.cache[key]


def _local_batch(batch, ax):
    return tuple(local_block(x, 0, ax.size, ax.index) for x in batch)


def _shardable(p, n: int) -> bool:
    return p.ndim > 0 and p.shape[0] % n == 0


def _grads(loss_fn, params, batch, k: int, ax, reduce_tree,
           overlapped: bool = False):
    """(reduced grads, local mean loss) over the rank's batch block."""
    if k > 1:
        return comm.accumulate_gradients(
            loss_fn, params, batch, group=ax.group, axis_size=ax.size,
            n_micro=k, reduce_tree=reduce_tree, overlapped=overlapped)
    loss, grads = value_and_grad(loss_fn, params, *batch)
    return reduce_tree(grads), loss


def _pmean(x, ax):
    return comm.all_reduce_sum(x, ax.group) / ax.size


def ddp_step(loss_fn: Callable, mesh, axis: str = "dp", lr: float = 1e-2,
             grad_accum_microbatches: Optional[int] = None,
             step_guard: Optional[bool] = None):
    """SGD DDP step: batch sharded over `axis`, gradients averaged.
    Returns step(params, *batch) -> (new_params, loss), the loss averaged
    over the axis; with the guard on, step((params, guard_state), *batch)
    -> ((params, guard_state), loss)."""
    ax = mesh_axis(mesh, axis)
    orders = _Orders(loss_fn)

    def step(params, *batch):
        k = _accum_k(grad_accum_microbatches)
        local = _local_batch(batch, ax)
        if k > 1:
            grads, loss = comm.accumulate_gradients(
                loss_fn, params, local, group=ax.group, axis_size=ax.size,
                n_micro=k)
        elif edconfig.comm_overlap:
            loss, grads = comm.overlapped_value_and_grad(
                loss_fn, params, *local, group=ax.group, axis_size=ax.size,
                emission_order=orders(params, *local))
        else:
            loss, grads = value_and_grad(loss_fn, params, *local)
            grads = comm.reduce_gradients(grads, ax.group, ax.size,
                                          op="pmean")
        new_params = pytree.tree_map(lambda p, g: p - lr * g, params, grads)
        return new_params, _pmean(loss, ax)

    return _maybe_guard(step, step_guard, ax)


def dp_state_layout(params, mode: str, mesh, axis: str = "dp"):
    """The layout of a `mode` ("ddp" | "zero2" | "zero3") state of the
    full `params` over `mesh` (a DeviceMesh, a `reshard.MeshDesc`, or a
    world size: one "dp" axis over every rank), as `reshard` and
    `runtime.checkpoint` read it: the state's tree with a `(MeshDesc,
    spec)` tuple at every leaf, or `(MeshDesc, spec, whole_shape)`.

    Dim 0 is sharded over `axis` exactly where `_shardable` shards it
    (the whole shape is the parameter's: zero2 keeps a moment block as
    [1, d0/n, ...], a view of the window [d0/n, ...]); everything else,
    the step count included, is replicated.  The JAX package reads this
    from its arrays' shardings; the port's per-rank states are plain
    tensors, so the layout is stated.  The tree matches ddp's params,
    zero2's (params, {"mu", "nu"}, count) and zero3's (blocks, {"mu",
    "nu"}, count)."""
    from easydist_tpu_torch.reshard.plan import MeshDesc

    if isinstance(mesh, int):
        desc = MeshDesc((axis,), (mesh,))
    elif isinstance(mesh, MeshDesc):
        desc = mesh
    else:
        desc = MeshDesc.from_mesh(mesh)
    n = desc.axis_size(axis)
    rep = (desc, ())

    def block(p):
        return (desc, (axis,), tuple(p.shape)) if _shardable(p, n) else rep

    if mode == "ddp":
        return pytree.tree_map(lambda p: rep, params)
    if mode not in ("zero2", "zero3"):
        raise ValueError(f"mode must be ddp|zero2|zero3, got {mode!r}")
    moments = pytree.tree_map(block, params)
    first = moments if mode == "zero3" else pytree.tree_map(lambda p: rep,
                                                            params)
    return (first, {"mu": moments, "nu": moments}, rep)


def zero_shard_params(params, mesh, axis: str = "dp"):
    """This rank's ZeRO-3 placement of `params`: the dim-0 block of every
    leaf whose dim 0 divides the axis, the whole leaf otherwise."""
    ax = mesh_axis(mesh, axis)
    return pytree.tree_map(
        lambda p: local_block(p, 0, ax.size, ax.index).clone()
        if _shardable(p, ax.size) else p.clone(), params)


def _adam(p, g, m, v, c1, c2, lr, b1, b2, eps):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    return p - lr * (m / c1) / (torch.sqrt(v / c2) + eps), m, v


def _bias_corrections(count, b1: float, b2: float):
    fcount = count.to(torch.float32)
    return 1 - b1 ** fcount, 1 - b2 ** fcount


class _Gathered(torch.autograd.Function):
    """A ZeRO-3 leaf's full value: all_gather of the rank's dim-0 block
    forward, the gradient reduce_scatter'd (mean) back to the block in
    the backward, as soon as the leaf's gradient is complete."""

    @staticmethod
    def forward(ctx, block, group, n, path):
        ctx.group, ctx.n, ctx.path = group, n, path
        return comm.all_gather_dim0(block, group, n)

    @staticmethod
    def backward(ctx, g):
        return (comm.reduce_scatter_grad(g, ctx.group, ctx.n, path=ctx.path),
                None, None, None)


class _Replicated(torch.autograd.Function):
    """A replicated leaf: identity forward, gradient all_reduce'd (mean)."""

    @staticmethod
    def forward(ctx, p, group, n, path):
        ctx.group, ctx.n, ctx.path = group, n, path
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        return (comm.all_reduce_grad(g, ctx.group, ctx.n, path=ctx.path),
                None, None, None)


class _Regather:
    """Saved-tensor hooks that keep no gathered parameter alive between
    the forward and the backward: a tensor the forward saves that is (a
    view of) a gathered leaf is packed as the leaf's index and its
    layout, and the backward gathers the leaf again when it first reads
    it (FSDP's and DeepSpeed stage 3's schedule)."""

    def __init__(self, blocks, group, n: int):
        self.blocks, self.group, self.n = blocks, group, n
        self.full: dict = {}     # leaf index -> its gathered value
        self.again: dict = {}    # leaf index -> gathered for the backward

    def pack(self, t):
        for i, full in self.full.items():
            if t is full or t._base is full:
                return (i, tuple(t.shape), t.stride(), t.storage_offset())
        return t

    def unpack(self, packed):
        if not isinstance(packed, tuple):
            return packed
        i, shape, stride, offset = packed
        full = self.again.get(i)
        if full is None:
            full = self.again[i] = comm.all_gather_dim0(
                self.blocks[i].detach(), self.group, self.n)
        return full.as_strided(shape, stride, offset)


def zero3_step(loss_fn: Callable, mesh, axis: str = "dp", lr: float = 1e-2,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               grad_accum_microbatches: Optional[int] = None,
               step_guard: Optional[bool] = None):
    """Adam ZeRO-3: parameters and moments sharded over `axis`.

    Each leaf whose dim 0 divides the axis lives as the rank's dim-0
    block; the step all_gathers it when the forward reads it, holds no
    gathered copy into the backward (the backward gathers again what it
    reads, `_Regather`), reduce_scatters its gradient as soon as it is
    complete, and updates the block.  Other leaves stay replicated with
    their gradients all_reduce'd (mean).  (The JAX package's one program
    gathers once and leaves freeing to XLA; eagerly, every gathered
    parameter would stay alive from the forward to the backward, and the
    peak would stand above ZeRO-2's.)

    The reductions run in the backward, each as soon as its gradient is
    complete, so `comm_overlap` changes nothing here.

    Returns (step, init_state): init_state(params) -> (param blocks,
    {"mu", "nu"} blocks, count); step(state, *batch) -> (state, loss).
    Which leaves are sharded is decided from the full shapes init_state
    sees (a block's shape no longer tells)."""
    ax = mesh_axis(mesh, axis)
    n = ax.size
    layouts = {}  # params treespec -> per-leaf sharded flags

    def init_state(params):
        leaves, spec = pytree.tree_flatten(params)
        layouts[spec] = tuple(_shardable(p, n) for p in leaves)
        sharded = zero_shard_params(params, mesh, axis)
        opt = {"mu": pytree.tree_map(torch.zeros_like, sharded),
               "nu": pytree.tree_map(torch.zeros_like, sharded)}
        return (sharded, opt, torch.zeros((), dtype=torch.int32,
                                          device=leaves[0].device))

    def step(state, *batch):
        blocks, opt, count = state
        flat_p, spec = pytree.tree_flatten(blocks)
        flags = layouts.get(spec)
        if flags is None:
            raise RuntimeError("zero3_step: build the state with its "
                               "init_state(params) first")
        paths = comm.keyed_leaves(blocks)[1]

        def sharded_loss(leaves, *mb):
            hooks = _Regather(leaves, ax.group, n)
            full = []
            for i, (p, flag) in enumerate(zip(leaves, flags)):
                if flag:
                    full.append(_Gathered.apply(p, ax.group, n, paths[i]))
                    hooks.full[i] = full[-1]
                else:
                    full.append(_Replicated.apply(p, ax.group, n, paths[i]))
            try:
                with torch.autograd.graph.saved_tensors_hooks(hooks.pack,
                                                              hooks.unpack):
                    return loss_fn(pytree.tree_unflatten(full, spec), *mb)
            finally:
                # the gathered values die with the forward: the backward
                # holds their indices only
                del full
                hooks.full.clear()

        # the gradients come out of the backward already reduced
        grads, loss = _grads(sharded_loss, flat_p, _local_batch(batch, ax),
                             _accum_k(grad_accum_microbatches), ax,
                             lambda g: g, overlapped=False)
        count = count + 1
        c1, c2 = _bias_corrections(count, b1, b2)
        new = [_adam(p, g, m, v, c1, c2, lr, b1, b2, eps)
               for p, g, m, v in zip(flat_p, grads,
                                     pytree.tree_leaves(opt["mu"]),
                                     pytree.tree_leaves(opt["nu"]))]
        new_p, new_m, new_v = (pytree.tree_unflatten([t[i] for t in new],
                                                     spec)
                               for i in range(3))
        return (new_p, {"mu": new_m, "nu": new_v}, count), _pmean(loss, ax)

    return _maybe_guard(step, step_guard, ax), init_state


def zero2_step(loss_fn: Callable, mesh, axis: str = "dp", lr: float = 1e-2,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               grad_accum_microbatches: Optional[int] = None,
               step_guard: Optional[bool] = None):
    """Adam ZeRO-2: params replicated, moments sharded over `axis`:
    reduce_scatter(grads) -> the local block's Adam update ->
    all_gather(params).

    Returns (step, init_opt): init_opt(params) -> {"mu", "nu"};
    step((params, opt, count), *batch) -> ((params, opt, count), loss)."""
    ax = mesh_axis(mesh, axis)
    n = ax.size
    orders = _Orders(loss_fn)

    def init_opt(params):
        def moment(p):
            if _shardable(p, n):
                return torch.zeros((1, p.shape[0] // n) + tuple(p.shape[1:]),
                                   dtype=p.dtype, device=p.device)
            return torch.zeros_like(p)

        return {"mu": pytree.tree_map(moment, params),
                "nu": pytree.tree_map(moment, params)}

    def step(state, *batch):
        params, opt, count = state
        flat_p, spec = pytree.tree_flatten(params)
        flags = [_shardable(p, n) for p in flat_p]
        paths = comm.keyed_leaves(params)[1]
        local = _local_batch(batch, ax)
        k = _accum_k(grad_accum_microbatches)
        overlap = bool(edconfig.comm_overlap)

        def reduce_leaf(i, g):
            if flags[i]:
                return comm.reduce_scatter_grad(g, ax.group, n,
                                                path=paths[i])
            return comm.all_reduce_grad(g, ax.group, n, path=paths[i])

        def reduce_tree(gtree):
            fg = pytree.tree_leaves(gtree)
            if overlap:
                fg = comm.chain_leaf_reduces(fg, orders(params, *local),
                                             reduce_leaf)
            else:
                fg = [reduce_leaf(i, g) for i, g in enumerate(fg)]
            return pytree.tree_unflatten(fg, spec)

        if overlap and k <= 1:
            loss, fg = comm.overlapped_leaf_grads(
                loss_fn, params, *local, reduce_leaf_fn=reduce_leaf)
            grads = pytree.tree_unflatten(fg, spec)
        else:
            grads, loss = _grads(loss_fn, params, local, k, ax, reduce_tree,
                                 overlapped=overlap)
        count = count + 1
        c1, c2 = _bias_corrections(count, b1, b2)
        new = []
        for p, g, m, v, flag in zip(flat_p, pytree.tree_leaves(grads),
                                    pytree.tree_leaves(opt["mu"]),
                                    pytree.tree_leaves(opt["nu"]), flags):
            if flag:
                p_blk, m, v = _adam(local_block(p, 0, n, ax.index), g, m[0],
                                    v[0], c1, c2, lr, b1, b2, eps)
                new.append((comm.all_gather_dim0(p_blk, ax.group, n),
                            m[None], v[None]))
            else:
                new.append(_adam(p, g, m, v, c1, c2, lr, b1, b2, eps))
        new_p, new_m, new_v = (pytree.tree_unflatten([t[i] for t in new],
                                                     spec)
                               for i in range(3))
        return (new_p, {"mu": new_m, "nu": new_v}, count), _pmean(loss, ax)

    return _maybe_guard(step, step_guard, ax), init_opt
