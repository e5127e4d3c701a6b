"""Automatic pipeline splitting of a traced function: the port of
easydist_tpu/parallel/auto_pipeline.py.

  1. trace `fn(params, mb)` with `make_fx` (fake tensors, forward only)
     into an aten graph;
  2. split its nodes into n contiguous stages balanced by estimated
     FLOPs, or at the user's `split_point` markers;
  3. every value crossing a stage boundary travels to the stage that
     reads it, residuals that skip stages included (the reference's
     test_reslink.py): a stage forwards what a later stage still needs;
  4. each rank interprets its own stage's nodes eagerly under autograd,
     on the supertick schedule of `parallel.pipeline` (gpipe, remat or
     1f1b), and its backward units take `torch.autograd.grad` through
     them.

Two divergences from the JAX package, both deliberate.  Each rank runs
its own program with P2P to its neighbours instead of one SPMD program
whose stages are `lax.switch` branches.  And each boundary tensor is sent
on its own, in its own dtype (integer and bool values too), where the JAX
package packs every boundary value into one padded f32 vector because a
single `ppermute` must carry them all.

Params used by exactly one stage (float32 / bfloat16 / float16) are
packed into that stage's f32 row; the rows are flat-sharded over the
sibling (non-pp) axes, all_gathered once per step and their gradients
reduce_scattered.  Params several stages use stay replicated.

With a tensor-parallel plan (`tp_plan`, {node name: NodeStrategy} on one
sibling axis, `fxfront.pp_compile` solves it) each stage replays its
nodes placement-tracked on that axis (`_tp_convert`, the port of the JAX
package's): an input the strategy wants sharded is sliced locally, a
sharded value read whole is all_gathered on the tp group, a partial sum
a node creates is all_reduced at once, and every boundary value leaves
the stage whole.  The tp axis does not divide the batch.  Gradients
follow from autograd: the slice's gradient is the zero-padded shard, the
gather's a reduce_scatter, the all_reduce's an all_reduce, so every
lane's gradient of a weight is its contribution and the sibling
reduction (sum over every sibling lane, divided by their count) sums
the shard gradients of a weight tp splits and averages over the tp lanes
the gradient of a weight tp replicates.
"""

from __future__ import annotations

import math
import operator
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import comm
from easydist_tpu_torch.metashard.combination import Reduction

from ._axes import Axis, local_block, mesh_axis
from .pipeline import LocalStages, drive_local, drive_p2p, rank_core, \
    schedule_tables


# ---------------------------------------------------------- split markers

@torch.library.custom_op("easydist_tpu_torch::split_point", mutates_args=())
def _split_point_op(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_split_point_op.register_fake
def _(x):
    return torch.empty_like(x)


_split_point_op.register_autograd(lambda ctx, g: g)


def split_point(x):
    """Mark a pipeline split after this value: everything producing `x`
    belongs to the earlier stage.  N markers -> N+1 stages.  An identity
    whose gradient is the identity, kept as one node by `make_fx`."""
    return _split_point_op(x)


SPLIT_POINT = torch.ops.easydist_tpu_torch.split_point.default


# ------------------------------------------------------------- FLOPs

def _shape(node):
    val = node.meta.get("val")
    return tuple(val.shape) if isinstance(val, torch.Tensor) else None


def node_flops(node) -> float:
    """Stage-balance weight of one aten node: 2*m*n*k for mm / addmm /
    bmm, the products of the flash ops (forward 4*B*H*T^2*D, dQ 6x, dK/dV
    8x the B*H*T^2*D; halved when causal), the output's element count
    otherwise (the JAX package's estimate), at least 1."""
    target = node.target
    name = getattr(target, "__name__", str(target))
    if name.startswith(("mm.", "addmm.", "bmm.")):
        out = _shape(node)
        a = node.args[1] if name.startswith("addmm") else node.args[0]
        k = _shape(a)[-1]
        return max(2.0 * math.prod(out) * k, 1.0)
    for op, factor in (("flash_fwd", 4), ("flash_bwd_dq", 6),
                       ("flash_bwd_dkv", 8)):
        if name.startswith(op + "."):
            b, h, t, d = _shape(node.args[0])
            causal = bool(node.args[-2]) if len(node.args) > 4 else True
            return factor * b * h * t * t * d / (2.0 if causal else 1.0)
    vals = node.meta.get("val")
    vals = vals if isinstance(vals, (tuple, list)) else (vals,)
    return max(float(sum(v.numel() for v in vals
                         if isinstance(v, torch.Tensor))), 1.0)


def _balanced_splits(flops: Sequence[float], n: int) -> List[int]:
    """Contiguous split into n non-empty groups at cumulative-FLOP quantiles;
    returns strictly increasing end indices."""
    import numpy as np

    if n > len(flops):
        raise ValueError(f"n_stages={n} exceeds the {len(flops)} traced "
                         f"equations")
    cum = np.cumsum(np.asarray(flops, dtype=np.float64))
    total = float(cum[-1])
    ends: List[int] = []
    prev = 0
    for k in range(1, n):
        i = int(np.searchsorted(cum, total * k / n)) + 1
        i = max(i, prev + 1)  # every stage keeps >= 1 equation
        i = min(i, len(flops) - (n - k))
        ends.append(i)
        prev = i
    ends.append(len(flops))
    return ends


# ------------------------------------------------------------- the plan

def trace(fn, example_params, example_mb):
    """(GraphModule of fn(params, mb) over flat leaves, #param leaves,
    #data leaves, output treespec)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    p_leaves, p_spec = pytree.tree_flatten(example_params)
    d_leaves, d_spec = pytree.tree_flatten(example_mb)
    n_p = len(p_leaves)
    out_spec = {}

    def flat_fn(*flat):
        out = fn(pytree.tree_unflatten(list(flat[:n_p]), p_spec),
                 pytree.tree_unflatten(list(flat[n_p:]), d_spec))
        leaves, out_spec["spec"] = pytree.tree_flatten(out)
        return leaves

    with torch.no_grad():
        gm = make_fx(flat_fn, tracing_mode="fake")(*p_leaves, *d_leaves)
    return gm, n_p, len(d_leaves), out_spec["spec"]


class StagePlan:
    """The stage split of a traced graph: each stage's nodes, the values
    each boundary carries, and which stage uses each param."""

    def __init__(self, gm, n_stages: int, n_param_leaves: int):
        self.gm = gm
        graph = gm.graph
        self.placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        self.param_nodes = self.placeholders[:n_param_leaves]
        self.data_nodes = self.placeholders[n_param_leaves:]
        calls = [n for n in graph.nodes if n.op == "call_function"]
        # a unit is an op with the getitems that unpack it: a split never
        # separates a tuple from its getitems
        units: List[List] = []
        for n in calls:
            if n.target is operator.getitem and units \
                    and n.args[0] in units[-1]:
                units[-1].append(n)
            else:
                units.append([n])
        markers = [i for i, u in enumerate(units)
                   if u[0].target is SPLIT_POINT]
        if markers:
            if len(markers) != n_stages - 1:
                raise ValueError(
                    f"{len(markers)} split_point markers imply "
                    f"{len(markers) + 1} stages, but n_stages={n_stages}")
            ends = [i + 1 for i in markers] + [len(units)]
        else:
            ends = _balanced_splits([node_flops(u[0]) for u in units],
                                    n_stages)
        starts = [0] + ends[:-1]
        self.stage_nodes = [[n for u in units[a:b] for n in u]
                            for a, b in zip(starts, ends)]
        self.n_stages = n_stages
        self.stage_flops = [sum(node_flops(n) for n in nodes
                                if n.target is not operator.getitem)
                            for nodes in self.stage_nodes]
        self.ends = ends

        def_stage: Dict = {}
        for s, nodes in enumerate(self.stage_nodes):
            for n in nodes:
                def_stage[n] = s
        last_use: Dict = {}
        for s, nodes in enumerate(self.stage_nodes):
            for n in nodes:
                for a in n.all_input_nodes:
                    last_use[a] = max(last_use.get(a, -1), s)
        self.output_node = next(n for n in graph.nodes if n.op == "output")
        self.out_nodes = list(self.output_node.args[0])
        for a in self.output_node.all_input_nodes:
            last_use[a] = n_stages - 1
        # boundary b carries the values made at stage <= b read after b
        self.boundaries: List[List] = [
            [n for n, d in def_stage.items()
             if d <= b and last_use.get(n, -1) > b]
            for b in range(n_stages - 1)]
        self.use_stages = {p: set() for p in self.param_nodes}
        for s, nodes in enumerate(self.stage_nodes):
            for n in nodes:
                for a in n.all_input_nodes:
                    if a in self.use_stages:
                        self.use_stages[a].add(s)

    @staticmethod
    def meta(node):
        val = node.meta["val"]
        return tuple(val.shape), val.dtype

    def plan_params(self):
        """(stage_layouts, shared_idx) over param positions: a float32 /
        bfloat16 / float16 leaf one stage uses goes into that stage's
        row, every other leaf is shared (replicated)."""
        layouts: List[List[int]] = [[] for _ in range(self.n_stages)]
        shared: List[int] = []
        for i, p in enumerate(self.param_nodes):
            stages = self.use_stages[p]
            packable = p.meta["val"].dtype in (torch.float32, torch.bfloat16,
                                               torch.float16)
            if len(stages) == 1 and packable:
                layouts[next(iter(stages))].append(i)
            else:
                shared.append(i)
        return layouts, shared


# --------------------------------------------------------- the programs

def _run_nodes(gm, nodes, env):
    for n in nodes:
        args = torch.fx.node.map_arg(n.args, env.__getitem__)
        kwargs = torch.fx.node.map_arg(n.kwargs, env.__getitem__)
        env[n] = n.target(*args, **kwargs)


# ------------------------------------------- tensor parallel inside stages

def _to_front(x, dim: int):
    return torch.movedim(x, dim, 0)


class _TpGather(torch.autograd.Function):
    """S(dim) -> R on the tp group: all_gather forward, reduce_scatter of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim: int, axis: Axis):
        ctx.dim, ctx.axis = dim, axis
        y = comm.all_gather_dim0(_to_front(x, dim), axis.group, axis.size)
        return torch.movedim(y, 0, dim)

    @staticmethod
    def backward(ctx, g):
        d, ax = ctx.dim, ctx.axis
        y = comm.reduce_scatter_sum(_to_front(g, d), ax.group, ax.size)
        return torch.movedim(y, 0, d), None, None


class _TpSum(torch.autograd.Function):
    """P(sum) -> R on the tp group: all_reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return comm.all_reduce_sum(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_sum(g, ctx.axis.group), None


def _tp_convert(val, cur, want, axis: Axis):
    """Move a stage-local value between tp placements (reference
    parallel/auto_pipeline.py:290-319): S -> R all_gathers, R -> S slices
    the rank's block, S(i) -> S(j) goes through R; a partial `want` reads
    the value whole.  Every collective's group lies inside one pipeline
    stage, so the stage's lanes reach each one together."""
    cur_dim = cur.dim if cur is not None and cur.is_shard() else None
    want_dim = want.dim if want is not None and want.is_shard() else None
    if cur_dim == want_dim:
        return val
    if cur_dim is not None:
        val = _TpGather.apply(val, cur_dim, axis)
    if want_dim is not None:
        size = val.shape[want_dim]
        if size % axis.size:
            raise ValueError(
                f"tp plan wants dim {want_dim} of shape {tuple(val.shape)} "
                f"sharded {axis.size}-way but it does not divide")
        step = size // axis.size
        val = val.narrow(want_dim, axis.index * step, step)
    return val


def _resolve_partial(val, p, created: bool, axis: Axis):
    """A partial output: summed over the tp group where this node creates
    it (a mean's partial divided by the group), else already whole (the
    node propagated a partial its inputs resolved)."""
    if not created:
        return val
    val = _TpSum.apply(val, axis)
    return val / axis.size if p.reduction == Reduction.AVG else val


def _run_nodes_tp(nodes, env, place, plan, axis: Axis):
    """`_run_nodes` under the tp plan: `place` maps a node to its tp
    Placement where it is sharded (absent: whole)."""
    from easydist_tpu_torch.fxfront.emit import _SHAPE_ARG, local_shape
    from easydist_tpu_torch.fxfront.interpreter import _is_tensor_node

    for n in nodes:
        if n.target is operator.getitem:
            src, i = n.args
            env[n] = env[src][i]
            p = place.get((src, i))
            if p is not None:
                place[n] = p
            continue
        strat = plan.get(n.name)
        leaves, spec = pytree.tree_flatten((tuple(n.args), dict(n.kwargs)))
        pos, new = 0, []
        for leaf in leaves:
            if _is_tensor_node(leaf):
                want = strat.in_placements[pos] if strat is not None \
                    and pos < len(strat.in_placements) else None
                new.append(_tp_convert(env[leaf], place.get(leaf), want,
                                       axis))
                pos += 1
            elif isinstance(leaf, torch.fx.Node):
                new.append(env[leaf])
            else:
                new.append(leaf)
        args, kwargs = pytree.tree_unflatten(new, spec)
        val = n.meta.get("val")
        if strat is None:
            env[n] = n.target(*args, **kwargs)
            continue
        outs = list(strat.out_placements)
        if isinstance(val, torch.Tensor):
            for idx, targets in _SHAPE_ARG.items():
                if n.target in targets:
                    args = list(args)
                    args[idx] = list(local_shape(val.shape, outs[:1],
                                                 [axis.size]))
                    args = tuple(args)
        out = n.target(*args, **kwargs)
        created = not any(q is not None and q.is_partial()
                          for q in strat.in_placements)
        if isinstance(val, torch.Tensor):
            outs, out = outs[:1], [out]
        else:
            out = list(out)
        for i, p in enumerate(outs[:len(out)]):
            if p is not None and p.is_partial():
                out[i] = _resolve_partial(out[i], p, created, axis)
            elif p is not None and p.is_shard():
                place[n if isinstance(val, torch.Tensor) else (n, i)] = p
        env[n] = out[0] if isinstance(val, torch.Tensor) else tuple(out)


def tp_conversions(plan: "StagePlan", s: int, tp_plan, size: int):
    """(kind, input bytes) of every tp collective stage `s` issues in one
    microbatch's forward, in program order: the counterpart of
    `_run_nodes_tp`'s conversions, from the traced shapes."""
    place, out = {}, []
    from easydist_tpu_torch.fxfront.interpreter import _is_tensor_node

    def nbytes(node, p=None):
        v = node.meta["val"]
        n = v.numel() * v.element_size()
        return n // size if p is not None else n

    def convert(node, cur, want):
        cur_dim = cur.dim if cur is not None and cur.is_shard() else None
        want_dim = want.dim if want is not None and want.is_shard() \
            else None
        if cur_dim is not None and cur_dim != want_dim:
            out.append(("all_gather_into_tensor", nbytes(node, cur)))

    for n in plan.stage_nodes[s]:
        if n.target is operator.getitem:
            if (n.args[0], n.args[1]) in place:
                place[n] = place[(n.args[0], n.args[1])]
            continue
        strat = tp_plan.get(n.name)
        pos = 0
        for leaf in pytree.tree_leaves((tuple(n.args), dict(n.kwargs))):
            if _is_tensor_node(leaf):
                want = strat.in_placements[pos] if strat is not None \
                    and pos < len(strat.in_placements) else None
                convert(leaf, place.get(leaf), want)
                pos += 1
        if strat is None:
            continue
        created = not any(q is not None and q.is_partial()
                          for q in strat.in_placements)
        val = n.meta.get("val")
        vals = [val] if isinstance(val, torch.Tensor) else list(val)
        for i, p in enumerate(list(strat.out_placements)[:len(vals)]):
            key = n if isinstance(val, torch.Tensor) else (n, i)
            if p is not None and p.is_partial() and created:
                v = vals[i]
                out.append(("all_reduce", v.numel() * v.element_size()))
            elif p is not None and p.is_shard():
                place[key] = p
    outs = plan.boundaries[s] if s < plan.n_stages - 1 else plan.out_nodes
    for n in outs:
        convert(n, place.get(n), None)
    return out


class _AutoStageProgram:
    """Rank `s`'s program of an auto-split pipeline: its stage's nodes,
    interpreted eagerly over the values its boundary brings."""

    def __init__(self, plan: StagePlan, s: int, param_vals: Dict,
                 data_vals, remat: bool, train: bool, tp=None):
        self.plan, self.S, self.s, self.V = plan, plan.n_stages, s, 1
        self.nodes = plan.stage_nodes[s]
        self.ins = plan.boundaries[s - 1] if s > 0 else []
        self.outs = plan.boundaries[s] if s < self.S - 1 else plan.out_nodes
        self.data_vals = data_vals  # [data leaf [M, ...]]
        self.remat = remat
        self.tp = tp  # (tp_plan, tp Axis) or None
        self.device = data_vals[0].device if data_vals else \
            next(iter(param_vals.values())).device
        self.param_nodes = list(param_vals)
        self.leaves = [(v.detach().requires_grad_() if train
                        and v.is_floating_point() else v)
                       for v in param_vals.values()]
        self.grad_nodes = [n for n, v in zip(self.param_nodes, self.leaves)
                           if v.requires_grad]
        consts = {}
        for n in plan.gm.graph.nodes:
            if n.op == "get_attr":
                consts[n] = getattr(plan.gm, n.target)
        self.consts = consts

    def params(self, k):
        return [p for p in self.leaves if p.requires_grad]

    def first_inputs(self, m):
        return []

    def in_meta(self, k):
        return [StagePlan.meta(n) for n in self.ins]

    def out_meta(self, k):
        return [StagePlan.meta(n) for n in self.outs]

    def _compute(self, m, ins, leaves):
        env = dict(self.consts)
        env.update(zip(self.param_nodes, leaves))
        env.update((n, x[m]) for n, x in zip(self.plan.data_nodes,
                                             self.data_vals))
        env.update(zip(self.ins, ins))
        if self.tp is None:
            _run_nodes(self.plan.gm, self.nodes, env)
            return [env[n] for n in self.outs]
        place: Dict = {}
        tp_plan, axis = self.tp
        _run_nodes_tp(self.nodes, env, place, tp_plan, axis)
        return [_tp_convert(env[n], place.get(n), None, axis)
                for n in self.outs]

    def body(self, k, m, ins):
        if not self.remat:
            return self._compute(m, ins, self.leaves)
        from torch.utils.checkpoint import checkpoint

        n_in = len(ins)

        def run(*tensors):
            return tuple(self._compute(m, list(tensors[:n_in]),
                                       list(tensors[n_in:])))

        return list(checkpoint(run, *ins, *self.leaves, use_reentrant=False))


def _sibling_axis(mesh, axis: str, exclude=()) -> Optional[Axis]:
    """The non-pp axes of `mesh` (less `exclude`) as one axis (None when
    there are none)."""
    names = [n for n in (mesh.mesh_dim_names or ())
             if n != axis and n not in exclude]
    if not names:
        return None
    if len(names) == 1:
        return mesh_axis(mesh, names[0])
    flat = mesh[tuple(names)]._flatten()
    return Axis(flat.get_group(), int(flat.size()),
                int(flat.get_local_rank()))


class _Prep:
    """What the pipeline entry points share: the plan, the packed-row
    layout, the mesh's pipeline and sibling axes."""

    def __init__(self, fn, example_params, example_mb, mesh, n_stages: int,
                 axis: str, shard_params: bool, traced=None, tp_axis=None,
                 tp_plan=None):
        self.gm, self.n_p, self.n_d, self.out_spec = traced or trace(
            fn, example_params, example_mb)
        self.plan = StagePlan(self.gm, n_stages, self.n_p)
        self.p_spec = pytree.tree_structure(example_params)
        self.local = isinstance(mesh, LocalStages)
        if self.local:
            if mesh.n != n_stages:
                raise ValueError(f"LocalStages({mesh.n}), expected "
                                 f"n_stages={n_stages}")
            self.pp, self.sib = None, None
            if tp_axis is not None:
                raise ValueError("a tp axis needs a DeviceMesh, not "
                                 "LocalStages")
        else:
            self.pp = mesh_axis(mesh, axis)
            if self.pp.size != n_stages:
                raise ValueError(f"mesh axis {axis!r} has size "
                                 f"{self.pp.size}, expected n_stages="
                                 f"{n_stages}")
            self.sib = _sibling_axis(mesh, axis)
        # the axes that divide the batch: the siblings less the tp axis
        self.batch = self.sib
        self.tp = None
        if tp_axis is not None:
            self.batch = _sibling_axis(mesh, axis, exclude=(tp_axis,))
            self.tp = (dict(tp_plan or {}), mesh_axis(mesh, tp_axis))
        self.n_sib = self.sib.size if self.sib else 1
        self.shard_params = shard_params
        self.layouts = self.shared = None
        if shard_params:
            self.layouts, self.shared = self.plan.plan_params()
            elems = max([sum(self.numel(i) for i in lay)
                         for lay in self.layouts] + [1])
            # rows are flat-split over the sibling axes: pad to a multiple
            self.row_elems = -(-elems // self.n_sib) * self.n_sib

    def numel(self, i):
        return math.prod(self.plan.param_nodes[i].meta["val"].shape)

    # ----------------------------------------------------------- packing
    def pack_row(self, leaves, s: int):
        parts = [leaves[i].reshape(-1).to(torch.float32)
                 for i in self.layouts[s]]
        dev = leaves[0].device
        flat = torch.cat(parts) if parts else torch.zeros(0, device=dev)
        return torch.nn.functional.pad(flat, (0, self.row_elems
                                              - flat.shape[0]))

    def pack_params(self, params):
        """params tree -> (this rank's block of its stage's row [1,
        row_elems / n_sib], shared leaves); chained (LocalStages), every
        stage's full row [S, row_elems]."""
        leaves = pytree.tree_leaves(params)
        if len(leaves) != self.n_p:
            raise ValueError("params pytree does not match the example")
        shared = tuple(leaves[i] for i in self.shared)
        if self.local:
            return torch.stack([self.pack_row(leaves, s)
                                for s in range(self.plan.n_stages)]), shared
        s = self.pp.index
        row = self.pack_row(leaves, s)
        if self.sib is not None:
            row = local_block(row, 0, self.sib.size, self.sib.index,
                              "packed row")
        return row[None].clone(), shared

    def unpack_row(self, row, s: int) -> Dict[int, torch.Tensor]:
        out, off = {}, 0
        for i in self.layouts[s]:
            shape, dtype = StagePlan.meta(self.plan.param_nodes[i])
            n = math.prod(shape)
            out[i] = row[off:off + n].reshape(shape).to(dtype)
            off += n
        return out

    def unpack_params(self, rows, shared) -> List[torch.Tensor]:
        """Full rows [S, row_elems] and the shared leaves -> the flat
        param leaves in the original order."""
        leaves: List = [None] * self.n_p
        for s in range(self.plan.n_stages):
            for i, v in self.unpack_row(rows[s], s).items():
                leaves[i] = v
        for pos, val in zip(self.shared, shared):
            leaves[pos] = val
        return leaves

    # ------------------------------------------------------------ stages
    def stage_param_vals(self, s: int, full_row=None, shared=(),
                         leaves=None) -> Dict:
        """{param node: value} a stage's nodes read: from the stage's full
        row and the shared leaves (packed), or from the leaves."""
        nodes = self.plan.param_nodes
        used = sorted(i for i, p in enumerate(nodes)
                      if s in self.plan.use_stages[p])
        if leaves is not None:
            return {nodes[i]: leaves[i] for i in used}
        own = self.unpack_row(full_row, s)
        shared_of = dict(zip(self.shared, shared))
        return {nodes[i]: own[i] if i in own else shared_of[i]
                for i in used}

    def microbatches(self, microbatches):
        leaves = pytree.tree_leaves(microbatches)
        if len(leaves) != self.n_d:
            raise ValueError(
                f"microbatches pytree has {len(leaves)} leaves; the "
                f"traced function expects {self.n_d}")
        if self.batch is None:
            return leaves
        return [local_block(x, 1, self.batch.size, self.batch.index)
                for x in leaves]

    def tp_collectives(self, s: int):
        """{kind: [count, input bytes]} of the tp collectives stage `s`
        issues in one microbatch's forward and backward (forward
        conversions: an all_gather per S -> R, an all_reduce per partial
        created; their gradients: a reduce_scatter of the whole value per
        gather, an all_reduce per all_reduce)."""
        out: Dict[str, List[int]] = {}
        if self.tp is None:
            return out
        tp_plan, axis = self.tp
        for kind, nbytes in tp_conversions(self.plan, s, tp_plan, axis.size):
            back = ("reduce_scatter_tensor", nbytes * axis.size) \
                if kind == "all_gather_into_tensor" else (kind, nbytes)
            for k, b in ((kind, nbytes), back):
                c = out.setdefault(k, [0, 0])
                c[0] += 1
                c[1] += b
        return out


def pipeline_forward(fn: Callable, example_params, example_mb, mesh,
                     n_stages: int, n_microbatches: int, axis: str = "pp",
                     shard_params: bool = False):
    """Auto-split `fn(params, mb)` into a forward pipeline.

    Stages split at user `split_point` markers when present, else at
    FLOP-balanced cuts.  Returns pipe(params, microbatches [M, ...mb
    shape]) -> stacked outputs [M, ...] (summed over the pipeline group,
    so every rank has them).  shard_params=True also returns
    pack_params: each rank then holds only its stage's packed row (and
    the shared leaves): pipe(pack_params(params), microbatches)."""
    prep = _Prep(fn, example_params, example_mb, mesh, n_stages, axis,
                 shard_params)
    M = n_microbatches
    tables = schedule_tables("gpipe", n_stages, 1, M, grad=False)

    def pipelined(params, microbatches):
        data = prep.microbatches(microbatches)

        def make_prog(s):
            if shard_params:
                row, shared = params
                vals = prep.stage_param_vals(s, row[0], shared)
            else:
                vals = prep.stage_param_vals(
                    s, leaves=pytree.tree_leaves(params))
            return _AutoStageProgram(prep.plan, s, vals, data, False, False)

        if prep.local:
            results = drive_local([rank_core(make_prog(s), tables, M, False)
                                   for s in range(n_stages)])
        else:
            prog = make_prog(prep.pp.index)
            results = [drive_p2p(rank_core(prog, tables, M, False),
                                 prep.pp.group, prep.pp.index, prog.device)]
        last = results[-1]
        n_out = len(prep.plan.out_nodes)
        if last["out"]:
            outs = [torch.stack([last["out"][m][i] for m in range(M)])
                    for i in range(n_out)]
        else:
            outs = [torch.zeros((M,) + shape, dtype=dtype,
                                device=data[0].device)
                    for shape, dtype in map(StagePlan.meta,
                                            prep.plan.out_nodes)]
        if not prep.local:
            outs = [comm.all_reduce_sum(o, prep.pp.group) for o in outs]
        pipelined.stats = [r["stats"].as_dict() for r in results]
        return pytree.tree_unflatten(outs, prep.out_spec)

    pipelined.plan = prep.plan
    if not shard_params:
        return pipelined
    return pipelined, prep.pack_params


def pipeline_grad(fn: Callable, example_params, example_mb, mesh,
                  n_stages: int, n_microbatches: int, axis: str = "pp",
                  schedule: str = "1f1b", traced=None, tp_axis=None,
                  tp_plan=None):
    """Auto-split `fn(params, mb) -> scalar mean loss` into a training
    pipeline on `schedule` ("gpipe", "remat", "1f1b").

    Params are packed per stage (`pack_params`) and flat-sharded over the
    sibling axes, which batch-parallelise each stage (the microbatches'
    batch dim is split over them; `fn` is traced at that local shape).
    Returns (pipe_grad, pack_params): pipe_grad((row block, shared),
    microbatches) -> (loss, (d row block, d shared)): the loss is the mean
    over microbatches and sibling lanes; the row gradient comes back
    reduce_scattered to the rank's block, the shared gradients summed over
    the stages and averaged over the siblings.  `traced` reuses a
    `trace(fn, ...)` result (the graph `tp_plan`'s node names refer to);
    `tp_axis` names the sibling axis `tp_plan` splits tensors on inside
    the stages (it does not divide the batch)."""
    prep = _Prep(fn, example_params, example_mb, mesh, n_stages, axis,
                 shard_params=True, traced=traced, tp_axis=tp_axis,
                 tp_plan=tp_plan)
    plan, M = prep.plan, n_microbatches
    if len(plan.out_nodes) != 1 or StagePlan.meta(plan.out_nodes[0])[0]:
        raise NotImplementedError(
            "the auto-split training pipeline supports a single scalar "
            "(mean) loss output")
    tables = schedule_tables(schedule, n_stages, 1, M)
    remat = schedule == "remat"

    def stage_prog(s, full_row, shared, data):
        return _AutoStageProgram(plan, s, prep.stage_param_vals(
            s, full_row, shared), data, remat, True, tp=prep.tp)

    def grads_of(s, prog, result):
        """(d full row [row_elems], d shared) of stage `s`."""
        d = dict(zip(prog.grad_nodes, result["grads"][0]))
        nodes = plan.param_nodes
        parts = []
        for node in (nodes[i] for i in prep.layouts[s]):
            parts.append(d[node].reshape(-1).to(torch.float32))
        dev = prog.device
        flat = torch.cat(parts) if parts else torch.zeros(0, device=dev)
        d_row = torch.nn.functional.pad(flat, (0, prep.row_elems
                                               - flat.shape[0]))
        d_shared = []
        for i in prep.shared:
            node = nodes[i]
            g = d.get(node)
            d_shared.append(g if g is not None else torch.zeros(
                StagePlan.meta(node)[0], dtype=StagePlan.meta(node)[1],
                device=dev))
        return d_row, d_shared

    def pipe_grad(params, microbatches):
        row, shared = params
        data = prep.microbatches(microbatches)
        if prep.local:
            progs = [stage_prog(s, row[s], shared, data)
                     for s in range(n_stages)]
            results = drive_local([rank_core(p, tables, M, True)
                                   for p in progs])
            loss = results[-1]["loss"] / M
            rows, d_shared = [], None
            for s, (p, r) in enumerate(zip(progs, results)):
                d_row, d_sh = grads_of(s, p, r)
                rows.append(d_row)
                d_shared = d_sh if d_shared is None else \
                    [a + b for a, b in zip(d_shared, d_sh)]
            pipe_grad.stats = [r["stats"].as_dict() for r in results]
            return loss, (torch.stack(rows), tuple(d_shared))
        s = prep.pp.index
        full = row[0]
        if prep.sib is not None:
            # the row's blocks gathered once per step, at a point every
            # rank reaches
            full = comm.all_gather_dim0(full, prep.sib.group, prep.sib.size)
        prog = stage_prog(s, full, shared, data)
        result = drive_p2p(rank_core(prog, tables, M, True), prep.pp.group,
                           s, prog.device)
        pipe_grad.stats = [result["stats"].as_dict()]
        loss = result["loss"] / M if result["loss"] is not None else \
            torch.zeros((), device=prog.device)
        d_row, d_shared = grads_of(s, prog, result)
        loss = comm.all_reduce_sum(loss, prep.pp.group)
        d_shared = [comm.all_reduce_sum(d, prep.pp.group) for d in d_shared]
        if prep.sib is not None:
            n = prep.sib.size
            loss = comm.all_reduce_sum(loss, prep.sib.group) / n
            d_row = comm.reduce_scatter_sum(d_row, prep.sib.group, n) / n
            d_shared = [comm.all_reduce_sum(d, prep.sib.group) / n
                        for d in d_shared]
        return loss, (d_row[None], tuple(d_shared))

    pipe_grad.plan = plan
    pipe_grad.prep = prep
    return pipe_grad, prep.pack_params


def pipeline_1f1b_grad(fn: Callable, example_params, example_mb, mesh,
                       n_stages: int, n_microbatches: int, axis: str = "pp"):
    """`pipeline_grad` on the 1F1B schedule (the JAX package's name)."""
    return pipeline_grad(fn, example_params, example_mb, mesh, n_stages,
                         n_microbatches, axis=axis, schedule="1f1b")
