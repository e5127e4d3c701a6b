"""Per-rank emission: rewrite the traced step into the program one rank of
the mesh runs on its shards (the counterpart of
easydist_tpu/jaxfront/api.py:147-258 `emit_sharded_fn`).

GSPMD does not exist here, so the design is the reference's own torch
`sharding_transform` (easydist/torch/passes/sharding.py:704-949), written
over functional collectives (`torch.ops._c10d_functional`):

  * every value carries one Placement per mesh axis: R, S(dim) or P(op);
  * on every edge where the producer's placement differs from what the
    consumer's strategy takes, a reshard is inserted per axis: S->R
    all_gather (through dim 0), P->R all_reduce, P->S reduce_scatter,
    S(i)->S(j) all_to_all, R->S a local slice at the rank's coordinate,
    R->P(sum) a local mask (the first rank keeps the value), P(avg) <->
    P(sum) a local scale; each collective's `wait_tensor` comes right
    before its first use;
  * shape-carrying arguments (view, _unsafe_view, reshape, expand and the
    creation ops) are rewritten to the local shape the node's output
    placements give;
  * a P-placed chain simply runs locally and is fenced by the collective
    the solver chose (no counterpart of jaxfront/partial_regions.py); a
    sum's fence goes through `comm.reduce.fence_plan`, so under
    `comm_quant_dtype` it is the block-scaled int8 (or bf16) collective of
    `comm.quant` exactly where the solver priced it so (the JAX fence's
    rule: quantizable by size);
  * a paired state output is resharded back to its input's placement,
    every other output to R;
  * an attention composite node (`ed_attention_fwd` / `_bwd`) on its seq
    strategy becomes the ring or Ulysses program on the axis's group
    (the variant in the strategy's meta, Ulysses re-checked against the
    rank's heads; reference jaxfront/api.py:89-133), the backward the
    vjp of the same program; its permutes / all_to_alls are recorded as
    the collectives of that node.

A tensor dim is never sharded on two axes at once (the frontend's solve
excludes such strategies), so one layout per dim holds throughout.

Every inserted collective is recorded (`Collective`): the axis, the kind,
the value it moves, the bytes of that value across the axis's group, the
bytes the solver's graph of that axis gave the same value, which the
frontend sums against what the solver priced, the bytes a rank sends for
it and its route.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch.comm.quant import (bf16_psum, bf16_psum_scatter,
                                           quantized_psum,
                                           quantized_psum_scatter)
from easydist_tpu_torch.comm.reduce import fence_plan
from easydist_tpu_torch.metashard.combination import Reduction
from easydist_tpu_torch.metashard.metair import Placement
# registers the attention composite's custom ops named below
import easydist_tpu_torch.ops.attention_prim  # noqa: F401
from .interpreter import VarNames, _is_tensor_node, node_tensor_inputs

aten = torch.ops.aten
_c10d = torch.ops._c10d_functional

_R = Placement.replicate()

_ATTENTION_BWD = torch.ops.easydist_tpu_torch.ed_attention_bwd.default
_ATTENTION = {torch.ops.easydist_tpu_torch.ed_attention_fwd.default,
              _ATTENTION_BWD}

# (argument index, targets) of the shape-carrying arguments
_SHAPE_ARG = {
    1: {aten.view.default, aten._unsafe_view.default, aten.reshape.default,
        aten.expand.default, aten.new_zeros.default, aten.new_ones.default,
        aten.new_empty.default, aten.new_full.default},
    0: {aten.zeros.default, aten.ones.default, aten.empty.memory_format,
        aten.full.default},
}


@dataclass
class Collective:
    """One collective the emitter inserted."""

    axis: str
    # all_gather | all_reduce | reduce_scatter | all_to_all | ppermute
    kind: str
    var: str
    # bytes of the value across the axis's group (a ppermute: the bytes
    # each rank sends)
    group_bytes: float
    # the same on the solver's axis graph
    priced_bytes: float
    # bytes one rank sends for it (the ring closed forms; a fence as
    # `comm.reduce.fence_plan` sends it)
    wire_bytes: float = float("nan")
    # "exact", or the fence's quantized route ("int8" | "bf16")
    route: str = "exact"


# --------------------------------------------------- local helper ops
# (call targets of the emitted graph)

def _to_front(x, dim: int):
    return torch.movedim(x, dim, 0).contiguous()


def _from_front(x, dim: int):
    return torch.movedim(x, 0, dim).contiguous()


def _local_chunk(x, dim: int, index: int, n: int):
    """The rank's contiguous 1/n of `x` along `dim`, in a storage of its
    own.  A slice of the leading dims is contiguous already, and as a view
    it would keep all of `x` alive for as long as the chunk lives (an
    activation saved for the backward, say), where the memory plan sizes
    the chunk alone and frees `x` at its last reader."""
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).clone(
        memory_format=torch.contiguous_format)


def _keep_on_first(x, first: bool):
    """R -> P(sum): the first rank of the group keeps the value, the rest
    hold zeros, so the pending sum is the value once."""
    return x if first else torch.zeros_like(x)


def _scale(x, factor: float):
    return x * factor


def _a2a_pack(x, dim: int, n: int):
    """[n, *chunk]: the i-th chunk of `x` along `dim` goes to rank i."""
    return torch.stack(torch.chunk(x, n, dim), 0).contiguous()


def _a2a_unpack(y, dim: int):
    """Concatenate what rank 0..n-1 sent along `dim`."""
    return torch.cat(torch.unbind(y, 0), dim)


def local_shape(shape: Sequence[int], placements: Sequence[Placement],
                sizes: Sequence[int]) -> Tuple[int, ...]:
    out = list(shape)
    for p, n in zip(placements, sizes):
        if p is not None and p.is_shard():
            out[p.dim] //= n
    return tuple(out)


def _reduce_name(p: Placement) -> str:
    return {Reduction.SUM: "sum", Reduction.AVG: "sum", Reduction.MAX: "max",
            Reduction.MIN: "min"}[p.reduction]


class _Emitter:

    def __init__(self, gm, per_axis, mesh_info, priced_sizes):
        self.gm = gm
        self.per_axis = per_axis
        self.names = list(mesh_info["names"])
        self.sizes = list(mesh_info["sizes"])
        self.coords = list(mesh_info["coords"])
        self.groups = list(mesh_info["groups"])
        # axes from the last solved to the first
        self.order = list(reversed(mesh_info.get(
            "order", range(len(self.names)))))
        self.priced_sizes = priced_sizes or [{} for _ in self.names]
        self.graph = torch.fx.Graph()
        self.collectives: List[Collective] = []
        # FX value name -> (new node, placements per axis, global val)
        self.env: Dict[str, tuple] = {}

    # -------------------------------------------------------- placements
    def _strategy(self, axis: int, name: str):
        return self.per_axis[axis].get(name) if axis < len(self.per_axis) \
            else None

    def _in_placements(self, name: str, pos: int) -> List[Placement]:
        out = []
        for a in range(len(self.names)):
            s = self._strategy(a, name)
            p = s.in_placements[pos] if s is not None \
                and pos < len(s.in_placements) else None
            out.append(p if p is not None else _R)
        return out

    def _out_placements(self, name: str, idx: int) -> List[Placement]:
        out = []
        for a in range(len(self.names)):
            s = self._strategy(a, name)
            p = s.out_placements[idx] if s is not None \
                and idx < len(s.out_placements) else None
            out.append(p if p is not None else _R)
        return out

    # ---------------------------------------------------------- reshard
    def _record(self, a, kind, var, val, cur, fence: bool = False):
        """Record one collective on axis `a`; a sum's fence (`fence`) goes
        through `comm.reduce.fence_plan`, which picks its route under
        `comm_quant_dtype` and records it in the comm counters.  Returns
        the route."""
        full = [p if b != a else _R for b, p in enumerate(cur)]
        numel = math.prod(local_shape(val.shape, full, self.sizes))
        nbytes = float(numel * val.element_size())
        n = self.sizes[a]
        route = "exact"
        if fence:
            route, wire = fence_plan(kind, numel, val.element_size(), n)
        elif kind == "all_to_all":
            wire = nbytes * (n - 1) / (n * n)
        elif kind == "all_reduce":
            wire = 2.0 * nbytes * (n - 1) / n
        else:  # all_gather, reduce_scatter
            wire = nbytes * (n - 1) / n
        self.collectives.append(Collective(
            self.names[a], kind, var, nbytes,
            float(self.priced_sizes[a].get(var, float("nan"))), wire, route))
        return route

    def _call(self, fn, *args):
        return self.graph.call_function(fn, args)

    def _step(self, x, a: int, p: Placement, q: Placement, var: str, val,
              cur: List[Placement]):
        """One axis's transition p -> q of value `x` (placements `cur`)."""
        n, g = self.sizes[a], self.groups[a]
        first = self.coords[a] == 0
        if p.is_shard() and (q.is_replicate() or q.is_partial()):
            self._record(a, "all_gather", var, val, cur)
            y = self._call(_to_front, x, p.dim)
            y = self._call(_c10d.all_gather_into_tensor.default, y, n, g)
            y = self._call(_c10d.wait_tensor.default, y)
            if p.dim != 0:
                y = self._call(_from_front, y, p.dim)
            if q.is_partial() and q.reduction == Reduction.SUM:
                y = self._call(_keep_on_first, y, first)
            return y
        if p.is_shard() and q.is_shard():
            self._record(a, "all_to_all", var, val, cur)
            y = self._call(_a2a_pack, x, q.dim, n)
            y = self._call(_c10d.all_to_all_single.default, y, [1] * n,
                           [1] * n, g)
            y = self._call(_c10d.wait_tensor.default, y)
            return self._call(_a2a_unpack, y, p.dim)
        if p.is_partial() and q.is_partial():
            pair = {p.reduction, q.reduction}
            if pair == {Reduction.SUM, Reduction.AVG}:
                return self._call(_scale, x, float(n) if q.reduction
                                  == Reduction.AVG else 1.0 / n)
            y = self._step(x, a, p, _R, var, val, cur)
            return self._step(y, a, _R, q, var, val, cur)
        if p.is_partial():
            sums = p.reduction in (Reduction.SUM, Reduction.AVG)
            if q.is_replicate():
                route = self._record(a, "all_reduce", var, val, cur, sums)
                if route == "int8":
                    y = self._call(quantized_psum, x, g, n)
                elif route == "bf16":
                    y = self._call(bf16_psum, x, g)
                else:
                    y = self._call(_c10d.all_reduce.default,
                                   self._call(_to_front, x, 0),
                                   _reduce_name(p), g)
                    y = self._call(_c10d.wait_tensor.default, y)
            else:
                route = self._record(a, "reduce_scatter", var, val, cur,
                                     sums)
                y = self._call(_to_front, x, q.dim)
                if route == "int8":
                    y = self._call(quantized_psum_scatter, y, g, n)
                elif route == "bf16":
                    y = self.graph.call_function(bf16_psum_scatter, (y, g),
                                                 {"axis_size": n})
                else:
                    y = self._call(_c10d.reduce_scatter_tensor.default, y,
                                   _reduce_name(p), n, g)
                    y = self._call(_c10d.wait_tensor.default, y)
                if q.dim != 0:
                    y = self._call(_from_front, y, q.dim)
            if p.reduction == Reduction.AVG:
                y = self._call(_scale, y, 1.0 / n)
            return y
        # p is R
        if q.is_shard():
            return self._call(_local_chunk, x, q.dim, self.coords[a], n)
        if q.is_partial() and q.reduction == Reduction.SUM:
            return self._call(_keep_on_first, x, first)
        return x  # R is already a valid P(avg), P(max), P(min)

    def reshard(self, x, cur: Sequence[Placement], want: Sequence[Placement],
                var: str, val):
        """Move value `x` from placements `cur` to `want`, axis by axis in
        reverse solve order: first every axis whose target is not a
        shard, then the shard targets whose dim is free; a cycle (two
        axes trading dims) goes through R on one of them.  Reverse solve
        order meets each collective at the size the solver priced it
        when the value's other axes have not moved yet (a later-solved
        axis's graph is shrunk by the earlier axes' producer
        placements)."""
        cur = list(cur)
        for a in self.order:
            if cur[a] != want[a] and not want[a].is_shard():
                x = self._step(x, a, cur[a], want[a], var, val, cur)
                cur[a] = want[a]
        while True:
            pending = [a for a in self.order if cur[a] != want[a]]
            if not pending:
                return x
            moved = False
            for a in pending:
                busy = any(b != a and cur[b].is_shard()
                           and cur[b].dim == want[a].dim
                           for b in range(len(cur)))
                if not busy:
                    x = self._step(x, a, cur[a], want[a], var, val, cur)
                    cur[a] = want[a]
                    moved = True
            if not moved:
                a = pending[0]
                x = self._step(x, a, cur[a], _R, var, val, cur)
                cur[a] = _R

    # ------------------------------------------------------------- nodes
    def _input(self, fx_node, name: str, pos: int, consumer: str):
        new, cur, val = self.env[fx_node.name]
        want = self._in_placements(consumer, pos)
        return self.reshard(new, cur, want, name, val)

    def run(self, out_targets):
        names = VarNames()
        for node in self.gm.graph.nodes:
            val = node.meta.get("val")
            if node.op == "placeholder":
                new = self.graph.placeholder(node.name)
                new.meta = dict(node.meta)
                self.env[node.name] = (new, self._out_placements(node.name, 0)
                                       if isinstance(val, torch.Tensor)
                                       else [_R] * len(self.names), val)
            elif node.op == "get_attr":
                new = self.graph.get_attr(node.target)
                self.env[node.name] = (new, [_R] * len(self.names), val)
            elif node.op == "call_function" \
                    and node.target is operator.getitem:
                src, idx = node.args
                s_new, s_cur, s_val = self.env[src.name]
                new = self.graph.call_function(operator.getitem, (s_new, idx))
                self.env[node.name] = (new, s_cur[idx], s_val[idx])
            elif node.op == "call_function":
                self._emit_call(node, names)
            elif node.op == "output":
                self._emit_output(node, out_targets, names)
        return self.graph

    def _var_name(self, fx_node, names) -> str:
        if fx_node.op == "call_function" \
                and fx_node.target is operator.getitem:
            src, idx = fx_node.args
            return names.name(src, idx)
        return names.name(fx_node)

    def _seq_axis(self, node):
        """(axis, variant) where `node` runs the attention composite's seq
        strategy, else None."""
        if node.target not in _ATTENTION:
            return None
        for a in range(len(self.names)):
            meta = getattr(self._strategy(a, node.name), "meta", None)
            if meta and meta.get("variant"):
                return a, meta["variant"]
        return None

    def _emit_seq_attention(self, node, names, tensors, a, variant):
        """The ring / Ulysses program of an attention node seq-sharded on
        axis `a`, on this rank's shards `tensors`."""
        from easydist_tpu_torch.ops.attention_prim import (seq_collectives,
                                                           seq_variant)
        from easydist_tpu_torch.parallel.ring_attention import (
            ring_attention_local, ring_attention_local_vjp)
        from easydist_tpu_torch.parallel.ulysses import (
            ulysses_attention_local, ulysses_attention_local_vjp)

        n, group, idx = self.sizes[a], self.groups[a], self.coords[a]
        causal, scale = node.args[-2], node.args[-1]
        q_node = node_tensor_inputs(node)[0]
        q = q_node.meta["val"]
        local = local_shape(q.shape, self._in_placements(node.name, 0),
                            self.sizes)
        variant = seq_variant(variant, local[1], n)
        backward = node.target is _ATTENTION_BWD
        if variant == "ring":
            fn = ring_attention_local_vjp if backward \
                else ring_attention_local
            args = (*tensors, group, n, idx, causal, scale)
        else:
            fn = ulysses_attention_local_vjp if backward \
                else ulysses_attention_local
            args = (*tensors, group, n, causal, scale)
        var = self._var_name(q_node, names)
        moved = math.prod(local) * q.element_size() * n
        priced = self.priced_sizes[a].get(var, float("nan"))
        for (kind, nbytes), (_, pbytes) in zip(
                seq_collectives(moved, n, backward, variant),
                seq_collectives(priced, n, backward, variant)):
            self.collectives.append(Collective(self.names[a], kind, var,
                                               float(nbytes), float(pbytes),
                                               float(nbytes)))
        return self.graph.call_function(fn, args)

    def _emit_call(self, node, names):
        mapped = iter([self._input(a, self._var_name(a, names), pos,
                                   node.name)
                       for pos, a in enumerate(node_tensor_inputs(node))])
        seq = self._seq_axis(node)
        if seq is not None:
            new = self._emit_seq_attention(node, names, list(mapped), *seq)
            val = node.meta.get("val")
            self.env[node.name] = (
                new, self._out_placements(node.name, 0)
                if isinstance(val, torch.Tensor) else
                [self._out_placements(node.name, i) for i in range(len(val))],
                val)
            new.meta["orig"] = node.name
            return
        leaves, spec = pytree.tree_flatten((tuple(node.args),
                                            dict(node.kwargs)))
        new_leaves = []
        for leaf in leaves:
            if _is_tensor_node(leaf):
                new_leaves.append(next(mapped))
            elif isinstance(leaf, torch.fx.Node):
                new_leaves.append(self.env[leaf.name][0])
            else:
                new_leaves.append(leaf)
        args, kwargs = pytree.tree_unflatten(new_leaves, spec)
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            outs = self._out_placements(node.name, 0)
            for idx, targets in _SHAPE_ARG.items():
                if node.target in targets:
                    args = list(args)
                    args[idx] = list(local_shape(val.shape, outs, self.sizes))
                    args = tuple(args)
            new = self.graph.call_function(node.target, args, kwargs)
            self.env[node.name] = (new, outs, val)
        else:
            new = self.graph.call_function(node.target, args, kwargs)
            outs = [self._out_placements(node.name, i)
                    for i in range(len(val))]
            self.env[node.name] = (new, outs, val)
        new.meta["orig"] = node.name

    def _emit_output(self, node, out_targets, names):
        leaves, spec = pytree.tree_flatten(node.args)
        new_leaves = []
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, torch.fx.Node):
                new_leaves.append(leaf)
                continue
            new, cur, val = self.env[leaf.name]
            want = out_targets.get(i, [_R] * len(self.names))
            new_leaves.append(self.reshard(new, cur, want,
                                           self._var_name(leaf, names), val))
        self.graph.output(pytree.tree_unflatten(new_leaves, spec)[0])


def emit_sharded_fn(gm: torch.fx.GraphModule, per_axis, mesh_info: dict,
                    out_targets: Dict[int, List[Placement]],
                    priced_sizes: Optional[List[Dict[str, float]]] = None):
    """The per-rank GraphModule of `gm` under the solved `per_axis`
    strategies ({node name: NodeStrategy} per mesh axis, mesh order).

    `mesh_info` holds the axes' "names", "sizes", this rank's "coords",
    the axes' process-group "groups" names and their solve "order";
    `out_targets` maps a flat output index to the placements it must
    come back in (paired state: its input's), the rest come back
    replicated; `priced_sizes` gives, per axis, the byte size the
    solver's graph of that axis gave each value.  Returns (GraphModule,
    [Collective])."""
    em = _Emitter(gm, per_axis, mesh_info, priced_sizes)
    graph = em.run(out_targets)
    graph.lint()
    return torch.fx.GraphModule(gm, graph), em.collectives
