"""Preset (analytic) SPMD rules for aten ops: the port of
easydist_tpu/jaxfront/presets.py over the targets of `make_fx` graphs.

Execution-based ShardCombine is the general mechanism, but the hot ops of
a transformer have well-known sharding rules; computing them analytically
makes compile time independent of tensor sizes (the reference's
discovery-bypass rule bank, easydist/torch/preset_propagation.py).
Anything not covered here falls back to execution discovery, and
`ShardingAnalyzer._crosscheck_preset` holds these rules against it.

A rule receives the FX node and the world size and returns {"space":
ShardSpace, "recombines": {group: fn}} with one row per tensor input, in
the order `interpreter.node_tensor_inputs` lists them, or None to decline.
Rules are registered by overload ("aten.add.Tensor") or by packet
("aten.add", every overload).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

# register the custom ops the presets below name: the kernels', the
# attention composite's and the sharding pin's
import easydist_tpu_torch.fxfront.scope  # noqa: F401
import easydist_tpu_torch.ops.attention_prim  # noqa: F401
import easydist_tpu_torch.ops.flash_attention  # noqa: F401
from easydist_tpu_torch.metashard.annotation import DimSharding, ShardSpace
from easydist_tpu_torch.metashard.combination import Recombine, Reduction
from easydist_tpu_torch.metashard.view_propagation import view_rule

aten = torch.ops.aten
_RULES: Dict[str, Callable] = {}


def _key(target) -> str:
    return str(target)


def register_preset(*targets):
    """Register a rule for aten overloads or packets (every overload)."""
    def deco(fn):
        for t in targets:
            _RULES[_key(t)] = fn
        return fn

    return deco


def rule_for(target) -> Optional[Callable]:
    fn = _RULES.get(_key(target))
    if fn is None and hasattr(target, "overloadpacket"):
        fn = _RULES.get(_key(target.overloadpacket))
    return fn


def preset_rule(node, world_size: int) -> Optional[dict]:
    fn = rule_for(node.target)
    if fn is None:
        return None
    try:
        return fn(node, world_size)
    except Exception:
        return None


def _inputs(node) -> List[torch.Tensor]:
    from .interpreter import node_tensor_inputs

    return [n.meta["val"] for n in node_tensor_inputs(node)]


def _out(node):
    return node.meta["val"]


def _arg(node, i: int, name: str, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


def _norm(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _concat(dim):
    return functools.partial(Recombine.concat, dim=dim)


def _reduce(op=Reduction.SUM):
    return functools.partial(Recombine.reduce, op=op)


def _replicated(node) -> dict:
    return {"space": ShardSpace([[DimSharding() for _ in a.shape]
                                 for a in _inputs(node)]),
            "recombines": {}}


def _rows(avals):
    return [[DimSharding() for _ in a.shape] for a in avals]


# ------------------------------------------------------------- elementwise

_ELEMENTWISE = [
    aten.add, aten.sub, aten.mul, aten.div, aten.rsub, aten.pow,
    aten.maximum, aten.minimum, aten.atan2, aten.remainder, aten.fmod,
    aten.eq, aten.ne, aten.lt, aten.le, aten.gt, aten.ge, aten.where,
    aten.logical_and, aten.logical_or, aten.logical_not, aten.logical_xor,
    aten.bitwise_and, aten.bitwise_or, aten.bitwise_not,
    aten.exp, aten.log, aten.log1p, aten.expm1, aten.tanh, aten.sin,
    aten.cos, aten.sqrt, aten.rsqrt, aten.reciprocal, aten.neg, aten.abs,
    aten.sign, aten.floor, aten.ceil, aten.round, aten.erf, aten.sigmoid,
    aten.relu, aten.silu, aten.gelu, aten.gelu_backward,
    aten.tanh_backward, aten.sigmoid_backward, aten.silu_backward,
    aten.threshold_backward, aten.clamp, aten.clamp_min, aten.clamp_max,
    aten.masked_fill, aten.square, aten.isfinite, aten.isnan,
    aten.clone, aten.detach, aten.alias, aten.lift_fresh_copy,
    aten._to_copy, aten.ones_like, aten.zeros_like, aten.full_like,
    aten.empty_like, aten.fill, aten.copy, aten.native_dropout_backward,
]


@register_preset(*_ELEMENTWISE)
def _elementwise_rule(node, world_size):
    """Each output dim is one group.  Inputs broadcast numpy-style
    (aligned right); a size-1 or missing dim rides along replicated."""
    avals = _inputs(node)
    out = _out(node)
    if not isinstance(out, torch.Tensor):
        return None
    rank = out.ndim
    if not avals:
        return {"space": ShardSpace([]), "recombines": {}}
    table = []
    for a in avals:
        if a.ndim > rank:
            return None
        off = rank - a.ndim
        row = []
        for j in range(a.ndim):
            d = off + j
            if a.shape[j] not in (1, out.shape[d]):
                return None
            row.append(DimSharding(group=d + 1)
                       if a.shape[j] == out.shape[d] != 1 else DimSharding())
        table.append(row)
    # number the live groups 1..k (an output dim of size 1 has none)
    live = sorted({d.group for row in table for d in row if d.group > 0})
    renum = {g: i for i, g in enumerate(live, start=1)}
    for row in table:
        for j, d in enumerate(row):
            if d.group > 0:
                row[j] = DimSharding(group=renum[d.group])
    return {"space": ShardSpace(table),
            "recombines": {renum[g]: _concat(g - 1) for g in live}}


# ------------------------------------------------------------------ matmul

@register_preset(aten.mm, aten.bmm)
def _matmul_rule(node, world_size):
    """[b,] m, k x [b,] k, n: batch and free dims concat, k reduces."""
    lhs, rhs = _inputs(node)
    batch = lhs.ndim - 2
    lrow, rrow = _rows([lhs, rhs])
    recombines, g = {}, 1
    if batch:
        lrow[0] = rrow[0] = DimSharding(group=g)
        recombines[g] = _concat(0)
        g += 1
    lrow[batch] = DimSharding(group=g)
    recombines[g] = _concat(batch)
    g += 1
    lrow[batch + 1] = rrow[batch] = DimSharding(group=g)
    recombines[g] = _reduce()
    g += 1
    rrow[batch + 1] = DimSharding(group=g)
    recombines[g] = _concat(batch + 1)
    return {"space": ShardSpace([lrow, rrow]), "recombines": recombines}


@register_preset(aten.addmm)
def _addmm_rule(node, world_size):
    """bias + a @ b: m and n concat (the bias rides n, or m and n when it
    is 2-D).  No k group: each shard would add the whole bias to its
    partial product (the zero probe of `MetaOp` rejects it)."""
    bias, lhs, rhs = _inputs(node)
    brow, lrow, rrow = _rows([bias, lhs, rhs])
    out = _out(node)
    lrow[0] = DimSharding(group=1)
    rrow[1] = DimSharding(group=2)
    off = 2 - bias.ndim
    for j in range(bias.ndim):
        if bias.shape[j] == out.shape[off + j] != 1:
            brow[j] = DimSharding(group=off + j + 1)
    return {"space": ShardSpace([brow, lrow, rrow]),
            "recombines": {1: _concat(0), 2: _concat(1)}}


# --------------------------------------------------------- layout changes

def _permute_rule(node, perm):
    (a,) = _inputs(node)
    row = [DimSharding() for _ in range(a.ndim)]
    recombines, g = {}, 1
    for out_dim, in_dim in enumerate(perm):
        if a.shape[in_dim] != 1:
            row[in_dim] = DimSharding(group=g)
            recombines[g] = _concat(out_dim)
            g += 1
    return {"space": ShardSpace([row]), "recombines": recombines}


@register_preset(aten.t, aten.transpose, aten.permute)
def _transpose_rule(node, world_size):
    (a,) = _inputs(node)
    rank = a.ndim
    perm = list(range(rank))
    if node.target.overloadpacket is aten.permute:
        perm = [_norm(d, rank) for d in node.args[1]]
    elif rank == 2 or node.target.overloadpacket is aten.transpose:
        d0, d1 = ((0, 1) if node.target.overloadpacket is aten.t
                  else (_norm(node.args[1], rank), _norm(node.args[2], rank)))
        perm[d0], perm[d1] = perm[d1], perm[d0]
    return _permute_rule(node, perm)


@register_preset(aten.expand)
def _expand_rule(node, world_size):
    """Input dims align right; only dims kept at their size shard (a
    stretched size-1 dim cannot)."""
    (a,) = _inputs(node)
    out = _out(node)
    off = out.ndim - a.ndim
    row = [DimSharding() for _ in range(a.ndim)]
    recombines, g = {}, 1
    for j in range(a.ndim):
        if a.shape[j] == out.shape[off + j] != 1:
            row[j] = DimSharding(group=g)
            recombines[g] = _concat(off + j)
            g += 1
    return {"space": ShardSpace([row]), "recombines": recombines}


def _dim_map_rule(node, in_to_out):
    (a,) = _inputs(node)
    row = [DimSharding() for _ in range(a.ndim)]
    recombines, g = {}, 1
    for i, o in in_to_out.items():
        if a.shape[i] != 1:
            row[i] = DimSharding(group=g)
            recombines[g] = _concat(o)
            g += 1
    return {"space": ShardSpace([row]), "recombines": recombines}


@register_preset(aten.squeeze)
def _squeeze_rule(node, world_size):
    (a,) = _inputs(node)
    out = _out(node)
    if len(node.args) > 1:
        dims = node.args[1]
        if not isinstance(dims, (list, tuple)):
            dims = [dims]
        dims = {_norm(d, a.ndim) for d in dims}
        dims = {d for d in dims if a.shape[d] == 1}
    else:
        dims = {d for d in range(a.ndim) if a.shape[d] == 1}
    kept = [d for d in range(a.ndim) if d not in dims]
    if len(kept) != out.ndim:
        return None
    return _dim_map_rule(node, {d: o for o, d in enumerate(kept)})


@register_preset(aten.unsqueeze)
def _unsqueeze_rule(node, world_size):
    (a,) = _inputs(node)
    d = _norm(node.args[1], a.ndim + 1)
    return _dim_map_rule(node, {i: (i if i < d else i + 1)
                                for i in range(a.ndim)})


@register_preset(aten.view, aten._unsafe_view, aten.reshape)
def _view_rule(node, world_size):
    (a,) = _inputs(node)
    rule = view_rule(list(a.shape), list(_out(node).shape),
                     world_size=world_size)
    return {"space": rule["space"], "recombines": rule["recombines"]}


# -------------------------------------------------------------- reductions

def _reduce_dims(node, rank):
    dims = _arg(node, 1, "dim")
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return set(range(rank))
    if isinstance(dims, int):
        dims = [dims]
    return {_norm(d, rank) for d in dims}


_REDUCTIONS = {"sum": Reduction.SUM, "mean": Reduction.AVG,
               "amax": Reduction.MAX, "amin": Reduction.MIN}


@register_preset(aten.sum, aten.mean, aten.amax, aten.amin, aten.var)
def _reduction_rule(node, world_size):
    """Kept dims concat; a reduced dim gives a partial of the op's
    reduction (sum, mean as an average of equal shards, max, min).  A
    variance's reduced dims do not shard."""
    (a,) = _inputs(node)
    name = node.target.overloadpacket.__name__
    if node.target in (aten.sum.default, aten.mean.default):
        dims, keep = set(range(a.ndim)), False
    else:
        dims = _reduce_dims(node, a.ndim)
        keep = bool(node.kwargs.get("keepdim", node.args[3])
                    if name == "var" and len(node.args) > 3
                    else node.kwargs.get("keepdim", False) if name == "var"
                    else _arg(node, 2, "keepdim", False))
    row = [DimSharding() for _ in range(a.ndim)]
    recombines, g, out_dim = {}, 1, 0
    for d in range(a.ndim):
        if d in dims:
            if name != "var" and a.shape[d] != 1:
                row[d] = DimSharding(group=g)
                recombines[g] = _reduce(_REDUCTIONS[name])
                g += 1
            out_dim += keep
            continue
        if a.shape[d] != 1:
            row[d] = DimSharding(group=g)
            recombines[g] = _concat(out_dim)
            g += 1
        out_dim += 1
    return {"space": ShardSpace([row]), "recombines": recombines}


@register_preset(aten._softmax, aten._log_softmax,
                 aten._softmax_backward_data, aten._log_softmax_backward_data)
def _softmax_rule(node, world_size):
    """Every dim but the normalized one shards, on all tensor inputs."""
    avals = _inputs(node)
    rank = avals[0].ndim
    dim = _norm(node.args[1] if len(avals) == 1 else node.args[2], rank)
    table = _rows(avals)
    recombines, g = {}, 1
    for d in range(rank):
        if d == dim or avals[0].shape[d] == 1:
            continue
        for row in table:
            row[d] = DimSharding(group=g)
        recombines[g] = _concat(d)
        g += 1
    return {"space": ShardSpace(table), "recombines": recombines}


# ---------------------------------------------------------- split & concat

@register_preset(aten.split, aten.split_with_sizes)
def _split_rule(node, world_size):
    (a,) = _inputs(node)
    dim = _norm(_arg(node, 2, "dim", 0), a.ndim)
    n_out = len(_out(node))
    row = [DimSharding() for _ in range(a.ndim)]
    recombines, g = {}, 1
    for d in range(a.ndim):
        if d == dim or a.shape[d] == 1:
            continue
        row[d] = DimSharding(group=g)
        recombines[g] = [_concat(d)] * n_out
        g += 1
    return {"space": ShardSpace([row]), "recombines": recombines}


@register_preset(aten.cat)
def _cat_rule(node, world_size):
    avals = _inputs(node)
    rank = _out(node).ndim
    if any(a.ndim != rank for a in avals):
        return None
    dim = _norm(_arg(node, 1, "dim", 0), rank)
    table = _rows(avals)
    recombines, g = {}, 1
    for d in range(rank):
        if d == dim or _out(node).shape[d] == 1:
            continue
        for row in table:
            row[d] = DimSharding(group=g)
        recombines[g] = _concat(d)
        g += 1
    return {"space": ShardSpace(table), "recombines": recombines}


# -------------------------------------------------------- gather / scatter

@register_preset(aten.gather)
def _gather_rule(node, world_size):
    """Dims other than the gathered one shard input and index together
    where their sizes agree."""
    src, idx = _inputs(node)
    dim = _norm(node.args[1], src.ndim)
    srow, irow = _rows([src, idx])
    recombines, g = {}, 1
    for d in range(src.ndim):
        if d == dim or src.shape[d] != idx.shape[d] or src.shape[d] == 1:
            continue
        srow[d] = irow[d] = DimSharding(group=g)
        recombines[g] = _concat(d)
        g += 1
    return {"space": ShardSpace([srow, irow]), "recombines": recombines}


@register_preset(aten.scatter_add, aten.scatter)
def _scatter_add_rule(node, world_size):
    """Dims other than the scattered one shard self, index and src
    together where their sizes agree."""
    avals = _inputs(node)
    dim = _norm(node.args[1], avals[0].ndim)
    table = _rows(avals)
    recombines, g = {}, 1
    for d in range(avals[0].ndim):
        if d == dim or avals[0].shape[d] == 1 \
                or any(a.ndim != avals[0].ndim
                       or a.shape[d] != avals[0].shape[d] for a in avals):
            continue
        for row in table:
            row[d] = DimSharding(group=g)
        recombines[g] = _concat(d)
        g += 1
    return {"space": ShardSpace(table), "recombines": recombines}


def _leading_index(node):
    """The one index tensor of `x[idx]` (aten.index / index_put with a
    single tensor at position 0), else None."""
    indices = node.args[1]
    if len(indices) != 1 or indices[0] is None:
        return None
    return indices[0].meta["val"]


@register_preset(aten.index)
def _index_rule(node, world_size):
    """x[idx] (an embedding lookup): idx's dims concat at the leading
    output dims, x's kept dims after them; the indexed dim never shards."""
    if _leading_index(node) is None:
        return None
    src, idx = _inputs(node)
    srow, irow = _rows([src, idx])
    recombines, g = {}, 1
    for i in range(idx.ndim):
        irow[i] = DimSharding(group=g)
        recombines[g] = _concat(i)
        g += 1
    for j in range(1, src.ndim):
        srow[j] = DimSharding(group=g)
        recombines[g] = _concat(idx.ndim + j - 1)
        g += 1
    return {"space": ShardSpace([srow, irow]), "recombines": recombines}


_ZERO_MAKERS = ("aten.zeros", "aten.new_zeros", "aten.zeros_like")


def _is_zeros(arg) -> bool:
    t = getattr(arg, "target", None)
    return t is not None and _key(getattr(t, "overloadpacket", t)) \
        in _ZERO_MAKERS


@register_preset(aten.index_put)
def _index_put_rule(node, world_size):
    """self[idx] += values (accumulate) over a zero `self`, the embedding
    gradient: idx's dims shard idx and values and the output is a partial
    sum; self's kept dims shard with values' trailing dims (concat).  The
    partial holds only where `self` is zeros, which the rule reads from
    the graph, so a probe on a random self cannot check it
    (`_CROSSCHECK_SKIP`)."""
    idx = _leading_index(node)
    accumulate = bool(_arg(node, 3, "accumulate", False))
    if idx is None:
        return None
    dst, idx, vals = _inputs(node)
    if vals.ndim != idx.ndim + dst.ndim - 1:
        return None
    drow, irow, vrow = _rows([dst, idx, vals])
    recombines, g = {}, 1
    if accumulate and _is_zeros(node.args[0]):
        for i in range(idx.ndim):
            irow[i] = vrow[i] = DimSharding(group=g)
        recombines[g] = _reduce()
        g += 1
    for j in range(1, dst.ndim):
        if vals.shape[idx.ndim + j - 1] == dst.shape[j] != 1:
            drow[j] = vrow[idx.ndim + j - 1] = DimSharding(group=g)
            recombines[g] = _concat(j)
            g += 1
    return {"space": ShardSpace([drow, irow, vrow]), "recombines": recombines}


@register_preset(aten.embedding)
def _embedding_rule(node, world_size):
    weight, idx = _inputs(node)
    wrow, irow = _rows([weight, idx])
    recombines, g = {}, 1
    for i in range(idx.ndim):
        irow[i] = DimSharding(group=g)
        recombines[g] = _concat(i)
        g += 1
    wrow[1] = DimSharding(group=g)
    recombines[g] = _concat(idx.ndim)
    return {"space": ShardSpace([wrow, irow]), "recombines": recombines}


@register_preset(aten.embedding_dense_backward)
def _embedding_backward_rule(node, world_size):
    """The table's gradient from zeros: idx's dims shard idx and grad
    (partial sum), grad's last dim shards the table's columns."""
    grad, idx = _inputs(node)
    grow, irow = _rows([grad, idx])
    for i in range(idx.ndim):
        grow[i] = irow[i] = DimSharding(group=1)
    grow[-1] = DimSharding(group=2)
    return {"space": ShardSpace([grow, irow]),
            "recombines": {1: _reduce(), 2: _concat(1)}}


# ------------------------------------------------------------ create ops

@register_preset(aten.zeros, aten.ones, aten.empty, aten.full, aten.arange,
                 aten.scalar_tensor, aten.new_zeros, aten.new_ones,
                 aten.new_empty, aten.new_full, aten.empty_strided,
                 aten.new_empty_strided)
def _create_rule(node, world_size):
    """Nothing to shard: the output is made whole (a consumer that wants
    a shard takes it locally)."""
    return _replicated(node)


@register_preset(aten.bernoulli, aten.bernoulli_, aten.rand, aten.rand_like,
                 aten.randn, aten.randn_like, aten.randint,
                 aten.randint_like, aten.randperm, aten.native_dropout,
                 aten.normal, aten.uniform, aten.uniform_, aten.normal_)
def _random_rule(node, world_size):
    """Random draws stay REPLICATED: every rank draws the whole tensor from
    a generator in the same state, in the one-device program's order, so
    the values equal the one-device draw and a consumer that wants a
    shard slices it locally.  A draw of the shard alone would give each
    rank other numbers (a generator's stream is sequential)."""
    return _replicated(node)


# ------------------------------------------------- torch's own attention

@register_preset(aten._scaled_dot_product_flash_attention_for_cpu,
                 aten._scaled_dot_product_flash_attention_for_cpu_backward)
def _sdpa_rule(node, world_size):
    """The CPU SDPA forward ((out, logsumexp) of q, k, v) and backward
    ((dq, dk, dv)): batch and head dims shard every tensor input and
    output together.  A probe would shard some inputs and not others,
    and the CPU kernels read such inconsistent shapes past their
    buffers, so the rule is analytic."""
    avals = _inputs(node)
    if any(a.ndim < 3 for a in avals):
        return None
    b, h = avals[0].shape[:2]
    table = _rows(avals)
    recombines, g = {}, 1
    n_out = len(_out(node))
    for d, size in ((0, b), (1, h)):
        if size == 1:
            continue
        for row, a in zip(table, avals):
            if a.ndim > d and a.shape[d] == size:
                row[d] = DimSharding(group=g)
        recombines[g] = [_concat(d)] * n_out
        g += 1
    return {"space": ShardSpace(table), "recombines": recombines}


@register_preset(aten._scaled_dot_product_efficient_attention,
                 aten._scaled_dot_product_efficient_attention_backward,
                 aten._scaled_dot_product_flash_attention,
                 aten._scaled_dot_product_flash_attention_backward,
                 aten._scaled_dot_product_cudnn_attention,
                 aten._scaled_dot_product_cudnn_attention_backward)
def _sdpa_card_rule(node, world_size):
    """The card's SDPA ops also return RNG seeds and sizes beside the
    tensors: they stay replicated, and no probe runs them."""
    return _replicated(node)


# ----------------------------------------------------------- convolutions

def _plain_conv(node, transposed_at: int, groups_at: int) -> bool:
    """A 2-D-or-more, untransposed, ungrouped convolution: the forms the
    rules below describe."""
    return (not _arg(node, transposed_at, "transposed", False)
            and _arg(node, groups_at, "groups", 1) == 1)


@register_preset(aten.convolution)
def _conv_rule(node, world_size):
    """input [N, C, ...] * weight [O, C, ...] (+ bias [O]): the batch dim
    and the output channels concat; the input channels reduce, when there
    is no bias (each shard would add it).  Spatial dims need halos and
    are not sharded.  Other forms (transposed, grouped) stay replicated:
    a probe of a convolution's operands at shapes that do not agree reads
    past their buffers on the card, so no probe runs it."""
    avals = _inputs(node)
    if not _plain_conv(node, 6, 8) or len(avals) not in (2, 3):
        return _replicated(node)
    table = _rows(avals)
    table[0][0] = DimSharding(group=1)
    table[1][0] = DimSharding(group=2)
    recombines = {1: _concat(0), 2: _concat(1)}
    if len(avals) == 3:
        table[2][0] = DimSharding(group=2)
    else:
        table[0][1] = table[1][1] = DimSharding(group=3)
        recombines[3] = _reduce()
    return {"space": ShardSpace(table), "recombines": recombines}


@register_preset(aten.convolution_backward)
def _conv_backward_rule(node, world_size):
    """(grad_input, grad_weight, grad_bias) of grad_out [N, O, ...], input
    [N, C, ...], weight [O, C, ...]: the batch dim concats grad_input and
    sums the weight's and bias's gradients; the output channels sum
    grad_input and concat the others; the input channels concat
    grad_input and grad_weight and leave grad_bias whole.  Other forms
    stay replicated (no probe runs a convolution, see `_conv_rule`)."""
    avals = _inputs(node)
    if not _plain_conv(node, 7, 9) or len(avals) != 3:
        return _replicated(node)
    live = [v is not None for v in _out(node)]
    table = _rows(avals)
    table[0][0] = table[1][0] = DimSharding(group=1)
    table[0][1] = table[2][0] = DimSharding(group=2)
    table[1][1] = table[2][1] = DimSharding(group=3)
    per_out = {1: (_concat(0), _reduce(), _reduce()),
               2: (_reduce(), _concat(0), _concat(0)),
               3: (_concat(1), _concat(1), Recombine.identity)}
    return {"space": ShardSpace(table),
            "recombines": {g: [f for f, on in zip(fns, live) if on]
                           for g, fns in per_out.items()}}


# ------------------------------------------------------ the port's kernels

@register_preset(torch.ops.easydist_tpu_torch.flash_fwd,
                 torch.ops.easydist_tpu_torch.flash_bwd_dq,
                 torch.ops.easydist_tpu_torch.flash_bwd_dkv)
def _kernel_rule(node, world_size):
    """The attention kernels stay REPLICATED under the solver, as the JAX
    package replicates every Pallas call (`jaxfront/presets.py:701-717`):
    a probe of shard-sized operands cannot stand for the kernel's own
    batch/head/sequence strategies, which come with the attention
    composite of the parallel modes."""
    return _replicated(node)


# ------------------------------------------------------- the sharding pin

@register_preset(torch.ops.easydist_tpu_torch.fix_sharding)
def _fix_sharding_rule(node, world_size):
    """A `fix_sharding` pin passes through the solver as a freely
    shardable identity; the frontend restricts its pool to the pinned
    placement per axis (`api._apply_user_pins`)."""
    (a,) = _inputs(node)
    row = [DimSharding() for _ in range(a.ndim)]
    live = [d for d in range(a.ndim) if a.shape[d] != 1]
    for g, d in enumerate(live, start=1):
        row[d] = DimSharding(group=g)
    return {"space": ShardSpace([row]),
            "recombines": {g: _concat(d) for g, d in enumerate(live, start=1)}}


@register_preset(torch.ops.easydist_tpu_torch.scoped_call)
def _scoped_call_rule(node, world_size):
    """A `scoped_region` is solved on its own mesh: in the outer solve its
    operands and results are replicated (no probe runs the region)."""
    return _replicated(node)


# ---------------------------------------------------- attention composite

def _attention_strategies(node, world_size, backward):
    """Explicit strategy pool of `ed_attention_fwd` / `_bwd` (the port of
    jaxfront/presets.py:733-795).  Rows: fwd (q, k, v) / bwd (q, k, v,
    dout), all [b, h, t, d].  Batch and head sharding are
    communication-free; sequence sharding is priced as the cheaper of
    ring and Ulysses as its intrinsic cost, the winner in the strategy's
    meta for emission."""
    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.metashard.metair import Placement
    from easydist_tpu_torch.ops.attention_prim import seq_strategy_costs

    q = _inputs(node)[0]
    b, h, t, d = q.shape
    n_in = 4 if backward else 3
    n_out = 3 if backward else 1
    dtype_bytes = q.element_size()

    def strat(dim):
        return ([Placement.shard(dim)] * n_in, [Placement.shard(dim)] * n_out)

    # tensor-core bound compute proxy: two products of 2 b h t^2 d FLOPs
    # (the backward does ~2.5x)
    flops = 4.0 * b * h * float(t) * t * d * (2.5 if backward else 1.0)
    full_compute = flops / edconfig.peak_flops
    shard_compute = full_compute / world_size

    strategies = []
    if b % world_size == 0:
        strategies.append((*strat(0), 0.0, shard_compute, None))
    if h % world_size == 0:
        strategies.append((*strat(1), 0.0, shard_compute, None))
    if t % world_size == 0 and world_size > 1:
        ring, ulysses = seq_strategy_costs((b, h, t, d), dtype_bytes,
                                           world_size, backward)
        # Ulysses needs head divisibility for its head-sharded compute
        if h % world_size == 0 and ulysses < ring:
            cost, variant = ulysses, "ulysses"
        else:
            cost, variant = ring, "ring"
        strategies.append((*strat(2), cost, shard_compute,
                           {"variant": variant}))
    if not strategies:
        return None
    return {"space": None, "recombines": {}, "strategies": strategies,
            "compute": full_compute}


@register_preset(torch.ops.easydist_tpu_torch.ed_attention_fwd)
def _attention_fwd_rule(node, world_size):
    return _attention_strategies(node, world_size, backward=False)


@register_preset(torch.ops.easydist_tpu_torch.ed_attention_bwd)
def _attention_bwd_rule(node, world_size):
    return _attention_strategies(node, world_size, backward=True)
