"""FX graph -> MetaGraph bridge: the port of easydist_tpu/jaxfront/bridge.py
(reference: easydist/torch's `torch2meta_graph`).

Each call node becomes one MetaNode named after the FX node; every
placeholder becomes an input node whose space comes from the view rule
on its own shape (any dim shardable, concat).  `getitem` of a
multi-output node (split, the kernels' (o, lse)) is folded: its consumers
read the producer's i-th outvar directly.  Constant tensors (`get_attr`)
are inputs that stay replicated.

`var_shapes` lets the frontend pre-shrink shapes already sharded on
earlier-solved mesh axes.  A preset's explicit "strategies" (the
attention composite's) become the node's whole pool, with their
intrinsic and compute seconds and emission meta; its "compute" is the
node's full compute proxy.
"""

from __future__ import annotations

import math
import operator
from typing import Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch.metashard import ShardSpace, view_rule
from easydist_tpu_torch.metashard.metair import (MetaGraph, MetaNode, MetaVar,
                                                 NodeStrategy)
from .interpreter import (VarNames, node_signature, node_tensor_inputs,
                          target_name)

aten = torch.ops.aten
_MATMULS = {aten.mm.default, aten.addmm.default, aten.bmm.default}


def node_flops(node) -> float:
    """Exact FLOPs of mm / addmm / bmm from their shapes, else the output
    numel (the replication accounting's proxy)."""
    out = node.meta.get("val")
    if node.target in _MATMULS:
        lhs = node_tensor_inputs(node)[-2].meta["val"]
        return 2.0 * math.prod(out.shape) * lhs.shape[-1]
    return float(sum(v.numel() for v in pytree.tree_leaves(out)
                     if isinstance(v, torch.Tensor)))


def _dtype(val) -> str:
    return str(val.dtype).removeprefix("torch.")


def _explicit(strategies):
    """A preset's whole-node strategies, (ins, outs, intrinsic cost[,
    compute seconds[, emission meta]]) each, as NodeStrategies (reference
    jaxfront/bridge.py:140-153)."""
    out = []
    for ins, outs, cost, *rest in strategies:
        s = NodeStrategy(ins, outs)
        s.intrinsic_cost = float(cost)
        if rest and rest[0] is not None:
            s.compute_cost = float(rest[0])
        if len(rest) > 1 and rest[1]:
            s.meta = dict(rest[1])
        out.append(s)
    return out


def fx_to_metagraph(gm: torch.fx.GraphModule, rules: Dict[str, dict],
                    shape_info: Dict[str, Tuple], world_size: int,
                    names: Optional[VarNames] = None,
                    var_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                    state_io: Optional[Dict[str, str]] = None) -> MetaGraph:
    """Build the MetaGraph of `gm`.  `state_io` maps the FX name of an
    output value to the name of the input placeholder it updates."""
    names = names or VarNames()
    var_shapes = var_shapes or {}
    graph = MetaGraph()
    mvars: Dict[str, MetaVar] = {}

    def new_var(name: str, val) -> MetaVar:
        shape = tuple(shape_info.get(name, (tuple(val.shape),))[0])
        mv = MetaVar(name, var_shapes.get(name, shape), _dtype(val))
        mvars[name] = mv
        return mv

    for node in gm.graph.nodes:
        val = node.meta.get("val")
        if node.op in ("placeholder", "get_attr"):
            if not isinstance(val, torch.Tensor):
                continue
            mv = new_var(names.name(node), val)
            if node.op == "placeholder":
                rule = view_rule(list(mv.shape), list(mv.shape),
                                 world_size=world_size)
            else:
                rule = {"space": ShardSpace.for_tensors([val]),
                        "recombines": {}}
            graph.add_input(MetaNode(
                name=mv.name, op_key=node.op, invars=[], outvars=[mv],
                space=rule["space"], recombines=rule["recombines"],
                is_input=True))
        elif node.op == "call_function":
            if node.target is operator.getitem:
                src, idx = node.args
                folded = mvars.get(names.name(src, idx))
                if folded is not None:
                    mvars[names.name(node)] = folded
                continue
            sig = node_signature(node)
            rule = rules.get(sig, {"space": None, "recombines": {}})
            invars = [mvars[names.name(a)] for a in node_tensor_inputs(node)]
            if isinstance(val, torch.Tensor):
                outvars = [new_var(names.name(node), val)]
            else:
                outvars = [new_var(names.name(node, i), v)
                           if isinstance(v, torch.Tensor) else None
                           for i, v in enumerate(val)]
            mnode = MetaNode(name=names.name(node),
                             op_key=target_name(node.target), invars=invars,
                             outvars=outvars, space=rule["space"],
                             recombines=rule["recombines"], sig=sig)
            if node.target in _MATMULS:
                mnode.flops = node_flops(node)
            if rule.get("compute") is not None:
                mnode.compute_proxy = float(rule["compute"])
            if rule.get("strategies") is not None:
                mnode.explicit_strategies = _explicit(rule["strategies"])
            graph.add_op(mnode)
        elif node.op == "output":
            for a in pytree.tree_leaves(node.args):
                if isinstance(a, torch.fx.Node) and names.name(a) in mvars:
                    graph.outputs.append(mvars[names.name(a)])

    if state_io:
        placeholders = {n.name: n for n in graph.inputs}
        for out_name, in_name in state_io.items():
            if out_name in mvars and in_name in placeholders:
                # a folded getitem names its producer's outvar
                graph.state_io[mvars[out_name].name] = placeholders[in_name]
    return graph
