"""FX sharding interpreter: give every aten node of a traced step a rule.

The port of easydist_tpu/jaxfront/interpreter.py over `make_fx` graphs.
Each call node resolves, once per signature, by analytic preset ->
propagation group -> persistent rule cache -> ShardCombine discovery
(`MetaOp` on random concrete inputs on `config.discovery_device`).
Views are handled analytically (`view_rule`).  Shapes come from the
fake tensors `make_fx` leaves in `node.meta["val"]`; nothing of the
step runs.

`make_fx` unrolls control flow, so the JAX interpreter's composite,
scan, cond and while discovery has no counterpart here (the reference's
own torch path unrolls the same way, easydist/torch/compile.py:78-83).
`getitem` of a multi-output node carries no rule of its own: the bridge
folds it into its producer.
"""

from __future__ import annotations

import logging
import operator
import time
import zlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.metashard import MetaOp, ShardSpace, view_rule
from easydist_tpu_torch.metashard.metaop import probe_calls

logger = logging.getLogger(__name__)

aten = torch.ops.aten

# targets whose rule is computed analytically, not by execution
_VIEW_TARGETS = {aten.view.default, aten._unsafe_view.default,
                 aten.reshape.default}

# presets the execution harness cannot cross-check (`_crosscheck_preset`):
#   view / _unsafe_view / reshape / expand: the target shape is an
#     absolute argument, so a shard-sized rebind raises; view_rule and the
#     expand rule are analytic by construction;
#   index_put: its partial-sum group holds only for a zero `self`, which
#     the rule reads from the graph and a random probe input cannot show;
#   creation ops and the attention kernels: replicate-only rules, nothing
#     to execute (the kernels' shard-sized rebind is not their strategy).
_CROSSCHECK_SKIP = {
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand",
    "aten.index_put", "aten.zeros", "aten.ones", "aten.empty",
    "aten.full", "aten.arange", "aten.scalar_tensor", "aten.new_zeros",
    "aten.new_ones", "aten.new_empty", "aten.new_full",
    "easydist_tpu_torch.flash_fwd", "easydist_tpu_torch.flash_bwd_dq",
    "easydist_tpu_torch.flash_bwd_dkv",
}


def target_name(target) -> str:
    """"aten.add" for every overload of add (the packet's name)."""
    return str(getattr(target, "overloadpacket", target))


def _is_tensor_node(a) -> bool:
    return isinstance(a, torch.fx.Node) \
        and isinstance(a.meta.get("val"), torch.Tensor)


def node_leaves(node) -> list:
    """Flat (args, kwargs) leaves of a call node, in the order `MetaOp`
    flattens its arguments (tensor rows follow this order)."""
    return pytree.tree_leaves((tuple(node.args), dict(node.kwargs)))


def node_tensor_inputs(node) -> List[torch.fx.Node]:
    """The tensor-valued input nodes of `node`, one per discovery row."""
    return [a for a in node_leaves(node) if _is_tensor_node(a)]


def _recombine_matches(expected, got) -> bool:
    """A preset recombine (functools.partial over Recombine.*) against
    what execution discovery matched, up to default halo/block."""
    if expected is None or got is None:
        return expected is None and got is None
    if isinstance(expected, list) or isinstance(got, list):
        if not isinstance(expected, list) or not isinstance(got, list) \
                or len(expected) != len(got):
            return False
        return all(_recombine_matches(e, g) for e, g in zip(expected, got))

    def norm(fn):
        kw = dict(getattr(fn, "keywords", {}) or {})
        if kw.get("halo") == 0:
            del kw["halo"]
        if kw.get("block") == 1:
            del kw["block"]
        return getattr(getattr(fn, "func", None), "__name__", None), kw

    return norm(expected) == norm(got)


class VarNames:
    """Stable names for graph values: an FX node's own name, and
    "<name>.<i>" for the i-th tensor of a multi-output node."""

    @staticmethod
    def name(node, index: Optional[int] = None) -> str:
        return node.name if index is None else f"{node.name}.{index}"


def hash_tensor_bytes(t: torch.Tensor) -> str:
    """Content digest of a tensor's bytes, for constants whose VALUES
    (not only shapes) must feed a cache key."""
    import hashlib

    data = t.detach().cpu().contiguous().view(torch.uint8).numpy()
    return hashlib.sha256(data.tobytes()).hexdigest()[:16]


def _leaf_repr(a) -> str:
    if _is_tensor_node(a):
        v = a.meta["val"]
        return f"{str(v.dtype).removeprefix('torch.')}{list(v.shape)}"
    if isinstance(a, torch.fx.Node):
        return f"node:{a.op}"
    if isinstance(a, torch.Tensor):
        if a.numel() > 1:
            return (f"lit:{str(a.dtype).removeprefix('torch.')}"
                    f"{list(a.shape)}:{hash_tensor_bytes(a)}")
        return f"lit:{a.item()!r}"
    return repr(a)


def node_signature(node) -> str:
    """Cache key of a call node: target + input shapes/dtypes + the
    non-tensor arguments (the counterpart of `eqn_signature`)."""
    parts = [_leaf_repr(a) for a in node_leaves(node)]
    return f"{node.target}|{';'.join(parts)}"


def _materialize(shape, dtype, generator, device):
    """Random concrete tensor for a fake one: floats uniform in [0.5, 1.5]
    (strictly positive, so contractions do not cancel toward zero and a
    valid reduce candidate is never rejected by chance), integers in
    [1, 8), booleans fair coins."""
    if dtype.is_floating_point:
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device) + 0.5
    if dtype == torch.bool:
        return torch.rand(shape, generator=generator,
                          device=device) < 0.5
    return torch.randint(1, 8, shape, generator=generator, dtype=dtype,
                         device=device)


class ShardingAnalyzer:
    """Discover a sharding rule for every call node of a GraphModule."""

    def __init__(self, gm: torch.fx.GraphModule, world_size: int,
                 seed: int = 42):
        from .discovery import DiscoveryCounters, get_cache

        self.gm = gm
        self.world_size = world_size
        self.names = VarNames()
        self.seed = seed
        self._node_seed = seed
        self._draws = 0
        # node signature -> {"space": ShardSpace, "recombines": {...}}
        self.rules: Dict[str, dict] = {}
        # target -> first discovered space (prompt for other shapes)
        self.prompts: Dict[str, ShardSpace] = {}
        self.shape_info: Dict[str, Tuple[Tuple[int, ...], str]] = {}
        # propagation groups: canonical signature -> (rule, row shapes,
        # representative signature)
        self.canon_rules: Dict[str, tuple] = {}
        self.counters = DiscoveryCounters()
        # signatures whose discovery failed and that were replicated
        self.replicated_on_failure: List[str] = []
        self._dcache = get_cache()
        self._last_discovery_failed = False

    # ------------------------------------------------------- probe inputs
    def _generator(self, device) -> torch.Generator:
        """Generator for the next probe input, seeded by (base seed, crc32
        of the node's signature, draw index): an op's probe inputs do not
        depend on which earlier nodes were served by a preset, a group or
        the cache."""
        g = torch.Generator(device=device)
        g.manual_seed((self._node_seed * 1_000_003 + self._draws)
                      % (2 ** 63))
        self._draws += 1
        return g

    def _device_for(self, node) -> torch.device:
        """`config.discovery_device`, except that an op with integer
        inputs (an index) is probed on the CPU: a random index out of
        range raises there, where on the card it is a device-side assert
        that ends the process."""
        dev = torch.device(edconfig.discovery_device)
        if dev.type != "cpu" and any(
                not (n.meta["val"].dtype.is_floating_point)
                for n in node_tensor_inputs(node)):
            return torch.device("cpu")
        return dev

    def _concrete_args(self, node, shapes: Optional[Dict[int, int]] = None):
        """(args, kwargs) of `node` with every tensor input replaced by a
        random concrete tensor (sizes mapped through `shapes`)."""
        dev = self._device_for(node)

        def conc(a):
            if _is_tensor_node(a):
                v = a.meta["val"]
                shape = tuple(shapes.get(d, d) for d in v.shape) \
                    if shapes else tuple(v.shape)
                return _materialize(shape, v.dtype, self._generator(dev),
                                    dev)
            if isinstance(a, torch.fx.Node):
                raise RuntimeError(f"non-tensor node input {a}")
            if isinstance(a, torch.device):
                return dev
            return a

        leaves, spec = pytree.tree_flatten((tuple(node.args),
                                            dict(node.kwargs)))
        return pytree.tree_unflatten([conc(a) for a in leaves], spec)

    # ---------------------------------------------------------------- run
    def run(self) -> Tuple[Dict[str, dict], Dict[str, Tuple]]:
        t0 = time.perf_counter()
        p0 = probe_calls()
        for node in self.gm.graph.nodes:
            val = node.meta.get("val")
            if isinstance(val, torch.Tensor):
                self.shape_info[node.name] = (
                    tuple(val.shape), str(val.dtype).removeprefix("torch."))
            elif isinstance(val, (tuple, list)):
                for i, v in enumerate(val):
                    if isinstance(v, torch.Tensor):
                        self.shape_info[VarNames.name(node, i)] = (
                            tuple(v.shape),
                            str(v.dtype).removeprefix("torch."))
            if node.op != "call_function" or node.target is operator.getitem:
                continue
            sig = node_signature(node)
            if sig not in self.rules:
                self._node_seed = (self.seed * 1_000_003
                                   + zlib.crc32(sig.encode()))
                self._draws = 0
                self.rules[sig] = self._lookup_or_discover(node, sig)
        self._finish(time.perf_counter() - t0, probe_calls() - p0)
        return self.rules, self.shape_info

    def _finish(self, elapsed: float, probes: int) -> None:
        c = self.counters
        c.discovery_seconds += elapsed
        c.probes_compiled += probes
        c.groups = len(self.canon_rules)
        if self._dcache is not None:
            self._dcache.flush()
        logger.info(
            "[discovery] %d signatures: %d preset, %d grouped, %d cached, "
            "%d discovered (%d probes, %d groups, %d replicated on failure) "
            "in %.2fs", len(self.rules), c.rules_preset, c.rules_from_group,
            c.rules_from_cache, c.rules_discovered, c.probes_compiled,
            c.groups, len(self.replicated_on_failure), c.discovery_seconds)

    def _lookup_or_discover(self, node, sig: str) -> dict:
        """preset -> propagation group -> persistent cache -> discovery."""
        from . import discovery as disc
        from .presets import preset_rule

        if edconfig.discovery_use_presets:
            preset = preset_rule(node, self.world_size)
            if preset is not None:
                self.counters.rules_preset += 1
                if edconfig.discovery_crosscheck:
                    self._crosscheck_preset(node, sig, preset)
                return preset

        csig = None
        if edconfig.discovery_prune or self._dcache is not None:
            csig = disc.canonical_signature(node, self.world_size)
        if csig is not None and edconfig.discovery_prune:
            got = self.canon_rules.get(csig)
            if got is not None and disc.rule_transferable(got[0], got[1],
                                                          node):
                self.counters.rules_from_group += 1
                return got[0]
        if csig is not None and self._dcache is not None:
            entry = self._dcache.get(csig)
            if entry is not None and disc.rule_transferable(
                    entry["rule"], entry["shapes"], node):
                self.counters.rules_from_cache += 1
                if edconfig.discovery_prune:
                    self.canon_rules[csig] = (entry["rule"], entry["shapes"],
                                              sig)
                return entry["rule"]

        self._last_discovery_failed = False
        rule = self._discover_node(node, sig)
        self.counters.rules_discovered += 1
        if csig is not None and not self._last_discovery_failed:
            shapes = disc.node_tensor_shapes(node)
            if edconfig.discovery_prune:
                self.canon_rules[csig] = (rule, shapes, sig)
            if self._dcache is not None:
                self._dcache.put(csig, {"rule": rule, "shapes": shapes,
                                        "target": target_name(node.target)})
        return rule

    def _crosscheck_preset(self, node, sig: str, rule: dict) -> None:
        """Execute every shard group the preset declares through the
        ShardCombine harness and compare its recombination with the
        declared one.  Failures are counted and logged, never raised."""
        space = rule.get("space")
        if target_name(node.target) in _CROSSCHECK_SKIP or space is None \
                or space.max_group() == 0:
            return
        total = sum(n.meta["val"].numel() for n in node_tensor_inputs(node))
        out = node.meta["val"]
        total += sum(v.numel() for v in pytree.tree_leaves(out)
                     if isinstance(v, torch.Tensor))
        if total > edconfig.discovery_hint_numel:
            return  # cross-check runs on small shapes only
        args, kwargs = self._concrete_args(node)
        op = MetaOp(node.target, args, kwargs,
                    name=target_name(node.target))
        if len(space) != len(op.tensor_indices):
            return
        from easydist_tpu_torch.metashard.metaop import _exact_matmuls

        with _exact_matmuls():
            try:
                global_out = op.run_global()
            except Exception:
                return
            self.counters.crosscheck_checked += 1
            for group in range(1, space.max_group() + 1):
                res = op._check_candidate(space, group, global_out)
                ok = (res is not None and res[1] is None
                      and _recombine_matches(rule["recombines"].get(group),
                                             res[0]))
                if not ok:
                    self.counters.crosscheck_failures += 1
                    logger.warning(
                        "[discovery] preset cross-check FAILED for %s "
                        "group %d (%s)", node.target, group, sig[:160])

    def _discover_node(self, node, sig: str) -> dict:
        """Derive a rule on a full miss: view analysis, then discovery on
        a shrunk instance above `discovery_hint_numel`, then `MetaOp`."""
        name = target_name(node.target)
        if node.target in _VIEW_TARGETS:
            (src,) = node_tensor_inputs(node)
            try:
                rule = view_rule(list(src.meta["val"].shape),
                                 list(node.meta["val"].shape),
                                 world_size=self.world_size)
                return {"space": rule["space"],
                        "recombines": rule["recombines"]}
            except RuntimeError:
                pass  # unalignable view: execution discovery below
        total = sum(n.meta["val"].numel() for n in node_tensor_inputs(node))
        total += sum(v.numel() for v in pytree.tree_leaves(node.meta["val"])
                     if isinstance(v, torch.Tensor))
        if total > edconfig.discovery_hint_numel:
            rule = self._discover_shrunk(node, name)
            if rule is not None:
                return rule
        try:
            args, kwargs = self._concrete_args(node)
            op = MetaOp(node.target, args, kwargs, name=name)
            space, recombines = op.discover(prompt=self.prompts.get(name))
        except Exception as e:
            logger.warning("discovery failed for %s (%s): %s — replicating",
                           name, sig[:160], e)
            space = ShardSpace.for_tensors(
                [n.meta["val"] for n in node_tensor_inputs(node)])
            recombines = {}
            # a replicate fallback is circumstantial: never persisted,
            # never transferred across a propagation group
            self._last_discovery_failed = True
            self.replicated_on_failure.append(sig)
        if name not in self.prompts and space.max_group() > 0:
            self.prompts[name] = space
        return {"space": space, "recombines": recombines}

    def _discover_shrunk(self, node, name: str) -> Optional[dict]:
        """Discovery on a size-reduced instance (equal sizes shrink
        together, so contraction and broadcast partners stay consistent),
        or None when the op rejects the shrunk shapes (its arguments
        restate a shape)."""
        cap = edconfig.discovery_hint_numel
        unit = max(self.world_size * edconfig.discovery_nshards, 8)
        vals = [n.meta["val"] for n in node_tensor_inputs(node)] + [
            v for v in pytree.tree_leaves(node.meta["val"])
            if isinstance(v, torch.Tensor)]
        sizes = sorted({d for v in vals for d in v.shape if d > unit},
                       reverse=True)

        def shrunk_total(size_map):
            total = 0
            for v in vals:
                n = 1
                for d in v.shape:
                    n *= size_map.get(d, d)
                total += n
            return total

        size_map: Dict[int, int] = {}
        for _ in range(64):
            if shrunk_total(size_map) <= cap:
                break
            for d in sizes:
                cur = size_map.get(d, d)
                nxt = max((cur // 2) // unit * unit, unit)
                if nxt < cur:
                    size_map[d] = nxt
                    break
            else:
                return None
        if not size_map:
            return None
        try:
            args, kwargs = self._concrete_args(node, size_map)
            node.target(*args, **kwargs)  # arguments consistent?
            op = MetaOp(node.target, args, kwargs, name=name)
            space, recombines = op.discover(prompt=self.prompts.get(name))
        except Exception:
            return None
        if name not in self.prompts and space.max_group() > 0:
            self.prompts[name] = space
        return {"space": space, "recombines": recombines}


# ops through which a partial-sum placement propagates linearly:
# f(sum_i x_i) == sum_i f(x_i) when every other operand is replicated
_PARTIAL_LINEAR_1IN = {"aten.view", "aten._unsafe_view", "aten.t",
                       "aten.transpose", "aten.permute", "aten.squeeze",
                       "aten.unsqueeze", "aten.expand", "aten.neg",
                       "aten.clone", "aten._to_copy", "aten.sum"}
_PARTIAL_LINEAR_2IN = {"aten.mul", "aten.div", "aten.mm", "aten.bmm"}


def _inject_partial_propagation(graph, world_size: int) -> None:
    """Add P-in/P-out strategies to the pools of linear aten ops (the
    counterpart of jaxfront/interpreter.py:1227-1255).  A multiply by a
    literal (one tensor input) gets none, as in the JAX package: letting P
    ride into loss-scale and optimizer chains is byte-neutral at best."""
    from easydist_tpu_torch.metashard.metair import NodeStrategy, Placement

    par = Placement.partial()
    rep = Placement.replicate()
    for node in graph.ops:
        base = node.strategy_pool(world_size)
        if not base or node._pool_cache is None:
            continue
        n_in = len(base[0].in_placements)
        n_out = len(base[0].out_placements)
        extras = []
        if node.op_key in _PARTIAL_LINEAR_1IN and n_in >= 1:
            extras.append(NodeStrategy([par] + [rep] * (n_in - 1),
                                       [par] * n_out))
        elif node.op_key in _PARTIAL_LINEAR_2IN and n_in == 2:
            extras.append(NodeStrategy([par, rep], [par] * n_out))
            if node.op_key != "aten.div":  # linear in the numerator only
                extras.append(NodeStrategy([rep, par], [par] * n_out))
        node._pool_cache = node._pool_cache + extras
