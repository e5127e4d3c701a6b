"""Compiler-chosen rematerialization over a traced FX program: the port of
easydist_tpu/schedule/remat.py.

When the planned per-device peak of a program is over the memory cap,
the planner picks long-lived activations (live across the forward ->
backward boundary) and rewrites the program so that their far consumers
read a recomputed copy, built just before the first of them from values
that are alive anyway, instead of keeping the original resident.  The
effect is `torch.utils.checkpoint` per block, chosen by the compiler from
the liveness profile after autograd, with no annotation in the step.

The liveness model is not the JAX package's.  There XLA fuses pointwise
chains, so their outputs never reach HBM and the model leaves them out.
The port replays its aten calls one by one: every intermediate takes
memory from the node that makes it until its last reader (FX codegen
drops each value after its last use), a view shares the storage of its
base, the program's inputs are held by the caller for the whole call and
its outputs live to the end.  The order of the program is the order of
execution.

A recomputed chain never holds a kernel custom op (`easydist_tpu_torch::*`,
as the JAX package never recomputes a `pallas_call`), a collective, an
in-place op, a Python helper of the emitted program, or a random op: a
torch generator's stream is sequential, so a second draw would give
another mask, where JAX's threefry draw is pure.  Nothing in the port
runs CSE over the rewritten program, so the chains need no barrier.

Candidates are ranked by resident bytes reclaimed per second of
recompute (`candidate_score`), largest first; chains are capped at
`config.remat_max_chain_len` nodes and priced by measured per-op times
from the PerfDB where a node's signature has one, else by a FLOP proxy.

The same rewrite carries out a user's selective checkpoint
(`GPTConfig(remat="dots")`, `save_dots_policy`): while `make_fx` traces,
torch's checkpoint keeps every output and leaves the recompute to a
partitioner, so `tag_dots_region` tags the region's nodes and
`apply_checkpoint_tags` rebuilds what the policy does not keep.
"""

from __future__ import annotations

import logging
import operator
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from easydist_tpu_torch import config as edconfig

logger = logging.getLogger(__name__)

# op namespaces whose calls are never chain material: the port's kernels
# and composites, the collectives
_BANNED_NAMESPACES = ("easydist_tpu_torch", "_c10d_functional",
                      "c10d_functional", "_c10d_functional_autograd",
                      "c10d", "_dtensor")
# random ops (by aten base name): a recomputed draw would change the mask
_RANDOM_OPS = frozenset((
    "bernoulli", "bernoulli_", "rand", "rand_like", "randn", "randn_like",
    "randint", "randint_like", "randperm", "native_dropout", "dropout",
    "normal", "normal_", "uniform", "uniform_", "multinomial",
    "exponential_", "geometric_", "cauchy_", "log_normal_", "poisson",
    "rrelu_with_noise", "feature_dropout", "alpha_dropout"))


def _base_name(target) -> str:
    return getattr(target, "__name__", str(target)).split(".")[0]


def _is_overload(target) -> bool:
    return isinstance(target, torch._ops.OpOverload)


def _aliases_input(node) -> bool:
    """True when `node`'s tensor output shares the storage of its first
    argument: a view (the schema's return carries alias info), an
    in-place op, or the wait of a collective."""
    t = node.target
    if not _is_overload(t):
        return False
    if t.namespace == "_c10d_functional" and _base_name(t) == "wait_tensor":
        return True
    rets = t._schema.returns
    return bool(rets) and rets[0].alias_info is not None


def recomputable(node) -> bool:
    """May `node` be executed again inside a recompute chain?"""
    if node.op != "call_function":
        return False
    t = node.target
    if t is operator.getitem:
        return True
    if not _is_overload(t):
        return False  # a Python helper of the emitted program
    if t.namespace in _BANNED_NAMESPACES:
        return False
    if t._schema.is_mutable or _base_name(t) in _RANDOM_OPS:
        return False
    return True


def candidate_score(nbytes: float, recompute_s: float) -> float:
    """The remat ranking metric: resident bytes reclaimed per second of
    recompute; candidates are taken largest first."""
    return nbytes / (1e-6 + recompute_s)


def _eqn_flops(node) -> float:
    """Recompute-cost proxy of one aten node: 2*M*N*K for the matmuls,
    the flash ops' products, 50x the output for a convolution, the
    output's element count otherwise (the JAX package's proxy, over aten
    targets as `parallel.auto_pipeline.node_flops` reckons stage FLOPs)."""
    from easydist_tpu_torch.parallel.auto_pipeline import node_flops

    if "convolution" in _base_name(node.target):
        val = node.meta.get("val")
        return 50.0 * float(val.numel()) if isinstance(
            val, torch.Tensor) else 0.0
    return node_flops(node)


_DOT_OPS = None


def save_dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of "dots" (the counterpart of
    `jax.checkpoint_policies.checkpoint_dots`): keep the outputs of the
    matmuls, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    global _DOT_OPS
    if _DOT_OPS is None:
        aten = torch.ops.aten
        _DOT_OPS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
                    aten.baddbmm.default}
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dots_context():
    """The `context_fn` of a "dots" checkpoint
    (`torch.utils.checkpoint.checkpoint(..., context_fn=dots_context)`)."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(save_dots_policy)


def tag_dots_region(fn, *args):
    """`fn(*args)` (a "dots" checkpoint); under `make_fx`, the nodes its
    forward adds are tagged with `save_dots_policy` (`meta["recompute"]`)
    for `apply_checkpoint_tags`.  Torch's selective checkpoint tags them
    itself on some versions only, and keeps every output while it
    traces."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    mode = get_proxy_mode()
    if mode is None:
        return fn(*args)
    before = set(mode.tracer.graph.nodes)
    out = fn(*args)
    for n in mode.tracer.graph.nodes:
        if n not in before and n.op == "call_function" \
                and n.target is not torch.ops.aten.detach.default:
            n.meta["recompute"] = save_dots_policy(None, n.target)
    return out


def _nbytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return int(val.numel()) * val.element_size()
    return 0


@dataclass
class RematRecord:
    """One rematerialized value: its producer's storage `var` (an FX node
    name), the chain of FX node names recomputed (program order), the
    chain nodes that the far consumers read in place of the originals
    (`targets`), and the far consumers."""
    var: str
    chain: List[str]
    targets: List[str]
    consumers: List[str]


@dataclass
class RematPlan:
    """The planner's result.  `recompute`: far consumer -> the chain node
    names recomputed for it; `records` in commit order; peaks in bytes
    under the port's liveness model; `recompute_seconds` the priced cost
    of the chains (each chain once)."""
    recompute: Dict[str, List[str]] = field(default_factory=dict)
    records: List[RematRecord] = field(default_factory=list)
    n_remat_vars: int = 0
    base_peak: int = 0
    predicted_peak: int = 0
    recompute_seconds: float = 0.0

    def __bool__(self):
        return bool(self.records)

    @property
    def recomputed_nodes(self) -> int:
        """Nodes the rewrite adds (chain nodes, getitems included)."""
        return sum(len(r.chain) for r in self.records)


class _Liveness:
    """Interval model over the program's storages: one interval each, at
    node-index granularity (every node of the graph has an index; the
    inputs come first)."""

    def __init__(self, gm):
        self.nodes = list(gm.graph.nodes)
        self.index = {n: i for i, n in enumerate(self.nodes)}
        self.n = len(self.nodes)
        last = self.n - 1
        self.storage: Dict = {}       # FX node -> storage key (a node)
        self.readers: Dict = {}       # storage -> reading node indices
        keys: List = []
        for node in self.nodes:
            if node.op == "output":
                continue
            val = node.meta.get("val")
            if node.op == "call_function" and node.target is \
                    operator.getitem:
                src = node.args[0]
                if _aliases_input(src) and src.args:
                    self.storage[node] = self.storage.get(src.args[0])
                elif isinstance(val, torch.Tensor):
                    self.storage[node] = node
                    keys.append(node)
                continue
            if node.op == "call_function" and _aliases_input(node) \
                    and isinstance(node.args[0], torch.fx.Node):
                self.storage[node] = self.storage.get(node.args[0])
                continue
            if isinstance(val, torch.Tensor):
                self.storage[node] = node
                keys.append(node)
        self.keys = keys
        self.key_id = {k: i for i, k in enumerate(keys)}
        k = len(keys)
        self.start = np.zeros(k, dtype=np.int64)
        self.end = np.zeros(k, dtype=np.int64)
        self.size = np.zeros(k, dtype=np.int64)
        self.pinned = np.zeros(k, dtype=bool)  # inputs, outputs, sources
        self.is_input = np.zeros(k, dtype=bool)
        for key, i in self.key_id.items():
            self.size[i] = _nbytes(key.meta.get("val"))
            if key.op in ("placeholder", "get_attr"):
                # the caller (or the module) holds them for the whole call
                self.start[i], self.end[i] = 0, last
                self.pinned[i] = self.is_input[i] = True
            else:
                self.start[i] = self.end[i] = self.index[key]
        out_node = self.nodes[-1]
        for node in self.nodes:
            if node.op not in ("call_function", "output"):
                continue
            j = self.index[node]
            for a in node.all_input_nodes:
                s = self.storage.get(a)
                if s is None:
                    continue
                i = self.key_id[s]
                if node is out_node:
                    self.end[i] = last
                    self.pinned[i] = True
                    continue
                self.end[i] = max(self.end[i], j)
                if _is_overload(node.target) \
                        and node.target._schema.is_mutable:
                    # a recomputed copy would miss the mutation
                    self.pinned[i] = True
                # an alias node is transparent: its readers read the base
                if node.op == "call_function" and self.storage.get(node) is s:
                    continue
                self.readers.setdefault(s, set()).add(j)
        # extra intervals the plan adds: (size, start, end)
        self.extra: List[Tuple[int, int, int]] = []

    def profile(self) -> np.ndarray:
        delta = np.zeros(self.n + 1, dtype=np.int64)
        ok = self.end >= self.start
        np.add.at(delta, self.start[ok], self.size[ok])
        np.add.at(delta, self.end[ok] + 1, -self.size[ok])
        for size, s, e in self.extra:
            delta[s] += size
            delta[e + 1] -= size
        return np.cumsum(delta[:-1])


def plan_remat(gm, cap_bytes: int) -> Optional[RematPlan]:
    """Greedy liveness-driven remat planning over `gm`, whose nodes carry
    `meta["val"]` (fake or real tensors at the shapes the program runs).
    Returns None when the program already fits, or when nothing
    recomputable helps."""
    if cap_bytes <= 0:
        return None
    lv = _Liveness(gm)
    if not lv.keys:
        return None
    base_peak = int(lv.profile().max())
    if base_peak <= cap_bytes:
        return None

    plan = RematPlan(base_peak=base_peak, predicted_peak=base_peak)
    max_chain = edconfig.remat_max_chain_len
    flops_per_s = max(edconfig.peak_flops, 1.0)
    op_times: Dict[str, float] = {}
    if edconfig.use_op_cost_db:
        try:
            from easydist_tpu_torch.runtime.op_profile import load_op_times

            op_times = load_op_times()
        except Exception:
            op_times = {}

    def node_seconds(node) -> float:
        if node.target is operator.getitem or _aliases_input(node):
            return 0.0
        if op_times:
            from easydist_tpu_torch.fxfront.interpreter import \
                node_signature

            try:
                measured = op_times.get(node_signature(node))
            except Exception:
                measured = None
            if measured is not None:
                return measured
        return _eqn_flops(node) / flops_per_s

    rematted: Set = set()  # storages whose far readers were redirected

    def build_chain(s, targets, at: int) -> Optional[List]:
        """FX nodes (program order) whose re-execution just before node
        index `at` rebuilds `targets` (nodes on storage `s`) from values
        the model keeps alive there."""
        chain: Set = set()
        stack = list(targets)
        count = 0
        while stack:
            u = stack.pop()
            if u in chain or u.op in ("placeholder", "get_attr"):
                continue
            su = lv.storage.get(u)
            multi = su is None and isinstance(u.meta.get("val"),
                                              (tuple, list))
            if su is not s and not multi and su is not None:
                i = lv.key_id[su]
                if su not in rematted and lv.end[i] >= at:
                    continue  # alive at the consumer: read it
            if not recomputable(u):
                return None
            chain.add(u)
            if u.target is not operator.getitem:
                count += 1
                if count > max_chain:
                    return None
            stack.extend(u.all_input_nodes)
        return sorted(chain, key=lv.index.__getitem__)

    def metric(profile) -> Tuple[int, int]:
        return (int(profile.max()),
                int(np.maximum(profile - cap_bytes, 0).sum()))

    for _round in range(4096):
        profile = lv.profile()
        peak = int(profile.max())
        cur = metric(profile)
        plan.predicted_peak = peak
        if peak <= cap_bytes:
            break
        t_star = int(profile.argmax())
        cands = []
        for s in lv.keys:
            i = lv.key_id[s]
            if lv.pinned[i] or s in rematted or lv.size[i] == 0:
                continue
            if not (lv.start[i] < t_star < lv.end[i]):
                continue
            readers = sorted(lv.readers.get(s, ()))
            far = [j for j in readers if j > t_star]
            if not far or len(far) > 4:
                continue
            far_nodes = [lv.nodes[j] for j in far]
            targets = sorted({a for n in far_nodes
                              for a in n.all_input_nodes
                              if lv.storage.get(a) is s},
                             key=lv.index.__getitem__)
            chain = build_chain(s, targets, far[0])
            if not chain:
                continue
            cost = sum(node_seconds(u) for u in chain)
            cands.append((candidate_score(float(lv.size[i]), cost), s,
                          readers, far, targets, chain, cost))
            if len(cands) >= 256:
                break
        if not cands:
            logger.warning(
                "[remat] peak %.3f GiB still over cap %.3f GiB and no "
                "rematerializable candidates remain", peak / 2**30,
                cap_bytes / 2**30)
            break
        cands.sort(key=lambda c: -c[0])
        committed = False
        for _, s, readers, far, targets, chain, cost in cands:
            i = lv.key_id[s]
            saved_end, saved_extra = lv.end.copy(), list(lv.extra)
            near = [j for j in readers if j <= t_star]
            first, last_far = far[0], far[-1]
            lv.end[i] = max(near) if near else lv.start[i]
            lv.extra.append((int(lv.size[i]), first, last_far))
            chain_set = set(chain)
            sources = set()
            for u in chain:
                su = lv.storage.get(u)
                if su is not None and su is not s \
                        and su is u:
                    # a recomputed intermediate: alive while the chain runs
                    lv.extra.append((int(lv.size[lv.key_id[su]]), first,
                                     first))
                for a in u.all_input_nodes:
                    if a in chain_set:
                        continue
                    sa = lv.storage.get(a)
                    if sa is not None:
                        k = lv.key_id[sa]
                        lv.end[k] = max(lv.end[k], first)
                        sources.add(k)
            new = metric(lv.profile())
            if new < cur:
                rematted.add(s)
                for k in sources:
                    lv.pinned[k] = True  # read by a chain: never evicted
                names = [u.name for u in chain]
                far_names = [lv.nodes[j].name for j in far]
                plan.records.append(RematRecord(
                    s.name, names, [t.name for t in targets], far_names))
                for c in far_names:
                    plan.recompute.setdefault(c, []).extend(names)
                plan.recompute_seconds += cost
                committed = True
                break
            lv.end, lv.extra = saved_end, saved_extra
        if not committed:
            logger.info("[remat] no candidate improves the profile at peak "
                        "%.3f GiB (cap %.3f GiB); stopping with %d values",
                        peak / 2**30, cap_bytes / 2**30, len(rematted))
            break
    plan.n_remat_vars = len(rematted)
    if not plan.records:
        return None
    logger.info("[remat] %d values rematerialized: planned peak %.3f -> "
                "%.3f GiB (cap %.3f), est. recompute %.2f ms a call",
                plan.n_remat_vars, plan.base_peak / 2**30,
                plan.predicted_peak / 2**30, cap_bytes / 2**30,
                plan.recompute_seconds * 1e3)
    return plan


def apply_remat(gm, plan: RematPlan):
    """Rewrite `gm` in place under `plan`: each record's chain is cloned
    just before its first far consumer (clones carry `meta["remat_of"]`,
    the original's name) and its far consumers read the clones of the
    targets.  Clones take the original nodes' arguments as the planner
    saw them; dead nodes are dropped after.  Returns `gm`."""
    graph = gm.graph
    by_name = {n.name: n for n in graph.nodes}
    orig_args = {n: (n.args, n.kwargs) for n in graph.nodes}
    for rec in plan.records:
        consumers = [by_name[c] for c in rec.consumers]
        env: Dict = {}
        with graph.inserting_before(consumers[0]):
            for name in rec.chain:
                u = by_name[name]
                args, kwargs = orig_args[u]
                remap = (lambda a: env.get(a, a))
                new = graph.call_function(
                    u.target, torch.fx.node.map_arg(args, remap),
                    torch.fx.node.map_arg(kwargs, remap))
                new.meta = dict(u.meta)
                new.meta["remat_of"] = u.name
                env[u] = new
        for c in consumers:
            for t in rec.targets:
                c.replace_input_with(by_name[t], env[by_name[t]])
    # the originals the far consumers no longer read (views the backward
    # made of a saved value) would hold it alive where they stand
    graph.eliminate_dead_code()
    graph.lint()
    gm.recompile()
    return gm


def apply_checkpoint_tags(gm) -> int:
    """Honour the policy tags a selective checkpoint leaves on a traced
    graph, in place.  Under a tracing mode `torch.utils.checkpoint`'s
    selective checkpoint keeps every output and only tags each node
    (`meta["recompute"]`), leaving the recompute to a partitioner; this
    is that step.  A value tagged to be recomputed that the backward
    reads through the checkpoint's saved copy (the detach that follows
    it) is rebuilt just before its first such reader from the values the
    policy keeps (chains share clones at one insertion point), the
    kernels' ops included, as the eager checkpoint recomputes them;
    random and in-place ops stay saved.  Returns the nodes added."""
    from torch.utils.checkpoint import CheckpointPolicy

    again = (CheckpointPolicy.PREFER_RECOMPUTE,
             CheckpointPolicy.MUST_RECOMPUTE)
    graph = gm.graph
    nodes = list(graph.nodes)
    index = {n: i for i, n in enumerate(nodes)}
    detach = torch.ops.aten.detach.default

    def tagged(n) -> bool:
        if n.op != "call_function" or n.target is detach:
            return False
        if n.target is operator.getitem:
            return tagged(n.args[0])
        t = n.target
        return n.meta.get("recompute") in again and _is_overload(t) \
            and not t._schema.is_mutable and _base_name(t) not in _RANDOM_OPS

    clones: Dict = {}  # insertion node -> {original: clone}
    added = 0
    for v in nodes:
        if not tagged(v):
            continue
        saved = [u for u in v.users if u.target is detach
                 and index[u] == index[v] + 1]
        copies, stack = set(), list(saved)
        while stack:
            d = stack.pop()
            copies.add(d)
            stack.extend(u for u in d.users if u.target is detach)
        readers = sorted({u for d in copies for u in d.users
                          if u not in copies}, key=index.__getitem__)
        if not readers:
            continue
        chain, stack = set(), [v]
        while stack:
            u = stack.pop()
            if u in chain or not tagged(u):
                continue
            chain.add(u)
            stack.extend(u.all_input_nodes)
        env = clones.setdefault(readers[0], {})
        with graph.inserting_before(readers[0]):
            for u in sorted(chain, key=index.__getitem__):
                if u in env:
                    continue
                new = graph.node_copy(u, lambda a: env.get(a, a))
                new.meta["remat_of"] = u.name
                env[u] = new
                added += 1
        for r in readers:
            for d in copies:
                r.replace_input_with(d, env[v])
    if added:
        graph.eliminate_dead_code()
        graph.lint()
        gm.recompile()
    return added


def program_peak(gm) -> int:
    """The planned peak of `gm` under the port's liveness model."""
    lv = _Liveness(gm)
    return int(lv.profile().max()) if lv.keys else 0


def memory_planner_peak(gm) -> int:
    """The second opinion: `schedule.memory_planner`'s skyline peak of
    `gm`, an allocator's packing of every buffer (the inputs held through
    the call, as the caller holds them).  The MetaGraph is built from the
    nodes' `meta["val"]` with each view folded into its base."""
    from easydist_tpu_torch.metashard.metair import (MetaGraph, MetaNode,
                                                     MetaVar)

    from .memory_planner import plan_graph_memory

    graph = MetaGraph()
    var: Dict = {}

    def new_var(name, val):
        return MetaVar(name, tuple(val.shape), val.dtype)

    for node in gm.graph.nodes:
        val = node.meta.get("val")
        if node.op in ("placeholder", "get_attr"):
            if isinstance(val, torch.Tensor):
                var[node] = new_var(node.name, val)
                graph.add_input(MetaNode(node.name, node.op, [], [var[node]],
                                         is_input=True))
        elif node.op == "call_function":
            src = node.args[0] if node.args else None
            if node.target is operator.getitem:
                got = var.get((src, node.args[1]))
                if got is None and _aliases_input(src) and src.args:
                    got = var.get(src.args[0])
                if got is not None:
                    var[node] = got
                continue
            if _aliases_input(node) and src in var:
                var[node] = var[src]
                continue
            ins = [var[a] for a in node.all_input_nodes if a in var]
            if isinstance(val, torch.Tensor):
                outs = [new_var(node.name, val)]
                var[node] = outs[0]
            elif isinstance(val, (tuple, list)):
                outs = []
                for i, v in enumerate(val):
                    if isinstance(v, torch.Tensor):
                        outs.append(new_var(f"{node.name}.{i}", v))
                        var[(node, i)] = outs[-1]
            else:
                outs = []
            graph.add_op(MetaNode(node.name, str(node.target), ins, outs))
            for i, v in enumerate(outs):
                v.producer, v.producer_idx = graph.ops[-1], i
        elif node.op == "output":
            # the caller holds the inputs through the call: they escape
            held = [n.outvars[0] for n in graph.inputs]
            graph.outputs = list({id(v): v for v in held + [
                var[a] for a in node.all_input_nodes if a in var]}.values())
    return int(plan_graph_memory(graph, [{}], [1]).peak_bytes)


def resolve_memory_cap(mesh=None, device=None) -> int:
    """Per-device memory budget in bytes with the `memory_ratio` headroom
    applied: a configured cap above 0 wins, 0 turns it off, and -1 (the
    default) asks the card for its total memory.  The device is the
    mesh's (its device type and this rank's current device) or
    `device`; a CPU device, or none, gives 0 (uncapped), as the JAX
    package does for its CPU meshes."""
    cap = edconfig.per_device_memory_cap
    if cap >= 0:
        return int(cap * edconfig.memory_ratio) if cap > 0 else 0
    dev = None
    if mesh is not None and hasattr(mesh, "device_type"):
        dev = torch.device(mesh.device_type)
    elif device is not None:
        dev = torch.device(device)
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return 0
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    total = torch.cuda.get_device_properties(index).total_memory
    return int(total * edconfig.memory_ratio)
