"""MetaIR: the framework-neutral SPMD strategy IR and dataflow graph.

Discovery results (ShardSpace + recombine fns per op) are lowered into
per-node strategy pools over the placement vocabulary

    R          replicate on the mesh axis
    S(dim)     shard tensor dim `dim` across the mesh axis
    P(red)     partial values that recombine by `red` (pending all_reduce)

The solver consumes a `MetaGraph` of `MetaNode`s coarsened into
`MetaNodeCluster`s whose intra-cluster strategies are sync-free (chosen by
back-propagating the cluster output node's strategies through its cone).

Reference semantics: easydist/metashard/metair.py (SPMD :29, VarSPMDStrategy
:63, NodeSPMDStrategy :131, strategy-pool construction :376-481, cone
clustering :842-917, liveness :818-840).  The IR here is a fresh design: one
`Placement` per mesh axis, ND strategies assembled by the frontend after the
per-axis solves.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .annotation import ShardSpace
from .combination import Recombine, Reduction

logger = logging.getLogger(__name__)

_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
    "uint32": 4, "uint64": 8, "bool": 1, "complex64": 8, "complex128": 16,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}


# --------------------------------------------------------------- placements

@dataclass(frozen=True, eq=False)
class Placement:
    """Placement of one tensor along ONE mesh axis."""

    kind: str  # "R" | "S" | "P"
    dim: int = -1  # tensor dim for S
    reduction: Optional[Reduction] = None  # for P

    def _key(self):
        # canonical identity: dim only matters for S, reduction only for P
        # (an R built with a stray dim is still just R)
        return (self.kind,
                self.dim if self.kind == "S" else -1,
                self.reduction if self.kind == "P" else None)

    def __eq__(self, other) -> bool:
        return isinstance(other, Placement) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    @staticmethod
    def replicate() -> "Placement":
        return Placement("R")

    @staticmethod
    def shard(dim: int) -> "Placement":
        return Placement("S", dim=dim)

    @staticmethod
    def partial(reduction: Reduction = Reduction.SUM) -> "Placement":
        return Placement("P", reduction=reduction)

    def is_replicate(self) -> bool:
        return self.kind == "R"

    def is_shard(self) -> bool:
        return self.kind == "S"

    def is_partial(self) -> bool:
        return self.kind == "P"

    def __repr__(self) -> str:
        if self.kind == "S":
            return f"S({self.dim})"
        if self.kind == "P":
            return f"P({self.reduction.value})"
        return "R"


class NodeStrategy:
    """One SPMD strategy of a node on one mesh axis: a Placement per graph
    invar and per outvar (reference NodeSPMDStrategy, metair.py:131)."""

    def __init__(self, in_placements: Sequence[Optional[Placement]],
                 out_placements: Sequence[Optional[Placement]]):
        self.in_placements = list(in_placements)
        self.out_placements = list(out_placements)
        # seconds of communication INSIDE the op under this strategy, priced
        # linearly by the solver (composite ops — a TP-sharded scan body pays
        # its per-iteration psums here; plain ops leave it 0)
        self.intrinsic_cost: float = 0.0
        # absolute compute seconds under this strategy (composite ops price
        # their body per-op: a strategy sharding only a trivial input must
        # not earn the whole body's 1/n discount); None -> the solver's
        # any-S factor heuristic
        self.compute_cost: Optional[float] = None
        # emission metadata (the attention composite's seq variant, "ring"
        # or "ulysses": same boundary placements, another lowering)
        self.meta: Optional[dict] = None

    def is_all_replicate(self) -> bool:
        return all(p is None or p.is_replicate() for p in self.out_placements)

    def __repr__(self) -> str:
        return f"NodeStrategy(in={self.in_placements}, out={self.out_placements})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, NodeStrategy)
                and self.in_placements == other.in_placements
                and self.out_placements == other.out_placements)


# ------------------------------------------------------------------- graph

class MetaVar:

    def __init__(self, name: str, shape: Tuple[int, ...], dtype):
        self.name = name
        self.shape = tuple(shape)
        # a bare name as `_DTYPE_BYTES` keys it ("float32", "bfloat16"); a
        # torch dtype's str() is "torch.float32"
        self.dtype = str(dtype).removeprefix("torch.")
        self.producer: Optional[MetaNode] = None
        self.producer_idx: int = -1
        self.consumers: List[Tuple[MetaNode, int]] = []  # (node, invar_idx)

    def size_bytes(self) -> float:
        n = math.prod(self.shape) if self.shape else 1
        return _DTYPE_BYTES.get(self.dtype, 4) * n

    def itemsize(self) -> int:
        return _DTYPE_BYTES.get(self.dtype, 4)

    def __repr__(self) -> str:
        return f"{self.name}({self.dtype}{list(self.shape)})"


class MetaNode:
    """One operator (or graph input placeholder) in the dataflow graph.

    `space`/`recombines` hold the ShardCombine discovery result.  The rows of
    `space` cover the op's *tensor arguments*; `arg_rows` maps each graph
    invar to its row index (non-Var tensor literals get rows too but no graph
    edge).  Placeholders have no invars; their single outvar's strategies come
    from their own space (reference is_placeholder handling, metair.py:361).
    """

    _uid = 0

    def __init__(self, name: str, op_key: str, invars: List[MetaVar],
                 outvars: List[Optional[MetaVar]],
                 space: Optional[ShardSpace] = None,
                 recombines: Optional[Dict[int, object]] = None,
                 arg_rows: Optional[List[int]] = None,
                 is_input: bool = False, sig: Optional[str] = None):
        MetaNode._uid += 1
        self.uid = MetaNode._uid
        self.name = name
        self.op_key = op_key
        # full op signature (primitive + params + shapes/dtypes) — the
        # PerfDB key for measured per-op runtimes (reference
        # runtime_prof.py keys ops the same way)
        self.sig = sig
        self.invars = invars
        self.outvars = outvars
        self.space = space
        self.recombines = recombines or {}
        # whole-node strategies that bypass the group table (composite ops:
        # a scan's candidate assignments overlap on dims, which one-group-
        # per-cell tables cannot encode).  List of NodeStrategy.
        self.explicit_strategies: Optional[List[NodeStrategy]] = None
        # exact MACs recorded by the bridge for dot/conv eqns (shape-only
        # recovery of the contraction length is ambiguous)
        self.flops: Optional[float] = None
        # full (unsharded) compute seconds when the node hides more work
        # than its output bytes show (scan: length x body); None -> the
        # solver's HBM byte proxy
        self.compute_proxy: Optional[float] = None
        self.arg_rows = arg_rows if arg_rows is not None else list(range(len(invars)))
        self.is_input = is_input
        self.cluster_id = -1
        self._pool_cache: Optional[List[NodeStrategy]] = None
        # user-pinned strategy for this solve axis (fix_sharding): when
        # set, the pool is exactly [pinned] — the solver prices neighbors
        # against the pin instead of fighting it at emission
        self.pinned: Optional[NodeStrategy] = None

        for idx, v in enumerate(invars):
            if v is not None:
                v.consumers.append((self, idx))
        for idx, v in enumerate(outvars):
            if v is not None:
                v.producer = self
                v.producer_idx = idx

    # ------------------------------------------------------ strategy pool

    def _recombine_placement(self, fn) -> Placement:
        name = fn.func.__name__ if hasattr(fn, "func") else fn.__name__
        kw = getattr(fn, "keywords", {})
        if name == "identity":
            return Placement.replicate()
        if name == "concat":
            return Placement.shard(kw.get("dim", 0))
        if name == "reduce":
            return Placement.partial(kw.get("op", Reduction.SUM))
        raise RuntimeError(f"unknown recombine fn {name}")

    def _strategy_for_group(self, group: int) -> Optional[NodeStrategy]:
        fns = self.recombines.get(group)
        if fns is None:
            return None
        if not isinstance(fns, (list, tuple)):
            fns = [fns]

        if self.is_input:
            in_placements = []
        else:
            in_placements = []
            for row_idx in self.arg_rows:
                if row_idx < 0 or self.space is None or row_idx >= len(self.space):
                    in_placements.append(Placement.replicate())
                    continue
                dim = self.space.group_dim(row_idx, group)
                in_placements.append(Placement.shard(dim) if dim is not None
                                     else Placement.replicate())

        out_placements: List[Optional[Placement]] = []
        fn_iter = iter(fns)
        for v in self.outvars:
            if v is None:
                out_placements.append(None)
            else:
                try:
                    out_placements.append(self._recombine_placement(next(fn_iter)))
                except StopIteration:
                    out_placements.append(Placement.replicate())
        return NodeStrategy(in_placements, out_placements)

    def replicate_strategy(self) -> NodeStrategy:
        n_in = 0 if self.is_input else len(self.invars)
        return NodeStrategy([Placement.replicate()] * n_in,
                            [Placement.replicate() if v is not None else None
                             for v in self.outvars])

    def strategy_pool(self, axis_size: int,
                      exclude: Sequence[NodeStrategy] = ()) -> List[NodeStrategy]:
        """All valid 1D strategies on a mesh axis of `axis_size` devices:
        one per discovered shard group whose sharded dims divide evenly,
        minus `exclude` (strategies already chosen on previous mesh axes —
        reference metair.py:393-430), plus replicate as fallback."""
        if self.pinned is not None:
            return [self.pinned]
        if self._pool_cache is None:
            if self.explicit_strategies is not None:
                self._pool_cache = list(self.explicit_strategies)
            else:
                pool = []
                for group in sorted(self.recombines):
                    s = self._strategy_for_group(group)
                    if s is not None:
                        pool.append(s)
                self._pool_cache = pool

        def divisible(s: NodeStrategy) -> bool:
            vars_for_in = self.outvars if self.is_input else self.invars
            placements = s.out_placements if self.is_input else s.in_placements
            for v, p in zip(vars_for_in, placements):
                if v is not None and p is not None and p.is_shard():
                    if v.shape[p.dim] % axis_size != 0:
                        return False
            for v, p in zip(self.outvars, s.out_placements):
                if v is not None and p is not None and p.is_shard():
                    if v.shape[p.dim] % axis_size != 0:
                        return False
            return True

        pool = [s for s in self._pool_cache
                if divisible(s) and all(s != e for e in exclude)]
        # Every op (placeholders AND compute) may replicate — the reference
        # forces shards (its replicate branch is commented out,
        # metair.py:441-443), which mis-prices DP weight replication.  The
        # zero-communication all-replicate degeneracy this would create
        # under a comm-only objective is priced away by the solver's
        # compute-redundancy cost (replicated compute runs full-size on
        # every device; sharded runs 1/n — see SpmdSolver._collect_edges).
        rep = self.replicate_strategy()
        if all(s != rep for s in pool) and all(rep != e for e in exclude):
            pool.append(rep)
        if not pool:
            pool = [rep]
        return pool

    def __repr__(self) -> str:
        return f"MetaNode({self.name}: {self.op_key})"


# composites solved as their own cluster (see coarsen): control flow and
# jax.checkpoint regions — both carry explicit priced strategies whose
# many-input boundaries a cone back-build would sync-free-match away
_SOLO_CLUSTER_OPS = {"scan", "while", "cond", "remat2", "remat", "checkpoint"}


# ---------------------------------------------------------------- clusters

class MetaNodeCluster:
    """A group of nodes solved as one unit.  Its strategy list is derived by
    taking each strategy of the cluster's output node and back-propagating
    matching (sync-free) strategies to every interior node
    (reference back_build_strategy, metair.py:659-699)."""

    def __init__(self, cid: int):
        self.cid = cid
        self.nodes: Dict[int, MetaNode] = {}
        self.output_node: Optional[MetaNode] = None
        # per cluster strategy: {node_uid: (pool_idx, NodeStrategy)}
        self.strategies: List[Dict[int, Tuple[int, NodeStrategy]]] = []

    def add(self, node: MetaNode):
        self.nodes[node.uid] = node
        node.cluster_id = self.cid

    # bound on sync-free assignments enumerated per output-pool entry: the
    # branching is tiny in practice (cones are near-trees, 1-3 matching
    # producer strategies per edge) but a pathological cluster must not
    # blow up the ILP
    _BACK_BUILD_CAP = 16
    # bound on total DFS expansions per output-pool entry: a branchy
    # cluster whose combinations mostly DEAD-END never fills `results`,
    # so the result cap alone would still let the tree search go
    # multiplicative (k matches/edge over n nodes)
    _BACK_BUILD_STEPS = 512

    def _back_build_all(self, pending, chosen, axis_size, exclude_map,
                        results, steps) -> None:
        """Enumerate every sync-free intra-cluster assignment consistent
        with the already-`chosen` strategies.  `pending` holds (node,
        strategy) pairs whose in-cluster producers still need covering;
        `steps` is a single-element work counter shared across the DFS.
        Enumerating ALL matches (not just the first) matters: a P-chain
        cluster has both a "create P mid-chain" and a "P rides the whole
        chain" assignment for the same output placement, and first-match
        back-build shadows the second."""
        steps[0] += 1
        if len(results) >= self._BACK_BUILD_CAP \
                or steps[0] > self._BACK_BUILD_STEPS:
            return
        while pending:
            node, strategy = pending[-1]
            edge = None
            for invar_idx, invar in enumerate(node.invars):
                if invar is None or invar.producer is None:
                    continue
                up = invar.producer
                if up.uid not in self.nodes:
                    continue
                want = strategy.in_placements[invar_idx]
                if up.uid in chosen:
                    # a second in-cluster consumer: sync-free requires the
                    # already-chosen producer strategy to serve it too
                    have = chosen[up.uid][1].out_placements[
                        invar.producer_idx]
                    if have != want:
                        return  # dead end
                    continue
                edge = (invar_idx, invar, up)
                break
            if edge is None:
                pending = pending[:-1]
                continue
            invar_idx, invar, up = edge
            want = strategy.in_placements[invar_idx]
            up_pool = up.strategy_pool(axis_size, exclude_map(up))
            for i, s in enumerate(up_pool):
                if s.out_placements[invar.producer_idx] != want:
                    continue
                nxt = dict(chosen)
                nxt[up.uid] = (i, s)
                self._back_build_all(pending + [(up, s)], nxt, axis_size,
                                     exclude_map, results, steps)
                if len(results) >= self._BACK_BUILD_CAP \
                        or steps[0] > self._BACK_BUILD_STEPS:
                    return
            return  # every branch of this edge explored (or none matched)
        results.append(chosen)

    def finalize(self, axis_size: int, exclude_map) -> None:
        # output node: the unique node with a var consumed outside the cluster
        # (or a graph output).  Root selection keeps this unique for cones;
        # if it still isn't (defensive), take the topologically-last external
        # node — back_build then falls back to all-replicate if needed.
        external_nodes = []
        for node in self.nodes.values():
            for v in node.outvars:
                if v is None:
                    continue
                external = not v.consumers or any(
                    c.uid not in self.nodes for c, _ in v.consumers)
                if external:
                    external_nodes.append(node)
                    break
        if not external_nodes:
            out_node = next(iter(self.nodes.values()))
        else:
            if len(external_nodes) > 1:
                logger.debug("cluster %d has %d external nodes; using the "
                             "last one", self.cid, len(external_nodes))
            out_node = max(external_nodes, key=lambda n: n.uid)
        self.output_node = out_node

        self.strategies = []
        seen = set()
        for idx, s in enumerate(out_node.strategy_pool(axis_size,
                                                       exclude_map(out_node))):
            results: List[Dict[int, Tuple[int, NodeStrategy]]] = []
            self._back_build_all([(out_node, s)],
                                 {out_node.uid: (idx, s)}, axis_size,
                                 exclude_map, results, steps=[0])
            for chosen in results:
                if len(chosen) != len(self.nodes):
                    logger.debug("cluster %d: strategy %d left nodes "
                                 "unassigned", self.cid, idx)
                    continue
                key = tuple(sorted((uid, i) for uid, (i, _) in chosen.items()))
                if key in seen:
                    continue
                seen.add(key)
                self.strategies.append(chosen)
        if not self.strategies:
            # fall back to all-replicate so the solver always has a choice
            chosen = {n.uid: (-1, n.replicate_strategy())
                      for n in self.nodes.values()}
            self.strategies.append(chosen)

    def strategy_count(self) -> int:
        return len(self.strategies)

    def node_strategy(self, node_uid: int, strategy_idx: int) -> NodeStrategy:
        return self.strategies[strategy_idx][node_uid][1]


class MetaGraph:

    def __init__(self, name: str = "graph"):
        self.name = name
        self.inputs: List[MetaNode] = []  # placeholder nodes
        self.ops: List[MetaNode] = []  # topological order, excludes inputs
        self.outputs: List[MetaVar] = []
        self.clusters: List[MetaNodeCluster] = []
        # updated-state outvar -> input placeholder node (train-step param/opt
        # threading; reference state_io_map, metair.py:793)
        self.state_io: Dict[str, MetaNode] = {}

    def add_input(self, node: MetaNode):
        self.inputs.append(node)

    def add_op(self, node: MetaNode):
        self.ops.append(node)

    def all_nodes(self) -> List[MetaNode]:
        return self.inputs + self.ops

    # ------------------------------------------------------------ liveness

    def liveness(self) -> List[List[MetaVar]]:
        """Live variable set before each op (reference metair.py:818-840)."""
        live: Dict[str, MetaVar] = {v.name: v for v in self.outputs}
        timeline: List[List[MetaVar]] = []
        for op in reversed(self.ops):
            for v in op.invars:
                if v is not None:
                    live[v.name] = v
            for v in op.outvars:
                if v is not None:
                    live[v.name] = v
            timeline.insert(0, list(live.values()))
            for v in op.outvars:
                if v is not None:
                    live.pop(v.name, None)
        return timeline

    # ---------------------------------------------------------- clustering

    def _cone_roots(self) -> List[MetaNode]:
        """A node roots a cone unless it has exactly one consumer, exactly one
        produced input, and does not shrink its input (reference
        find_cone_roots, metair.py:852-892)."""
        roots = []
        for node in self.ops:
            if node.op_key in _SOLO_CLUSTER_OPS:
                # composites must never be grown into a downstream cone:
                # back-build would sync-free-match their many-input boundary
                # and silently drop strategies (a single-outvar scan passes
                # every other root test)
                roots.append(node)
                continue
            # externally-visible edges: every consumer, plus each dangling /
            # graph-output var (no consumers).  A cone interior node must
            # have exactly one — multi-output prims like scan whose extra
            # outputs dangle would otherwise give a cone two output nodes.
            external = 0
            for v in node.outvars:
                if v is None:
                    continue
                external += len(v.consumers) if v.consumers else 1
            if external != 1:
                roots.append(node)
                continue
            produced_ins = [v for v in node.invars
                            if v is not None and v.producer is not None
                            and not v.producer.is_input]
            if len(produced_ins) > 1:
                roots.append(node)
                continue
            if len(produced_ins) == 0:
                continue  # interior leaf of some cone
            out_sizes = [v.size_bytes() for v in node.outvars if v is not None]
            if out_sizes and out_sizes[0] < produced_ins[0].size_bytes():
                roots.append(node)
        return roots

    def coarsen(self, axis_size: int, level: int = 1,
                exclude_map=lambda node: ()) -> None:
        """Build clusters and their sync-free strategy lists.

        level 0: one node per cluster; level >=1: cone clusters.
        `exclude_map(node)` returns strategies banned for that node (already
        chosen on previous mesh axes)."""
        self.clusters = []
        for node in self.inputs:
            c = MetaNodeCluster(len(self.clusters))
            c.add(node)
            c.finalize(axis_size, exclude_map)
            self.clusters.append(c)

        if level == 0:
            for node in self.ops:
                c = MetaNodeCluster(len(self.clusters))
                c.add(node)
                c.finalize(axis_size, exclude_map)
                self.clusters.append(c)
            return

        roots = self._cone_roots()
        root_ids = {n.uid for n in roots}
        visited = set()

        def grow(node: MetaNode, cluster: MetaNodeCluster):
            cluster.add(node)
            visited.add(node.uid)
            for v in node.invars:
                if v is not None and v.producer is not None \
                        and not v.producer.is_input \
                        and v.producer.uid not in root_ids \
                        and v.producer.uid not in visited:
                    grow(v.producer, cluster)

        for root in roots:
            c = MetaNodeCluster(len(self.clusters))
            if root.op_key in _SOLO_CLUSTER_OPS:
                # composite ops price their internals via intrinsic_cost and
                # have many-input boundaries; absorbing producers into their
                # cone would DROP any strategy a producer can't serve
                # sync-free (R->S is a free slice when priced as an edge)
                c.add(root)
                visited.add(root.uid)
            else:
                grow(root, c)
            c.finalize(axis_size, exclude_map)
            self.clusters.append(c)

        # any op not reached (cycles can't happen; dangling chains can)
        for node in self.ops:
            if node.uid not in visited:
                c = MetaNodeCluster(len(self.clusters))
                c.add(node)
                c.finalize(axis_size, exclude_map)
                self.clusters.append(c)

    def __repr__(self) -> str:
        lines = [f"MetaGraph({self.name}): {len(self.inputs)} inputs, "
                 f"{len(self.ops)} ops, {len(self.outputs)} outputs"]
        for op in self.ops:
            lines.append(f"  {op.outvars} <- {op.op_key} <- {op.invars}")
        return "\n".join(lines)
