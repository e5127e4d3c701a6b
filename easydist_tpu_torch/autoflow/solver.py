"""Global SPMD strategy selection: binary ILP over cluster strategies.

Formulation (reference AutoFlowSolver1D, autoflow/solver.py:224-730, rebuilt
on scipy/HiGHS since neither `mip` nor `ortools` ships here):

  variables   y[c,s] in {0,1}   cluster c uses strategy s
              z[e,i,j] >= 0     edge e joins producer strategy i / consumer j
  constraints sum_s y[c,s] == 1
              z[e,i,j] >= y[up(e),i] + y[down(e),j] - 1
  objective   min sum_e C_e[i,j] z[e,i,j]  +  w_mem * sum_e M_e[i,j] z[e,i,j]

With one-hot y and non-negative costs the z lower bounds make z behave as the
product y_up*y_down at the optimum, so z stays continuous — the model has far
fewer integers than the reference's all-binary AND-linearization.

Optionally a hard per-device memory cap is enforced per liveness step
(the reference left this half-finished: solver.py:665-707 commented out).

An ND mesh is solved one axis at a time by the frontend (reference
compile_auto.py:128-173): strategies already chosen on earlier axes are
excluded from pools and shapes pre-shrunk before the next 1D solve.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.metashard.metair import (MetaGraph, NodeStrategy,
                                          Placement)
from .cost_model import (MeshAxisSpec, overlap_discount_ratio,
                         placement_bytes, resharding_cost)

logger = logging.getLogger(__name__)

_op_times_cache: Optional[Tuple[Tuple[str, float], Dict[str, float]]] = None
# check-then-reload below is a read-mutate race under ServeEngine's
# concurrent bucket compiles (two threads can interleave the None check and
# the assignment, one returning a half-installed table); all access to the
# module global goes through this lock
_op_times_lock = threading.Lock()


def _cached_op_times() -> Dict[str, float]:
    """PerfDB op-time table, reloaded only when the DB file changes (the
    solver runs once per mesh axis per compile).  Thread-safe."""
    global _op_times_cache
    from easydist_tpu_torch.runtime.perfdb import db_mtime

    path = edconfig.prof_db_path
    mtime = db_mtime(path)
    if mtime is None:
        return {}
    key = (path, mtime)
    with _op_times_lock:
        if _op_times_cache is None or _op_times_cache[0] != key:
            from easydist_tpu_torch.runtime.op_profile import load_op_times

            _op_times_cache = (key, load_op_times())
        return _op_times_cache[1]


class _Edge:
    """One producer-cluster -> consumer-cluster tensor dependency."""

    def __init__(self, var, up_cluster, up_node, out_idx,
                 down_cluster, down_node, in_idx):
        self.var = var
        self.up_cluster = up_cluster
        self.up_node = up_node
        self.out_idx = out_idx
        self.down_cluster = down_cluster
        self.down_node = down_node
        self.in_idx = in_idx
        self.comm: Optional[np.ndarray] = None
        self.mem: Optional[np.ndarray] = None
        self.z_offset: int = -1

    def up_placement(self, i: int) -> Placement:
        s = self.up_cluster.strategies[i][self.up_node.uid][1]
        return s.out_placements[self.out_idx]

    def down_placement(self, j: int) -> Placement:
        s = self.down_cluster.strategies[j][self.down_node.uid][1]
        if self.down_node.is_input:
            # state_io edge: the placeholder's "need" is its own out placement
            return s.out_placements[self.in_idx]
        return s.in_placements[self.in_idx]


class SpmdSolver:
    """Solve one mesh axis for a coarsened MetaGraph."""

    def __init__(self, graph: MetaGraph, axis: MeshAxisSpec,
                 reachability=None, free_outputs: bool = False,
                 cluster_dedup: Optional[bool] = None):
        self.graph = graph
        self.axis = axis
        self.reachability = reachability
        # per-solve override of edconfig.solver_cluster_dedup (composite-body
        # solves pass False: tying would fight their per-placeholder pins)
        self.cluster_dedup = edconfig.solver_cluster_dedup \
            if cluster_dedup is None else cluster_dedup
        # composite-body solves (scan/remat): graph outputs cross the
        # composite boundary with their own recombines, so sharded/partial
        # outputs must not be priced as if handed back replicated
        self.free_outputs = free_outputs
        self.clusters = graph.clusters
        self.edges: List[_Edge] = []
        # pure edge-communication cost of the solution this solver last
        # returned, computed from its own pick indices — the analyzer's
        # objective audit (analyze.audit_solver_objective) recomputes the
        # same number independently via assignment_comm_cost and compares
        self.last_comm_cost: Optional[float] = None
        self._collect_edges()
        self._build_matrices()
        # isomorphic-cluster tying: identical transformer layers share one
        # set of ILP variables (reference pain point: per-cluster binaries,
        # autoflow/solver.py:266-273 — an L-layer stack solved L times over)
        self.tie_rep: Dict[int, int] = {c.cid: c.cid for c in self.clusters}
        # under a hard memory cap, only non-uniform per-instance assignments
        # may be feasible and refinement is disabled — solve untied
        if self.cluster_dedup and edconfig.per_device_memory_cap <= 0:
            self._compute_tie_groups()

    # ------------------------------------------------------------ model build

    def _collect_edges(self):
        by_cid = {c.cid: c for c in self.clusters}
        for node in self.graph.all_nodes():
            down_c = by_cid[node.cluster_id]
            for in_idx, var in enumerate(node.invars):
                if var is None or var.producer is None:
                    continue
                up = var.producer
                if up.cluster_id == node.cluster_id:
                    continue  # intra-cluster: sync-free by construction
                self.edges.append(_Edge(var, by_cid[up.cluster_id], up,
                                        var.producer_idx, down_c, node, in_idx))
        # state threading: the producer of an updated state tensor should land
        # on the same placement the matching input placeholder chose, else the
        # next step pays a reshard (reference state_io_map edges,
        # solver.py:279-283)
        for out_name, placeholder in self.graph.state_io.items():
            var = next((v for v in self.graph.outputs if v.name == out_name), None)
            if var is None or var.producer is None:
                continue
            self.edges.append(_Edge(var, by_cid[var.producer.cluster_id],
                                    var.producer, var.producer_idx,
                                    by_cid[placeholder.cluster_id], placeholder,
                                    0))

        # non-state graph outputs are handed back to the user replicated, so a
        # PARTIAL or SHARD producer pays the final collective here (reference
        # forces returns to REPLICATE, torch/passes/sharding.py:920-949).
        # Linear cost on the producer cluster's y variables.  The same
        # vector carries the compute-redundancy cost: a strategy that
        # replicates an op's outputs runs the op full-size on every device,
        # while sharded/partial outputs split the work 1/n — without this
        # term, replicate-everything is a free zero-communication optimum.
        self.output_y_cost: Dict[int, np.ndarray] = {}
        inv_hbm = 1.0 / edconfig.hbm_bandwidth
        # measured per-op seconds (PerfDB, keyed by the node's signature)
        # price compute-redundancy exactly; the HBM proxy covers misses
        # (reference runtime_prof.py:35-150 -> solver costs)
        op_times = _cached_op_times() if edconfig.use_op_cost_db else {}
        n_comp = n_hit = 0
        # strategy-independent per-node numbers, computed once (the cost
        # loop runs per cluster x strategy x node and dominates solve prep)
        from .reachability import _node_flops

        _node_cache: Dict[int, tuple] = {}

        def node_numbers(node):
            got = _node_cache.get(id(node))
            if got is None:
                got = (_node_flops(node),
                       [v.size_bytes() if v is not None else 0
                        for v in node.invars],
                       [v.size_bytes() if v is not None else 0
                        for v in node.outvars])
                _node_cache[id(node)] = got
            return got

        for c in self.clusters:
            costs = None
            for s in range(c.strategy_count()):
                t = 0.0
                for uid, (_, strat) in c.strategies[s].items():
                    node = c.nodes[uid]
                    if node.is_input:
                        continue
                    measured = op_times.get(node.sig) if node.sig else None
                    if s == 0:
                        n_comp += 1
                        n_hit += measured is not None
                    strat_compute = getattr(strat, "compute_cost", None)
                    if strat_compute is not None:
                        # composite strategies price their body per-op
                        t += strat_compute
                    elif measured is not None or \
                            node.compute_proxy is not None:
                        full_t = measured if measured is not None \
                            else node.compute_proxy
                        # scalar time sources: only SHARD splits the work
                        # 1/n (a pure P-propagating op runs full-shape on
                        # every rank, same as replicate)
                        sharded = any(
                            p is not None and p.is_shard()
                            for p in list(strat.out_placements)
                            + list(strat.in_placements))
                        factor = (1.0 / self.axis.size) if sharded else 1.0
                        t += factor * full_t
                    else:
                        n = self.axis.size
                        flops, in_b, out_b = node_numbers(node)
                        sharded = any(
                            p is not None and p.is_shard()
                            for p in list(strat.out_placements)
                            + list(strat.in_placements))
                        if flops > 0.0:
                            # tensor-core ops: per-strategy roofline at LOCAL
                            # sizes, discounting only the vars the
                            # strategy actually shards.  This is what
                            # makes weight-stationary TP visible — an
                            # output-bytes proxy hides the weight-read
                            # half of its savings (r5 Phase B).
                            nbytes = sum(
                                b / n if (p is not None and p.is_shard())
                                else b for b, p in
                                zip(in_b, strat.in_placements))
                            nbytes += sum(
                                b / n if (p is not None and p.is_shard())
                                else b for b, p in
                                zip(out_b, strat.out_placements))
                            if sharded:
                                flops /= n  # any sharded dim splits MACs
                            t += max(flops / edconfig.peak_flops,
                                     nbytes / edconfig.hbm_bandwidth)
                        else:
                            # memory-bound ops keep the conservative
                            # output-bytes proxy: pricing their input
                            # traffic too makes the ILP chase ZeRO-style
                            # param scatter at toy scale, where the per-
                            # collective alpha dwarfs the savings (the
                            # dp x tp never-costlier gate pins this)
                            full_t = sum(out_b) * inv_hbm
                            t += full_t * ((1.0 / n) if sharded else 1.0)
                    # composite ops (scan bodies) carry their internal
                    # per-strategy collective seconds here
                    t += getattr(strat, "intrinsic_cost", 0.0)
                if t > 0.0:
                    if costs is None:
                        costs = np.zeros(c.strategy_count())
                    costs[s] = t
            if costs is not None:
                self.output_y_cost[c.cid] = costs
        if op_times and n_comp:
            logger.info("[SpmdSolver] op-cost DB hit rate %d/%d (%.0f%%)",
                        n_hit, n_comp, 100.0 * n_hit / n_comp)
        state_outs = set(self.graph.state_io)
        for var in self.graph.outputs:
            if self.free_outputs or var.name in state_outs \
                    or var.producer is None:
                continue
            c = by_cid[var.producer.cluster_id]
            costs = self.output_y_cost.setdefault(
                c.cid, np.zeros(c.strategy_count()))
            for s in range(c.strategy_count()):
                p = c.strategies[s][var.producer.uid][1].out_placements[
                    var.producer_idx]
                if p is not None:
                    costs[s] += resharding_cost(
                        var.size_bytes(), p, Placement.replicate(),
                        self.axis, var.itemsize())

    def _build_matrices(self):
        for e in self.edges:
            n_up = e.up_cluster.strategy_count()
            n_down = e.down_cluster.strategy_count()
            comm = np.zeros((n_up, n_down))
            mem = np.zeros((n_up, n_down))
            size = e.var.size_bytes()
            for i in range(n_up):
                pu = e.up_placement(i)
                for j in range(n_down):
                    pd = e.down_placement(j)
                    if pu is None or pd is None:
                        continue
                    comm[i, j] = resharding_cost(size, pu, pd, self.axis,
                                                 e.var.itemsize())
                    mem[i, j] = (placement_bytes(size, pu, self.axis.size)
                                 + placement_bytes(size, pd, self.axis.size))
                    # a P edge carries an unrealized reduction: when a
                    # deferred plan is comm-byte-NEUTRAL (psum at the fence
                    # costs what the immediate psum did), prefer the
                    # immediate one — full-size partials inflate liveness
                    # and block remat for no wire saving.  Epsilon-scale so
                    # it can never flip a genuinely byte-saving deferral.
                    if (pu is not None and pu.is_partial()) \
                            or (pd is not None and pd.is_partial()):
                        mem[i, j] += 1e-3 * size
            if self.reachability is not None and edconfig.predict_comm_overlap:
                # overlap-capable collectives cost less — but only as much
                # as the independent compute can actually hide (the
                # reference's flat discount, adjust_resharding_cost
                # solver.py:79-84, fires on ANY parallel flops; here the
                # hideable seconds bound the reduction per edge, and the
                # ratio comes from overlap_discount_ratio(): the runtime-
                # MEASURED fraction when calibrate_overlap has recorded
                # one, else the configured guess (per
                # comm_overlap_ratio_source)
                ratio = overlap_discount_ratio()
                hideable = self.reachability.independent_peer_seconds(
                    e.up_node.name, e.down_node.name)
                if hideable > 0 and ratio > 0:
                    comm = comm - ratio * np.minimum(comm, hideable)
            e.comm, e.mem = comm, mem

    def _compute_tie_groups(self):
        """Weisfeiler-Lehman style refinement: clusters with identical
        strategy tables AND isomorphic cost environments collapse to one
        representative.  Tying restricts the solution space to uniform
        per-type strategies — exactly the repeated-layer optimum."""
        import hashlib

        def sig(c):
            parts = [str(c.strategy_count())]
            for uid, node in c.nodes.items():
                parts.append(str([None if v is None else v.size_bytes()
                                  for v in node.invars]))
                parts.append(str([None if v is None else v.size_bytes()
                                  for v in node.outvars]))
            for s in range(c.strategy_count()):
                for uid, (_, st) in c.strategies[s].items():
                    parts.append(f"{st.in_placements}>{st.out_placements}")
            yc = self.output_y_cost.get(c.cid)
            parts.append("-" if yc is None else yc.tobytes().hex())
            return hashlib.sha256("|".join(parts).encode()).hexdigest()

        h = {c.cid: sig(c) for c in self.clusters}
        # ONE refinement round: content + immediate cost environment.  More
        # rounds would progressively split a repeated-layer chain from both
        # ends (layer 2's depth-2 environment sees the distinct embedding),
        # reverting the dedup; one round keeps boundary layers separate
        # (where tying is actually risky) and ties the middle.
        for _ in range(1):
            env: Dict[int, list] = {c.cid: [] for c in self.clusters}
            for e in self.edges:
                ekey = hashlib.sha256(
                    e.comm.tobytes() + e.mem.tobytes()
                    + f"{e.out_idx}:{e.in_idx}".encode()).hexdigest()
                env[e.up_cluster.cid].append(
                    f"out:{ekey}:{h[e.down_cluster.cid]}")
                env[e.down_cluster.cid].append(
                    f"in:{ekey}:{h[e.up_cluster.cid]}")
            h = {c.cid: hashlib.sha256(
                    (h[c.cid] + "|".join(sorted(env[c.cid]))).encode()
                 ).hexdigest() for c in self.clusters}

        first: Dict[str, int] = {}
        for c in self.clusters:
            self.tie_rep[c.cid] = first.setdefault(h[c.cid], c.cid)
        n_rep = len(set(self.tie_rep.values()))
        if n_rep < len(self.clusters):
            logger.info("[SpmdSolver] tied %d clusters into %d groups",
                        len(self.clusters), n_rep)

    def _picks_comm_cost(self, picks: Dict[int, int]) -> float:
        """Edge-communication cost of a {cid: strategy_idx} solution."""
        return float(sum(
            e.comm[picks[e.up_cluster.cid], picks[e.down_cluster.cid]]
            for e in self.edges))

    def assignment_comm_cost(self, chosen: Dict[str, NodeStrategy]) -> float:
        """Pure edge-communication cost of a node-strategy assignment
        (no y costs): 0.0 means sync-free."""
        pick: Dict[int, int] = {}
        for c in self.clusters:
            for s in range(c.strategy_count()):
                if all(c.strategies[s][uid][1]
                       == chosen.get(c.nodes[uid].name)
                       for uid in c.strategies[s]):
                    pick[c.cid] = s
                    break
            else:
                return float("inf")
        return sum(e.comm[pick[e.up_cluster.cid], pick[e.down_cluster.cid]]
                   for e in self.edges)

    # ----------------------------------------------------------------- solve

    def solve(self) -> Dict[str, NodeStrategy]:
        if edconfig.solver_backend == "beam" or not self.edges:
            return self.beam_search()
        try:
            return self._ilp_solve()
        except Exception:
            logger.exception("ILP solve failed; falling back to beam search")
            return self.beam_search()

    def _ilp_solve(self, apply_memory_cap: bool = True
                   ) -> Dict[str, NodeStrategy]:
        start = time.perf_counter()
        rep = self.tie_rep
        rep_clusters = [c for c in self.clusters if rep[c.cid] == c.cid]

        y_offset: Dict[int, int] = {}
        nvar = 0
        for c in rep_clusters:
            y_offset[c.cid] = nvar
            nvar += c.strategy_count()
        n_y = nvar

        # tied edges with identical cost matrices collapse into one z block
        # with a multiplicity weight
        groups: Dict[tuple, list] = {}
        for e in self.edges:
            key = (rep[e.up_cluster.cid], rep[e.down_cluster.cid],
                   e.comm.tobytes(), e.mem.tobytes())
            if key in groups:
                groups[key][0] += 1
            else:
                groups[key] = [1, e]
        edge_groups = list(groups.values())
        for _, e in edge_groups:
            e.z_offset = nvar
            nvar += e.up_cluster.strategy_count() * e.down_cluster.strategy_count()

        # objective = comm (dominant) + memory (strict tie-breaker).
        # Comm is rescaled to O(1): raw costs in seconds (~1e-8) sit below
        # HiGHS's default tolerances, which silently accepts suboptimal
        # incumbents.  Memory is then scaled so that the TOTAL memory term
        # stays below the smallest nonzero comm difference — it can order
        # comm-equivalent solutions (shard beats replicate) but never flip a
        # real comm decision.
        comm = np.zeros(nvar)
        mem = np.zeros(nvar)
        for count, e in edge_groups:
            comm[e.z_offset:e.z_offset + e.comm.size] = count * e.comm.ravel()
            mem[e.z_offset:e.z_offset + e.mem.size] = count * e.mem.ravel()
        for cid, costs in self.output_y_cost.items():
            off = y_offset[rep[cid]]
            comm[off:off + costs.size] += costs
        cost_scale = float(comm.max())
        if cost_scale > 0:
            comm = comm / cost_scale
        positive = comm[comm > 0]
        min_comm_step = positive.min() if positive.size else 1.0
        mem_max = float(mem.max())
        if mem_max > 0:
            n_active = max(len(edge_groups), 1)
            mem = mem * (min_comm_step / (10.0 * n_active * mem_max))
        cost = comm + mem

        rows, cols, vals, lbs, ubs = [], [], [], [], []
        row = 0
        # one-hot cluster choice
        for c in rep_clusters:
            for s in range(c.strategy_count()):
                rows.append(row); cols.append(y_offset[c.cid] + s); vals.append(1.0)
            lbs.append(1.0); ubs.append(1.0)
            row += 1
        # marginal (transportation) formulation — tighter LP relaxation than
        # z >= y_up + y_down - 1 and fewer rows (n_up + n_down per edge):
        #   sum_j z[i, j] == y_up[i],  sum_i z[i, j] == y_down[j]
        # with integral y the z become exactly the indicator of the chosen
        # pair; the LP picks the cheapest joint consistent with the
        # marginals.  (A self-type edge's rows stay valid: both marginal
        # systems constrain the same tied y vector.)
        for _, e in edge_groups:
            n_up = e.up_cluster.strategy_count()
            n_down = e.down_cluster.strategy_count()
            up_off = y_offset[rep[e.up_cluster.cid]]
            down_off = y_offset[rep[e.down_cluster.cid]]
            for i in range(n_up):
                for j in range(n_down):
                    rows.append(row)
                    cols.append(e.z_offset + i * n_down + j)
                    vals.append(1.0)
                rows.append(row); cols.append(up_off + i); vals.append(-1.0)
                lbs.append(0.0); ubs.append(0.0)
                row += 1
            for j in range(n_down):
                for i in range(n_up):
                    rows.append(row)
                    cols.append(e.z_offset + i * n_down + j)
                    vals.append(1.0)
                rows.append(row); cols.append(down_off + j); vals.append(-1.0)
                lbs.append(0.0); ubs.append(0.0)
                row += 1

        # optional hard memory cap per liveness step
        cap = edconfig.per_device_memory_cap if apply_memory_cap else 0
        if cap > 0:
            cap_eff = cap * edconfig.memory_ratio
            producer_cluster = {}
            for c in self.clusters:
                for n in c.nodes.values():
                    # liveness_only_input: cap only placeholder tensors
                    # (params/state dominate; activations churn fast —
                    # reference config.liveness_only_input)
                    if edconfig.liveness_only_input and not n.is_input:
                        continue
                    for v in n.outvars:
                        if v is not None:
                            producer_cluster[v.name] = (c, n, v.producer_idx)
            for live in self.graph.liveness():
                any_entry = False
                for v in live:
                    hit = producer_cluster.get(v.name)
                    if hit is None:
                        continue
                    c, n, out_idx = hit
                    for s in range(c.strategy_count()):
                        p = c.strategies[s][n.uid][1].out_placements[out_idx]
                        if p is None:
                            continue
                        rows.append(row)
                        cols.append(y_offset[rep[c.cid]] + s)
                        vals.append(placement_bytes(v.size_bytes(), p,
                                                    self.axis.size))
                        any_entry = True
                if any_entry:
                    lbs.append(-np.inf); ubs.append(cap_eff)
                    row += 1

        A = sparse.csr_matrix((vals, (rows, cols)), shape=(row, nvar))
        integrality = np.zeros(nvar)
        integrality[:n_y] = 1
        res = milp(c=cost,
                   constraints=LinearConstraint(A, np.array(lbs), np.array(ubs)),
                   integrality=integrality,
                   bounds=Bounds(0, 1),
                   options={"time_limit": edconfig.solver_time_limit,
                            # plateaus of equal-cost optima (latency and
                            # compute terms quantize) make optimality proofs
                            # explode; a small gap ends the search early
                            "mip_rel_gap": edconfig.solver_mip_rel_gap})
        # status 1 = iteration/time limit: keep the incumbent if HiGHS found one
        if res.x is None or res.status not in (0, 1):
            if apply_memory_cap and edconfig.per_device_memory_cap > 0 \
                    and res.status == 2:
                # no sharding assignment satisfies the liveness cap: solve
                # for minimum communication uncapped — the downstream remat
                # pass (schedule/remat.py) closes the remaining memory gap
                logger.warning(
                    "[SpmdSolver] liveness cap %.2f GiB infeasible on axis "
                    "%s; re-solving uncapped (auto-remat takes over)",
                    edconfig.per_device_memory_cap * edconfig.memory_ratio
                    / 2**30, self.axis.name)
                # the capped model ran untied (only non-uniform assignments
                # can dodge a cap); the uncapped fallback must re-tie, or
                # the larger untied ILP lands on a different near-tie than
                # the cap-0 solve and the remat planner sees a worse plan
                if self.cluster_dedup:
                    self._compute_tie_groups()
                return self._ilp_solve(apply_memory_cap=False)
            raise RuntimeError(f"MILP failed: status={res.status} {res.message}")
        logger.info("[SpmdSolver] axis=%s clusters=%d (%d tied) edges=%d "
                    "(%d grouped) vars=%d cost=%.3e time=%.2fs",
                    self.axis.name, len(self.clusters), len(rep_clusters),
                    len(self.edges), len(edge_groups), nvar, res.fun,
                    time.perf_counter() - start)

        picks: Dict[int, int] = {}
        for c in self.clusters:
            off = y_offset[rep[c.cid]]
            ys = res.x[off:off + c.strategy_count()]
            picks[c.cid] = int(np.argmax(ys))
        # Local refinement always runs: it recovers per-instance deviations
        # the tied quotient model cannot express AND deterministically
        # enforces the memory tie-break that mip_rel_gap's early stop may
        # leave on the table (the gap tolerance is orders of magnitude
        # larger than the scaled memory term).  Strictly monotone in the
        # untied objective.
        picks = self._refine(picks, capped=(
            apply_memory_cap and edconfig.per_device_memory_cap > 0))
        self.last_comm_cost = self._picks_comm_cost(picks)

        chosen: Dict[str, NodeStrategy] = {}
        for c in self.clusters:
            for uid, (_, strat) in c.strategies[picks[c.cid]].items():
                chosen[c.nodes[uid].name] = strat
        return chosen

    def _refine(self, picks: Dict[int, int], max_sweeps: int = 10,
                capped: bool = False) -> Dict[int, int]:
        """Coordinate descent on the full (untied) model: re-pick each
        cluster's strategy given its neighbors until a fixed point."""
        if capped:
            # a local move could break the per-liveness-step cap the ILP
            # enforced; keep the capped solution as-is.  (The uncapped
            # FALLBACK solve does refine — its model has no cap to break,
            # and skipping left a memory-worse near-tie for remat.)
            return picks
        in_edges: Dict[int, List[_Edge]] = {}
        out_edges: Dict[int, List[_Edge]] = {}
        for e in self.edges:
            in_edges.setdefault(e.down_cluster.cid, []).append(e)
            out_edges.setdefault(e.up_cluster.cid, []).append(e)
        all_comm = [c for e in self.edges for c in e.comm.ravel() if c > 0]
        min_comm = min(all_comm) if all_comm else 1.0
        max_mem = max((float(e.mem.max()) for e in self.edges), default=0.0)
        w_mem = (min_comm / (10.0 * max(len(self.edges), 1) * max_mem)
                 if max_mem > 0 else 0.0)
        eps = 1e-12

        def local_cost(c, s):
            cost = 0.0
            yc = self.output_y_cost.get(c.cid)
            if yc is not None:
                cost += float(yc[s])
            for e in in_edges.get(c.cid, []):
                i = picks[e.up_cluster.cid]
                cost += e.comm[i, s] + w_mem * e.mem[i, s]
            for e in out_edges.get(c.cid, []):
                j = picks[e.down_cluster.cid]
                cost += e.comm[s, j] + w_mem * e.mem[s, j]
            return cost

        by_cid = {c.cid: c for c in self.clusters}

        def local_cost_overlay(c, s, overlay):
            # edges into the moving region get a hair more weight so that a
            # locally-indifferent node follows the chain instead of stalling
            # the propagation at a tie (acceptance still uses true cost)
            cost = 0.0
            yc = self.output_y_cost.get(c.cid)
            if yc is not None:
                cost += float(yc[s])
            for e in in_edges.get(c.cid, []):
                up = e.up_cluster.cid
                i = overlay.get(up, picks[up])
                w = 1.0 + 1e-6 if up in overlay else 1.0
                cost += w * (e.comm[i, s] + w_mem * e.mem[i, s])
            for e in out_edges.get(c.cid, []):
                dn = e.down_cluster.cid
                j = overlay.get(dn, picks[dn])
                w = 1.0 + 1e-6 if dn in overlay else 1.0
                cost += w * (e.comm[s, j] + w_mem * e.mem[s, j])
            return cost

        def region_cost(cids, overlay):
            total = 0.0
            seen = set()
            for cid in cids:
                c = by_cid[cid]
                s = overlay.get(cid, picks[cid])
                yc = self.output_y_cost.get(cid)
                if yc is not None:
                    total += float(yc[s])
                for e in in_edges.get(cid, []) + out_edges.get(cid, []):
                    if id(e) in seen:
                        continue
                    seen.add(id(e))
                    i = overlay.get(e.up_cluster.cid,
                                    picks[e.up_cluster.cid])
                    j = overlay.get(e.down_cluster.cid,
                                    picks[e.down_cluster.cid])
                    total += e.comm[i, j] + w_mem * e.mem[i, j]
            return total

        def try_flip(root, s_root, cap=64):
            """Ejection chain: flip `root` to `s_root`, propagate each
            neighbor's best response (tied optimizer chains are coupled
            through zero-cost-when-consistent edges, so a profitable flip
            only shows up when the whole chain moves), accept if the
            affected region got cheaper."""
            overlay = {root.cid: s_root}
            frontier = [root]
            while frontier and len(overlay) < cap:
                c = frontier.pop()
                peers = [e.up_cluster for e in in_edges.get(c.cid, [])] + \
                        [e.down_cluster for e in out_edges.get(c.cid, [])]
                for q in peers:
                    if q.cid in overlay:
                        continue
                    costs = [local_cost_overlay(q, s, overlay)
                             for s in range(q.strategy_count())]
                    s_q = int(np.argmin(costs))
                    if s_q != picks[q.cid] \
                            and costs[s_q] < costs[picks[q.cid]] - 1e-18:
                        overlay[q.cid] = s_q
                        frontier.append(q)
            cids = list(overlay)
            if region_cost(cids, overlay) < region_cost(cids, {}) - eps:
                picks.update(overlay)
                return True
            return False

        moves = 0
        for _ in range(max_sweeps):
            changed = False
            for c in self.clusters:
                # cheap single move first, ejection chain if it is blocked
                cur = picks[c.cid]
                cur_cost = local_cost(c, cur)
                for s in range(c.strategy_count()):
                    if s == cur:
                        continue
                    if local_cost(c, s) < cur_cost - eps:
                        picks[c.cid] = s
                        cur, cur_cost = s, local_cost(c, s)
                        changed = True
                        moves += 1
                    elif try_flip(c, s):
                        cur, cur_cost = picks[c.cid], local_cost(
                            c, picks[c.cid])
                        changed = True
                        moves += 1
            if not changed:
                break
        if moves:
            logger.info("[SpmdSolver] refinement applied %d moves", moves)
        return picks

    # ----------------------------------------------------------- beam search

    def beam_search(self, width: Optional[int] = None) -> Dict[str, NodeStrategy]:
        """Greedy beam over clusters in order (reference solver.py:814-890)."""
        width = width or edconfig.beam_width
        # an edge's cost is charged when its SECOND endpoint gets assigned, so
        # edges in either direction (incl. state_io edges, whose producer
        # cluster comes after the placeholder consumer) are all priced
        in_edges: Dict[int, List[_Edge]] = {}
        out_edges: Dict[int, List[_Edge]] = {}
        for e in self.edges:
            in_edges.setdefault(e.down_cluster.cid, []).append(e)
            out_edges.setdefault(e.up_cluster.cid, []).append(e)

        # same comm >> memory hierarchy as the ILP objective
        all_comm = [c for e in self.edges for c in e.comm.ravel() if c > 0]
        min_comm = min(all_comm) if all_comm else 1.0
        max_mem = max((float(e.mem.max()) for e in self.edges), default=0.0)
        w_mem = (min_comm / (10.0 * max(len(self.edges), 1) * max_mem)
                 if max_mem > 0 else 0.0)

        # hot loop: prefer the native C++ beam core when built
        from easydist_tpu_torch import native

        pos = {c.cid: i for i, c in enumerate(self.clusters)}
        if native.available():
            strat_count = [c.strategy_count() for c in self.clusters]
            y_cost_list = [
                np.asarray(self.output_y_cost.get(c.cid,
                                                  np.zeros(c.strategy_count())))
                for c in self.clusters]
            n_edges = [(pos[e.up_cluster.cid], pos[e.down_cluster.cid],
                        e.comm + w_mem * e.mem) for e in self.edges]
            res = native.beam_search_native(strat_count, y_cost_list, n_edges,
                                            width)
            if res is not None:
                assign, best_cost = res
                logger.info("[SpmdSolver.beam/native] axis=%s cost=%.3e",
                            self.axis.name, best_cost)
                self.last_comm_cost = self._picks_comm_cost(
                    {c.cid: int(assign[pos[c.cid]]) for c in self.clusters})
                chosen: Dict[str, NodeStrategy] = {}
                for c in self.clusters:
                    for uid, (_, strat) in \
                            c.strategies[int(assign[pos[c.cid]])].items():
                        chosen[c.nodes[uid].name] = strat
                return chosen
        # beam entries: (cost, {cid: strategy_idx})
        beam: List[Tuple[float, Dict[int, int]]] = [(0.0, {})]
        for c in self.clusters:
            grown: List[Tuple[float, Dict[int, int]]] = []
            out_cost = self.output_y_cost.get(c.cid)
            for base_cost, assign in beam:
                for s in range(c.strategy_count()):
                    delta = 0.0 if out_cost is None else float(out_cost[s])
                    for e in in_edges.get(c.cid, []):
                        i = assign.get(e.up_cluster.cid)
                        if i is not None:
                            delta += e.comm[i, s] + w_mem * e.mem[i, s]
                    for e in out_edges.get(c.cid, []):
                        j = assign.get(e.down_cluster.cid)
                        if j is not None and e.down_cluster.cid != c.cid:
                            delta += e.comm[s, j] + w_mem * e.mem[s, j]
                    grown.append((base_cost + delta, {**assign, c.cid: s}))
            grown.sort(key=lambda t: t[0])
            beam = grown[:width]

        best_cost, best = beam[0]
        logger.info("[SpmdSolver.beam] axis=%s cost=%.3e", self.axis.name,
                    best_cost)
        self.last_comm_cost = self._picks_comm_cost(best)
        chosen: Dict[str, NodeStrategy] = {}
        for c in self.clusters:
            for uid, (_, strat) in c.strategies[best[c.cid]].items():
                chosen[c.nodes[uid].name] = strat
        return chosen
