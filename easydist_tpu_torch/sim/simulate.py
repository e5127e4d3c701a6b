"""Calibrated performance simulator: discrete-event replay of a solved
MetaIR graph or of a traced program (port of easydist_tpu/sim/simulate.py;
DistIR, arXiv:2111.05426 — trace-driven prediction over a distributed IR
with per-op measured costs).

Cost sources, in priority order, all consumed through read-only PerfDB
snapshots (`runtime/perfdb.py::snapshot`):

  1. measured per-op seconds from the op-profile DB
     (`runtime/op_profile.py::profile_ops`), keyed by the SAME signature
     string (`fxfront.interpreter.node_signature`) the FX -> MetaIR
     bridge stamps on each node;
  2. the node's `compute_proxy` / exact-flops roofline against the
     calibrated `hbm_bandwidth`/`peak_flops`
     (`runtime/calibrate.py::calibrate` / the device datasheet);
  3. the solver's conservative output-bytes/HBM proxy.

Collective seconds come from the SAME alpha-beta closed forms the solver
prices edges with (`autoflow/cost_model.py::resharding_cost`), and the
overlap discount is the solver's `overlap_discount_ratio()` — simulator
and solver never disagree about what a collective costs.

Host dispatch.  The JAX package runs one XLA program a step, so its
replay has one device stream.  The port's compiled programs replay their
aten calls one by one from the host, and a decode round of GPT-2 small
issues ~550 of them against ~2 ms of device work.  So the replay here
has a HOST stream as well: each call costs `OpTimeTable.dispatch_s`
there, a kernel starts no earlier than the host has issued it, and the
program ends when both streams have ended.  A host-bound program's wall
time over its calls is that cost (`store_dispatch`, per domain, beside
the op table under `DISPATCH_KEY`).  `profile_ops` times one call between
two CUDA events, so an op's table time also holds the host's latency to
launch it; `OpTimeTable.launch_s` (`measure_launch_floor`: the same
timing of a call that does no device work) is taken off every measured
time, so the device stream does not count the host twice.  With both 0
(the default, and `OpTimeTable({})`) the replay is the JAX package's.

Because summed per-op times still miss what the allocator, caching and
the replay's own bookkeeping do to a whole program, predictions go
through a one-point multiplicative RESIDUAL per domain ("train" /
"decode" / "prefill"), calibrated on one preset and validated on the
others.  The committed validation bound is `SIM_REL_ERROR_BOUND`.
"""

from __future__ import annotations

import logging
import math
import operator
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import torch

from easydist_tpu_torch import config as edconfig

from .events import EventLog, Stream

logger = logging.getLogger(__name__)

__all__ = ["SIM_REL_ERROR_BOUND", "RESIDUAL_KEY", "DISPATCH_KEY",
           "OpTimeTable", "SimReport", "replay_graph",
           "simulate_train_step", "predict_fn_seconds",
           "simulate_pipeline", "predict_pipeline_step",
           "predict_decode_throughput", "predict_ttft", "store_residual",
           "load_residual", "measure_launch_floor", "store_dispatch",
           "store_launch_floor", "relative_error"]

# committed validation contract: |predicted - measured| / measured on
# every non-calibration preset must stay under this bound
SIM_REL_ERROR_BOUND = 0.60

RESIDUAL_KEY = "sim_residual"
DISPATCH_KEY = "sim_dispatch"


def relative_error(predicted: float, measured: float) -> float:
    if measured <= 0.0:
        return math.inf if predicted > 0.0 else 0.0
    return abs(predicted - measured) / measured


def _device_key() -> str:
    """The backend name residuals and host times are stored under: the
    device type the port runs on by default."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _sub_key(name: Optional[str] = None) -> str:
    return f"{_device_key()}:{name}" if name else _device_key()


def _store(key: str, sub_key: str, value: float, db=None) -> None:
    from easydist_tpu_torch.runtime.perfdb import PerfDB

    db = db if db is not None else PerfDB()
    db.record_op_perf(key, sub_key, float(value))
    try:
        db.persist()
    except Exception:
        logger.warning("could not persist %s[%s]", key, sub_key)


# --------------------------------------------------------------- op table

class OpTimeTable:
    """Per-op seconds resolver over one PerfDB snapshot.

    `node_seconds` mirrors the solver's compute pricing exactly
    (autoflow/solver.py cost prep): measured signature time first, then
    the flops/bytes roofline, then the output-bytes/HBM proxy — so the
    simulator predicts with the same numbers the solver optimized
    against.  `dispatch_s` is the host's seconds to issue one call of a
    replayed program (0 = the host is never the bottleneck); `launch_s`
    the host latency every measured time holds, taken off it."""

    def __init__(self, op_times: Dict[str, float],
                 hbm_bandwidth: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 dispatch_s: float = 0.0, launch_s: float = 0.0):
        self.op_times = dict(op_times)
        self.hbm_bandwidth = hbm_bandwidth or edconfig.hbm_bandwidth
        self.peak_flops = peak_flops or edconfig.peak_flops
        self.dispatch_s = float(dispatch_s or 0.0)
        self.launch_s = float(launch_s or 0.0)
        self.hits = 0
        self.misses = 0

    @classmethod
    def from_perfdb(cls, db=None,
                    domain: Optional[str] = None) -> "OpTimeTable":
        """Build from the PerfDB snapshot: the card's op-profile table,
        any stored calibrate() fit (measured hbm_bandwidth wins over the
        datasheet/config default), the host's seconds a call for
        `domain` (else the device's default) and the launch floor."""
        from easydist_tpu_torch.runtime.calibrate import (_CAL_KEY,
                                                          _backend_key)
        from easydist_tpu_torch.runtime.op_profile import backend_key
        from easydist_tpu_torch.runtime.perfdb import PerfDB

        snap = (db if db is not None else PerfDB()).snapshot()
        op_times = dict(snap.get(backend_key(), {}))
        cal = snap.get(_CAL_KEY, {}).get(_backend_key()) or {}
        host = snap.get(DISPATCH_KEY, {})
        return cls(op_times,
                   hbm_bandwidth=cal.get("hbm_bandwidth"),
                   peak_flops=cal.get("peak_flops"),
                   dispatch_s=host.get(_sub_key(domain),
                                       host.get(_sub_key())),
                   launch_s=host.get(_sub_key("launch")))

    def node_seconds(self, sig: Optional[str], out_bytes: float,
                     flops: Optional[float] = None,
                     compute_proxy: Optional[float] = None,
                     in_bytes: float = 0.0) -> float:
        measured = self.op_times.get(sig) if sig else None
        if measured is not None:
            self.hits += 1
            return max(0.0, float(measured) - self.launch_s)
        self.misses += 1
        if compute_proxy is not None:
            return float(compute_proxy)
        if flops:
            return max(flops / self.peak_flops,
                       (in_bytes + out_bytes) / self.hbm_bandwidth)
        return out_bytes / self.hbm_bandwidth

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# ----------------------------------------------------------------- report

@dataclass
class SimReport:
    """One prediction with its replay breakdown.  `host_s` is the host
    stream's busy seconds (calls x dispatch_s), `compute_s` the device
    stream's."""

    predicted_s: float
    compute_s: float = 0.0
    comm_s: float = 0.0          # total seconds on the wire
    comm_exposed_s: float = 0.0  # wire seconds NOT hidden under compute
    n_ops: int = 0
    n_collectives: int = 0
    op_db_hit_rate: float = 0.0
    residual: float = 1.0
    detail: Dict[str, Any] = field(default_factory=dict)
    log: Optional[EventLog] = None
    host_s: float = 0.0

    def scaled(self, residual: float) -> "SimReport":
        """Apply a calibrated domain residual to the headline number."""
        return SimReport(self.predicted_s * residual, self.compute_s,
                         self.comm_s, self.comm_exposed_s, self.n_ops,
                         self.n_collectives, self.op_db_hit_rate,
                         residual, dict(self.detail), self.log, self.host_s)

    def as_dict(self) -> Dict[str, Any]:
        return {"predicted_s": self.predicted_s,
                "compute_s": round(self.compute_s, 9),
                "host_s": round(self.host_s, 9),
                "comm_s": round(self.comm_s, 9),
                "comm_exposed_s": round(self.comm_exposed_s, 9),
                "n_ops": self.n_ops,
                "n_collectives": self.n_collectives,
                "op_db_hit_rate": round(self.op_db_hit_rate, 3),
                "residual": round(self.residual, 6)}


def _issue(host: Stream, table: OpTimeTable, label: str) -> float:
    """The host issues one call; returns when the device may start it."""
    if table.dispatch_s <= 0.0:
        return 0.0
    return host.reserve(host.free_at, table.dispatch_s, label=label)[1]


# ----------------------------------------------------- solved-graph replay

def _placement_or_replicate(p):
    from easydist_tpu_torch.metashard.metair import Placement

    return p if p is not None else Placement.replicate()


def _shards(strat) -> bool:
    return any(p is not None and p.is_shard()
               for p in list(strat.out_placements)
               + list(strat.in_placements))


def replay_graph(graph, strategies: Sequence[Dict[str, Any]],
                 axes: Sequence[Any],
                 op_table: Optional[OpTimeTable] = None) -> SimReport:
    """Discrete-event replay of a solved MetaIR graph.

    `graph` is a `metashard.metair.MetaGraph` in topological order (the
    FX bridge's, `CompileResult.graphs[i]`: every axis's graph names its
    nodes alike); `strategies` is the per-axis `{node_name:
    NodeStrategy}` list a `CompileResult` carries; `axes` the matching
    `MeshAxisSpec`s.

    Streams: the host issues every op in order (`dispatch_s` each);
    compute executes ops in topological order; collectives occupy the
    wire, and only `(1 - overlap_discount_ratio())` of each collective's
    seconds block the consumer — the same discount the solver applies to
    reduction edges.  Output vars are handed back replicated, so
    SHARD/PARTIAL producers pay the final collective, mirroring the
    solver's output cost row."""
    from easydist_tpu_torch.autoflow.cost_model import (
        overlap_discount_ratio, resharding_cost)
    from easydist_tpu_torch.metashard.metair import Placement

    table = op_table or OpTimeTable.from_perfdb()
    log = EventLog()
    host = Stream("host", log)
    compute = Stream("compute", log)
    wire = Stream("comm", log)
    ratio = overlap_discount_ratio()
    pairs = [(ax, chosen) for ax, chosen in zip(axes, strategies)
             if chosen and ax.size > 1]

    ready: Dict[str, float] = {}
    visible_end = 0.0
    n_coll = 0
    hits0, miss0 = table.hits, table.misses

    for node in graph.ops:
        out_b = sum(v.size_bytes() for v in node.outvars if v is not None)
        in_b = sum(v.size_bytes() for v in node.invars if v is not None)
        dur = table.node_seconds(node.sig, out_b, node.flops,
                                 node.compute_proxy, in_bytes=in_b)
        intrinsic = 0.0
        for ax, chosen in pairs:
            strat = chosen.get(node.name)
            if strat is None:
                continue
            if strat.compute_cost is not None:
                # composite strategies carry absolute per-strategy seconds
                dur = float(strat.compute_cost)
            elif _shards(strat):
                dur /= ax.size
            intrinsic += getattr(strat, "intrinsic_cost", 0.0)

        t_ready = _issue(host, table, node.name)
        for idx, var in enumerate(node.invars):
            if var is None:
                continue
            t_in = ready.get(var.name, 0.0)
            comm_s = 0.0
            if var.producer is not None and not var.producer.is_input:
                for ax, chosen in pairs:
                    up_s = chosen.get(var.producer.name)
                    down_s = chosen.get(node.name)
                    if up_s is None or down_s is None:
                        continue
                    up = _placement_or_replicate(
                        up_s.out_placements[var.producer_idx]
                        if var.producer_idx < len(up_s.out_placements)
                        else None)
                    down = _placement_or_replicate(
                        down_s.in_placements[idx]
                        if idx < len(down_s.in_placements) else None)
                    comm_s += resharding_cost(var.size_bytes(), up, down,
                                              ax)
            if comm_s > 0.0:
                n_coll += 1
                c_start, _ = wire.reserve(t_in, comm_s,
                                          label=f"reshard:{var.name}")
                # only the unhidden fraction gates the consumer
                t_in = c_start + (1.0 - ratio) * comm_s
            t_ready = max(t_ready, t_in)

        if intrinsic > 0.0:
            n_coll += 1
            wire.busy_s += intrinsic  # inside the op: always exposed
            dur += intrinsic
        _, end = compute.reserve(t_ready, dur, label=node.name)
        visible_end = max(visible_end, end)
        for v in node.outvars:
            if v is not None:
                ready[v.name] = end

    # graph outputs return replicated: SHARD/PARTIAL producers pay the
    # final collective (all_gather / all_reduce) after their op finishes
    state_outs = set(graph.state_io)
    for var in graph.outputs:
        if var.producer is None or var.name in state_outs:
            continue
        comm_s = 0.0
        for ax, chosen in pairs:
            up_s = chosen.get(var.producer.name)
            if up_s is None:
                continue
            up = _placement_or_replicate(
                up_s.out_placements[var.producer_idx]
                if var.producer_idx < len(up_s.out_placements) else None)
            comm_s += resharding_cost(var.size_bytes(), up,
                                      Placement.replicate(), ax)
        if comm_s > 0.0:
            n_coll += 1
            c_start, _ = wire.reserve(ready.get(var.name, 0.0), comm_s,
                                      label=f"output:{var.name}")
            visible_end = max(visible_end, c_start + comm_s)

    visible_end = max(visible_end, host.free_at)
    exposed = max(0.0, visible_end - max(compute.busy_s, host.busy_s))
    hit_rate_den = (table.hits - hits0) + (table.misses - miss0)
    return SimReport(
        predicted_s=visible_end,
        compute_s=compute.busy_s,
        comm_s=wire.busy_s,
        comm_exposed_s=min(exposed, wire.busy_s),
        n_ops=len(graph.ops),
        n_collectives=n_coll,
        op_db_hit_rate=((table.hits - hits0) / hit_rate_den
                        if hit_rate_den else 0.0),
        log=log, host_s=host.busy_s)


def simulate_train_step(compile_result,
                        op_table: Optional[OpTimeTable] = None
                        ) -> SimReport:
    """Replay a mesh `CompileResult` (fxfront.api) — its solved MetaGraph,
    per-axis strategies, and axis specs — into a predicted step time."""
    graph = next((g for g in compile_result.graphs if g is not None), None)
    if graph is None:
        raise ValueError("compile result carries no solved MetaIR graph "
                         "(one-device compile, or strategies from the "
                         "compile cache) — use predict_fn_seconds for "
                         "unsolved programs")
    return replay_graph(graph, compile_result.strategies,
                        compile_result.axis_specs, op_table=op_table)


# --------------------------------------------------- flat-program replay

def _out_bytes(val) -> float:
    vals = val if isinstance(val, (tuple, list)) else (val,)
    return float(sum(v.numel() * v.element_size() for v in vals
                     if isinstance(v, torch.Tensor)))


def predict_fn_seconds(fn, *args,
                       op_table: Optional[OpTimeTable] = None,
                       **kwargs) -> SimReport:
    """One-device replay of `fn`'s program: the `make_fx` graph
    `profile_ops` traces, every call node but `getitem` priced by
    signature against the op table and issued by the host (the decode-
    step / prefill-chunk / one-device train-step path, where there is no
    solved multi-axis graph to walk).  A kernel's custom op is one node,
    priced by its own signature."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront.interpreter import node_signature

    table = op_table or OpTimeTable.from_perfdb()
    flat, spec = pytree.tree_flatten((args, kwargs))

    def flat_fn(*xs):
        a, kw = pytree.tree_unflatten(list(xs), spec)
        return pytree.tree_leaves(fn(*a, **kw))

    with torch.no_grad():
        gm = make_fx(flat_fn, tracing_mode="fake")(*flat)

    log = EventLog()
    host = Stream("host", log)
    compute = Stream("compute", log)
    hits0, miss0 = table.hits, table.misses
    n_ops = 0
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        sig = node_signature(node)
        t_issued = _issue(host, table, node.name)
        compute.reserve(max(t_issued, compute.free_at),
                        table.node_seconds(sig,
                                           _out_bytes(node.meta.get("val"))),
                        label=str(node.target))
        n_ops += 1
    hit_den = (table.hits - hits0) + (table.misses - miss0)
    return SimReport(predicted_s=max(compute.free_at, host.free_at),
                     compute_s=compute.busy_s, n_ops=n_ops,
                     op_db_hit_rate=((table.hits - hits0) / hit_den
                                     if hit_den else 0.0),
                     log=log, host_s=host.busy_s)


# ------------------------------------------------------------ host times

def measure_launch_floor(device=None, trials: int = 21) -> float:
    """Seconds `profile_ops` reads for a call that does no device work:
    a one-element add timed as it times every op (`op_profile._time_call`:
    CUDA events around one call on the card), the median of `trials`.
    It is the host's latency to launch an op, which every time in the
    table holds."""
    from easydist_tpu_torch import resolve_device
    from easydist_tpu_torch.runtime.op_profile import _time_call

    device = resolve_device(device)
    a = torch.zeros(1, device=device)

    def call():
        return torch.ops.aten.add.Tensor(a, a)

    call()
    times = sorted(_time_call(call, device) for _ in range(trials))
    return float(times[len(times) // 2])


def store_dispatch(seconds: float, domain: Optional[str] = None,
                   db=None) -> None:
    """Persist the host's seconds a call for `domain` (the device's
    default without one) beside the op table."""
    _store(DISPATCH_KEY, _sub_key(domain), seconds, db)


def store_launch_floor(seconds: float, db=None) -> None:
    _store(DISPATCH_KEY, _sub_key("launch"), seconds, db)


# ------------------------------------------------------- pipeline replay

def simulate_pipeline(tables: Dict[str, Any], fwd_unit_s: float,
                      bwd_unit_s: float = 0.0) -> SimReport:
    """Replay a 1F1B/interleaved tick table
    (`parallel/pipeline.py::_1f1b_schedule_tables`) under per-unit stage
    costs: every supertick runs in lockstep, so its duration is the
    slowest device's (fwd + bwd) work that tick, and the step is the sum
    over ticks.  The emergent bubble fraction matches
    `schedule_stats(tables)` when stage costs are uniform."""
    f_ok = tables["f_ok"]
    b_ok = tables.get("b_ok")
    U, S = f_ok.shape
    log = EventLog()
    total = 0.0
    busy = 0.0
    for u in range(U):
        tick = 0.0
        for s in range(S):
            work = (fwd_unit_s if f_ok[u, s] else 0.0) + \
                (bwd_unit_s if b_ok is not None and b_ok[u, s] else 0.0)
            busy += work
            tick = max(tick, work)
        total += tick
        if tick > 0.0:
            log.record(total, "supertick", u=u, duration=tick)
    ideal = busy / S if S else 0.0
    report = SimReport(predicted_s=total, compute_s=busy, n_ops=int(U),
                       log=log)
    report.detail["bubble_fraction"] = (
        (total - ideal) / total if total > 0 else 0.0)
    return report


def predict_pipeline_step(pp: int, n_virtual: int, n_micro: int,
                          fwd_unit_s: float, bwd_unit_s: float
                          ) -> SimReport:
    """Convenience: build the 1F1B tick tables and replay them."""
    from easydist_tpu_torch.parallel.pipeline import _1f1b_schedule_tables

    tables = _1f1b_schedule_tables(pp, n_virtual, n_micro)
    return simulate_pipeline(tables, fwd_unit_s, bwd_unit_s)


# --------------------------------------------------- serving predictions

def predict_decode_throughput(per_token_s: float, n_slots: int,
                              occupancy: float = 1.0) -> float:
    """Committed tokens/s of one replica at the given decode-slot
    occupancy: a decode round advances every live slot by one token in
    one (batched) step, so throughput scales with live slots until the
    step itself slows down."""
    if per_token_s <= 0.0:
        return 0.0
    live = max(0.0, min(1.0, occupancy)) * n_slots
    return live / per_token_s


def predict_ttft(chunk_s: float, n_chunks: int, per_token_s: float,
                 queue_wait_s: float = 0.0,
                 prefix_hit_chunks: int = 0) -> float:
    """TTFT under chunked prefill: queueing + the chunks actually
    executed (prefix-cache hits skip leading chunks) + the first decode
    step that commits token one."""
    run_chunks = max(0, n_chunks - prefix_hit_chunks)
    return queue_wait_s + run_chunks * chunk_s + per_token_s


# ----------------------------------------------------- residual handling

def store_residual(domain: str, scale: float, db=None) -> None:
    """Persist a one-point multiplicative residual (measured/predicted on
    the domain's calibration preset)."""
    _store(RESIDUAL_KEY, _sub_key(domain), scale, db)


def load_residual(domain: str, db=None, default: float = 1.0) -> float:
    from easydist_tpu_torch.runtime.perfdb import PerfDB

    try:
        got = (db if db is not None else PerfDB()).get_op_perf(
            RESIDUAL_KEY, _sub_key(domain))
        return float(got) if got else float(default)
    except Exception:
        return float(default)
