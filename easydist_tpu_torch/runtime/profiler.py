"""Profiling and cost analysis of compiled steps: the port of
easydist_tpu/runtime/profiler.py.

XLA's `cost_analysis` / `memory_analysis` of a compiled executable become
readings of the `CompileResult`'s FX program: FLOPs from its nodes (the
per-node model the pipeline splitter and the remat planner use: exact
products for the matmuls and the flash kernels, the output's elements for
the rest) and bytes from their inputs and outputs; the memory peaks are
the liveness model's and the memory planner's.  `profile_compiled` times
a callable with the card synchronised; `measure_collective_overlap`
measures how much of an all_reduce a process group hides under
independent compute.
"""

from __future__ import annotations

import operator
import time
from typing import Dict, Optional

import torch
from torch.utils import _pytree as pytree

from .perfdb import PerfDB

_TENSOR_CORE = ("mm.", "addmm.", "bmm.", "flash_fwd.", "flash_bwd_dq.",
                "flash_bwd_dkv.")


def _program(compiled):
    """The FX program of a CompileResult: this rank's, dead nodes
    dropped, every node's `meta["val"]` at this rank's shapes."""
    gm = compiled.planning_program()
    if gm is None:
        raise ValueError("this CompileResult's program cannot be read on "
                         "fake tensors")
    return gm


def _nbytes(val) -> float:
    return float(sum(v.numel() * v.element_size()
                     for v in pytree.tree_leaves(val)
                     if isinstance(v, torch.Tensor)))


def op_cost_analysis(compiled) -> Dict[str, float]:
    """{"flops": tensor-core FLOPs (matmuls and the flash kernels),
    "flops_total": with every other node's output elements added,
    "bytes accessed": every node's input and output bytes, "nodes",
    "optimal_seconds": the larger of flops / peak_flops and bytes /
    hbm_bandwidth} of a CompileResult's program."""
    from easydist_tpu_torch import config as edconfig
    from easydist_tpu_torch.parallel.auto_pipeline import node_flops

    gm = _program(compiled)
    flops = total = nbytes = 0.0
    nodes = 0
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        nodes += 1
        f = node_flops(node)
        total += f
        name = getattr(node.target, "__name__", str(node.target))
        if name.startswith(_TENSOR_CORE):
            flops += f
        nbytes += _nbytes(node.meta.get("val")) + sum(
            _nbytes(a.meta.get("val")) for a in node.all_input_nodes)
    return {"flops": flops, "flops_total": total, "bytes accessed": nbytes,
            "nodes": float(nodes),
            "optimal_seconds": max(flops / edconfig.peak_flops,
                                   nbytes / edconfig.hbm_bandwidth)}


def memory_analysis(compiled) -> Dict[str, int]:
    """Per-device memory of a CompileResult's program: `peak_bytes` (the
    liveness model's, which remat plans against), `planner_peak_bytes`
    (the memory planner's skyline packing), `argument_size_in_bytes` and
    `output_size_in_bytes`."""
    from easydist_tpu_torch.schedule.remat import (memory_planner_peak,
                                                   program_peak)

    gm = _program(compiled)
    args = sum(_nbytes(n.meta.get("val")) for n in gm.graph.nodes
               if n.op == "placeholder")
    out = next(n for n in gm.graph.nodes if n.op == "output")
    outs = sum(_nbytes(a.meta.get("val")) for a in out.all_input_nodes)
    return {"peak_bytes": program_peak(gm),
            "planner_peak_bytes": memory_planner_peak(gm),
            "argument_size_in_bytes": int(args),
            "output_size_in_bytes": int(outs)}


def serving_history(sub_key: str = "engine",
                    db: Optional[PerfDB] = None) -> list:
    """Recorded serving-metrics snapshots of one engine (what
    `serve.ServeMetrics.export` writes), oldest first."""
    if db is None:
        db = PerfDB()
    return db.get_op_perf("serving", sub_key) or []


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def two_point_time(fn, args=(), n1: int = 3, n2: int = 12,
                   device="cpu") -> float:
    """Seconds a call of `fn(*args)`: (t(n2 calls) - t(n1 calls)) /
    (n2 - n1) after one warm call, with `device` synchronised around each
    run, so the fixed cost of a run cancels."""
    def run(n):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        _sync(device)
        return time.perf_counter() - t0

    run(1)
    return max((run(n2) - run(n1)) / (n2 - n1), 1e-12)


def measure_collective_overlap(group, n_elems: int = 1 << 22,
                               compute_dim: int = 256, iters: int = 12,
                               repeats: int = 3,
                               device=None) -> Dict[str, float]:
    """How much of an all_reduce's time this group hides under independent
    compute: t_comm (an all_reduce of an `n_elems` f32 vector alone),
    t_compute (a chain of matmuls alone), t_both (the all_reduce issued,
    the matmuls run, then the wait).  overlap_fraction = clamp((t_comm +
    t_compute - t_both) / min(t_comm, t_compute), 0, 1).  Each time is
    the minimum over `repeats` interleaved two-point samples.  Every rank
    of the group calls it."""
    from easydist_tpu_torch.comm.reduce import group_name

    c10d = torch.ops._c10d_functional
    name = group_name(group)
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    v = torch.ones(n_elems, dtype=torch.float32, device=device)
    a = torch.full((compute_dim, compute_dim), 1e-2, device=device)

    def matmuls(x):
        for _ in range(4):
            x = x @ x * 1e-3
        return x

    def comm():
        return c10d.wait_tensor(c10d.all_reduce(v, "sum", name))

    def both():
        y = c10d.all_reduce(v, "sum", name)
        m = matmuls(a)
        return c10d.wait_tensor(y), m

    n1, n2 = max(2, iters // 4), iters
    t_comm = t_compute = t_both = float("inf")
    for _ in range(max(1, repeats)):
        t_comm = min(t_comm, two_point_time(comm, (), n1, n2, device))
        t_compute = min(t_compute,
                        two_point_time(matmuls, (a,), n1, n2, device))
        t_both = min(t_both, two_point_time(both, (), n1, n2, device))
    frac = (t_comm + t_compute - t_both) / max(min(t_comm, t_compute),
                                               1e-12)
    return {"t_comm": float(t_comm), "t_compute": float(t_compute),
            "t_both": float(t_both),
            "overlap_fraction": float(min(max(frac, 0.0), 1.0))}


def profile_compiled(fn, args, key: Optional[str] = None,
                     trials: int = 5, warmup: int = 2,
                     db: Optional[PerfDB] = None,
                     trace_dir: Optional[str] = None) -> float:
    """Wall-clock seconds a call of `fn(*args)` with the card synchronised,
    recorded into the PerfDB under ("compiled", key) when both are given;
    `trace_dir` also writes one call's `torch.profiler` trace there."""
    device = next((x.device for x in pytree.tree_leaves(args)
                   if isinstance(x, torch.Tensor)), torch.device("cpu"))
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    if trace_dir:
        import os

        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            fn(*args)
            _sync(device)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    start = time.perf_counter()
    for _ in range(trials):
        fn(*args)
    _sync(device)
    elapsed = (time.perf_counter() - start) / trials
    if db is not None and key is not None:
        db.record_op_perf("compiled", key, elapsed)
    return elapsed
