"""Measured per-op runtime costs feeding the solver (reference: the
on-device per-node profiling pass + persistent DB,
easydist/torch/passes/runtime_prof.py:35-150 and
utils/graph_profile_db.py:24-48; the port of
easydist_tpu/runtime/op_profile.py).

`profile_ops` (the write half) traces a step with `make_fx` and times
every unique aten node of it on the device its arguments lie on, keyed
by `fxfront.interpreter.node_signature`, into the PerfDB under
`backend_key()`.  `load_op_times` (the read half) hands the table to
`SpmdSolver`, which prices compute redundancy with the measured time
wherever a node's signature hits (`config.use_op_cost_db`) and with its
roofline proxy otherwise.
"""

from __future__ import annotations

import logging
import operator
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

OP_TIMES_KEY = "op_times"


def backend_key() -> str:
    return f"{OP_TIMES_KEY}:cuda"


def load_op_times() -> Dict[str, float]:
    """All measured op times for the card ({signature: s})."""
    from .perfdb import PerfDB

    try:
        return dict(PerfDB().snapshot().get(backend_key(), {}))
    except Exception:
        return {}


def _time_call(call, device: torch.device) -> float:
    """Seconds of one call: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    call()
    return time.perf_counter() - t0


def profile_ops(fn, *args, trials: int = 3, persist: bool = True,
                max_ops: Optional[int] = None, **kwargs) -> Dict[str, float]:
    """Trace `fn(*args, **kwargs)` and time every unique aten node
    signature on the device of the first tensor argument: one warm-up
    call, then the median of `trials`.  Inputs are random (floats in
    [0.5, 1.5], integers in [1, 8)).  Returns {signature: seconds} and
    persists it into the PerfDB (`config.prof_db_path`) so later compiles
    price ops with the card's own times."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront.interpreter import (_is_tensor_node,
                                                        _materialize,
                                                        node_signature)

    flat, spec = pytree.tree_flatten((args, kwargs))
    device = next((x.device for x in flat if isinstance(x, torch.Tensor)),
                  torch.device("cpu"))

    def flat_fn(*xs):
        a, kw = pytree.tree_unflatten(list(xs), spec)
        return pytree.tree_leaves(fn(*a, **kw))

    with torch.no_grad():
        gm = make_fx(flat_fn, tracing_mode="fake")(*flat)
    seen = {}
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        seen.setdefault(node_signature(node), node)
        if max_ops and len(seen) >= max_ops:
            break

    gen = torch.Generator(device=device).manual_seed(0)
    results: Dict[str, float] = {}
    t_start = time.perf_counter()
    for sig, node in seen.items():
        def conc(a):
            if _is_tensor_node(a):
                v = a.meta["val"]
                return _materialize(tuple(v.shape), v.dtype, gen, device)
            return device if isinstance(a, torch.device) else a

        try:
            leaves, aspec = pytree.tree_flatten((tuple(node.args),
                                                 dict(node.kwargs)))
            op_args, op_kwargs = pytree.tree_unflatten(
                [conc(a) for a in leaves], aspec)

            def call(_t=node.target, _a=op_args, _k=op_kwargs):
                return _t(*_a, **_k)

            with torch.no_grad():
                call()
                ts = sorted(_time_call(call, device) for _ in range(trials))
            results[sig] = float(ts[len(ts) // 2])
        except Exception as e:  # unprofilable op: the proxy prices it
            logger.debug("op profile skipped %s: %s", sig[:80], e)
    logger.info("[op-profile] %d/%d ops measured in %.1fs on %s",
                len(results), len(seen), time.perf_counter() - t_start,
                device)
    if persist and results:
        from .perfdb import PerfDB

        db = PerfDB()
        for sig, t in results.items():
            db.record_op_perf(backend_key(), sig, t)
        try:
            db.persist()
        except Exception:
            logger.warning("could not persist the op profile")
    return results
