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


# integer inputs are drawn in [1, 8); an op that indexes a dim shorter
# than that with one raises on the CPU, and on the card it fails a
# device-side assert, which leaves the CUDA context unusable.  So these
# ops are checked first and skipped, on every device:
# {target name: positions of (index tensor, indexed dim or None for "the
# index list's own positions")}
_INT_HIGH = 8
_INDEX_OPS = {"index.Tensor": None, "index_put.default": None,
              "index_put_.default": None, "_unsafe_index.Tensor": None,
              "_unsafe_index_put.default": None,
              "index_select.default": (2, 1), "gather.default": (2, 1),
              "scatter.src": (2, 1), "scatter.value": (2, 1),
              "scatter_add.default": (2, 1), "embedding.default": (1, 0)}


def _index_out_of_range(node) -> bool:
    """Whether `node`'s drawn integer indices may fall outside the dims
    they index (the op would raise on the CPU, assert on the card)."""
    name = str(node.target).split("aten.")[-1]
    if name not in _INDEX_OPS:
        return False
    args = list(node.args)
    shape = args[0].meta["val"].shape
    where = _INDEX_OPS[name]
    if where is None:   # self, [index per leading dim]
        dims = [d for d, ix in enumerate(args[1]) if ix is not None]
    else:
        dims = [int(args[where[1]]) if isinstance(args[where[1]], int)
                else where[1]]
    return any(shape[d] < _INT_HIGH for d in dims)


def _drawn_call(node, gen, device):
    """A thunk calling `node`'s op on random inputs of its shapes on
    `device` (floats in [0.5, 1.5], integers in [1, 8))."""
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.fxfront.interpreter import (_is_tensor_node,
                                                        _materialize)

    def conc(a):
        if _is_tensor_node(a):
            v = a.meta["val"]
            return _materialize(tuple(v.shape), v.dtype, gen, device)
        return device if isinstance(a, torch.device) else a

    leaves, aspec = pytree.tree_flatten((tuple(node.args),
                                         dict(node.kwargs)))
    op_args, op_kwargs = pytree.tree_unflatten([conc(a) for a in leaves],
                                               aspec)
    return lambda: node.target(*op_args, **op_kwargs)


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

    from easydist_tpu_torch.fxfront.interpreter import node_signature

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
        if _index_out_of_range(node):
            logger.debug("op profile skipped %s: its drawn indices may "
                         "leave the dims they index", sig[:80])
            continue
        try:
            call = _drawn_call(node, gen, device)
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
