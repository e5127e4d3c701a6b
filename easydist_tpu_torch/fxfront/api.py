"""`easydist_compile` in its one-device form: the port of
easydist_tpu/jaxfront/api.py's compile surface (`infer_state_io`,
`CompiledFunction`, `easydist_compile`).

Each call signature is traced once with `make_fx` (fake tensors, so
tracing launches nothing and allocates nothing) into a GraphModule of
aten ops, which every later call with that signature replays.  Custom
ops — the port's CUDA kernels — stay single nodes.  Like the JAX
package on a mesh of one device, nothing is solved: every placement is
equivalent.  ShardCombine discovery, the per-axis ILP and emission over
a larger mesh are still to port (ROADMAP queue A item 1): a mesh of
more than one device raises.

A train step is traced whole: its forward, the backward that
`torch.autograd.grad` runs inside the step (the kernels' backward ops
stay single nodes too) and the optimizer update.

State threading: output leaves are paired positionally with input
leaves (`infer_state_io`).  Where the JAX package donates a paired input
so XLA updates it in place, the port's functions write paired state in
place themselves; a paired output that comes back as a new tensor is
copied into its input (a profiler range, "easydist_compile.state_copy",
marks the copies), so paired state keeps its storage across calls
either way.  `donate_state=False` leaves the inputs as they were and
returns the new tensors.
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, Optional

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

logger = logging.getLogger(__name__)


def _leaf_sig(x):
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else None


def infer_state_io(args, out) -> Dict[int, int]:
    """Pair output leaves with input leaves for state threading.

    Pairing is strictly positional over the *leading* outputs and inputs
    — `(new_params, new_opt, ...) = step(params, opt, ...)` — and stops
    at the first mismatch, so an inference output is never paired with a
    data input of the same shape.  Only container subtrees qualify as
    state: a bare-tensor argument is data.
    Returns {flat_output_index: flat_input_index}."""
    outs = out if isinstance(out, tuple) else (out,)
    pairs: Dict[int, int] = {}
    in_base = out_base = 0
    for o, a in zip(outs, args):
        o_leaves, o_spec = pytree.tree_flatten(o)
        a_leaves, a_spec = pytree.tree_flatten(a)
        if (not o_leaves or o_spec != a_spec or a_spec.is_leaf()
                or [_leaf_sig(x) for x in o_leaves]
                != [_leaf_sig(x) for x in a_leaves]):
            if pairs and o_leaves and not o_spec.is_leaf():
                logger.info(
                    "state_io pairing stopped at output %d (structure "
                    "mismatch): later state will not be updated in place",
                    out_base)
            break
        for k in range(len(o_leaves)):
            pairs[out_base + k] = in_base + k
        in_base += len(a_leaves)
        out_base += len(o_leaves)
    return pairs


class SignatureMismatch(Exception):
    """A compiled result was called with another input structure."""


class CompileResult:
    """One traced signature: `graph_module` takes and returns flat leaves;
    `tree_jitted` takes and returns the caller's pytrees."""

    def __init__(self, graph_module, in_spec, out_spec,
                 state_pairs: Dict[int, int], donate_state: bool = True):
        self.graph_module = graph_module
        self.in_spec = in_spec
        self.out_spec = out_spec
        self.state_pairs = dict(state_pairs)
        self.donate_state = donate_state

    def tree_jitted(self, *args, **kwargs):
        flat, spec = pytree.tree_flatten((args, kwargs))
        if spec != self.in_spec:
            raise SignatureMismatch(f"compiled for {self.in_spec}, "
                                    f"called with {spec}")
        with torch.no_grad():
            outs = list(self.graph_module(*flat))
            if self.donate_state:
                with torch.profiler.record_function(
                        "easydist_compile.state_copy"):
                    for o, i in self.state_pairs.items():
                        if outs[o] is not flat[i]:
                            flat[i].copy_(outs[o])
                            outs[o] = flat[i]
        return pytree.tree_unflatten(outs, self.out_spec)


def compile_step(func, args, kwargs,
                 donate_state: bool = True) -> CompileResult:
    """Trace `func(*args, **kwargs)` with `make_fx` over fake tensors and
    pair its state (`infer_state_io`)."""
    flat, in_spec = pytree.tree_flatten((args, kwargs))
    traced = {}

    def flat_fn(*flat_args):
        a, kw = pytree.tree_unflatten(list(flat_args), in_spec)
        out = func(*a, **kw)
        out_flat, traced["spec"] = pytree.tree_flatten(out)
        traced["out"] = out
        return out_flat

    with torch.no_grad():
        gm = make_fx(flat_fn, tracing_mode="fake")(*flat)
    return CompileResult(gm, in_spec, traced["spec"],
                         infer_state_io(args, traced["out"]), donate_state)


class CompiledFunction:
    """User-facing wrapper: traces on the first call per input signature
    and replays after."""

    def __init__(self, func, donate_state: Optional[bool] = None):
        self.func = func
        self.donate_state = donate_state is not False
        self._cache: Dict[object, CompileResult] = {}
        self._cache_hits = 0
        self._cache_misses = 0
        functools.update_wrapper(self, func)

    @staticmethod
    def _signature(flat_args, spec):
        # tensors by (shape, dtype, device); anything else is baked into
        # the traced graph, so it keys by value
        return (spec, tuple(
            (tuple(x.shape), x.dtype, x.device)
            if isinstance(x, torch.Tensor) else (type(x), x)
            for x in flat_args))

    def get_compiled(self, *args, **kwargs) -> CompileResult:
        flat, spec = pytree.tree_flatten((args, kwargs))
        sig = self._signature(flat, spec)
        result = self._cache.get(sig)
        if result is None:
            self._cache_misses += 1
            result = compile_step(self.func, args, kwargs,
                                  self.donate_state)
            self._cache[sig] = result
        else:
            self._cache_hits += 1
        return result

    # ------------------------------------------------------ stable surface
    def cache_key(self, *args, **kwargs):
        """Hashable key of the compiled-result cache entry these args
        resolve to.  Two call signatures share a trace iff keys are
        equal."""
        flat, spec = pytree.tree_flatten((args, kwargs))
        return self._signature(flat, spec)

    def compiled_signatures(self):
        """Keys (see `cache_key`) of every signature traced so far."""
        return tuple(self._cache)

    def cache_stats(self) -> Dict[str, int]:
        """{size, hits, misses} of the signature cache."""
        return {"size": len(self._cache), "hits": self._cache_hits,
                "misses": self._cache_misses}

    def __call__(self, *args, **kwargs):
        return self.get_compiled(*args, **kwargs).tree_jitted(*args, **kwargs)


def _mesh_size(mesh) -> int:
    """Devices in `mesh`: None, a device or a device name is one; a
    sequence counts its entries; an object with `.devices` (a mesh)
    counts those."""
    if mesh is None or isinstance(mesh, (str, int, torch.device)):
        return 1
    devices = getattr(mesh, "devices", mesh)
    size = getattr(devices, "size", None)
    if isinstance(size, int):
        return size
    return len(pytree.tree_leaves(list(devices)))


def easydist_compile(func=None, mesh=None, state_io="auto",
                     donate_state: Optional[bool] = None):
    """Decorator entry point: `easydist_compile(fn)`, `@easydist_compile`,
    `@easydist_compile()` or `easydist_compile(step, mesh=mesh)`.

    `mesh` is None or one device: the port compiles for the device its
    tensors lie on, and a larger mesh raises NotImplementedError (the
    multi-device frontend is ROADMAP queue A item 1).  `state_io` is
    "auto" only: state is paired positionally (`infer_state_io`).
    `donate_state` (default True) writes paired outputs into their
    inputs; False returns them as new tensors.  The JAX package's
    pipeline and solver arguments belong to slices not ported yet."""
    n_devices = _mesh_size(mesh)
    if n_devices != 1:
        raise NotImplementedError(
            f"easydist_compile over a mesh of {n_devices} devices is not "
            f"ported yet (ROADMAP queue A item 1: discovery, ILP and "
            f"emission); pass mesh=None or one device")
    if state_io != "auto":
        raise NotImplementedError(
            f"state_io={state_io!r} is not ported; the port pairs state "
            f"positionally (state_io='auto')")

    def wrap(f):
        return CompiledFunction(f, donate_state=donate_state)

    return wrap(func) if func is not None else wrap
