"""User-directed sharding: the port of easydist_tpu/jaxfront/scope.py.

`fix_sharding(x, *spec_entries)` pins a tensor's placement inside a
compiled step: the solver's pool at the pin is the pinned placement on
every mesh axis (`api._apply_user_pins`), and emission lays the value out
so.  It is the manual override for a plan that should be constrained
(say, column-sharded weights for one layer).  In the port the pin is the
custom op `easydist_tpu_torch::fix_sharding`, an identity whose spec rides
as an argument, so `make_fx` keeps it as one node.

`scoped_region(fn, mesh)` solves `fn` on its own mesh, with its own
cache, and runs it there wherever it is called, inside a step compiled on
another mesh of the same ranks too.  In the outer step the region is one
node (the custom op `easydist_tpu_torch::scoped_call`) whose operands and
results are replicated on the outer mesh; inside it, the region's own
per-rank program shards them on its mesh.  The region is forward-only:
its op has no autograd.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from .mesh import get_device_mesh

# the mesh being compiled right now (set by `compile_step` around
# tracing), so a pin inside a step targets the step's mesh even when the
# global mesh is another
_COMPILE_MESH = None


class _compile_mesh_ctx:
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        global _COMPILE_MESH
        self._prev = _COMPILE_MESH
        _COMPILE_MESH = self.mesh

    def __exit__(self, *exc):
        global _COMPILE_MESH
        _COMPILE_MESH = self._prev


# --------------------------------------------------------------- the pin

def encode_spec(spec_entries) -> str:
    """PartitionSpec-like entries (None, an axis name, or a tuple of names,
    one per tensor dim) as the pin op's string argument: entries split by
    ";", names within one by ","."""
    out = []
    for e in spec_entries:
        names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        out.append(",".join(names))
    return ";".join(out)


def decode_spec(spec: str) -> List[tuple]:
    """The mesh axis names of each pinned dim."""
    if spec == "":
        return []
    return [tuple(n for n in e.split(",") if n) for e in spec.split(";")]


@torch.library.custom_op("easydist_tpu_torch::fix_sharding", mutates_args=())
def _fix_sharding_op(x: torch.Tensor, spec: str) -> torch.Tensor:
    return x.clone()


@_fix_sharding_op.register_fake
def _(x, spec):
    return torch.empty_like(x)


def _pin_backward(ctx, g):
    return g, None


_fix_sharding_op.register_autograd(_pin_backward)


def fix_sharding(x, *spec_entries, mesh=None):
    """Pin `x` to the layout `spec_entries` names (one entry per leading
    dim: None, a mesh axis name, or a tuple of names) on the current mesh
    (the mesh under compilation, else the global mesh).  Without a mesh
    it returns `x`."""
    mesh = mesh or _COMPILE_MESH or get_device_mesh()
    if mesh is None:
        return x
    names = set(mesh.mesh_dim_names or ())
    if len(spec_entries) > x.ndim:
        raise ValueError(f"fix_sharding: {len(spec_entries)} spec entries "
                         f"for a {x.ndim}-d tensor")
    for axes in decode_spec(encode_spec(spec_entries)):
        unknown = set(axes) - names
        if unknown:
            raise ValueError(f"fix_sharding: {sorted(unknown)} are not axes "
                             f"of the mesh {tuple(sorted(names))}")
    return _fix_sharding_op(x, encode_spec(spec_entries))


def pinned_axes(node) -> Optional[List[tuple]]:
    """The per-dim axis names of a `fix_sharding` FX node, else None."""
    if node.op != "call_function" \
            or node.target is not torch.ops.easydist_tpu_torch.fix_sharding\
            .default:
        return None
    return decode_spec(node.args[1])


# --------------------------------------------------------- scoped regions

_REGIONS: Dict[int, "_Region"] = {}
_REGION_IDS = itertools.count()


class _Region:

    def __init__(self, fn, mesh, axis_specs):
        self.fn = fn
        self.mesh = mesh
        self.axis_specs = axis_specs
        self.compiled: Dict[tuple, object] = {}
        self.out_specs: Dict[tuple, object] = {}

    @staticmethod
    def key(args) -> tuple:
        return tuple((tuple(a.shape), a.dtype) for a in args)

    def out_spec(self, args):
        """Output structure of `fn` on `args`, by a run on fake tensors."""
        key = self.key(args)
        if key not in self.out_specs:
            from torch._subclasses.fake_tensor import FakeTensorMode

            with FakeTensorMode(allow_non_fake_inputs=True) as mode:
                fake = [mode.from_tensor(a) for a in args]
                self.out_specs[key] = pytree.tree_flatten(
                    self.fn(*fake))[1]
        return self.out_specs[key]

    def run(self, args):
        from .api import compile_step

        key = self.key(args)
        result = self.compiled.get(key)
        if result is None:
            result = self.compiled[key] = compile_step(
                self.fn, tuple(args), {}, mesh=self.mesh, state_io={},
                axis_specs=self.axis_specs)
        outs = pytree.tree_leaves(result.tree_jitted(*args))
        ids = {id(a) for a in args}
        return [o.clone() if id(o) in ids else o for o in outs]


@torch.library.custom_op("easydist_tpu_torch::scoped_call", mutates_args=())
def _scoped_call_op(args: List[torch.Tensor], region: int
                    ) -> List[torch.Tensor]:
    return _REGIONS[region].run(args)


@_scoped_call_op.register_fake
def _(args, region):
    outs = pytree.tree_leaves(_REGIONS[region].fn(*args))
    return [torch.empty_like(o) for o in outs]


def scoped_region(fn, mesh, axis_specs=None):
    """Solve `fn`'s strategy on its OWN mesh and run the region there
    wherever it is called, inside an `easydist_compile` step on another
    view of the same ranks too.  `fn` takes tensors and returns a pytree
    of tensors; the per-signature compile runs once and is cached.
    Returns wrapped(*args) with fn's semantics."""
    rid = next(_REGION_IDS)
    _REGIONS[rid] = region = _Region(fn, mesh, axis_specs)

    def wrapped(*args):
        if not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError("scoped_region takes tensor arguments")
        outs = _scoped_call_op(list(args), rid)
        return pytree.tree_unflatten(outs, region.out_spec(list(args)))

    return wrapped
