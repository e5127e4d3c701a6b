"""`easydist_compile`: the port of easydist_tpu/jaxfront/api.py's compile
surface (`infer_state_io`, `compile_step`, `solve_axes`,
`CompiledFunction`, `easydist_compile`, `get_opt_strategy`).

Each call signature is traced once with `make_fx` (fake tensors, so
tracing launches nothing and allocates nothing) into a GraphModule of
aten ops, which every later call with that signature replays.  Custom
ops — the port's CUDA kernels — stay single nodes.  A train step is
traced whole: its forward, the backward that `torch.autograd.grad` runs
inside the step (the kernels' backward ops stay single nodes too) and
the optimizer update.

On one device (no mesh, a device, or a DeviceMesh of one rank) nothing
is solved: every placement is equivalent and the traced graph runs as
it is.  On a DeviceMesh of more than one rank (reference
jax/api.py:173-323 redesigned for ND meshes):

  1. `ShardingAnalyzer` gives every aten node a rule (preset, group,
     cache or ShardCombine discovery), at the smallest axis's world;
  2. `solve_axes`: per mesh axis, bridge -> coarsen -> `SpmdSolver`, the
     shapes pre-shrunk by earlier axes and their strategies excluded;
  3. `emit.emit_sharded_fn`: the per-rank GraphModule of local aten ops
     and functional collectives, which each rank runs on its shards.

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
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.metashard.metair import NodeStrategy, Placement

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


def _mesh_ranks(mesh) -> int:
    """Ranks of `mesh`: None, a device or a device name is one; a
    DeviceMesh counts its ranks.  Anything else naming several devices
    raises: the port distributes over a `torch.distributed` DeviceMesh."""
    if mesh is None or isinstance(mesh, (str, int, torch.device)):
        return 1
    if _is_device_mesh(mesh):
        return int(mesh.size())
    devices = getattr(mesh, "devices", mesh)
    size = getattr(devices, "size", None)
    n = size if isinstance(size, int) else len(
        pytree.tree_leaves(list(devices)))
    if n != 1:
        raise TypeError(
            f"mesh {mesh!r} names {n} devices but is not a "
            f"torch.distributed DeviceMesh; build one with "
            f"fxfront.mesh.make_device_mesh")
    return 1


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def _dtensor_placements(placements):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(p.dim) if p.is_shard() else Replicate()
            for p in placements]


class CompileResult:
    """One traced signature: `graph_module` takes and returns flat leaves
    (on a mesh: this rank's shards); `tree_jitted` takes and returns the
    caller's pytrees.

    On a mesh, `in_placements` holds, per flat input, its Placement per
    mesh axis (the counterpart of the JAX package's `in_shardings`);
    `strategies` the solved {node name: NodeStrategy} per axis;
    `collectives` what emission inserted; `priced` per axis the
    (kind, value, bytes) the solver priced for its picks; `timings`
    seconds by stage; `counters` the analyzer's counts.  `remat_plan` is
    the compiler-chosen remat (`schedule.remat.RematPlan`) applied to
    `graph_module` (this rank's program), or None."""

    def __init__(self, graph_module, in_spec, out_spec,
                 state_pairs: Dict[int, int], donate_state: bool = True,
                 mesh=None):
        self.graph_module = graph_module
        self.in_spec = in_spec
        self.out_spec = out_spec
        self.state_pairs = dict(state_pairs)
        self.donate_state = donate_state
        self.mesh = mesh
        self.traced = graph_module
        self.in_placements: Optional[List[List[Placement]]] = None
        self.strategies: List[Dict[str, NodeStrategy]] = []
        self.axis_specs = []
        self.graphs = []
        self.solvers = []
        self.collectives = []
        self.priced: List[List[Tuple[str, str, float]]] = []
        self.solver_costs: List[Optional[float]] = []
        self.timings: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.replicated_on_failure: List[str] = []
        self.replicated_flops_fraction = 0.0
        self.remat_plan = None

    # ----------------------------------------------------- mesh plumbing
    def program_for(self, coords):
        """(GraphModule, [Collective]): the program the rank at mesh
        coordinates `coords` runs, emitted from the solved strategies.
        `graph_module` is this rank's; another rank's is for inspection
        (its collectives run on this process's groups)."""
        from .emit import emit_sharded_fn

        specs = self.axis_specs
        mesh_info = {"names": [s.name for s in specs],
                     "sizes": [s.size for s in specs],
                     "coords": list(coords),
                     "groups": [self.mesh.get_group(i).group_name
                                for i in range(len(specs))],
                     "order": _axis_solve_order(specs)}
        priced_sizes = [
            {v.name: v.size_bytes() for node in g.all_nodes()
             for v in node.outvars if v is not None} if g is not None
            else {} for g in (self.graphs or [None] * len(specs))]
        out_targets = {o: self.in_placements[i]
                       for o, i in self.state_pairs.items()}
        return emit_sharded_fn(self.traced, self.strategies, mesh_info,
                               out_targets, priced_sizes)

    def _mesh_layout(self):
        return ([s.size for s in self.axis_specs],
                list(self.mesh.get_coordinate()))

    def local_shard(self, x: torch.Tensor, placements,
                    coords=None) -> torch.Tensor:
        """This rank's shard of the whole tensor `x` under `placements`
        (the shard of the rank at mesh `coords`, when given)."""
        sizes, here = self._mesh_layout()
        coords = here if coords is None else coords
        for p, n, c in zip(placements, sizes, coords):
            if p.is_shard():
                step = x.shape[p.dim] // n
                x = x.narrow(p.dim, c * step, step)
        return x.contiguous()

    def _local_input(self, x, placements):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            want = _dtensor_placements(placements)
            if tuple(x.placements) != tuple(want):
                x = x.redistribute(self.mesh, want)
            return x.to_local()
        if isinstance(x, torch.Tensor):
            return self.local_shard(x, placements)
        return x

    def tree_jitted(self, *args, **kwargs):
        flat, spec = pytree.tree_flatten((args, kwargs))
        if spec != self.in_spec:
            raise SignatureMismatch(f"compiled for {self.in_spec}, "
                                    f"called with {spec}")
        if self.in_placements is None:
            return self._run_local(flat)
        from torch.distributed.tensor import DTensor

        local = [self._local_input(x, p)
                 for x, p in zip(flat, self.in_placements)]
        grad = _needs_grad(local)
        outs = self._call(local, grad)
        with torch.no_grad():
            for o, i in self.state_pairs.items():
                want = _dtensor_placements(self.in_placements[i])
                if self.donate_state and not grad \
                        and isinstance(flat[i], DTensor) \
                        and tuple(flat[i].placements) == tuple(want):
                    with torch.profiler.record_function(
                            "easydist_compile.state_copy"):
                        flat[i].to_local().copy_(outs[o])
                    outs[o] = flat[i]
                else:
                    outs[o] = DTensor.from_local(outs[o], self.mesh, want,
                                                 run_check=False)
        return pytree.tree_unflatten(outs, self.out_spec)

    def _run_local(self, flat):
        grad = _needs_grad(flat)
        outs = self._call(flat, grad)
        with torch.no_grad():
            if self.donate_state and not grad:
                with torch.profiler.record_function(
                        "easydist_compile.state_copy"):
                    for o, i in self.state_pairs.items():
                        if outs[o] is not flat[i]:
                            flat[i].copy_(outs[o])
                            outs[o] = flat[i]
        return pytree.tree_unflatten(outs, self.out_spec)

    def _call(self, flat, grad: bool):
        """Run the program.  Where an input requires grad (and grad mode
        is on) the replay records autograd, under `config.remat_policy`'s
        checkpoint (reference jaxfront/api.py:1010-1022); else it runs
        under no_grad.  Paired state is then returned, not written back."""
        if not grad:
            with torch.no_grad():
                return list(self.graph_module(*flat))
        bad = sorted({str(n.target) for n in self.graph_module.graph.nodes
                      if n.op == "call_function" and _no_autograd(n.target)})
        if bad:
            raise NotImplementedError(
                f"differentiating through this compiled function needs the "
                f"autograd formula of {bad}, which the emitted program's "
                f"collectives do not have; compile the train step whole "
                f"instead")
        policy = edconfig.remat_policy
        if policy == "none":
            return list(self.graph_module(*flat))
        from torch.utils.checkpoint import checkpoint

        from easydist_tpu_torch.schedule.remat import dots_context

        kw = {"context_fn": dots_context} if policy == "dots" else {}
        return list(checkpoint(self.graph_module, *flat,
                               use_reentrant=False, **kw))

    def planning_program(self):
        """A copy of this rank's program as the remat planner reads it:
        dead nodes dropped (autograd's unused views would hold values
        alive in the model that the replay frees), every node's
        `meta["val"]` at this rank's shapes.  None when fake tensors
        cannot run the program."""
        if self.in_placements is not None and not _size_rank_program(self):
            return None
        gm = _copy_gm(self.graph_module)
        gm.graph.eliminate_dead_code()
        gm.recompile()
        return gm

    def materialize(self, init_fn, *init_args, arg_offset: int = 0):
        """The state `init_fn(*init_args)` builds, as DTensors with the
        step's solved placements for the flat inputs from `arg_offset`
        on (0: leading state).  Its leaves are checked against the step's
        inputs on fake tensors first.  Each rank keeps only its shards;
        they are cut from the whole leaf, which exists on the rank while
        it is cut, because a generator's stream is sequential and
        cutting keeps the values equal to the one-device init."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor

        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = init_fn(*init_args)
        leaves, tree = pytree.tree_flatten(fake)
        step_in = pytree.tree_leaves(
            [n.meta.get("val") for n in self.traced.graph.nodes
             if n.op == "placeholder"])
        want = [(tuple(v.shape), v.dtype)
                for v in step_in[arg_offset:arg_offset + len(leaves)]]
        got = [(tuple(v.shape), v.dtype) for v in leaves]
        if got != want:
            raise ValueError(
                f"init_fn output does not match the step's inputs at "
                f"arg_offset={arg_offset}: init produces {got[:4]}..., "
                f"step expects {want[:4]}...")
        if self.in_placements is None:
            return init_fn(*init_args)
        full = pytree.tree_leaves(init_fn(*init_args))
        out = []
        for k in range(len(full)):
            pl = self.in_placements[arg_offset + k]
            x, full[k] = full[k], None
            out.append(DTensor.from_local(self.local_shard(x, pl), self.mesh,
                                          _dtensor_placements(pl),
                                          run_check=False))
            del x
        return pytree.tree_unflatten(out, tree)


def _needs_grad(flat) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in flat)


def _no_autograd(target) -> bool:
    """An emitted collective (a functional collective, or the ring /
    Ulysses program of an attention node): no autograd formula."""
    if isinstance(target, torch._ops.OpOverload):
        return target.namespace == "_c10d_functional"
    return getattr(target, "__module__", "").startswith(
        ("easydist_tpu_torch.parallel.ring_attention",
         "easydist_tpu_torch.parallel.ulysses"))


_REMAT_POLICIES = ("none", "dots", "all")


def _global_fakes(flat):
    """`flat` as make_fx traces it: unchanged without DTensors; else every
    tensor as a fake tensor of one mode, a DTensor at its global shape
    (a compiled program traces the whole tensors, whatever their
    placements)."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(x, DTensor) for x in flat):
        return flat
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    out = []
    for x in flat:
        if isinstance(x, DTensor):
            with mode:
                x = torch.empty(tuple(x.shape), dtype=x.dtype,
                                device=x.device)
        elif isinstance(x, torch.Tensor):
            x = mode.from_tensor(x)
        out.append(x)
    return out


def _trace(func, args, kwargs, mesh=None):
    from .scope import _compile_mesh_ctx

    flat, in_spec = pytree.tree_flatten((args, kwargs))
    traced = {}

    def flat_fn(*flat_args):
        a, kw = pytree.tree_unflatten(list(flat_args), in_spec)
        out = func(*a, **kw)
        out_flat, traced["spec"] = pytree.tree_flatten(out)
        traced["out"] = out
        return out_flat

    # a `fix_sharding` inside the step targets the mesh being compiled
    with torch.no_grad(), _compile_mesh_ctx(
            mesh if _is_device_mesh(mesh) else None):
        gm = make_fx(flat_fn, tracing_mode="fake")(*_global_fakes(flat))
    return gm, in_spec, traced["spec"], traced["out"]


def compile_step(func, args, kwargs, mesh=None, state_io="auto",
                 donate_state: bool = True,
                 axis_specs=None) -> CompileResult:
    """Trace `func(*args, **kwargs)` with `make_fx` over fake tensors, pair
    its state (`infer_state_io`, or `state_io` {flat out: flat in}) and,
    on a mesh of more than one rank, discover, solve (over `axis_specs`,
    default the mesh's) and emit."""
    if edconfig.remat_policy not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {edconfig.remat_policy!r}; "
                         f"expected none|dots|all")
    from easydist_tpu_torch.schedule.remat import apply_checkpoint_tags

    t0 = time.perf_counter()
    gm, in_spec, out_spec, out = _trace(func, args, kwargs, mesh)
    # a selective checkpoint in the step only tagged its nodes
    apply_checkpoint_tags(gm)
    trace_s = time.perf_counter() - t0
    pairs = (infer_state_io(args, out) if state_io == "auto"
             else {int(o): int(i) for o, i in state_io.items()})
    result = CompileResult(gm, in_spec, out_spec, pairs, donate_state, mesh)
    result.timings["trace"] = trace_s
    if _mesh_ranks(mesh) > 1:
        _compile_on_mesh(result, axis_specs)
    _auto_remat(result)
    return result


# ------------------------------------------------------------ auto remat

def _copy_gm(gm):
    graph = torch.fx.Graph()
    graph.output(graph.graph_copy(gm.graph, {}))
    return torch.fx.GraphModule(gm, graph)


def _size_rank_program(result) -> bool:
    """Fill `meta["val"]` of the rank program's nodes with fake tensors
    at this rank's shapes (emission does not carry them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.passes.fake_tensor_prop import FakeTensorProp

    from .emit import local_shape

    sizes = [s.size for s in result.axis_specs]
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = []
    for n, pl in zip([n for n in result.traced.graph.nodes
                      if n.op == "placeholder"], result.in_placements):
        v = n.meta.get("val")
        if isinstance(v, torch.Tensor):
            with mode:
                v = torch.empty(local_shape(v.shape, pl, sizes),
                                dtype=v.dtype, device=v.device)
        fakes.append(v)
    try:
        FakeTensorProp(result.graph_module, mode)\
            .propagate_dont_convert_inputs(*fakes)
    except Exception as exc:  # a program fake tensors cannot run
        logger.warning("[remat] could not size the rank program (%s: %s); "
                       "no remat", type(exc).__name__, exc)
        return False
    return True


def _program_device(result):
    for n in result.traced.graph.nodes:
        v = n.meta.get("val")
        if n.op == "placeholder" and isinstance(v, torch.Tensor):
            return v.device
    return None


def _auto_remat(result: CompileResult) -> None:
    """Plan remat over the program this rank runs when the resolved cap
    is above 0 and the planned peak is over it (reference
    jaxfront/api.py:934-995), and apply it.  The second opinion is
    `schedule.memory_planner` over the same program (where the JAX
    package asks XLA's memory_analysis): the plan is dropped when that
    model already fits the program under the cap, and when the rewrite
    does not lower its peak."""
    if not edconfig.enable_auto_remat:
        return
    from easydist_tpu_torch.schedule.remat import (apply_remat,
                                                   memory_planner_peak,
                                                   plan_remat,
                                                   resolve_memory_cap)

    mesh = result.mesh if _is_device_mesh(result.mesh) else None
    cap = resolve_memory_cap(mesh, device=_program_device(result))
    if cap <= 0:
        return
    t0 = time.perf_counter()
    gm = result.planning_program()
    if gm is None:
        return
    plan = plan_remat(gm, cap)
    if plan is not None:
        before = memory_planner_peak(gm)
        if before <= cap:
            logger.info("[remat] liveness peak %.3f GiB over the cap, the "
                        "memory planner's %.3f GiB under it (cap %.3f): no "
                        "remat", plan.base_peak / 2**30, before / 2**30,
                        cap / 2**30)
            plan = None
        else:
            trial = apply_remat(_copy_gm(gm), plan)
            after = memory_planner_peak(trial)
            if after >= before:
                logger.warning(
                    "[remat] the rewrite does not lower the memory "
                    "planner's peak (%.3f -> %.3f GiB); dropping it, the "
                    "program exceeds the %.3f GiB cap", before / 2**30,
                    after / 2**30, cap / 2**30)
                plan = None
            else:
                result.graph_module = trial
    result.remat_plan = plan
    result.timings["remat"] = time.perf_counter() - t0


# ------------------------------------------------------------ the solve

def _axis_solve_order(axis_specs):
    """InfiniBand axes first (coarser, costlier), then NVLink by size
    descending: the first solve picks the dominant (usually batch) dim."""
    return sorted(range(len(axis_specs)),
                  key=lambda i: (axis_specs[i].kind != "ib",
                                 -axis_specs[i].size))


def _shards_dim_twice(s: NodeStrategy, taken_in, taken_out) -> bool:
    for pos, p in enumerate(s.in_placements):
        if p is not None and p.is_shard() and p.dim in taken_in.get(pos, ()):
            return True
    for pos, p in enumerate(s.out_placements):
        if p is not None and p.is_shard() \
                and p.dim in taken_out.get(pos, ()):
            return True
    return False


def _apply_user_pins(graph, gm, axis, prev=()) -> None:
    """Restrict each `fix_sharding` node's pool to the user's placement on
    this axis (reference jaxfront/api.py:573-604): a pin that names the
    axis on a dim becomes S(dim), one that does not becomes R.  A pin
    that cannot be realised here (the dim does not divide by the axis, or
    an earlier-solved axis already shards it) leaves the node free.
    Without this the solver would treat the pin as a free identity and
    pick a layout the user did not ask for."""
    from .scope import pinned_axes

    node_by_name = {n.name: n for n in graph.ops}
    for fx_node in gm.graph.nodes:
        axes = pinned_axes(fx_node)
        node = node_by_name.get(fx_node.name)
        if axes is None or node is None or not node.outvars:
            continue
        dims = [d for d, names in enumerate(axes) if axis.name in names]
        if not dims:
            node.pinned = node.replicate_strategy()
            continue
        dim = dims[-1]
        shape = node.outvars[0].shape
        taken = any(s is not None and any(
            p is not None and p.is_shard() and p.dim == dim
            for p in s.out_placements)
            for s in (chosen.get(node.name) for chosen in prev))
        if dim >= len(shape) or shape[dim] % axis.size != 0 or taken:
            continue
        node.pinned = NodeStrategy([Placement.shard(dim)],
                                   [Placement.shard(dim)])


def _earlier_out(chosen, node, pos) -> Optional[Placement]:
    """The placement an earlier axis's `chosen` gave the producer of
    `node`'s input `pos`, or None."""
    var = node.invars[pos] if pos < len(node.invars) else None
    if var is None or var.producer is None:
        return None
    s = chosen.get(var.producer.name)
    if s is None or var.producer_idx >= len(s.out_placements):
        return None
    return s.out_placements[var.producer_idx]


def solve_axes(gm, axis_specs, world, rules, shape_info, names,
               state_io_names=None):
    """The per-axis sequential solve (reference compile_auto.py:128-173):
    strategies chosen on earlier axes are excluded from later pools, and
    so is any strategy that would shard a tensor dim an earlier axis
    already shards (emission keeps one layout per dim), or take an input
    on the dim an earlier axis moves it off (the two axes would trade
    dims, which emission does only through R, unpriced); sharded shapes
    are pre-shrunk.  Returns (per_axis strategies, per-axis MetaGraphs,
    per-axis solvers), in mesh order; a size-1 axis gets {} and None."""
    from easydist_tpu_torch.autoflow import SpmdSolver

    from .bridge import fx_to_metagraph
    from .interpreter import _inject_partial_propagation

    n_axes = len(axis_specs)
    per_axis: List[Optional[Dict[str, NodeStrategy]]] = [None] * n_axes
    graphs, solvers = [None] * n_axes, [None] * n_axes
    var_shapes: Dict[str, Tuple[int, ...]] = {}
    prev: List[Dict[str, NodeStrategy]] = []
    for a in _axis_solve_order(axis_specs):
        axis = axis_specs[a]
        if axis.size == 1:
            per_axis[a] = {}
            continue
        t0 = time.perf_counter()
        graph = fx_to_metagraph(gm, rules, shape_info, world_size=world,
                                names=names, var_shapes=dict(var_shapes),
                                state_io=state_io_names or {})
        if edconfig.enable_partial_pools:
            _inject_partial_propagation(graph, axis.size)
        _apply_user_pins(graph, gm, axis, prev)

        def exclude_map(node, _prev=tuple(prev), _size=axis.size):
            out = []
            taken_in: Dict[int, set] = {}
            taken_out: Dict[int, set] = {}
            for chosen in _prev:
                s = chosen.get(node.name)
                if s is None:
                    continue
                if not edconfig.allow_repeated_axis_strategy \
                        and not s.is_all_replicate():
                    out.append(s)
                for pos, p in enumerate(s.in_placements):
                    if p is not None and p.is_shard():
                        taken_in.setdefault(pos, set()).add(p.dim)
                        # an earlier axis moving this input S(i) -> S(j)
                        # keeps this axis off dim i here: with this axis
                        # making S(j) -> S(i) the two would trade dims,
                        # which emission can only do through R
                        up = _earlier_out(chosen, node, pos)
                        if up is not None and up.is_shard() \
                                and up.dim != p.dim:
                            taken_in[pos].add(up.dim)
                for pos, p in enumerate(s.out_placements):
                    if p is not None and p.is_shard():
                        taken_out.setdefault(pos, set()).add(p.dim)
            if taken_in or taken_out:
                out += [s for s in node.strategy_pool(_size)
                        if _shards_dim_twice(s, taken_in, taken_out)]
            return out

        level = edconfig.coarsen_level if edconfig.enable_graph_coarsen \
            else 0
        graph.coarsen(axis.size, level=level, exclude_map=exclude_map)
        reach = None
        if edconfig.predict_comm_overlap:
            from easydist_tpu_torch.autoflow.reachability import \
                ReachabilityMap

            reach = ReachabilityMap(graph)
        solver = SpmdSolver(graph, axis, reachability=reach)
        chosen = solver.solve()
        per_axis[a], graphs[a], solvers[a] = chosen, graph, solver
        prev.append(chosen)
        logger.info("[solve] axis %s (%d devices) in %.2fs", axis.name,
                    axis.size, time.perf_counter() - t0)
        for node in graph.all_nodes():
            s = chosen.get(node.name)
            if s is None:
                continue
            for v, p in zip(node.outvars, s.out_placements):
                if v is not None and p is not None and p.is_shard():
                    shape = list(var_shapes.get(v.name, v.shape))
                    if shape[p.dim] % axis.size == 0:
                        shape[p.dim] //= axis.size
                        var_shapes[v.name] = tuple(shape)
    return per_axis, graphs, solvers


def _edge_kind(up: Placement, down: Placement) -> Optional[str]:
    """The collective `autoflow.cost_model.resharding_cost` prices for an
    up -> down edge, or None where it prices nothing."""
    if up is None or down is None:
        return None
    if up.is_shard():
        if down.is_shard():
            return None if up.dim == down.dim else "all_to_all"
        return "all_gather"
    if up.is_partial():
        if down.is_shard():
            return "reduce_scatter"
        return None if down.is_partial() else "all_reduce"
    return None


def priced_collectives(solver, chosen) -> List[Tuple[str, str, float]]:
    """(kind, value name, value bytes) of every collective the solver
    priced for `chosen`: its inter-cluster and state edges at the picked
    strategies, each non-state graph output handed back replicated, and
    the ring permutes or Ulysses all_to_alls inside an attention node on
    its seq strategy (its intrinsic cost, counted by
    `seq_collectives`' byte formulas at the node's q)."""
    graph = solver.graph
    pick: Dict[int, int] = {}
    for c in solver.clusters:
        for s in range(c.strategy_count()):
            if all(c.strategies[s][uid][1] == chosen.get(c.nodes[uid].name)
                   for uid in c.strategies[s]):
                pick[c.cid] = s
                break
    out = []
    for e in solver.edges:
        kind = _edge_kind(e.up_placement(pick[e.up_cluster.cid]),
                          e.down_placement(pick[e.down_cluster.cid]))
        if kind:
            out.append((kind, e.var.name, e.var.size_bytes()))
    state_outs = set(graph.state_io)
    for var in graph.outputs:
        if var.name in state_outs or var.producer is None:
            continue
        s = chosen.get(var.producer.name)
        kind = _edge_kind(s.out_placements[var.producer_idx]
                          if s is not None else None,
                          Placement.replicate())
        if kind:
            out.append((kind, var.name, var.size_bytes()))
    out += _intrinsic_collectives(graph, chosen, solver.axis.size)
    return out


def _intrinsic_collectives(graph, chosen, n: int):
    from easydist_tpu_torch.ops.attention_prim import (seq_collectives,
                                                       seq_variant)

    out = []
    for node in graph.ops:
        meta = getattr(chosen.get(node.name), "meta", None)
        if not meta or not meta.get("variant"):
            continue
        q = node.invars[0]
        variant = seq_variant(meta["variant"], q.shape[1], n)
        for kind, nbytes in seq_collectives(
                q.size_bytes(), n, node.op_key.endswith("bwd"), variant):
            out.append((kind, q.name, nbytes))
    return out


def _replicated_flops_fraction(gm, per_axis, axis_specs) -> float:
    """Fraction of modeled FLOPs in nodes whose strategy is all-replicate
    on every axis of more than one device (the silent-zero-parallelism
    signal)."""
    import operator

    from .bridge import node_flops

    live = [i for i, s in enumerate(axis_specs) if s.size > 1]
    total = replicated = 0.0
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        f = node_flops(node)
        if f <= 0:
            continue
        total += f
        if not any(s is not None and any(
                p is not None and not p.is_replicate()
                for p in list(s.out_placements) + list(s.in_placements))
                for s in (per_axis[i].get(node.name) for i in live)):
            replicated += f
    return replicated / total if total > 0 else 0.0


# ------------------------------------------------------ strategy cache

def _compile_cache_key(gm, axis_specs) -> str:
    """Key over the traced program's code, its nodes' shapes and the
    mesh layout, salted by the rule, cost-model and solver knobs and the
    PerfDB's mtime (measured op times price the solve)."""
    import hashlib

    from easydist_tpu_torch.runtime.perfdb import db_mtime

    from .interpreter import node_signature

    h = hashlib.sha256()
    h.update(("fx-v2|" + "|".join(
        f"{k}={getattr(edconfig, k)}" for k in
        ("nvlink_bandwidth", "ib_bandwidth", "nvlink_latency", "ib_latency",
         "hbm_bandwidth", "peak_flops", "all_to_all_punish_factor",
         "solver_cluster_dedup", "per_device_memory_cap",
         "enable_partial_pools", "coarsen_level", "enable_graph_coarsen",
         "predict_comm_overlap", "comm_overlap_ratio",
         "allow_repeated_axis_strategy", "solver_backend",
         "liveness_only_input", "comm_quant_dtype", "comm_quant_block",
         "comm_quant_min_numel", "comm_overlap_ratio_source",
         "comm_overlap_ratio_measured", "discovery_use_presets",
         "discovery_nshards", "extend_space", "use_op_cost_db",
         "enable_auto_remat", "remat_max_chain_len", "remat_policy",
         "memory_ratio"))
        + f"|db={db_mtime() if edconfig.use_op_cost_db else None}"
    ).encode())
    h.update(gm.code.encode())
    for node in gm.graph.nodes:
        if node.op == "call_function":
            h.update(node_signature(node).encode())
        elif node.op == "placeholder":
            v = node.meta.get("val")
            h.update(f"{getattr(v, 'shape', v)}{getattr(v, 'dtype', '')}"
                     .encode())
    for s in axis_specs:
        h.update(f"{s.name}:{s.size}:{s.kind}".encode())
    return h.hexdigest()[:32]


def _strategy_cache_path(key: str) -> str:
    import os

    return os.path.join(edconfig.compile_cache_dir, f"strategies_{key}.pkl")


def _strategy_cache_load(key: str):
    import os
    import pickle

    path = _strategy_cache_path(key)
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:
            logger.warning("compile cache read failed for %s", path)
    return None


def _strategy_cache_store(key: str, per_axis) -> None:
    import os
    import pickle
    import tempfile

    os.makedirs(edconfig.compile_cache_dir, exist_ok=True)
    path = _strategy_cache_path(key)
    tmp = None
    try:
        fd, tmp = tempfile.mkstemp(dir=edconfig.compile_cache_dir,
                                   prefix=f"strategies_{key}.",
                                   suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(per_axis, f)
        os.replace(tmp, path)
        tmp = None
    except Exception:
        logger.warning("compile cache write failed for %s", path)
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _agree_across_ranks(per_axis):
    """Rank 0's strategies, on every rank: each rank solves the same
    problem, and the emitted programs must pair their collectives."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return per_axis
    box = [per_axis]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _compile_on_mesh(result: CompileResult, axis_specs=None) -> None:
    """Discovery, the per-axis solve and emission of `result.traced` over
    `result.mesh` (its axes `axis_specs`, default the mesh's), filling the
    result's mesh fields."""
    from .interpreter import ShardingAnalyzer, VarNames
    from .mesh import get_axis_specs

    gm, mesh = result.traced, result.mesh
    axis_specs = result.axis_specs = list(axis_specs or get_axis_specs(mesh))
    names = VarNames()
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    out_leaves = pytree.tree_leaves(gm.graph.output_node().args)
    state_io_names = {out_leaves[o].name: placeholders[i].name
                      for o, i in result.state_pairs.items()
                      if isinstance(out_leaves[o], torch.fx.Node)}

    key = per_axis = None
    if edconfig.enable_compile_cache:
        key = _compile_cache_key(gm, axis_specs)
        per_axis = _strategy_cache_load(key)
        if per_axis is not None:
            logger.info("[compile cache] hit %s", key)
    if per_axis is None:
        t0 = time.perf_counter()
        world = min(s.size for s in axis_specs)
        analyzer = ShardingAnalyzer(gm, world_size=world)
        rules, shape_info = analyzer.run()
        result.timings["discovery"] = time.perf_counter() - t0
        result.counters = analyzer.counters.snapshot()
        result.replicated_on_failure = list(analyzer.replicated_on_failure)
        t0 = time.perf_counter()
        per_axis, graphs, solvers = solve_axes(
            gm, axis_specs, world, rules, shape_info, names, state_io_names)
        result.timings["solve"] = time.perf_counter() - t0
        result.graphs, result.solvers = graphs, solvers
        result.priced = [priced_collectives(sv, c) if sv is not None else []
                         for sv, c in zip(solvers, per_axis)]
        result.solver_costs = [sv.last_comm_cost if sv is not None else None
                               for sv in solvers]
        if key is not None:
            _strategy_cache_store(key, per_axis)
    per_axis = _agree_across_ranks(per_axis)
    result.strategies = per_axis

    frac = result.replicated_flops_fraction = _replicated_flops_fraction(
        gm, per_axis, axis_specs)
    if frac > edconfig.replicate_warn_threshold:
        logger.warning(
            "[easydist] %.0f%% of modeled FLOPs run fully REPLICATED on a "
            "%d-rank mesh: near-zero parallelism (indivisible dims, ops "
            "without sharding rules, or a cost model preferring "
            "replication at these sizes)", 100.0 * frac, mesh.size())

    rep = Placement.replicate()
    result.in_placements = [
        [c[n.name].out_placements[0] if n.name in c else rep
         for c in per_axis] for n in placeholders]
    t0 = time.perf_counter()
    result.graph_module, result.collectives = result.program_for(
        list(mesh.get_coordinate()))
    result.timings["emit"] = time.perf_counter() - t0


class CompiledFunction:
    """User-facing wrapper: traces (and on a mesh, solves and emits) on
    the first call per input signature and replays after."""

    def __init__(self, func, mesh=None, state_io="auto",
                 donate_state: Optional[bool] = None,
                 compile_only: bool = False):
        self.func = func
        self.mesh = mesh
        self.state_io = state_io
        self.donate_state = donate_state is not False
        self.compile_only = compile_only
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
            result = compile_step(self.func, args, kwargs, mesh=self.mesh,
                                  state_io=self.state_io,
                                  donate_state=self.donate_state)
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
        result = self.get_compiled(*args, **kwargs)
        if self.compile_only:
            return result
        return result.tree_jitted(*args, **kwargs)


_PIPELINE_DEFAULTS = {"pp_stages": None, "n_microbatches": None,
                      "pp_axis": "pp", "schedule": "gpipe", "lr": None,
                      "optimizer": "adam", "tp_axes": None}


def easydist_compile(func=None, mesh=None, state_io="auto",
                     donate_state: Optional[bool] = None,
                     compile_only: bool = False,
                     max_solver_time: Optional[float] = None,
                     liveness_only_input: Optional[bool] = None,
                     **pipeline):
    """Decorator entry point: `easydist_compile(fn)`, `@easydist_compile`,
    `@easydist_compile()` or `easydist_compile(step, mesh=mesh)`.

    `mesh`: None (the mesh `fxfront.mesh.make_device_mesh` installed, if
    any, else the device the tensors lie on), a device, or a DeviceMesh;
    a DeviceMesh of one rank keeps the one-device path.  `state_io`:
    "auto" pairs state positionally (`infer_state_io`); a dict {flat
    output index: flat input index} pairs explicitly.  `donate_state`
    (default True) writes paired outputs into their inputs (on a mesh:
    into DTensor inputs' shards); False returns new tensors.
    `compile_only` returns the CompileResult instead of running.
    `max_solver_time` (seconds) and `liveness_only_input` set the
    solver's knobs (`config.solver_time_limit`, `config.liveness_only_input`)
    as the JAX package does.  Under a memory cap
    (`config.per_device_memory_cap`, resolved by
    `schedule.remat.resolve_memory_cap`) the program is rewritten with
    compiler-chosen remat when its planned peak is over the cap
    (`config.enable_auto_remat`); a caller may differentiate through a
    compiled forward, under `config.remat_policy`'s checkpoint.

    With `pp_stages=` the decorated function is a LOSS `loss_fn(params,
    *batch) -> scalar` (mean over the batch) and the result a hybrid
    pipeline x data parallel train step (`fxfront.pp_compile`), with
    `n_microbatches` (default 2 * pp_stages), `pp_axis` ("pp"),
    `schedule` ("gpipe" | "remat" | "1f1b"), `lr` and `optimizer`
    ("adam" | "sgd" | an (init, update) pair), and `tp_axes` (one non-pp
    mesh axis whose tensor parallelism inside each stage the solver
    picks).  That path manages its own state, so `state_io`,
    `donate_state` and `compile_only` are refused with it, as are the
    pipeline arguments without it."""
    from .mesh import get_device_mesh

    unknown = sorted(set(pipeline) - set(_PIPELINE_DEFAULTS))
    if unknown:
        raise TypeError(f"easydist_compile got unexpected arguments "
                        f"{unknown}")
    pp = {**_PIPELINE_DEFAULTS, **pipeline}
    if max_solver_time is not None:
        edconfig.solver_time_limit = max_solver_time
    if liveness_only_input is not None:
        edconfig.liveness_only_input = liveness_only_input

    if pp["pp_stages"] is not None:
        dropped = [name for name, val, default in (
            ("state_io", state_io, "auto"),
            ("donate_state", donate_state, None),
            ("compile_only", compile_only, False)) if val != default]
        if dropped:
            raise ValueError(
                f"easydist_compile(pp_stages=...) does not support "
                f"{dropped}: the hybrid path manages its own train state "
                f"and always builds lazily on the first init_state call")
        m = mesh if mesh is not None else get_device_mesh()
        if m is None:
            raise ValueError("pp_stages= needs an explicit mesh")

        def wrap_pp(f):
            from .pp_compile import PPCompiledFunction

            return PPCompiledFunction(
                f, m, pp_stages=pp["pp_stages"],
                n_microbatches=pp["n_microbatches"] or pp["pp_stages"] * 2,
                pp_axis=pp["pp_axis"], schedule=pp["schedule"], lr=pp["lr"],
                optimizer=pp["optimizer"], tp_axes=pp["tp_axes"])

        return wrap_pp(func) if func is not None else wrap_pp
    pp_only = sorted(name for name, val in pp.items()
                     if val != _PIPELINE_DEFAULTS[name])
    if pp_only:
        raise ValueError(
            f"{pp_only} only apply with pp_stages=; without it the "
            f"decorated function IS the train step (it owns its optimizer), "
            f"so silently dropping them would change training behavior")

    if not (state_io == "auto" or isinstance(state_io, dict)):
        raise ValueError(f"state_io must be 'auto' or a dict {{flat output "
                         f"index: flat input index}}, got {state_io!r}")
    if mesh is None:
        mesh = get_device_mesh()
    _mesh_ranks(mesh)  # a multi-device spec that is not a DeviceMesh raises

    def wrap(f):
        return CompiledFunction(f, mesh=mesh, state_io=state_io,
                                donate_state=donate_state,
                                compile_only=compile_only)

    return wrap(func) if func is not None else wrap


def get_opt_strategy(func, *args, mesh=None, **kwargs):
    """Solve and return the per-axis strategy dicts without running the
    step (reference public API jax/api.py:1309)."""
    return compile_step(func, args, kwargs, mesh=mesh).strategies
