"""One-decorator hybrid pipeline x data parallel training: the port of
easydist_tpu/jaxfront/pp_compile.py.

`easydist_compile(loss_fn, pp_stages=S, n_microbatches=M, mesh=mesh)`
takes an unmodified mean-reduction loss `loss_fn(params, *batch) ->
scalar` and returns a train step over a pp x (anything) mesh:

  1. the loss is traced at sibling-local microbatch shape (the batch
     divided by n_microbatches and by the product of the non-pp axis
     sizes) and auto-split into S FLOP-balanced stages
     (`parallel.auto_pipeline.StagePlan`; `split_point` markers honoured);
  2. stage-exclusive params are packed per stage, each rank holding its
     stage's row flat-sharded over the sibling axes (per-rank param
     bytes ~ total / ranks); the rows are all_gathered once per step and
     their gradients reduce_scattered;
  3. each rank runs its own stage on the schedule ("gpipe", "remat",
     "1f1b") with P2P to its neighbours; the sibling axes
     batch-parallelise each stage and the loss is averaged over them;
  4. the optimizer ("adam", "sgd", or an (init, update) pair of
     `models/optim.py`) runs elementwise on the packed row block and the
     shared leaves, so its state is sharded like the params.

`tp_axes=("tp",)` names one non-pp axis on which the solver picks
tensor parallelism inside every stage (`_solve_tp`: discovery and the
per-axis ILP on the batch-local loss graph, at the tp axis's size; the
same graph feeds the split, so the plan's node names are the stages').
The tp axis does not divide the batch; each stage replays its nodes
under the plan with collectives on the tp group
(`parallel.auto_pipeline._run_nodes_tp`).  When nothing is worth
sharding the axis idles: its lanes run the stage replicated.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

logger = logging.getLogger(__name__)


def _struct(tree):
    """Shape/dtype signature used to pin the build geometry."""
    return pytree.tree_map(lambda x: (tuple(x.shape), x.dtype), tree)


def _is_pair(optimizer) -> bool:
    return isinstance(optimizer, tuple) and len(optimizer) == 2 \
        and all(callable(f) for f in optimizer)


class PPCompiledFunction:
    """Hybrid-compiled train step.  Usage, on every rank:

        compiled = easydist_compile(loss_fn, pp_stages=4,
                                    n_microbatches=8, mesh=mesh)
        state = compiled.init_state(params, *batch)   # packs + shards
        state, loss = compiled(state, *batch)         # one train step
    """

    def __init__(self, loss_fn: Callable, mesh, pp_stages: int,
                 n_microbatches: int, pp_axis: str = "pp",
                 schedule: str = "gpipe", lr: Optional[float] = None,
                 optimizer="adam", tp_axes=None):
        if schedule not in ("gpipe", "remat", "1f1b"):
            raise NotImplementedError(
                f"unknown schedule {schedule!r}; auto-split supports "
                f"'gpipe', 'remat' (gpipe + per-stage rematerialization) "
                f"and '1f1b' (one-forward-one-backward, O(n_stages) "
                f"residual memory)")
        tp_axes = tuple(tp_axes or ())
        if len(tp_axes) > 1:
            raise NotImplementedError(
                "one tp axis per hybrid compile for now")
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        for name in tp_axes:
            if name == pp_axis or name not in names:
                raise ValueError(f"tp axis {name!r} must be a non-pp mesh "
                                 f"axis (mesh has {names})")
        self.tp_axes = tp_axes
        self._tp_plan = None
        pair = _is_pair(optimizer)
        if not pair and optimizer not in ("adam", "sgd"):
            raise ValueError(
                f"optimizer must be 'adam', 'sgd', or an (init, update) "
                f"pair of models/optim.py, got {optimizer!r}")
        if pair and lr is not None:
            raise ValueError(
                "lr= is ignored with an (init, update) optimizer pair: bind "
                "the learning rate into its update instead")
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.pp_stages = pp_stages
        self.n_microbatches = n_microbatches
        self.pp_axis = pp_axis
        self.schedule = schedule
        self.lr = 1e-4 if lr is None else lr
        self.optimizer = optimizer
        self._is_pair = pair
        self._built = None  # (step, init_state, prep)
        self._batch_struct = None

    # ------------------------------------------------------------- build

    def _build(self, params, batch):
        from easydist_tpu_torch.models.optim import (adam_init, adam_update,
                                                     sgd_update)
        from easydist_tpu_torch.parallel.auto_pipeline import (pipeline_grad,
                                                               trace)

        M = self.n_microbatches
        mesh, pp_axis = self.mesh, self.pp_axis
        names = tuple(mesh.mesh_dim_names or ())
        if pp_axis not in names:
            raise ValueError(f"mesh has no {pp_axis!r} axis: {names}")
        if mesh.size(names.index(pp_axis)) != self.pp_stages:
            raise ValueError(
                f"mesh axis {pp_axis!r} has size "
                f"{mesh.size(names.index(pp_axis))}, expected pp_stages="
                f"{self.pp_stages}")
        # the non-tp siblings divide the batch; a tp axis sees it whole
        n_batch = math.prod(mesh.size(i) for i, n in enumerate(names)
                            if n != pp_axis and n not in self.tp_axes)

        # non-float param leaves (masks, index tables) are baked into the
        # traced closure as constants; only the float leaves pipeline
        all_leaves, pdef = pytree.tree_flatten(params)
        diff_idx = [i for i, x in enumerate(all_leaves)
                    if x.is_floating_point()]
        const_vals = {i: x for i, x in enumerate(all_leaves)
                      if i not in set(diff_idx)}
        self._diff_idx, self._params_treedef = diff_idx, pdef
        self._const_baked = const_vals

        def merge(diff_leaves):
            out = [const_vals.get(i) for i in range(len(all_leaves))]
            for i, x in zip(diff_idx, diff_leaves):
                out[i] = x
            return pytree.tree_unflatten(out, pdef)

        def loss_flat_mb(p, mb_tuple):
            return self.loss_fn(merge(p), *mb_tuple)

        def to_mb(x):
            if x.shape[0] % (M * n_batch) != 0:
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by "
                    f"n_microbatches*batch-siblings = {M}*{n_batch}")
            return x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))

        def to_local_mb(x):
            mb = to_mb(x)[0]
            return mb[: mb.shape[0] // n_batch]

        mb_local = tuple(pytree.tree_map(to_local_mb, b) for b in batch)
        diff_example = [all_leaves[i] for i in diff_idx]
        # one trace serves the tp solve and the split
        traced = trace(loss_flat_mb, diff_example, mb_local)
        tp_axis = None
        if self.tp_axes:
            tp_axis = self.tp_axes[0]
            self._tp_plan = self._solve_tp(
                traced[0], tp_axis, mesh.size(names.index(tp_axis)))
            if not self._tp_plan:
                # the lanes then run every stage replicated, and the
                # sibling reduction averages their equal gradients
                logger.warning(
                    "[pp-hybrid] tp solver found nothing profitable to "
                    "shard; axis %r runs idle - drop tp_axes= for batch "
                    "parallelism instead", tp_axis)
        pipe_grad, pack_params = pipeline_grad(
            loss_flat_mb, diff_example, mb_local, mesh,
            n_stages=self.pp_stages, n_microbatches=M, axis=pp_axis,
            schedule=self.schedule, traced=traced, tp_axis=tp_axis,
            tp_plan=self._tp_plan)
        self.pipe = pipe_grad

        if self._is_pair:
            opt_init, opt_update = self.optimizer
        elif self.optimizer == "adam":
            opt_init = adam_init

            def opt_update(p, g, s):
                return adam_update(p, g, s, lr=self.lr)
        else:
            opt_init = None

            def opt_update(p, g, s):
                return sgd_update(p, g, lr=self.lr), s

        def step(state, *batch_args):
            params_repr, opt = state
            mbs = tuple(pytree.tree_map(to_mb, b) for b in batch_args)
            loss, grads = pipe_grad(params_repr, mbs)
            new_repr, new_opt = opt_update(params_repr, grads, opt)
            return (tuple(new_repr), new_opt), loss

        def init_state(raw_params):
            raw = pytree.tree_leaves(raw_params)
            repr_ = pack_params([raw[i] for i in diff_idx])
            return (repr_, opt_init(repr_) if opt_init is not None else ())

        self._built = (step, init_state, pipe_grad.prep)
        self._batch_struct = _struct(batch)
        return self._built

    # --------------------------------------------------------- introspection

    @property
    def tp_plan(self):
        """A copy of the tensor-parallel plan inside stages: {node name of
        the traced loss graph: NodeStrategy} (empty when tp_axes was not
        given, nothing was profitable, or before the first init_state
        builds)."""
        return dict(self._tp_plan) if self._tp_plan else {}

    def tp_summary(self):
        """{'planned': strategies, 'sharded': strategies that shard at
        least one operand}."""
        plan = self.tp_plan
        sharded = sum(
            1 for s in plan.values()
            if any(q is not None and q.is_shard()
                   for q in list(s.in_placements) + list(s.out_placements)))
        return {"planned": len(plan), "sharded": sharded}

    # ------------------------------------------------------------ tp solve

    @staticmethod
    def _tp_replay_skip(node) -> bool:
        """The port's custom ops (the flash kernels, the attention
        composite, split_point and the scope ops; reference
        `_TP_REPLAY_SKIP`): their strategies describe whole-op programs
        that a replay on sliced operands cannot honour, so they stay
        replicated over tp."""
        t = node.target
        return getattr(t, "namespace", None) == "easydist_tpu_torch"

    def _solve_tp(self, gm, tp_axis: str, tp_size: int):
        """Per-node tensor-parallel plan for the tp axis (reference
        jaxfront/pp_compile.py:289-329): discovery and the per-axis ILP on
        the batch-local loss graph at the tp axis's own size.  Returns
        {node name: NodeStrategy} for the nodes the replay shards."""
        from easydist_tpu_torch import config as edconfig
        from easydist_tpu_torch.autoflow.cost_model import MeshAxisSpec
        from easydist_tpu_torch.metashard.combination import Reduction

        from .api import solve_axes
        from .interpreter import ShardingAnalyzer, VarNames

        analyzer = ShardingAnalyzer(gm, world_size=tp_size)
        rules, shape_info = analyzer.run()
        # one node a cluster: a cone cluster offers a chain one layout
        # throughout, which hides the column-then-row split of a layer pair
        level = edconfig.coarsen_level
        edconfig.coarsen_level = 0
        try:
            per_axis, _, _ = solve_axes(
                gm, [MeshAxisSpec(tp_axis, tp_size)], tp_size, rules,
                shape_info, VarNames())
        finally:
            edconfig.coarsen_level = level
        chosen = per_axis[0] or {}
        plan = {}
        for node in gm.graph.nodes:
            s = chosen.get(node.name)
            if node.op != "call_function" or s is None \
                    or s.is_all_replicate() or self._tp_replay_skip(node):
                continue
            if any(p is not None and p.is_partial()
                   and p.reduction not in (Reduction.SUM, Reduction.AVG)
                   for p in s.out_placements):
                continue  # a max / min partial: the replay sums only
            plan[node.name] = s
        return plan

    @property
    def stage_plan(self):
        """The traced split (`parallel.auto_pipeline.StagePlan`) once
        built."""
        return None if self._built is None else self._built[2].plan

    # --------------------------------------------------------------- api

    def init_state(self, params, *example_batch):
        if self._built is None:
            if not example_batch:
                raise ValueError(
                    "first init_state call needs an example batch: "
                    "init_state(params, *batch)")
            self._build(params, example_batch)
            self._param_struct = _struct(params)
            return self._built[1](params)
        if _struct(params) != self._param_struct:
            raise ValueError(
                "params shape/dtype signature differs from the one this "
                "step was built with; build a new "
                "easydist_compile(pp_stages=...) instance")
        leaves = pytree.tree_leaves(params)
        for i, baked in self._const_baked.items():
            if not torch.equal(leaves[i].cpu(), baked.cpu()):
                raise ValueError(
                    "a non-float param leaf changed content since the "
                    "build; non-float leaves are baked into the traced "
                    "program as constants — build a new "
                    "easydist_compile(pp_stages=...) instance")
        if example_batch:
            bstruct = _struct(example_batch)
            if bstruct != self._batch_struct:
                raise ValueError(
                    f"batch signature {bstruct} differs from the build's "
                    f"{self._batch_struct}; build a new "
                    f"easydist_compile(pp_stages=...) instance")
        return self._built[1](params)

    def __call__(self, state, *batch):
        if self._built is None:
            raise RuntimeError("call init_state(params, *batch) first")
        struct = _struct(batch)
        if struct != self._batch_struct:
            raise ValueError(
                f"batch shape/dtype signature {struct} differs from the "
                f"one this step was built with {self._batch_struct}; "
                f"build a separate easydist_compile(pp_stages=...) "
                f"instance per batch geometry")
        return self._built[0](state, *batch)

    def export_state_dict(self, state):
        """The live train state's params as the logical params tree: the
        packed rows gathered over the sibling and pipeline groups (every
        rank calls it), each leaf sliced back out, the shared leaves and
        the baked non-float constants merged in.  Optimizer state is not
        exported (it lives in the packed representation)."""
        from easydist_tpu_torch import comm

        if self._built is None:
            raise RuntimeError("call init_state(params, *batch) first")
        prep = self._built[2]
        (row, shared) = state[0]
        if prep.local:
            rows = row
        else:
            full = row[0]
            if prep.sib is not None:
                full = comm.all_gather_dim0(full, prep.sib.group,
                                            prep.sib.size)
            rows = comm.all_gather_dim0(full[None], prep.pp.group,
                                        prep.pp.size)
        diff_leaves = prep.unpack_params(rows, shared)
        out = [None] * (len(self._diff_idx) + len(self._const_baked))
        for i, leaf in zip(self._diff_idx, diff_leaves):
            out[i] = leaf
        for i, baked in self._const_baked.items():
            out[i] = baked
        return pytree.tree_unflatten(out, self._params_treedef)
