"""MetaOp: execution-based SPMD sharding-rule discovery ("ShardCombine").

Wraps a single operator (`fn`, concrete `args`).  `discover()` searches the
space of input shardings: it assigns a shard *group* to at most one dimension
of each tensor argument, executes the op once per shard with those dimensions
split `nshards` ways, and accepts the assignment iff the per-shard outputs can
be recombined into the unsharded output (see combination.match_recombine).
Each accepted group becomes one SPMD strategy of the op: inputs SHARD on their
group dims, output placement given by the recombination kind.

Reference semantics: easydist/metashard/metaop.py:60-277 (search order,
halo-retry loop, prompt fast-path).  Discovery runs eagerly where the op's
tensors live (platform.torch_backend), with TF32 off while it probes:
`Recombine.identity` compares the parts bitwise, every other match at
`allclose_rtol`.  An op that writes an input (aten `add_`, `copy_`) gets
fresh copies of its arguments for every probe.  A reduce recombination is
accepted only if it also holds with the group's sharded inputs zeroed
(`_holds_at_zero`); the JAX package's engine lacks that probe and accepts
a partial sum of `b + x @ w` once K passes ~1/rtol.
"""

from __future__ import annotations

import contextlib
import copy
import logging
from typing import Callable, Dict, List, Optional, Tuple

import torch

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch import platform
from .annotation import DimSharding, HaloSpec, ShardSpace, halo_pad
from .combination import HaloHint, Recombine, match_recombine

logger = logging.getLogger(__name__)

# process-wide probe accounting: every eager execution of an op under
# discovery (global run, per-shard candidate run, or one batched candidate
# bind) is one probe call.  A caller reads the delta around a discovery
# (`chip_smoke.py` prints it per op).
_PROBES = {"calls": 0}


def probe_calls() -> int:
    return _PROBES["calls"]


def reset_probe_calls() -> None:
    _PROBES["calls"] = 0


@contextlib.contextmanager
def _exact_matmuls():
    """float32 products in full precision (no TF32) while probes run, so
    that a replicated op's parts agree bitwise and reductions hold the
    allclose tolerance; the caller's settings come back afterwards."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


class MetaOp:

    def __init__(self, fn: Callable, args, kwargs=None,
                 nshards: Optional[int] = None, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", repr(fn))
        self.nshards = nshards or edconfig.discovery_nshards
        # args are the op's positional arguments, kwargs its keyword
        # arguments — kept explicit so a dict-valued positional arg is never
        # mistaken for keywords
        self.flat_args, self.args_spec = platform.tree_flatten(
            (tuple(args), dict(kwargs or {})))
        self.tensor_indices = [i for i, a in enumerate(self.flat_args)
                               if isinstance(a, platform.Tensor)]
        self.writes_input = platform.writes_input(fn)

    # ------------------------------------------------------------- execution

    def _call(self, flat_args):
        _PROBES["calls"] += 1
        if self.writes_input:
            # shards are views of the arguments: without copies the write
            # would reach the global inputs and every later candidate
            flat_args = [platform.clone(a) if isinstance(a, platform.Tensor)
                         else a for a in flat_args]
        args, kwargs = platform.tree_unflatten(flat_args, self.args_spec)
        return self.fn(*args, **kwargs)

    def run_global(self):
        return self._call(list(self.flat_args))

    def _shard_tensor(self, tensor, dim: int, block: int, halo: Optional[HaloSpec]):
        """Split `tensor` into nshards along `dim`; block-cyclic if block > 1;
        halo-pad the shards afterwards."""
        if tensor.shape[dim] % (self.nshards * block) != 0:
            raise RuntimeError(
                f"dim {dim} of size {tensor.shape[dim]} not divisible into "
                f"{self.nshards} shards x {block} blocks")
        if block == 1:
            shards = platform.chunk(tensor, self.nshards, dim)
        else:
            blocks = platform.chunk(tensor, block, dim)
            per_block = [platform.chunk(b, self.nshards, dim) for b in blocks]
            shards = [platform.concatenate([pb[s] for pb in per_block], dim=dim)
                      for s in range(self.nshards)]
        return halo_pad(shards, halo)

    def run_sharded(self, space: ShardSpace, group: int,
                    halo: Optional[HaloSpec] = None) -> List:
        """Execute once per shard with the group's dims split; returns the list
        of per-shard outputs.  Raises RuntimeError when shapes don't divide."""
        shard_plans: Dict[int, List] = {}  # flat-arg index -> per-shard tensors
        for t_idx, flat_idx in enumerate(self.tensor_indices):
            row = space[t_idx]
            for dim_idx, d in enumerate(row):
                if d.group == group:
                    eff_halo = halo if halo is not None else d.halo
                    if eff_halo is not None:
                        # halo is always exchanged along the dim being split —
                        # a HaloHint's dim refers to the *output* concat dim
                        # and must not leak here
                        eff_halo = HaloSpec(eff_halo.width, dim_idx)
                    shard_plans[flat_idx] = self._shard_tensor(
                        self.flat_args[flat_idx], dim_idx, d.block, eff_halo)
                    break
        if not shard_plans:
            raise RuntimeError(f"group {group} not present in shard space")

        if edconfig.discovery_batch_probes and self.nshards > 1:
            try:
                return self._run_sharded_batched(shard_plans)
            except Exception as e:
                logger.debug("%s: batched probe fell back to the shard "
                             "loop: %s", self.name, e)

        outs = []
        for s in range(self.nshards):
            shard_args = list(self.flat_args)
            for flat_idx, shards in shard_plans.items():
                shard_args[flat_idx] = shards[s]
            outs.append(self._call(shard_args))
        return outs

    def _run_sharded_batched(self, shard_plans: Dict[int, List]) -> List:
        """Fuse the nshards per-shard executions of one candidate into a
        single batched bind: sharded operands stack along a fresh leading
        axis and the op runs vmapped over it (platform.batched_call).  One
        eager dispatch per candidate instead of nshards, with bitwise-equal
        per-shard outputs for every primitive whose batching rule is the op
        itself over slices.  Raises on non-uniform shard shapes (halo-padded
        edge shards), unbatchable ops or ops that write an input; the caller
        falls back to the loop."""
        if self.writes_input:
            raise RuntimeError(f"{self.name} writes an input")
        stacked = list(self.flat_args)
        in_axes: List[Optional[int]] = [None] * len(stacked)
        for flat_idx, shards in shard_plans.items():
            if len({tuple(s.shape) for s in shards}) != 1:
                raise RuntimeError("non-uniform shard shapes")
            stacked[flat_idx] = platform.stack(shards, dim=0)
            in_axes[flat_idx] = 0

        def call_flat(*flat):
            args, kwargs = platform.tree_unflatten(list(flat),
                                                   self.args_spec)
            return self.fn(*args, **kwargs)

        out = platform.batched_call(call_flat, stacked, tuple(in_axes))
        _PROBES["calls"] += 1
        leaves, spec = platform.tree_flatten(out)
        if any(getattr(leaf, "ndim", 0) < 1
               or leaf.shape[0] != self.nshards for leaf in leaves):
            raise RuntimeError("batched output lost the shard axis")
        return [platform.tree_unflatten([leaf[s] for leaf in leaves], spec)
                for s in range(self.nshards)]

    # -------------------------------------------------------------- discovery

    def _check_candidate(self, space: ShardSpace, group: int, global_out):
        """Execute a candidate sharding and match recombination; drives the
        halo-retry loop (reference metaop.py:147-166).  Returns
        (recombine_fn_or_list, halo_used) or None."""
        try:
            sharded = self.run_sharded(space, group)
        except Exception as e:  # shape indivisible, op rejects sharded input, ...
            logger.debug("candidate %r failed to execute: %s", space, e)
            return None

        fn = match_recombine(sharded, global_out)
        if isinstance(fn, HaloHint):
            hint = fn
            width0 = max(hint.width, 1)
            sample = sharded[0][hint.out_idx] if hint.out_idx is not None else sharded[0]
            width_cap = max(sample.shape[hint.dim] // 2, width0)
            for width in range(width0, width_cap + 1):
                halo = HaloSpec(width, hint.dim)
                try:
                    sharded = self.run_sharded(space, group, halo=halo)
                except Exception:
                    return None
                fn = match_recombine(sharded, global_out)
                if fn is not None and not isinstance(fn, HaloHint):
                    if not self._holds_at_zero(space, group, fn, halo):
                        return None
                    return fn, halo
            return None
        if fn is None or not self._holds_at_zero(space, group, fn, None):
            return None
        return fn, None

    def _holds_at_zero(self, space: ShardSpace, group: int, fn,
                       halo: Optional[HaloSpec]) -> bool:
        """A reduce recombination must also hold where the group's sharded
        inputs are zero.  A term that does not depend on them (addmm's
        bias) is counted once per shard by a partial sum; on [0.5, 1.5]
        inputs it can hide under `allclose_rtol` (at K = 3072, bias /
        (x @ w) ~ 3e-4), at zero it is all that is left.  NaN matches
        NaN here: an op that is NaN at zero (x log x) keeps its rule.
        Other recombinations pass unprobed."""
        fns = fn if isinstance(fn, (list, tuple)) else [fn]
        if all(getattr(f, "func", None) is not Recombine.reduce for f in fns):
            return True
        zeroed = list(self.flat_args)
        for t_idx, flat_idx in enumerate(self.tensor_indices):
            if any(d.group == group for d in space[t_idx]):
                zeroed[flat_idx] = platform.zeros_like(zeroed[flat_idx])
        probe = copy.copy(self)
        probe.flat_args = zeroed
        try:
            target = probe.run_global()
            parts = probe.run_sharded(space, group, halo=halo)
        except Exception as e:
            logger.debug("%s: zero probe of group %d failed: %s", self.name,
                         group, e)
            return False
        if isinstance(target, platform.Tensor):
            return platform.allclose(fns[0](parts), target, equal_nan=True)
        outs = [i for i, t in enumerate(target)
                if isinstance(t, platform.Tensor)]
        return all(platform.allclose(f([p[i] for p in parts]), target[i],
                                     equal_nan=True)
                   for f, i in zip(fns, outs))

    def _search_group(self, space: ShardSpace, group: int,
                      anchor: Tuple[int, int], global_out):
        """Find an assignment of `group` to >=1 currently-unsharded dims (at
        most one per tensor), whose first assigned dim is at/after `anchor`.
        Candidates are enumerated depth-first in (tensor, dim) order; the first
        that executes and recombines wins (reference metaop.py:130-188).

        Returns (new_space, recombine, halo) or None."""
        ntensors = len(space)

        def assignments(t_idx: int, chosen: List[Tuple[int, int]]):
            if t_idx == ntensors:
                if chosen:
                    yield list(chosen)
                return
            start = anchor[1] if t_idx == anchor[0] and not chosen else 0
            if not chosen and t_idx < anchor[0]:
                # first assigned dim must not precede the anchor tensor
                yield from assignments(t_idx + 1, chosen)
                return
            for dim_idx in range(start, len(space[t_idx])):
                if space[t_idx][dim_idx].group == 0:
                    chosen.append((t_idx, dim_idx))
                    yield from assignments(t_idx + 1, chosen)
                    chosen.pop()
            yield from assignments(t_idx + 1, chosen)

        budget = edconfig.discovery_max_candidates
        for chosen in assignments(0, []):
            budget -= 1
            if budget < 0:
                logger.debug("%s: candidate budget exhausted for group %d",
                             self.name, group)
                return None
            cand = copy.deepcopy(space)
            for t_idx, dim_idx in chosen:
                cand.table[t_idx][dim_idx] = DimSharding(group=group)
            res = self._check_candidate(cand, group, global_out)
            if res is not None:
                fn, halo = res
                cand.attach_halo(halo, group)
                return cand, fn, halo
        return None

    def discover(self, prompt: Optional[ShardSpace] = None):
        """Full sharding discovery.  Returns (ShardSpace, {group: recombine}).

        `prompt` is a space discovered for the same op at other shapes; its
        groups are re-validated cheaply before falling back to search
        (reference metaop.py:190-260, 262-277).
        """
        with _exact_matmuls():
            return self._discover(prompt)

    def _discover(self, prompt: Optional[ShardSpace]):
        recombines: Dict[int, object] = {}
        space = ShardSpace.for_args(self.flat_args)
        global_out = self.run_global()

        if prompt is not None and prompt.compatible_with_args(self.flat_args):
            prompt_halos = {}
            for group in range(1, prompt.max_group() + 1):
                res = self._check_candidate(prompt, group, global_out)
                if res is None:
                    break
                recombines[group] = res[0]
                prompt_halos[group] = res[1]
            if recombines:
                space = prompt.truncate(len(recombines))
                for group, halo in prompt_halos.items():
                    if halo is not None:  # re-validation needed a new width
                        space.attach_halo(halo, group)

        group = len(recombines) + 1
        anchor = (0, 0)
        while anchor[0] < len(space):
            found = self._search_group(space, group, anchor, global_out)
            if found is None:
                break
            space, fn, _halo = found
            recombines[group] = fn
            # next group's first dim must come after this group's first dim
            pos = next(((t, d) for t in range(len(space))
                        for d in range(len(space[t]))
                        if space[t][d].group == group))
            t, d = pos
            anchor = (t, d + 1) if d + 1 < len(space[t]) else (t + 1, 0)
            group += 1

        logger.debug("discovered space of %s: %r", self.name, space)
        return space, recombines
