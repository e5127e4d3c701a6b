"""NaN/Inf step guard, skip-and-hold: the port of
easydist_tpu/resilience/guard.py.

The guard runs the candidate step, checks every floating leaf of the
candidate state and the loss for finiteness, and selects (`torch.where`)
between the candidate and the previous state: a non-finite step HOLDS
the previous state, bit for bit, instead of committing NaN.

Guard state (a small tree threaded through the step beside the state):

    consecutive   int32  non-finite steps in a row (reset on a clean step)
    skips         int32  total held steps
    steps         int32  total steps seen
    scale         f32    overflow scale: decays on each skip, grows back
                         after `scale_growth_every` clean steps

The select needs the state from before the step, so the guarded step
must not write its state in place: a step compiled with `donate_state`
(the default of `easydist_compile`) is refused; compile it with
`donate_state=False`.  Budget enforcement is on the host (`GuardedStep`):
it reads the consecutive-skip counter after each step and raises
`GuardBudgetExceededError` past the budget.

With the guard off nothing here runs: the dp / ZeRO step makers and
`run_training` call the step directly.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from . import faultinject


class GuardBudgetExceededError(RuntimeError):
    """More consecutive non-finite steps than the guard budget allows."""

    def __init__(self, consecutive: int, budget: int):
        self.consecutive = consecutive
        self.budget = budget
        super().__init__(
            f"step guard held {consecutive} consecutive non-finite steps "
            f"(budget {budget}); the step function is producing NaN/Inf "
            f"every step — aborting instead of silently spinning")


def init_guard_state(scale: float = 1.0, device=None):
    """A fresh guard-state tree (the second element of the guarded carry)."""
    return {"consecutive": torch.zeros((), dtype=torch.int32, device=device),
            "skips": torch.zeros((), dtype=torch.int32, device=device),
            "steps": torch.zeros((), dtype=torch.int32, device=device),
            "scale": torch.tensor(scale, dtype=torch.float32, device=device)}


def all_finite(*trees) -> torch.Tensor:
    """Scalar bool tensor: every floating leaf of every tree is finite
    (integer leaves are exempt).  No host sync."""
    flag = None
    for tree in trees:
        for leaf in pytree.tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and (
                    leaf.is_floating_point() or leaf.is_complex()):
                f = torch.isfinite(leaf).all()
                flag = f if flag is None else torch.logical_and(flag, f)
    return torch.tensor(True) if flag is None else flag


def _refuse_donating(step_fn) -> None:
    if getattr(step_fn, "donate_state", False):
        raise ValueError(
            "the step guard holds the pre-step state when a step is not "
            "finite, but this compiled step writes its state in place "
            "(donate_state=True); compile it with "
            "easydist_compile(..., donate_state=False)")


def guard_train_step(step_fn: Callable, *,
                     scale_decay: Optional[float] = None,
                     scale_growth_every: Optional[int] = None,
                     scale_max: float = 1.0,
                     group=None) -> Callable:
    """Wrap `step_fn(state, *batch) -> (state, loss)` into
    `gstep((state, guard_state), *batch) -> ((state, guard_state), loss)`
    with the skip-and-hold select.  `group` (a process group or its name):
    the finite flag is the minimum over the group's ranks, so ranks that
    each hold a block of the state hold or commit together.

    The returned loss is the candidate's, NaN on a held step."""
    from easydist_tpu_torch import config as edconfig

    decay = (edconfig.resilience_guard_scale_decay if scale_decay is None
             else scale_decay)
    growth_every = (edconfig.resilience_guard_scale_growth_every
                    if scale_growth_every is None else scale_growth_every)
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"scale_decay must be in (0, 1], got {decay}")
    if growth_every < 1:
        raise ValueError(
            f"scale_growth_every must be >= 1, got {growth_every}")
    _refuse_donating(step_fn)

    def gstep(carry, *batch):
        state, gs = carry
        cand, loss = step_fn(state, *batch)
        finite = all_finite(cand, loss)
        if group is not None:
            from easydist_tpu_torch.comm.reduce import group_name

            c10d = torch.ops._c10d_functional
            flag = c10d.all_reduce(finite.to(torch.int32).reshape(1),
                                   "min", group_name(group))
            finite = c10d.wait_tensor(flag)[0] > 0
        finite = finite.to(gs["consecutive"].device)
        new_state = pytree.tree_map(
            lambda c, p: torch.where(finite.to(c.device), c, p)
            if isinstance(c, torch.Tensor) else c, cand, state)
        one = torch.ones_like(gs["consecutive"])
        zero = torch.zeros_like(one)
        clean_run = torch.where(finite, gs["steps"] - gs["skips"] + 1, zero)
        grown = torch.where(
            finite & (clean_run % growth_every == 0),
            torch.clamp(gs["scale"] * 2.0, max=scale_max), gs["scale"])
        new_gs = {
            "consecutive": torch.where(finite, zero,
                                       gs["consecutive"] + 1),
            "skips": gs["skips"] + torch.where(finite, zero, one),
            "steps": gs["steps"] + 1,
            "scale": torch.where(finite, grown, gs["scale"] * decay),
        }
        return (new_state, new_gs), loss

    return gstep


def poison_batch(batch):
    """Replace the first floating tensor of `batch` with NaN of its shape
    and dtype (the `step.nan_grad` action).  A batch without one raises:
    an integer token batch needs a float argument of its own, such as a
    loss scale."""
    out = list(batch)
    for i, a in enumerate(out):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            out[i] = torch.full_like(a, float("nan"))
            return tuple(out)
    raise ValueError(
        "step.nan_grad needs at least one float batch argument to poison; "
        "this batch has none (int token batches: pass a float loss scale "
        "with the batch)")


class GuardedStep:
    """Host wrapper owning the guard state and the skip budget, over any
    `step_fn(state, *batch) -> (state, loss)`: a dp / ZeRO rank step, a
    non-donating `easydist_compile` function or a plain function.  One
    scalar is read back a step (the budget check)."""

    def __init__(self, step_fn: Callable,
                 max_consecutive_skips: Optional[int] = None, *,
                 scale_decay: Optional[float] = None,
                 scale_growth_every: Optional[int] = None,
                 init_scale: float = 1.0, group=None, device=None):
        from easydist_tpu_torch import config as edconfig

        self.budget = (edconfig.resilience_guard_max_skips
                       if max_consecutive_skips is None
                       else max_consecutive_skips)
        if self.budget < 1:
            raise ValueError(
                f"max_consecutive_skips must be >= 1, got {self.budget}")
        self._gstep = guard_train_step(
            step_fn, scale_decay=scale_decay,
            scale_growth_every=scale_growth_every, scale_max=init_scale,
            group=group)
        self._init_scale = init_scale
        self.guard_state = init_guard_state(init_scale, device)

    def __call__(self, state, *batch):
        if faultinject.fire("step.nan_grad"):
            batch = poison_batch(batch)
        gs = self.guard_state
        dev = next((x.device for x in pytree.tree_leaves(state)
                    if isinstance(x, torch.Tensor)), None)
        if dev is not None and gs["steps"].device != dev:
            gs = {k: v.to(dev) for k, v in gs.items()}
        (state, self.guard_state), loss = self._gstep((state, gs), *batch)
        consecutive = int(self.guard_state["consecutive"])
        if consecutive > self.budget:
            raise GuardBudgetExceededError(consecutive, self.budget)
        return state, loss

    def stats(self) -> dict:
        return {k: (float(v) if k == "scale" else int(v))
                for k, v in self.guard_state.items()}
