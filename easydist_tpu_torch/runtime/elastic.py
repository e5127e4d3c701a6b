"""Fault-tolerant training loop: the port of easydist_tpu/runtime/elastic.py.

`run_training` persists state every N steps through the atomic commit
protocol (runtime/checkpoint.py), resumes from the newest COMMITTED step
and carries on:

  * the data cursor (`batches_consumed`) commits atomically WITH the
    state in the manifest; resume skips the loader's deterministic stream
    to exactly where the restored state left it, so a restart never draws
    a batch twice and never skips one;
  * SIGTERM is turned into a flag; the loop takes one final checkpoint at
    the next step boundary and exits through `PreemptedError`
    (resilience/preempt.py);
  * with the step guard on, the step runs under `GuardedStep`, the NaN /
    Inf skip-and-hold guard with a bounded skip budget;
  * a batch that takes longer than `data_timeout_s` raises
    `DataStallError` instead of hanging the job.

Fault points: `preempt.sigterm`, `step.nan_grad`, `data.stall`,
`ckpt.write.partial`, `ckpt.manifest.corrupt`,
`elastic.restore.chunk_corrupt`.  A restart on another world size is
ROADMAP queue A item 8 (`elastic.mesh.shrink` and `elastic.restore.oom`
come with it).

Batches: the loop draws host batches (numpy) from `data_iter` and hands
them to the step on `device`, the card unless the caller names the CPU.

Bitwise resume needs a step that is bitwise from run to run: an index
backward (GPT's embedding lookup) accumulates in a nondeterministic order
on the card and the CPU unless `torch.use_deterministic_algorithms(True)`
is set (XLA's programs are deterministic as they are).
"""

from __future__ import annotations

import logging
import signal
import time
from typing import Callable, Optional

import torch

from easydist_tpu_torch import config as edconfig
from easydist_tpu_torch.resilience import faultinject
from easydist_tpu_torch.resilience.guard import GuardedStep
from easydist_tpu_torch.resilience.preempt import (PreemptedError,
                                                    PreemptionHandler)

from .checkpoint import latest_step, load_checkpoint, save_checkpoint

logger = logging.getLogger(__name__)


class DataStallError(RuntimeError):
    """The input pipeline took longer than the stall budget to produce one
    batch: the loop fails loudly instead of wedging on `next()`."""

    def __init__(self, elapsed_s: float, budget_s: float):
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s
        super().__init__(
            f"data loader stalled: one batch took {elapsed_s:.2f}s "
            f"(budget {budget_s:.2f}s, EASYDIST_DATA_TIMEOUT)")


def multihost_setup(coordinator: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    backend: Optional[str] = None) -> None:
    """Initialize the default process group: `coordinator` is its address
    ("tcp://host:port"), `num_processes` the world size, `process_id` this
    rank.  NCCL when the card is present, else gloo.  Without arguments
    torch reads the env:// variables (MASTER_ADDR, WORLD_SIZE, RANK)."""
    import torch.distributed as dist

    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=coordinator,
                                world_size=num_processes, rank=process_id)


def _draw_batch(data_iter, timeout_s: float):
    """One batch from the iterator, with the stall fault point and the
    after-the-fact watchdog (a wedged C++ read cannot be cancelled; a
    typed raise is the recoverable contract)."""
    t0 = time.perf_counter()
    if faultinject.fire("data.stall"):
        time.sleep((timeout_s * 1.5) if timeout_s > 0 else 0.05)
    batch = next(data_iter)
    elapsed = time.perf_counter() - t0
    if timeout_s > 0 and elapsed > timeout_s:
        raise DataStallError(elapsed, timeout_s)
    return batch


def to_device(batch, device):
    """The default `prepare_batch`: every host array as a tensor on
    `device`."""
    return tuple(torch.as_tensor(x).to(device) for x in batch)


def run_training(step_fn: Callable, init_state: Callable, data_iter,
                 ckpt_dir: str, total_steps: int,
                 checkpoint_every: int = 100,
                 on_step: Optional[Callable] = None,
                 step_guard: Optional[bool] = None,
                 preempt_grace_s: Optional[float] = None,
                 data_timeout_s: Optional[float] = None,
                 keep: int = 3, device=None,
                 prepare_batch: Optional[Callable] = None):
    """Fault-tolerant training loop.

    step_fn(state, *batch) -> (state, loss); init_state() -> fresh state.
    Resumes from the newest COMMITTED checkpoint under `ckpt_dir` when one
    exists (a corrupt newest one falls back to the previous good one).
    Returns the final state.

    `device` (default the card, "cuda"): where the batches go;
    `prepare_batch(batch, device)` (default `to_device`) turns a drawn
    batch into the step's arguments.  `step_guard` / `preempt_grace_s` /
    `data_timeout_s` default to the EASYDIST_STEP_GUARD /
    EASYDIST_PREEMPT_GRACE / EASYDIST_DATA_TIMEOUT knobs; with the guard
    off `step_fn` is called directly (a guarded `easydist_compile` step
    must be compiled with `donate_state=False`)."""
    if step_guard is None:
        step_guard = edconfig.resilience_step_guard
    if preempt_grace_s is None:
        preempt_grace_s = edconfig.resilience_preempt_grace_s
    if data_timeout_s is None:
        data_timeout_s = edconfig.resilience_data_timeout_s
    device = torch.device("cuda" if device is None else device)
    prepare = prepare_batch or to_device
    faultinject.arm_from_config()

    cursor = 0
    start = latest_step(ckpt_dir)
    if start is None:
        state = init_state()
        start = 0
        logger.info("elastic: fresh start")
    else:
        # step=None: a corrupt newest checkpoint falls back to the
        # previous committed step; `start` is what actually restored
        state, start, meta = load_checkpoint(ckpt_dir, init_state(),
                                             with_meta=True)
        logger.info("elastic: resumed from step %d", start)
        cursor = meta.get("batches_consumed")
        if cursor is None:
            cursor = start
            logger.warning(
                "elastic: checkpoint step %d has no data cursor; resuming "
                "on steps == batches", start)
        if hasattr(data_iter, "skip"):
            already = getattr(data_iter, "batches_consumed", 0)
            if already < cursor:
                data_iter.skip(cursor - already)
                logger.info("elastic: data cursor advanced to batch %d",
                            cursor)
    if not hasattr(data_iter, "__next__"):
        data_iter = iter(data_iter)

    stepper = GuardedStep(step_fn, device=device) if step_guard else step_fn
    drawn = int(cursor)

    def checkpoint(state, step: int, extra: Optional[dict] = None) -> None:
        meta = {"batches_consumed": drawn}
        if step_guard:
            meta["guard"] = stepper.stats()
        if extra:
            meta.update(extra)
        save_checkpoint(ckpt_dir, state, step, keep=keep, meta=meta)

    t0 = time.perf_counter()
    with PreemptionHandler(grace_s=preempt_grace_s) as pre:
        for step in range(start, total_steps):
            if faultinject.fire("preempt.sigterm"):
                signal.raise_signal(signal.SIGTERM)
            if pre.requested:
                t_ck = time.perf_counter()
                checkpoint(state, step, extra={"preempted": True})
                dt = time.perf_counter() - t_ck
                if dt > pre.grace_s:
                    logger.error(
                        "preempt: final checkpoint took %.2fs, over the "
                        "%.1fs grace budget", dt, pre.grace_s)
                raise PreemptedError(step, dt)
            batch = _draw_batch(data_iter, data_timeout_s)
            drawn += 1
            state, loss = stepper(state, *prepare(batch, device))
            if on_step is not None:
                on_step(step, loss)
            if (step + 1) % checkpoint_every == 0 or step + 1 == total_steps:
                checkpoint(state, step + 1)
                logger.info("elastic: checkpointed step %d (%.1fs elapsed)",
                            step + 1, time.perf_counter() - t0)
    return state
