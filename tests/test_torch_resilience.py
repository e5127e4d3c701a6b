"""The port's NaN guard (`resilience/guard.py`), preemption handler
(`resilience/preempt.py`) and atomic checkpoints (`runtime/checkpoint.py`)
against the JAX package's (tests/test_resilience/test_{guard,
checkpoint_atomic}.py).

  * `GuardedStep`'s stats and held state equal the JAX guard's under the
    same fault plan, bitwise; skip-and-hold, the overflow scale, the skip
    budget, `poison_batch`; a donating compiled step is refused;
  * the guarded ddp / zero2 / zero3 steps on gloo world 2: a batch with
    NaN rows in one rank's block holds every rank's state bitwise;
  * the commit protocol's cases (layout, torn write invisible, corrupt
    newest falls back, explicit step raises, GC invariants, I/O retry);
    zero2's per-rank state through one commit on world 2, restored
    bitwise; a checkpoint of another world saved without a layout
    refused.
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_fxfront_ranks as ranks
from tests.test_torch_comm_quant import SCEN, _mlp


# ------------------------------------------------------------------ guard

def _jstep(state, x):
    return state + jnp.mean(x), jnp.mean(x) ** 2


def _tstep(state, x):
    return state + torch.mean(x), torch.mean(x) ** 2


def test_all_finite_ignores_int_leaves():
    from easydist_tpu_torch.resilience import all_finite

    assert bool(all_finite({"a": torch.ones(3), "n": torch.arange(3)}))
    assert not bool(all_finite({"a": torch.tensor([1.0, float("nan")])}))
    assert bool(all_finite({"n": torch.arange(3)}))


def test_skip_and_hold_and_scale():
    from easydist_tpu_torch.resilience import (guard_train_step,
                                               init_guard_state)

    gstep = guard_train_step(_tstep, scale_decay=0.5, scale_growth_every=2,
                             scale_max=1.0)
    carry = (torch.zeros(()), init_guard_state())
    carry, _ = gstep(carry, torch.ones(4))
    held = carry[0].clone()
    carry, loss = gstep(carry, torch.full((4,), float("nan")))
    assert torch.equal(carry[0], held) and torch.isnan(loss)
    gs = carry[1]
    assert (int(gs["consecutive"]), int(gs["skips"])) == (1, 1)
    assert float(gs["scale"]) == 0.5
    for _ in range(4):
        carry, _ = gstep(carry, torch.ones(4))
    assert int(carry[1]["consecutive"]) == 0
    assert float(carry[1]["scale"]) == 1.0  # grown back, capped


@pytest.mark.parametrize("plan,steps", [("step.nan_grad@2", 4),
                                        ("step.nan_grad@1,step.nan_grad@3",
                                         5)])
def test_guarded_step_matches_jax(plan, steps):
    from easydist_tpu.resilience import faultinject as jfi
    from easydist_tpu.resilience.guard import GuardedStep as JGuarded
    from easydist_tpu_torch.resilience import GuardedStep, fault_plan

    xs = np.random.RandomState(0).randn(steps, 4).astype(np.float32)
    with jfi.fault_plan(plan):
        jg = JGuarded(_jstep, max_consecutive_skips=4)
        js = jnp.zeros(())
        for x in xs:
            js, _ = jg(js, jnp.asarray(x))
    with fault_plan(plan):
        tg = GuardedStep(_tstep, max_consecutive_skips=4)
        ts = torch.zeros(())
        for x in xs:
            ts, _ = tg(ts, torch.from_numpy(x))
    assert tg.stats() == jg.stats()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_guarded_step_budget_raises():
    from easydist_tpu_torch.resilience import (GuardBudgetExceededError,
                                               GuardedStep)

    guarded = GuardedStep(_tstep, max_consecutive_skips=2)
    state, bad = torch.zeros(()), torch.full((4,), float("nan"))
    state, _ = guarded(state, bad)
    state, _ = guarded(state, bad)
    with pytest.raises(GuardBudgetExceededError) as ei:
        guarded(state, bad)
    assert (ei.value.consecutive, ei.value.budget) == (3, 2)


def test_poison_batch():
    from easydist_tpu_torch.resilience import poison_batch

    x, n = torch.ones(2, 3), torch.arange(4)
    px, pn = poison_batch((x, n))
    assert torch.isnan(px).all() and px.shape == x.shape and pn is n
    with pytest.raises(ValueError):
        poison_batch((torch.arange(4),))


def test_guard_refuses_donating_compiled_step():
    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.resilience import GuardedStep

    with pytest.raises(ValueError, match="donate_state=False"):
        GuardedStep(easydist_compile(_tstep))
    GuardedStep(easydist_compile(_tstep, donate_state=False))


def test_preemption_handler_restores_previous_handler():
    from easydist_tpu_torch.resilience import PreemptionHandler

    before = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler(grace_s=5.0) as pre:
        assert not pre.requested
        signal.raise_signal(signal.SIGTERM)
        assert pre.requested and pre.grace_remaining() <= 5.0
    assert signal.getsignal(signal.SIGTERM) is before
    with pytest.raises(ValueError):
        PreemptionHandler(grace_s=0)


# ------------------------------------------- guard and checkpoints on gloo

@pytest.fixture(scope="module")
def runtime_run(tmp_path_factory):
    params, x, y = _mlp(60)
    return ranks.spawn(SCEN + "runtime_cases", 2,
                       tmp_path_factory.mktemp("runtime"), params=params,
                       x=x, y=y)


@pytest.mark.parametrize("mode", ["ddp", "zero2", "zero3"])
def test_guarded_modes_hold_on_nan(runtime_run, mode):
    for r in runtime_run:
        clean, after, gs, losses = r["guard"][mode]
        assert np.isfinite(losses[0]) and np.isnan(losses[1])
        for a, b in zip(jax.tree.leaves(clean), jax.tree.leaves(after)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert (int(gs["skips"]), int(gs["steps"])) == (1, 2)


def test_per_rank_checkpoint_roundtrip(runtime_run):
    for rank, r in enumerate(runtime_run):
        assert r["same"] and r["step"] == 2 and r["latest"] == 2
        assert r["meta"]["batches_consumed"] == 2
        assert r["meta"]["mesh"]["n_devices"] == 2
        assert r["files"] == ["rank00000.pt", "rank00001.pt"]
        assert "without a stated layout" in r["refused"]


# ------------------------------------------------------ commit protocol

def _state(seed=0):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) + seed,
            "count": torch.tensor(seed, dtype=torch.int32)}


def _bitwise_equal(a, b):
    return (a["w"].numpy().tobytes() == b["w"].numpy().tobytes()
            and int(a["count"]) == int(b["count"]))


def test_commit_protocol_layout(tmp_path):
    from easydist_tpu_torch.runtime.checkpoint import (
        ARRAYS_SUBDIR, COMMITTED_NAME, MANIFEST_NAME, checkpoint_meta,
        latest_step, save_checkpoint, verify_checkpoint)

    root = str(tmp_path)
    final = save_checkpoint(root, _state(), step=7,
                            meta={"batches_consumed": 7})
    assert final == os.path.join(root, "step_7")
    assert os.path.isdir(os.path.join(final, ARRAYS_SUBDIR))
    assert os.path.isfile(os.path.join(final, COMMITTED_NAME))
    with open(os.path.join(final, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert set(manifest) == {"format", "step", "created", "meta", "files"}
    assert manifest["step"] == 7
    assert manifest["meta"]["batches_consumed"] == 7
    assert manifest["meta"]["mesh"]["format"] == 1
    assert manifest["meta"]["mesh"]["n_devices"] == 1
    for rel, want in manifest["files"].items():
        assert len(want["sha256"]) == 64
        assert want["bytes"] == os.path.getsize(os.path.join(final, rel))
    assert latest_step(root) == 7
    assert verify_checkpoint(final) == []
    assert checkpoint_meta(root, 7)["batches_consumed"] == 7


def test_partial_write_is_invisible(tmp_path):
    from easydist_tpu_torch.resilience import InjectedFault, fault_plan
    from easydist_tpu_torch.runtime.checkpoint import (latest_step,
                                                       load_checkpoint,
                                                       save_checkpoint)

    root = str(tmp_path)
    save_checkpoint(root, _state(0), step=0)
    with fault_plan("ckpt.write.partial@1"):
        with pytest.raises(InjectedFault):
            save_checkpoint(root, _state(1), step=1)
    assert latest_step(root) == 0
    assert not os.path.isdir(os.path.join(root, "step_1"))
    assert not [d for d in os.listdir(root) if d.startswith(".tmp")]
    assert _bitwise_equal(load_checkpoint(root, _state(99)), _state(0))


def test_corrupt_newest_falls_back(tmp_path):
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.runtime.checkpoint import (
        CheckpointCorruptionError, latest_step, load_checkpoint,
        save_checkpoint, verify_checkpoint)

    root = str(tmp_path)
    save_checkpoint(root, _state(0), step=3, meta={"batches_consumed": 3})
    with fault_plan("ckpt.manifest.corrupt@1"):
        save_checkpoint(root, _state(1), step=6,
                        meta={"batches_consumed": 6})
    assert latest_step(root) == 6
    assert verify_checkpoint(os.path.join(root, "step_6")) != []
    state, step, meta = load_checkpoint(root, _state(99), with_meta=True)
    assert step == 3 and meta["batches_consumed"] == 3
    assert _bitwise_equal(state, _state(0))
    with pytest.raises(CheckpointCorruptionError):
        load_checkpoint(root, _state(99), step=6)


def test_restore_chunk_corrupt_falls_back(tmp_path):
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                       save_checkpoint)

    root = str(tmp_path)
    save_checkpoint(root, _state(0), step=1)
    save_checkpoint(root, _state(1), step=2)
    with fault_plan("elastic.restore.chunk_corrupt@1"):
        state, step, _ = load_checkpoint(root, _state(9), with_meta=True)
    assert step == 1 and _bitwise_equal(state, _state(0))


def test_every_candidate_corrupt_raises(tmp_path):
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.runtime.checkpoint import (
        CheckpointCorruptionError, load_checkpoint, save_checkpoint)

    root = str(tmp_path)
    with fault_plan("ckpt.manifest.corrupt@*"):
        save_checkpoint(root, _state(0), step=1)
    with pytest.raises(CheckpointCorruptionError):
        load_checkpoint(root, _state(9))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), _state(9))


def test_template_mismatch_raises(tmp_path):
    from easydist_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                       save_checkpoint)

    save_checkpoint(str(tmp_path), _state(0), step=1)
    bad = {"w": torch.zeros(4, 3), "count": torch.tensor(0,
                                                         dtype=torch.int32)}
    with pytest.raises(ValueError, match="template"):
        load_checkpoint(str(tmp_path), bad)


def test_gc_keeps_committed_window_and_protects_newest(tmp_path):
    from easydist_tpu_torch.runtime.checkpoint import (_gc_old, _step_dirs,
                                                       save_checkpoint)

    root = str(tmp_path)
    for s in range(5):
        save_checkpoint(root, _state(s), step=s, keep=2)
    assert [s for s, _ in _step_dirs(root)] == [3, 4]
    # an uncommitted dir superseded by a committed step is swept, a dead
    # tmp dir older than an hour too, a young one is left alone
    os.makedirs(os.path.join(root, "step_2"))
    old = os.path.join(root, ".tmp_step_9_dead")
    young = os.path.join(root, ".tmp_step_9_live")
    os.makedirs(old)
    os.makedirs(young)
    past = time.time() - 7200
    os.utime(old, (past, past))
    _gc_old(root, keep=2, protect=4)
    assert sorted(os.listdir(root)) == [".tmp_step_9_live", "step_3",
                                        "step_4"]
    _gc_old(root, keep=1, protect=3)
    assert "step_3" in os.listdir(root)


def test_retry_io_backoff(monkeypatch):
    from easydist_tpu_torch import config as tconfig
    from easydist_tpu_torch.runtime.checkpoint import _retry_io

    monkeypatch.setattr(tconfig, "resilience_ckpt_retries", 2)
    monkeypatch.setattr(tconfig, "resilience_ckpt_backoff_s", 0.0)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert _retry_io(flaky, "test") == "ok" and len(calls) == 3
    calls.clear()

    def dead():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        _retry_io(dead, "test")
    assert len(calls) == 3

    def logic():
        raise KeyError("not I/O")

    with pytest.raises(KeyError):
        _retry_io(logic, "test")


def test_resilience_knobs_validated():
    import importlib
    import subprocess
    import sys

    code = ("import easydist_tpu_torch.config")
    env = dict(os.environ, EASYDIST_GUARD_SCALE_DECAY="1.5")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "EASYDIST_GUARD_SCALE_DECAY" in r.stderr
    assert importlib.import_module("easydist_tpu_torch.config")
