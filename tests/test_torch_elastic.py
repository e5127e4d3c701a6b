"""The port's elastic loop (`runtime/elastic.py`) and token loader
(`runtime/data.py` over `native/csrc/dataloader.cpp`) against the JAX
package's (tests/test_resilience/test_recovery_matrix.py:77-125,
262-283; tests/test_runtime/test_runtime.py's loader).

  * `TokenLoader`: the port's windows bitwise equal to the JAX package's
    native loader on the same file and seed, also after `skip(n)`; both
    on the native path;
  * the recovery matrix on the same model (a 4x2 linear regression, batch
    i a pure function of i): the clean run's losses within rtol 1e-4 /
    atol 1e-5 of the JAX `run_training`'s; every drill (a torn write, a
    corrupt committed step, SIGTERM, a data stall, a corrupt checkpoint
    found at restore) resumes to the clean run's final state bitwise;
    the guarded run survives a poisoned batch deterministically;
  * `run_training` takes the card unless told the CPU.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOTAL = 10
EVERY = 3


def _batch(i):
    rs = np.random.RandomState(1000 + i)
    return (rs.randn(8, 4).astype(np.float32),
            rs.randn(8, 2).astype(np.float32))


class Loader:
    """Deterministic cursor-skippable stream of numpy batches."""

    def __init__(self, wrap=lambda a: a):
        self.batches_consumed = 0
        self.wrap = wrap

    def skip(self, n):
        self.batches_consumed += n

    def __iter__(self):
        return self

    def __next__(self):
        i = self.batches_consumed
        self.batches_consumed += 1
        return tuple(self.wrap(a) for a in _batch(i))


def _tstep(w, x, y):
    from easydist_tpu_torch.models.optim import value_and_grad

    loss, g = value_and_grad(lambda w, x, y: torch.mean((x @ w - y) ** 2),
                             w, x, y)
    return w - 0.1 * g, loss


def _run(ckpt_dir, losses=None, **kw):
    from easydist_tpu_torch.runtime.elastic import run_training

    def on_step(step, loss):
        if losses is not None:
            losses.append((step, float(loss)))

    return run_training(_tstep, lambda: torch.zeros(4, 2), Loader(),
                        str(ckpt_dir), TOTAL, checkpoint_every=EVERY,
                        on_step=on_step, device="cpu", **kw)


def _bits(state):
    return state.numpy().tobytes()


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    losses = []
    final = _run(tmp_path_factory.mktemp("baseline"), losses)
    return _bits(final), losses


def test_clean_run_matches_jax(tmp_path, baseline):
    import jax

    from easydist_tpu.runtime.elastic import run_training

    def loss_fn(w, x, y):
        return jnp.mean((x @ w - y) ** 2)

    @jax.jit
    def step(w, x, y):
        loss, g = jax.value_and_grad(loss_fn)(w, x, y)
        return w - 0.1 * g, loss

    jlosses = []
    final = run_training(step, lambda: jnp.zeros((4, 2), jnp.float32),
                         Loader(jnp.asarray), str(tmp_path), TOTAL,
                         checkpoint_every=EVERY,
                         on_step=lambda s, l: jlosses.append((s, float(l))))
    _, losses = baseline
    assert [s for s, _ in losses] == [s for s, _ in jlosses]
    np.testing.assert_allclose([l for _, l in losses],
                               [l for _, l in jlosses], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.frombuffer(baseline[0], np.float32).reshape(4, 2),
        np.asarray(final), rtol=1e-4, atol=1e-5)


def test_recover_ckpt_write_partial(tmp_path, baseline):
    from easydist_tpu_torch.resilience import InjectedFault, fault_plan
    from easydist_tpu_torch.runtime.checkpoint import latest_step

    with fault_plan("ckpt.write.partial@2"):
        with pytest.raises(InjectedFault):
            _run(tmp_path)
    assert latest_step(str(tmp_path)) == 3
    assert _bits(_run(tmp_path)) == baseline[0]


def test_recover_ckpt_manifest_corrupt(tmp_path, baseline):
    from easydist_tpu_torch.resilience import PreemptedError, fault_plan
    from easydist_tpu_torch.runtime.checkpoint import latest_step

    with fault_plan("ckpt.manifest.corrupt@2,preempt.sigterm@8"):
        with pytest.raises(PreemptedError):
            _run(tmp_path)
    assert latest_step(str(tmp_path)) == 7
    # resume must go through the corrupt step 6 and fall back to step 3
    shutil.rmtree(str(tmp_path / "step_7"))
    assert _bits(_run(tmp_path)) == baseline[0]


def test_recover_preempt_sigterm(tmp_path, baseline):
    from easydist_tpu_torch.resilience import PreemptedError, fault_plan
    from easydist_tpu_torch.runtime.checkpoint import (checkpoint_meta,
                                                       latest_step)

    with fault_plan("preempt.sigterm@5"):
        with pytest.raises(PreemptedError) as ei:
            _run(tmp_path)
    step = ei.value.step
    assert latest_step(str(tmp_path)) == step
    meta = checkpoint_meta(str(tmp_path), step)
    assert meta["preempted"] is True and meta["batches_consumed"] == step
    losses = []
    assert _bits(_run(tmp_path, losses)) == baseline[0]
    # no batch drawn twice: the resumed losses are the clean run's tail
    assert losses == baseline[1][step:]


def test_recover_data_stall(tmp_path, baseline):
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.runtime.checkpoint import latest_step
    from easydist_tpu_torch.runtime.elastic import DataStallError

    with fault_plan("data.stall@5"):
        with pytest.raises(DataStallError):
            _run(tmp_path, data_timeout_s=0.2)
    assert latest_step(str(tmp_path)) == 3
    assert _bits(_run(tmp_path, data_timeout_s=0.2)) == baseline[0]


def test_recover_restore_chunk_corrupt(tmp_path, baseline):
    from easydist_tpu_torch.resilience import PreemptedError, fault_plan

    with fault_plan("preempt.sigterm@5"):
        with pytest.raises(PreemptedError):
            _run(tmp_path)
    # the newest (step 4) is found corrupt at restore: resume from step 3
    with fault_plan("elastic.restore.chunk_corrupt@1"):
        assert _bits(_run(tmp_path)) == baseline[0]


def test_recover_step_nan_grad(tmp_path):
    from easydist_tpu_torch.resilience import fault_plan
    from easydist_tpu_torch.runtime.checkpoint import checkpoint_meta

    with fault_plan("step.nan_grad@4"):
        final_a = _run(tmp_path / "a", step_guard=True)
    with fault_plan("step.nan_grad@4"):
        final_b = _run(tmp_path / "b", step_guard=True)
    assert torch.isfinite(final_a).all()
    assert _bits(final_a) == _bits(final_b)
    guard = checkpoint_meta(str(tmp_path / "a"), TOTAL)["guard"]
    assert guard["skips"] == 1 and guard["steps"] == TOTAL


def test_run_training_defaults_to_the_card(tmp_path):
    from easydist_tpu_torch.runtime.elastic import to_device

    batch = _batch(0)
    assert to_device(batch, torch.device("cpu"))[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            _run_default(tmp_path)


def _run_default(tmp_path):
    from easydist_tpu_torch.runtime.elastic import run_training

    return run_training(_tstep, lambda: torch.zeros(4, 2), Loader(),
                        str(tmp_path), 1)


# ------------------------------------------------------------- the loader

@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens.bin")
    np.random.RandomState(7).randint(0, 50257, size=1 << 16).astype(
        np.uint16).tofile(path)
    return path


@pytest.mark.parametrize("seed,skip", [(0, 0), (3, 5)])
def test_token_loader_matches_jax(token_file, seed, skip):
    from easydist_tpu.runtime.data import TokenLoader as JLoader
    from easydist_tpu_torch.runtime.data import TokenLoader

    jl = JLoader(token_file, batch=4, seq=64, seed=seed)
    tl = TokenLoader(token_file, batch=4, seq=64, seed=seed)
    try:
        assert jl._handle is not None and tl.native  # both native
        assert tl.n_tokens == jl.n_tokens == 1 << 16
        jl.skip(skip)
        tl.skip(skip)
        for _ in range(3):
            a, b = tl.next_batch(), jl.next_batch()
            assert a.dtype == np.int32 and a.shape == (4, 65)
            assert np.array_equal(a, b)
        assert tl.batches_consumed == jl.batches_consumed == skip + 3
        x, y = next(iter(tl))
        assert np.array_equal(x[:, 1:], y[:, :-1])
    finally:
        jl.close()
        tl.close()
