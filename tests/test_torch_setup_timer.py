"""The port's package entry points and timer: `easydist_setup` (logging,
the platform backend, TF32 flags only when asked, a process group only
when the environment names a multi-process job), the package-level
`easydist_compile`, and `utils.timer` (`host_sync`, `two_point_time`,
`EDTimer`) against the JAX package's contract on the CPU."""

import time

import pytest
import torch

import easydist_tpu_torch as edt
from easydist_tpu_torch.utils import timer


@pytest.fixture
def tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def test_setup_leaves_tf32_alone_unless_asked(tf32_flags, monkeypatch):
    import torch.distributed as dist

    from easydist_tpu_torch import platform

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    edt.easydist_setup(device="cpu")
    assert platform.get_backend() == "torch"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not dist.is_initialized()
    edt.easydist_setup(device="cpu", allow_tf32=True)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    edt.easydist_setup(device="cpu", allow_tf32=False)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_setup_joins_the_job_the_environment_names(monkeypatch, tmp_path):
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", "1")
    edt.easydist_setup(device="cpu")
    assert not dist.is_initialized()          # one process: no group
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    edt.easydist_setup(device="cpu")
    assert not dist.is_initialized()          # no rendezvous named


def test_setup_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edt.easydist_setup()


def test_package_compile_dispatches_to_fxfront():
    from easydist_tpu_torch.fxfront.api import CompiledFunction

    step = edt.easydist_compile(lambda w, x: torch.tanh(x @ w).sum())
    assert isinstance(step, CompiledFunction)
    w, x = torch.ones(4, 2), torch.ones(3, 4)
    assert torch.equal(step(w, x), torch.tanh(x @ w).sum())

    @edt.easydist_compile(donate_state=False)
    def add(a):
        return a + 1

    assert isinstance(add, CompiledFunction)
    assert torch.equal(add(torch.zeros(2)), torch.ones(2))


def test_two_point_time_cancels_the_fixed_cost():
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.002)
        return torch.ones(2)

    per = timer.two_point_time(fn, n1=2, n2=6)
    assert 0.0015 < per < 0.05
    assert len(calls) == 2 + 2 + 6          # warm-up, then n1 and n2
    t = timer.EDTimer(fn, trials=8)
    assert 0.0015 < t.time() < 0.05
    timer.host_sync({"a": torch.ones(3), "b": None})
    timer.host_sync(None)
