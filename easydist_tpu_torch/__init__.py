"""easydist_tpu_torch: the PyTorch/CUDA port of easydist_tpu.

The port stands beside the JAX package and imports nothing of it (nor
JAX).  It carries GPT-2 serving (`serve.GenerationSession` over
`models.gpt`, bucketed or paged KV, exact or int8 pages) and GPT-2
training (`models.gpt.make_gpt_train_step`), compiled by
`fxfront.easydist_compile` (one device), with every attention kernel
hand-written in CUDA C++ (`ops/csrc/`).

Entry points run on the card unless the caller asks for another device:
`resolve_device(None)` is `cuda`, and it raises when no card is present
instead of carrying on on the CPU.  `easydist_setup` and
`easydist_compile` are the package's user surface (reference
easydist/__init__.py:21, the JAX package's `easydist_tpu/__init__.py`).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a dtype name ("float32", "bfloat16", ...)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype name: {name!r}")
    return dt


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless `device` names
    another.  Raises when the card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return dev


def easydist_setup(backend: str = "torch", device: str = "cuda",
                   allow_tf32=None) -> None:
    """Initialise the framework: logging at `config.log_level`, the
    platform backend (`platform.init_backend`), and `torch.distributed`
    when the environment names a multi-process job (WORLD_SIZE above 1
    with MASTER_ADDR, as `torchrun` sets them; NCCL on `device="cuda"`,
    gloo on the CPU).  `device="cuda"` needs a card.

    `allow_tf32` sets `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` only when it is passed: the port's
    float32 numerics keep TF32 off unless the caller turns it on (the
    JAX package's default is True, which on a TPU has no TF32 to
    change)."""
    import logging
    import os

    from . import config

    logging.basicConfig(level=config.log_level)
    from .platform import init_backend

    init_backend(backend)
    dev = resolve_device(device)
    if allow_tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(allow_tf32)
        torch.backends.cudnn.allow_tf32 = bool(allow_tf32)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and "MASTER_ADDR" in os.environ:
        import torch.distributed as dist

        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                rank=int(os.environ["RANK"]), world_size=world)


def easydist_compile(func=None, **kwargs):
    """Decorator entry point; dispatches to the FX frontend
    (`fxfront.easydist_compile`)."""
    from .fxfront.api import easydist_compile as _fx_compile

    return _fx_compile(func, **kwargs)
