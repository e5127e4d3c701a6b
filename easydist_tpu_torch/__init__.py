"""easydist_tpu_torch: the PyTorch/CUDA port of easydist_tpu.

The port stands beside the JAX package and imports nothing of it (nor
JAX).  It carries GPT-2 serving (`serve.GenerationSession` over
`models.gpt`, bucketed or paged KV, exact or int8 pages) and GPT-2
training (`models.gpt.make_gpt_train_step`), compiled by
`fxfront.easydist_compile` (one device), with every attention kernel
hand-written in CUDA C++ (`ops/csrc/`).

Entry points run on the card unless the caller asks for another device:
`resolve_device(None)` is `cuda`, and it raises when no card is present
instead of carrying on on the CPU.
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
