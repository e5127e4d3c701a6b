"""Flat env-var-driven knobs of the port (the subset of
easydist_tpu/config.py that the serving path reads).

Every knob is a module global, read from its environment variable at
import time and mutable at runtime.  Imported as `edconfig`.
"""

import os


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


# attention backend of the cache-carrying decode steps: "auto" (the CUDA
# kernel for CUDA tensors, the plain PyTorch version for CPU tensors),
# "flash" / "paged" (force the kernel; raises on a CPU tensor — "paged"
# names the page-table kernels, and the contiguous path treats it as
# "auto"), "xla" (force the plain version — named after the JAX package's
# masked dot_general path; raises on a CUDA tensor, so the card always
# runs the kernel).
decode_attention_backend = os.environ.get("EASYDIST_DECODE_ATTENTION",
                                          "auto")
# keys one online-softmax step of the decode kernel takes: B4's split of a
# row, halved while a split would not fit shared memory.
decode_block_k = _env_int("EASYDIST_DECODE_BLOCK_K", 256)
# attention backend of the chunked-prefill pass: "auto" | "xla" — both
# resolve to the plain PyTorch masked einsum.
prefill_attention_backend = os.environ.get("EASYDIST_PREFILL_ATTENTION",
                                           "auto")
