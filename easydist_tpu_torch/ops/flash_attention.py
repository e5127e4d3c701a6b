"""Attention on the serving path: the decode kernel's wrapper, the plain
PyTorch versions beside it, and the dispatchers the models call.

Port of the serving half of easydist_tpu/ops/flash_attention.py.  The
TPU's Pallas decode kernel `_flash_decode_kernel` becomes the CUDA
kernel `csrc/flash_decode.cu` (see its header for the design and its
bound), bound through `ctypes` and registered as the custom op
`easydist_tpu_torch::flash_decode`, so `make_fx` keeps it as one node.

`_decode_attention_xla` and `_chunk_attention_xla` keep the JAX
package's names: they are the plain versions of the same functions (the
masked einsum the JAX package leaves to XLA).  The CPU runs them; on the
card the decode dispatcher launches the kernel, and the chunked-prefill
path stays plain PyTorch as it stays XLA in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from easydist_tpu_torch import config as edconfig

_NEG_INF = -1e30

# dynamic shared memory a decode tile may take (the card allows 227 KB a
# block; a margin is left for the kernel's static arrays)
_TILE_SMEM_LIMIT = 200 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _pick_block(block: int, t: int) -> int:
    b = min(block, t)
    while t % b:
        b //= 2
    return max(b, 1)


# ------------------------------------------------- single-query decode


def _decode_lib():
    from ._build import load

    lib = load("flash_decode")
    fn = lib.flash_decode
    if fn.argtypes is None:  # first load: declare the C signatures
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _decode_tile(block_k: int, t_k: int, d: int, itemsize: int) -> int:
    """Keys per tile: `_pick_block`'s divisor of the cache length, halved
    until a K tile, a V tile and the tile's scores fit `_TILE_SMEM_LIMIT`."""
    bk = _pick_block(block_k, t_k)
    while bk > 1 and 2 * bk * d * itemsize + 4 * bk > _TILE_SMEM_LIMIT:
        bk //= 2
    return bk


@torch.library.custom_op("easydist_tpu_torch::flash_decode", mutates_args=())
def _flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float,
                     block_k: int) -> torch.Tensor:
    if not (q.is_cuda and k.is_cuda and v.is_cuda and lengths.is_cuda):
        raise RuntimeError("flash_decode runs on CUDA tensors only")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_decode takes float32/bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, h, d = q.shape
    t_k = k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_decode takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [{b}, {h}, T, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    q = q.contiguous()
    k = k.contiguous()
    v = v.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode needs 16-byte aligned k and v")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    tile = _decode_tile(block_k, t_k, d, k.element_size())
    lib = _decode_lib()
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, t_k, d, tile, float(scale),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_decode launch failed: "
            f"{lib.flash_decode_error_string(err).decode()} (cudaError {err})")
    flash_decode_attention.launches += 1
    return out


@_flash_decode_op.register_fake
def _(q, k, v, lengths, scale, block_k):
    return q.new_empty(q.shape)


def flash_decode_attention(q, k, v, lengths, scale: Optional[float] = None,
                           block_k: Optional[int] = None):
    """Single-query attention against a KV cache, in the CUDA kernel.

    q: [batch, heads, head_dim] — one query per sequence; k, v: [batch,
    heads, max_len, head_dim] cache buffers; lengths: int32 [batch] valid
    prefix length per row (positions >= length are masked).  Returns
    [batch, heads, head_dim] in q's dtype.  CUDA tensors only: a CPU
    tensor raises (the plain version is `_decode_attention_xla`).

    `flash_decode_attention.launches` counts kernel launches; it grows
    where the kernel runs, never while a graph is traced."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if block_k is None:
        block_k = edconfig.decode_block_k
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_decode_attention needs CUDA tensors, got {q.device}; "
            f"the CPU runs the plain version (backend 'auto' or 'xla')")
    return _flash_decode_op(q, k, v, lengths, float(scale), int(block_k))


flash_decode_attention.launches = 0


def _decode_attention_xla(q, k, v, lengths, scale: float):
    """Plain PyTorch decode attention: masked einsum with -1e30 fill and a
    softmax over the full cache length — the CPU path, and the version
    the kernel is held against.  A row of length 0 gets mean(v), as the
    JAX package's XLA path does."""
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    k_pos = torch.arange(s.shape[2], device=s.device)
    s = torch.where(k_pos[None, None, :]
                    < lengths.to(torch.int32)[:, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, v.float()).to(q.dtype)


def decode_attention(q, k, v, lengths, scale: Optional[float] = None,
                     backend: Optional[str] = None):
    """Backend-dispatching decode attention (the models' decode steps call
    this).  "auto" launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; `EASYDIST_DECODE_ATTENTION` forces
    "flash" (the kernel — raises on a CPU tensor) or "xla" (the plain
    version — raises on a CUDA tensor, which always runs the kernel)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if lengths.ndim == 0:
        lengths = lengths.expand(q.shape[0])
    if backend is None:
        backend = edconfig.decode_attention_backend
    if backend == "auto":
        backend = "flash" if q.device.type == "cuda" else "xla"
    if backend == "flash":
        return flash_decode_attention(q, k, v, lengths, scale=scale)
    if backend == "xla":
        if q.device.type == "cuda":
            raise RuntimeError(
                "decode attention backend 'xla' (the plain version) runs on "
                "CPU tensors only; CUDA tensors launch the kernel (backend "
                "'auto' or 'flash')")
        return _decode_attention_xla(q, k, v, lengths, scale)
    raise ValueError(f"unknown decode attention backend {backend!r}; "
                     f"expected auto|flash|xla")


# ------------------------------------------------- chunked prefill


def _chunk_attention_xla(q, k, v, q_pos, scale: float):
    """Masked einsum chunked-prefill attention: q [b, h, c, hd] at absolute
    positions `q_pos` (int32 [b, c]) attends the full cache window k/v
    [b, h, T, hd].  A key at position kp is visible iff kp <= q_pos: the
    causal mask within the chunk and the validity mask over the cache
    tail at once (stale rows past a row's live length sit at positions
    > q_pos, so their softmax weight underflows to exactly 0)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    k_pos = torch.arange(s.shape[3], device=s.device)
    s = torch.where(k_pos[None, None, None, :]
                    <= q_pos.to(torch.int32)[:, None, :, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def chunk_attention(q, k, v, q_pos, scale: Optional[float] = None,
                    backend: Optional[str] = None):
    """Backend-dispatching chunked-prefill attention (the models'
    `*_prefill_chunk` call this): q is a fixed-size token chunk at
    absolute positions `q_pos`, k/v the full bucket-length cache.
    `EASYDIST_PREFILL_ATTENTION` names the backend; "auto" and "xla" both
    resolve to the plain masked einsum."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if backend is None:
        backend = edconfig.prefill_attention_backend
    if backend in ("auto", "xla"):
        return _chunk_attention_xla(q, k, v, q_pos, scale)
    raise ValueError(f"unknown prefill attention backend {backend!r}; "
                     f"expected auto|xla")
