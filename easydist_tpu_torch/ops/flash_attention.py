"""Attention kernels' wrappers, the plain PyTorch versions beside them,
and the dispatchers the models call.

Port of easydist_tpu/ops/flash_attention.py, serving and training:

  * training (`flash_attention_lse` / `flash_attention`): the TPU's
    forward `_flash_kernel` and the FlashAttention-2 backward pair
    `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` become the CUDA
    kernels `csrc/flash_attn_fwd.cu` and `csrc/flash_attn_bwd.cu`,
    registered as the custom ops `easydist_tpu_torch::flash_fwd`,
    `::flash_bwd_dq` and `::flash_bwd_dkv`, the forward differentiable
    in both outputs through `register_autograd`.  On bfloat16 the three
    kernels run on the tensor cores (`wgmma` fed by a TMA ring,
    `csrc/flash_attn_sm90.cuh`); on float32 they run on the tensor cores
    too, each product of the function as three TF32 products of hi/lo
    halves;
  * serving: the decode kernel `_flash_decode_kernel` becomes
    `csrc/flash_decode.cu`, the custom op `easydist_tpu_torch::flash_decode`;
    the paged decode kernels `_flash_paged_decode_kernel` (exact pages)
    and `_flash_paged_decode_quant_kernel` (block-scaled int8 pages)
    become `csrc/paged_decode.cu`, the custom ops
    `easydist_tpu_torch::paged_decode` and `::paged_decode_quant`.  The
    three are one split-K design (`csrc/decode_split.cuh`): each row's
    keys in splits, one block a split, merged inside the same launch.

Every kernel is bound through `ctypes` (see each source's header for its
design and bound), and `make_fx` keeps each custom op as one node.  The
custom ops run their plain version on CPU tensors and their kernel on
CUDA tensors (the decode op takes CUDA tensors only); the public
`flash_*decode*` functions raise on a CPU tensor, and the dispatchers
pick the plain version for the CPU.

`_flash_forward_xla`, `_flash_backward_xla`, `_decode_attention_xla`,
`_paged_decode_attention[_quant]_xla` and `_chunk_attention_xla` keep the
JAX package's names: they are the plain versions of the same functions
(the masked einsum the JAX package leaves to XLA).  The chunked-prefill
path, `gather_pages` and `kv_quantize`/`kv_dequantize` stay plain
PyTorch, as they stay XLA in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from easydist_tpu_torch import config as edconfig

_NEG_INF = -1e30

# dynamic shared memory a decode split may take (the card allows 227 KB a
# block; a margin is left for the kernel's static arrays)
_TILE_SMEM_LIMIT = 200 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Every kernel takes every head_dim from 1 to _MAX_HEAD_DIM.  64 and 128
# run B1-B3 on the tensor cores and B4-B6 on the decode body's exact
# width; every other head_dim runs B1-B3's SIMT kernels
# (csrc/flash_attn_simt.cuh) and B4-B6's padded body
# (csrc/decode_split.cuh, "Head dims").  Above the limit they raise.
_TENSOR_CORE_DIMS = (64, 128)
_MAX_HEAD_DIM = 256


def _check_head_dim(op: str, d: int) -> None:
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"{op} takes head_dim 1..{_MAX_HEAD_DIM} (64 and "
                         f"128 on the tensor cores), got {d}")


def _pow2_at_least(d: int, floor: int) -> int:
    return max(floor, 1 << (d - 1).bit_length())


def _decode_width(d: int) -> int:
    """The width D of the decode body a head_dim runs on: d itself at 64
    and 128, else the next of 64, 128, 256 (the padded body's shared rows
    hold D elements a key)."""
    return d if d in _TENSOR_CORE_DIMS else _pow2_at_least(d, 64)


def _check_launch(lib, prefix: str, err: int):
    if err:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{prefix} launch failed: {msg} (cudaError {err})")


def _require_cuda(fn: str, q) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(
            f"{fn} needs CUDA tensors, got {q.device}; the CPU runs the "
            f"plain version (backend 'auto' or 'xla')")


# ------------------------------------- training attention (B1, B2, B3)


def _causal_fill(s):
    """Scores [..., t_q, t_k] with keys past the query filled with -1e30
    (positions aligned at 0, as the TPU kernels' `_causal_mask`)."""
    t_q, t_k = s.shape[-2], s.shape[-1]
    visible = (torch.arange(t_k, device=s.device)[None, :]
               <= torch.arange(t_q, device=s.device)[:, None])
    return torch.where(visible, s, _NEG_INF)


def _masked_scores(q, k, causal: bool, scale: float):
    """f32 scores (q * scale) . k [b, h, t_q, t_k], causally filled."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    return _causal_fill(s) if causal else s


def _reference_attention(q, k, v, causal: bool, scale: float):
    """Plain softmax attention in f32, output in q's dtype: the yardstick
    of the flash path's gradients."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = _causal_fill(s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _flash_forward_xla(q, k, v, causal: bool, scale: float):
    """Plain version of B1: (out [b, h, t_q, d] in q's dtype, lse
    [b*h, t_q] f32), with the kernel's -1e30 fill, 1e-30 denominator
    clamp and lse = m + log(l)."""
    b, h, t_q, _ = q.shape
    s = _masked_scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe)).reshape(b * h, t_q)
    return out.to(q.dtype), lse


def _flash_delta(o, do, g_lse=None):
    """delta = rowsum(dO * O) - g_lse, f32 [b*h, t_q]: the row term of
    the backward, plain torch as it stays XLA in the JAX package.  An lse
    cotangent folds in with the opposite sign; None and zeros both mean
    the lse output was unused."""
    b, h, t_q, _ = o.shape
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b * h, t_q)
    if g_lse is not None:
        delta = delta - g_lse.reshape(b * h, t_q).float()
    return delta


def _bwd_p_ds(q, k, v, do, lse, delta, causal: bool, scale: float):
    """P = exp(S - lse) recomputed from the saved lse, and dS = P * (dO.V^T
    - delta), both f32 [b, h, t_q, t_k]."""
    b, h, t_q, _ = q.shape
    p = torch.exp(_masked_scores(q, k, causal, scale)
                  - lse.reshape(b, h, t_q, 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.reshape(b, h, t_q, 1))


def _flash_bwd_dq_xla(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of B2: dQ = dS.K * scale, in q's dtype."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(
        q.dtype)


def _flash_bwd_dkv_xla(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of B3: (dK = dS^T.Q * scale, dV = P^T.dO), in k's and
    v's dtypes."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward_xla(q, k, v, o, lse, do, causal: bool, scale: float,
                        g_lse=None):
    """Plain FlashAttention-2 backward of `flash_attention_lse`: (dq, dk,
    dv) from the saved out and lse and the cotangents of both."""
    delta = _flash_delta(o, do, g_lse)
    dq = _flash_bwd_dq_xla(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _flash_bwd_dkv_xla(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# per library: its C functions and how many pointers lead their arguments
# (then bh, t_q, t_k, head_dim, causal, scale, dtype, stream)
_TRAIN_FNS = {"flash_attn_fwd": {"flash_attn_fwd": 5},
              "flash_attn_bwd": {"flash_attn_bwd_dq": 7,
                                 "flash_attn_bwd_dkv": 8}}


def _train_lib(name: str):
    from ._build import load

    lib = load(name)
    fns = _TRAIN_FNS[name]
    if getattr(lib, next(iter(fns))).argtypes is None:  # first load
        tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        for fn, n_ptr in fns.items():
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * n_ptr + tail
            getattr(lib, fn).restype = ctypes.c_int
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return lib


def _check_train_inputs(op: str, q, k, v, *rows):
    """Validate CUDA inputs of a training kernel; returns (b, h, t_q,
    t_k, d) and the inputs made contiguous (q, k, v in one dtype; the
    row tensors lse/delta f32 [b*h, t_q])."""
    if not all(x.is_cuda for x in (q, k, v, *rows)):
        raise RuntimeError(f"{op} runs its kernel on CUDA tensors and its "
                           f"plain version on CPU tensors; got "
                           f"{[str(x.device) for x in (q, k, v, *rows)]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} takes float32/bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    _check_head_dim(op, d)
    if k.shape != (b, h, t_k, d) or v.shape != k.shape or t_k < 1:
        raise ValueError(f"k/v must be [{b}, {h}, T >= 1, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for x in rows:
        if x.shape != (b * h, t_q) or x.dtype != torch.float32:
            raise ValueError(f"lse/delta must be float32 [{b * h}, {t_q}], "
                             f"got {x.dtype} {tuple(x.shape)}")
    out = [x.contiguous() for x in (q, k, v, *rows)]
    _check_aligned(op, *out[:3])
    return (b, h, t_q, t_k, d), out


def _check_aligned(op: str, *tensors) -> None:
    """The tensor-core kernels (head_dim 64 and 128) read q, k, v and dO
    through TMA tensor maps or with 16-byte loads, both of which need a
    16-byte aligned base: raise on any other, rather than copy.  The SIMT
    kernels read elements and take any base."""
    if tensors[0].shape[-1] not in _TENSOR_CORE_DIMS:
        return
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{op} needs 16-byte aligned q, k, v and dO; "
                             f"got a base at {x.data_ptr():#x}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


@torch.library.custom_op("easydist_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return _flash_forward_xla(q, k, v, causal, scale)
    (b, h, t_q, t_k, d), (q, k, v) = _check_train_inputs("flash_fwd", q, k,
                                                         v)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    lib = _train_lib("flash_attn_fwd")
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b * h, t_q, t_k, d, int(causal), float(scale),
        _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(lib, "flash_attn_fwd", err)
    flash_fwd.launches += 1
    return out, lse


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale):
    b, h, t_q, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b * h, t_q), dtype=torch.float32))


@torch.library.custom_op("easydist_tpu_torch::flash_bwd_dq", mutates_args=())
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                     causal: bool, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return _flash_bwd_dq_xla(q, k, v, do, lse, delta, causal, scale)
    (b, h, t_q, t_k, d), (q, k, v, lse, delta) = _check_train_inputs(
        "flash_bwd_dq", q, k, v, lse, delta)
    do = do.to(q.dtype).contiguous()
    _check_aligned("flash_bwd_dq", do)
    dq = torch.empty_like(q)
    lib = _train_lib("flash_attn_bwd")
    err = lib.flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, t_q, t_k, d,
        int(causal), float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(lib, "flash_attn_bwd", err)
    flash_bwd_dq.launches += 1
    return dq


@_flash_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, causal, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("easydist_tpu_torch::flash_bwd_dkv",
                         mutates_args=())
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool, scale: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return _flash_bwd_dkv_xla(q, k, v, do, lse, delta, causal, scale)
    (b, h, t_q, t_k, d), (q, k, v, lse, delta) = _check_train_inputs(
        "flash_bwd_dkv", q, k, v, lse, delta)
    do = do.to(q.dtype).contiguous()
    _check_aligned("flash_bwd_dkv", do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _train_lib("flash_attn_bwd")
    err = lib.flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, t_q, t_k, d, int(causal), float(scale),
        _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(lib, "flash_attn_bwd", err)
    flash_bwd_dkv.launches += 1
    return dk, dv


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, delta, causal, scale):
    return k.new_empty(k.shape), v.new_empty(v.shape)


def flash_fwd(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """B1: (out, lse) of causal or full attention; q [b, h, t_q, d], k/v
    [b, h, t_k, d] in float32 or bfloat16, d from 1 to 256.  CPU tensors
    run `_flash_forward_xla`; CUDA tensors launch `csrc/flash_attn_fwd.cu`
    (at d 64 and 128 both dtypes on the tensor cores, float32 as three
    TF32 products of hi/lo halves; every other d on the SIMT kernel).
    `flash_fwd.launches` counts kernel launches (never a trace)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _flash_fwd_op(q, k, v, bool(causal), float(scale))


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 scale: Optional[float] = None):
    """B2: dQ from the saved lse and delta (`_flash_delta`).  CPU tensors
    run `_flash_bwd_dq_xla`; CUDA tensors launch the dQ kernel of
    `csrc/flash_attn_bwd.cu` (at d 64 and 128 both dtypes on the tensor
    cores, float32 as three TF32 products of hi/lo halves for each of S,
    dP and dQ; every other d on the SIMT kernel)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _flash_bwd_dq_op(q, k, v, do, lse, delta, bool(causal),
                            float(scale))


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  scale: Optional[float] = None):
    """B3: (dK, dV) from the saved lse and delta.  CPU tensors run
    `_flash_bwd_dkv_xla`; CUDA tensors launch the dK/dV kernel of
    `csrc/flash_attn_bwd.cu` (at d 64 and 128 both dtypes on the tensor
    cores, float32 as three TF32 products of hi/lo halves for each of
    S^T, dP^T, dV and dK; every other d on the SIMT kernel)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _flash_bwd_dkv_op(q, k, v, do, lse, delta, bool(causal),
                             float(scale))


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale


def _fwd_backward(ctx, g_out, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    delta = _flash_delta(out, g_out, g_lse)
    dq = _flash_bwd_dq_op(q, k, v, g_out, lse, delta, ctx.causal, ctx.scale)
    dk, dv = _flash_bwd_dkv_op(q, k, v, g_out, lse, delta, ctx.causal,
                               ctx.scale)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup_context)


def flash_attention_lse(q, k, v, causal: bool = True,
                        scale: Optional[float] = None, block_q: int = 256,
                        block_k: int = 256):
    """Like `flash_attention` but also returns the per-row logsumexp
    [batch*heads, seq] (f32), differentiable in BOTH outputs: the
    backward folds the lse cotangent into delta and runs B2 and B3.

    `block_q`/`block_k` are tile hints kept for the JAX signature: the
    kernels pick their own tiles and compute the same function for any."""
    del block_q, block_k
    # contiguous here, so the tensors autograd saves need no copy in the
    # backward's kernels
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                     scale)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, block_q: int = 256,
                    block_k: int = 256):
    """q, k, v: [batch, heads, seq, head_dim] -> out of q's shape and
    dtype; the CUDA kernels on CUDA tensors, the plain versions on CPU
    tensors."""
    out, _ = flash_attention_lse(q, k, v, causal, scale, block_q, block_k)
    return out


# ------------------------------- shared memory of B1-B3 (long context)

# Each route's tile constants, as the C++ structs hold them
# (csrc/flash_attn_fwd.cu FwdSm90 / FwdTf32, csrc/flash_attn_bwd.cu
# DqSm90 / DqTf32 / DkvSm90 / DkvTf32, csrc/flash_attn_simt.cuh Cfg): the
# dynamic shared memory each launch passes.  None depends on t_q or t_k:
# every kernel blocks over the sequence with tiles of fixed size.  The
# card holds this table equal to what each launch asks for
# (`_launch_smem_bytes`).
_SIMT_TILE = 32


def _tensor_core_smem(kernel: str, d: int, f32: bool) -> int:
    if kernel == "fwd" and not f32:
        bq, bk, st = 128, 128 if d == 64 else 64, 2
        return 1024 + bq * d * 2 + 2 * st * bk * d * 2 + 8 * (1 + 2 * st)
    if kernel == "fwd":
        wg, bk = (2 if d == 64 else 1), 32
        raw, conv = (2, 4) if d == 64 else (1, 2)
        tile = bk * d * 4
        q_bytes = 0 if d == 64 else 2 * 64 * wg * d * 4
        return (1024 + q_bytes + raw * 2 * tile + conv * 4 * tile
                + 16 * (raw + conv))
    if kernel == "dq" and not f32:
        bq, bk, st = 128, 64, 2
        return (1024 + 2 * bq * d * 2 + 2 * st * bk * d * 2
                + 8 * (1 + 2 * st))
    if kernel == "dq":
        wg, bk, st = (2, 32, 3) if d == 64 else (1, 32, 1)
        half = 64 * wg * d * 4
        res = (2 if d == 64 else 4) * half
        return 1024 + res + st * 6 * bk * d * 4 + 24 * st
    if not f32:  # dkv
        bk, bq, st = 128, 64 if d == 64 else 32, 2
        return (1024 + 2 * bk * d * 2 + st * (2 * bq * d * 2 + 2 * bq * 4)
                + 8 * (1 + 2 * st))
    bk, bq, st = 64, (32 if d == 64 else 16), (2 if d == 64 else 1)
    stage = 4 * bq * d * 4 + 4 * d * 128
    return (1024 + 4 * bk * d * 4 + st * (stage + 2 * bq * 4)
            + 8 * (2 + 3 * st))


def _simt_smem(kernel: str, d: int) -> int:
    width = _pow2_at_least(d, 32)
    tiles = 2 * _SIMT_TILE * width * 4  # K and V, or Q and dO, as f32
    return tiles + (2 * _SIMT_TILE * 4 if kernel == "dkv" else 0)


def _route_smem(kernel: str, d: int, dtype) -> int:
    """Dynamic shared memory of one launch of B1 ("fwd"), B2 ("dq") or B3
    ("dkv") at head_dim d on the route the dispatch picks (the kernels
    keep no static shared memory)."""
    if d in _TENSOR_CORE_DIMS:
        return _tensor_core_smem(kernel, d, dtype == torch.float32)
    return _simt_smem(kernel, d)


def estimate_smem_bytes(t_q: int, t_k: int, d: int, dtype) -> int:
    """The largest per-block shared memory, static plus dynamic, that
    B1, B2 and B3 take at [t_q, t_k] x head_dim d in `dtype` (float32 or
    bfloat16) on the route the dispatch picks: the counterpart of the JAX
    package's `estimate_vmem_bytes` (per-program VMEM of its Pallas
    kernels).  Plain Python, from the routes' tile constants: every
    kernel blocks over the sequence and keeps the head_dim whole, so the
    value does not grow with t_q or t_k, and it stays under the card's
    opt-in maximum of 232448 bytes a block for every d from 1 to 256."""
    del t_q, t_k  # tiles are fixed: the long-context guarantee
    _check_head_dim("estimate_smem_bytes", d)
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"estimate_smem_bytes takes float32 or bfloat16, "
                        f"got {dtype}")
    return max(_route_smem(k, d, dtype) for k in ("fwd", "dq", "dkv"))


def _launch_smem_bytes(d: int, dtype) -> dict:
    """{"fwd" | "dq" | "dkv": (static, dynamic)} bytes of shared memory
    each kernel's launch at head_dim d in `dtype` takes on the card, from
    the kernels themselves (`cudaFuncGetAttributes` and the size each
    launch passes).  Needs the built libraries and a card."""
    out = {}
    code = _DTYPE_CODES[dtype]
    st, dy = ctypes.c_int(), ctypes.c_int()
    for lib_name, fn, args in (("flash_attn_fwd", "flash_attn_fwd_smem",
                                (("fwd", ()),)),
                               ("flash_attn_bwd", "flash_attn_bwd_smem",
                                (("dq", (0,)), ("dkv", (1,))))):
        lib = _train_lib(lib_name)
        c_fn = getattr(lib, fn)
        for kernel, lead in args:
            err = c_fn(*lead, d, code, ctypes.byref(st), ctypes.byref(dy))
            _check_launch(lib, lib_name, err)
            out[kernel] = (st.value, dy.value)
    return out


# ------------------------------- split-K decode state (B4, B5, B6)

# The three decode kernels' per-row arrival counters by (device, stream).
# A launch leaves every counter it used at 0 again (the row's last block
# resets it), so a buffer is zeroed once, when it is made, and B4, B5 and
# B6 share it: launches on one stream run in order, so no two use it at
# once. One per stream keeps launches on different streams from sharing
# counters. A CUDA graph that captures a decode kernel needs the buffer
# made (a launch) before the capture.
_SPLIT_COUNTERS: dict = {}


def _split_counters(device, rows: int):
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _SPLIT_COUNTERS.get(key)
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(rows, dtype=torch.int32, device=device)
        _SPLIT_COUNTERS[key] = buf
    return buf


def _split_work(q, rows: int, n_splits: int, d: int):
    """The f32 workspace of a split launch's partials: (m, l, acc) for
    every row and split, allocated each call."""
    return torch.empty(rows * n_splits * (d + 2), dtype=torch.float32,
                       device=q.device)


# ------------------------------------------------- single-query decode


def _decode_lib():
    from ._build import load

    lib = load("flash_decode")
    fn = lib.flash_decode
    if fn.argtypes is None:  # first load: declare the C signatures
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _decode_split_tokens(block_k: int, d: int, itemsize: int) -> int:
    """Tokens per split of a B4 row: `block_k` (how many keys one
    online-softmax step takes, as in the JAX API), halved until a split's
    K and V (`itemsize` bytes an element, rows of the body's width
    `_decode_width(d)`) and scores fit `_TILE_SMEM_LIMIT` (a bound on the
    kernel's `split_smem`).  No divisor of the cache length is needed: a
    row's last split may be partial."""
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    width = _decode_width(d)
    tokens = block_k
    while tokens > 1 and \
            tokens * (2 * width * itemsize + 4) > _TILE_SMEM_LIMIT:
        tokens //= 2
    return tokens


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
    _check_head_dim("flash_decode", d)
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [{b}, {h}, T, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    q = q.contiguous()
    k = k.contiguous()
    v = v.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    if d in _TENSOR_CORE_DIMS and (k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("flash_decode needs 16-byte aligned k and v at "
                         "head_dim 64 and 128")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    chunk = _decode_split_tokens(block_k, d, k.element_size())
    work = _split_work(q, b * h, max(1, -(-t_k // chunk)), d)
    lib = _decode_lib()
    err = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), work.data_ptr(),
        _split_counters(q.device, b * h).data_ptr(), b, h, t_k, d, chunk,
        float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(lib, "flash_decode", err)
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
    prefix length per row (positions >= length are masked).  The kernel
    splits each row's keys across blocks (`_decode_split_tokens` of
    `block_k`) and merges the splits' partials in a fixed order inside the
    same launch, as B5 and B6 do.  Returns [batch, heads, head_dim] in q's
    dtype.  CUDA tensors only: a CPU tensor raises (the plain version is
    `_decode_attention_xla`, which gives mean(v) where the kernel gives 0
    for a row of length 0).

    `flash_decode_attention.launches` counts kernel launches; it grows
    where the kernel runs, never while a graph is traced."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if block_k is None:
        block_k = edconfig.decode_block_k
    _require_cuda("flash_decode_attention", q)
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
    if backend == "paged":
        # "paged" selects the page-table kernel in paged_decode_attention;
        # contiguous callers degrade to auto (there is no table to chase)
        backend = "auto"
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
                     f"expected auto|flash|xla|paged")


# ------------------------------------------------- paged decode (B5, B6)


def gather_pages(pages, table, n_heads: Optional[int] = None):
    """The contiguous "virtual cache" a page table describes.

    pages: [n_pages, kv_heads, page_tokens, d] (one layer of the arena,
    or of its scale arena with d = n_blocks); table: int [batch,
    max_pages] arena page per window (sentinel `n_pages` for unmapped).
    Returns [batch, heads, max_pages * page_tokens, d]: sentinel entries
    clip to the last page, whose rows sit at masked positions (>= the
    row's length), so their softmax weight is exactly zero.  `n_heads`
    repeats kv_heads GQA-style AFTER the gather, as the JAX package
    does."""
    n_pages, kvh, pt, d = pages.shape
    b, mp = table.shape
    if n_heads is not None:
        _check_gqa(n_heads, kvh)
    idx = table.long().clamp(0, n_pages - 1)
    v = pages[idx]                                  # [b, mp, kvh, pt, d]
    v = v.transpose(1, 2).reshape(b, kvh, mp * pt, d)
    if n_heads is not None and n_heads != kvh:
        v = v.repeat_interleave(n_heads // kvh, dim=1)
    return v


def _check_gqa(heads: int, kv_heads: int) -> None:
    if heads % kv_heads:
        raise ValueError(f"heads {heads} not a multiple of kv_heads "
                         f"{kv_heads}")


def _paged_decode_attention_xla(q, k_pages, v_pages, table, lengths,
                                scale: float):
    """Plain version of B5: gather the virtual contiguous cache through
    the table, then the masked einsum of `_decode_attention_xla` — the
    CPU path, and the version the kernel is held against."""
    h = q.shape[1]
    kf = gather_pages(k_pages, table, n_heads=h)
    vf = gather_pages(v_pages, table, n_heads=h)
    return _decode_attention_xla(q, kf, vf, lengths, scale)


# Block-scaled int8 KV pages: each K/V row is split into `n_blocks` equal
# head-dim blocks, every block carries one f32 scale (amax / 127), and
# the payload is stored int8.  torch.round rounds half to even like
# jnp.rint, so quantization is deterministic and equals the JAX package's
# bitwise on the same f32 inputs.  Scales live in a parallel scale arena
# ({"k_scale", "v_scale"}: [..., page_tokens, n_blocks] f32) that rides
# the same page-table indices as the payload.

_KV_QMAX = 127.0


def kv_quantize(x, n_blocks: int):
    """Block-scaled int8 over the LAST dim of `x` [..., d] with d split
    into `n_blocks` equal blocks.  Returns (q int8 [..., d], scales f32
    [..., n_blocks]); all-zero blocks get scale 1.0."""
    d = x.shape[-1]
    if d % n_blocks:
        raise ValueError(f"head_dim {d} not a multiple of n_blocks "
                         f"{n_blocks}")
    xb = x.float().reshape(*x.shape[:-1], n_blocks, d // n_blocks)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax / _KV_QMAX, 1.0)
    q = torch.clamp(torch.round(xb / scale), -_KV_QMAX, _KV_QMAX)
    return q.to(torch.int8).reshape(x.shape), scale[..., 0]


def kv_dequantize(q, scales, dtype=torch.float32):
    """Inverse of `kv_quantize`: q int8 [..., d], scales f32
    [..., n_blocks] -> [..., d] in `dtype`."""
    d = q.shape[-1]
    nb = scales.shape[-1]
    xb = q.float().reshape(*q.shape[:-1], nb, d // nb)
    return (xb * scales[..., None]).reshape(q.shape).to(dtype)


def _paged_decode_attention_quant_xla(q, k_pages, v_pages, k_scale,
                                      v_scale, table, lengths,
                                      scale: float):
    """Plain version of B6: gather the int8 payload AND the scale pages
    through the same table, dequantize to f32, then the masked einsum of
    `_decode_attention_xla`."""
    h = q.shape[1]
    kf = kv_dequantize(gather_pages(k_pages, table, n_heads=h),
                       gather_pages(k_scale, table, n_heads=h))
    vf = kv_dequantize(gather_pages(v_pages, table, n_heads=h),
                       gather_pages(v_scale, table, n_heads=h))
    return _decode_attention_xla(q, kf, vf, lengths, scale)


def _paged_lib():
    from ._build import load

    lib = load("paged_decode")
    if lib.paged_decode.argtypes is None:  # first load: the C signatures
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode.argtypes = [ptr] * 8 + [i32] * 8 + [
            ctypes.c_float, i32, i32, ptr]
        lib.paged_decode_quant.argtypes = [ptr] * 10 + [i32] * 9 + [
            ctypes.c_float, i32, ptr]
        lib.paged_decode.restype = ctypes.c_int
        lib.paged_decode_quant.restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


# (q dtype, page dtype) pairs B5 takes: pages in q's dtype, or bfloat16
# pages under a float32 q (the widening is exact)
_PAGED_DTYPES = {(torch.float32, torch.float32), (torch.bfloat16,
                                                  torch.bfloat16),
                 (torch.float32, torch.bfloat16)}


def _check_paged_inputs(op: str, q, k_pages, v_pages, table, lengths,
                        *scales):
    """Validate a paged kernel's CUDA inputs; returns (b, h, kvh,
    n_pages, pt, mp, d) and the inputs made contiguous (the arena views
    the models pass already are, so nothing is copied), with table and
    lengths as int32."""
    tensors = (q, k_pages, v_pages, table, lengths, *scales)
    if not all(x.is_cuda for x in tensors):
        raise RuntimeError(f"{op} runs its kernel on CUDA tensors and its "
                           f"plain version on CPU tensors; got "
                           f"{[str(x.device) for x in tensors]}")
    b, h, d = q.shape
    n_pages, kvh, pt, _ = k_pages.shape
    mp = table.shape[1] if table.ndim == 2 else -1
    _check_head_dim(op, d)
    if k_pages.shape != (n_pages, kvh, pt, d) or v_pages.shape != \
            k_pages.shape:
        raise ValueError(f"k/v pages must be [n_pages, kv_heads, "
                         f"page_tokens, {d}] alike, got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    _check_gqa(h, kvh)
    if table.shape != (b, mp) or lengths.shape != (b,):
        raise ValueError(f"table must be [{b}, max_pages] and lengths "
                         f"[{b}], got {tuple(table.shape)} and "
                         f"{tuple(lengths.shape)}")
    for s in scales:
        if s.dtype != torch.float32 or s.shape[:3] != (n_pages, kvh, pt) \
                or s.shape != scales[0].shape or d % s.shape[3]:
            raise ValueError(f"scales must be float32 [{n_pages}, {kvh}, "
                             f"{pt}, n_blocks] alike with n_blocks "
                             f"dividing {d}, got {s.dtype} "
                             f"{tuple(s.shape)}")
    out = [x.contiguous() for x in (q, k_pages, v_pages)]
    out += [table.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous()]
    out += [s.contiguous() for s in scales]
    if d in _TENSOR_CORE_DIMS and (out[1].data_ptr() % 16
                                   or out[2].data_ptr() % 16):
        raise ValueError(f"{op} needs 16-byte aligned k/v pages at head_dim "
                         f"64 and 128")
    return (b, h, kvh, n_pages, pt, mp, d), out


# B5 and B6 cut each row's keys into splits of whole pages, up to this
# many tokens, one block each (flash-decoding; csrc/paged_decode.cu)
_SPLIT_TOKENS = 256


def _split_tokens(page_tokens: int, d: int, n_blocks: int,
                  elem_bytes: int = 1) -> int:
    """Tokens per split of a B5/B6 row: whole pages up to
    `_SPLIT_TOKENS` (`_SPLIT_TOKENS` itself when a page is longer), the
    budget halved until a split's K and V (`elem_bytes` an element: 1 for
    B6's int8 pages, 2 or 4 for B5's; rows of the body's width
    `_decode_width(d)`), scales (`n_blocks` a row; 0 for B5), scores and
    arena rows fit `_TILE_SMEM_LIMIT` (a bound on the kernel's
    `split_smem`)."""
    per_key = 2 * _decode_width(d) * elem_bytes + 8 * n_blocks + 12
    tokens = _SPLIT_TOKENS
    while tokens > 16 and tokens * per_key + 96 > _TILE_SMEM_LIMIT:
        tokens //= 2
    return tokens // page_tokens * page_tokens if page_tokens <= tokens \
        else tokens


@torch.library.custom_op("easydist_tpu_torch::paged_decode", mutates_args=())
def _paged_decode_op(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return _paged_decode_attention_xla(q, k_pages, v_pages, table,
                                           lengths, scale)
    if (q.dtype, k_pages.dtype) not in _PAGED_DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_decode takes float32/bfloat16 q with pages "
                        f"of its dtype (or bfloat16 pages under a float32 "
                        f"q), got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    (b, h, kvh, n_pages, pt, mp, d), (q, kp, vp, tbl, lens) = \
        _check_paged_inputs("paged_decode", q, k_pages, v_pages, table,
                            lengths)
    chunk = _split_tokens(pt, d, 0, kp.element_size())
    out = torch.empty_like(q)
    work = _split_work(q, b * h, -(-(mp * pt) // chunk), d)
    lib = _paged_lib()
    err = lib.paged_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tbl.data_ptr(),
        lens.data_ptr(), out.data_ptr(), work.data_ptr(),
        _split_counters(q.device, b * h).data_ptr(), b, h, kvh, n_pages, pt,
        mp, d, chunk, float(scale), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[kp.dtype], _stream(q))
    _check_launch(lib, "paged_decode", err)
    flash_paged_decode_attention.launches += 1
    return out


@_paged_decode_op.register_fake
def _(q, k_pages, v_pages, table, lengths, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("easydist_tpu_torch::paged_decode_quant",
                         mutates_args=())
def _paged_decode_quant_op(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor,
                           scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return _paged_decode_attention_quant_xla(
            q, k_pages, v_pages, k_scale, v_scale, table, lengths, scale)
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8:
        raise TypeError(f"paged_decode_quant takes a float32/bfloat16 q "
                        f"and int8 pages, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    (b, h, kvh, n_pages, pt, mp, d), (q, kp, vp, tbl, lens, ks, vs) = \
        _check_paged_inputs("paged_decode_quant", q, k_pages, v_pages,
                            table, lengths, k_scale, v_scale)
    nb = ks.shape[3]
    chunk = _split_tokens(pt, d, nb)
    out = torch.empty_like(q)
    work = _split_work(q, b * h, -(-(mp * pt) // chunk), d)
    lib = _paged_lib()
    err = lib.paged_decode_quant(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        work.data_ptr(), _split_counters(q.device, b * h).data_ptr(), b, h,
        kvh, n_pages, pt, mp, d, nb, chunk, float(scale),
        _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(lib, "paged_decode", err)
    flash_paged_decode_quant_attention.launches += 1
    return out


@_paged_decode_quant_op.register_fake
def _(q, k_pages, v_pages, k_scale, v_scale, table, lengths, scale):
    return q.new_empty(q.shape)


def flash_paged_decode_attention(q, k_pages, v_pages, table, lengths,
                                 scale: Optional[float] = None):
    """B5: single-query attention through a page table, in the CUDA
    kernel (`csrc/paged_decode.cu`).

    q: [batch, heads, head_dim]; k_pages/v_pages: [n_pages, kv_heads,
    page_tokens, head_dim] arena layers; table: int32 [batch, max_pages];
    lengths: int32 [batch].  Query head hi reads kv head
    hi // (heads // kv_heads).  The kernel splits each row's keys across
    blocks (`_split_tokens`) and merges the splits' partials in a fixed
    order inside the same launch, as B6 does.  Returns [batch, heads,
    head_dim] in q's dtype.  CUDA tensors only (the plain version is
    `_paged_decode_attention_xla`, which gives mean(v) where the kernel
    gives 0 for a row of length 0).  `flash_paged_decode_attention.launches`
    counts kernel launches; it grows where the kernel runs, never while a
    graph is traced."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_gqa(q.shape[1], k_pages.shape[1])
    _require_cuda("flash_paged_decode_attention", q)
    return _paged_decode_op(q, k_pages, v_pages, table, lengths,
                            float(scale))


def flash_paged_decode_quant_attention(q, k_pages, v_pages, k_scale,
                                       v_scale, table, lengths,
                                       scale: Optional[float] = None):
    """B6: `flash_paged_decode_attention` over a block-scaled int8 arena.

    k_pages/v_pages: int8 [n_pages, kv_heads, page_tokens, head_dim];
    k_scale/v_scale: f32 [n_pages, kv_heads, page_tokens, n_blocks],
    riding the same table.  The kernel dequantizes on chip and splits
    each row's keys across blocks (`_split_tokens`), merging the splits'
    partials in a fixed order inside the same launch: one kernel a call,
    deterministic.  Returns [batch, heads, head_dim] in q's dtype.  CUDA
    tensors only (the plain version is `_paged_decode_attention_quant_xla`,
    which gives mean(v) where the kernel gives 0 for a row of length 0);
    `flash_paged_decode_quant_attention.launches` counts launches."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_gqa(q.shape[1], k_pages.shape[1])
    _require_cuda("flash_paged_decode_quant_attention", q)
    return _paged_decode_quant_op(q, k_pages, v_pages, k_scale, v_scale,
                                  table, lengths, float(scale))


flash_paged_decode_attention.launches = 0
flash_paged_decode_quant_attention.launches = 0


def paged_decode_attention(q, k_pages, v_pages, table, lengths,
                           scale: Optional[float] = None,
                           backend: Optional[str] = None,
                           k_scale=None, v_scale=None):
    """Backend-dispatching paged decode attention (the models' paged
    decode steps call this).  "auto" launches the kernel for CUDA tensors
    and runs the plain version for CPU tensors; `EASYDIST_DECODE_ATTENTION`
    forces "paged"/"flash" (the kernel — raises on a CPU tensor) or "xla"
    (the plain version — raises on a CUDA tensor).  With
    `k_scale`/`v_scale` the pages are block-scaled int8: B6, or the plain
    version that dequantizes after the gather."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if lengths.ndim == 0:
        lengths = lengths.expand(q.shape[0])
    if backend is None:
        backend = edconfig.decode_attention_backend
    if backend == "auto":
        backend = "paged" if q.device.type == "cuda" else "xla"
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    quant = k_scale is not None
    if backend in ("paged", "flash"):
        if quant:
            return flash_paged_decode_quant_attention(
                q, k_pages, v_pages, k_scale, v_scale, table, lengths,
                scale=scale)
        return flash_paged_decode_attention(q, k_pages, v_pages, table,
                                            lengths, scale=scale)
    if backend == "xla":
        if q.device.type == "cuda":
            raise RuntimeError(
                "paged decode attention backend 'xla' (the plain version) "
                "runs on CPU tensors only; CUDA tensors launch the kernel "
                "(backend 'auto', 'paged' or 'flash')")
        if quant:
            return _paged_decode_attention_quant_xla(
                q, k_pages, v_pages, k_scale, v_scale, table, lengths,
                scale)
        return _paged_decode_attention_xla(q, k_pages, v_pages, table,
                                           lengths, scale)
    raise ValueError(f"unknown paged decode attention backend {backend!r}; "
                     f"expected auto|paged|flash|xla")


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
