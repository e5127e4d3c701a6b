"""Block-wise-scaled quantized reduction collectives: the port of
easydist_tpu/comm/quant.py.

The two-pass int8 scheme over a process group, with functional
collectives (`torch.ops._c10d_functional`), so a rank's step runs
eagerly or traces with `make_fx` into collective nodes:

  pass 1 (reduce-scatter hop)   quantize the local vector block-wise
                                (int8 payload + one f32 scale per block),
                                `all_to_all_single` so rank i receives
                                every peer's chunk i, dequantize and sum
                                in f32 in fixed peer order
  pass 2 (all-gather hop)       re-quantize the reduced chunk,
                                `all_gather_into_tensor` payload and
                                scales, dequantize everywhere

Both passes round half to even (`torch.round`, the JAX `jnp.rint`) and
sum in a fixed peer order (a left fold over ranks 0..n-1), so results
are deterministic and identical on every rank at any world size.  The
int8 payload carries no arithmetic on the wire.  "bf16" is the one-pass
form: cast, reduce, cast back.

The JAX package's version is plain `jnp` (no Pallas kernel), and so is
this one.  Wire bytes: `int8_payload_bytes` is the JAX closed form; the
collectives pad to whole blocks per rank chunk, and `int8_wire_bytes`
gives what they really move (the counters, the solver's price and the
emitted fences all use it).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch

from easydist_tpu_torch import config as edconfig

_c10d = torch.ops._c10d_functional

_QMAX_INT8 = 127.0
_VALID_MODES = ("none", "int8", "bf16")


def quant_mode() -> str:
    """The configured wire dtype, validated ("none" | "int8" | "bf16")."""
    mode = (edconfig.comm_quant_dtype or "none").lower()
    if mode not in _VALID_MODES:
        raise ValueError(
            f"comm_quant_dtype={edconfig.comm_quant_dtype!r}; expected one "
            f"of {_VALID_MODES}")
    return mode


def comm_enabled() -> bool:
    """True when quantization or bucketing is on; False means the
    gradient paths emit one exact collective per leaf."""
    return quant_mode() != "none" or edconfig.comm_bucket_bytes > 0


def leaf_quantizable(path: str, numel: int,
                     mode: Optional[str] = None) -> bool:
    """Per-leaf opt-out: leaves whose path matches `comm_quant_skip`
    (biases, norm gains) and leaves below `comm_quant_min_numel` stay at
    full precision."""
    mode = quant_mode() if mode is None else mode
    if mode == "none":
        return False
    if numel < edconfig.comm_quant_min_numel:
        return False
    pat = edconfig.comm_quant_skip
    if pat and re.search(pat, path, re.IGNORECASE):
        return False
    return True


# ------------------------------------------------------------- block scaling

def quantize_blockwise(flat: torch.Tensor, block: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D f32 vector (size % block == 0) -> (int8 payload, f32 per-block
    scales).  An all-zero block gets scale 1.0, so it dequantizes
    exactly."""
    xb = flat.reshape(-1, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0.0, amax / _QMAX_INT8, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale), -_QMAX_INT8, _QMAX_INT8)
    return (q.to(torch.int8).reshape(-1),
            scale.to(torch.float32).reshape(-1))


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         block: int) -> torch.Tensor:
    return (q.to(torch.float32).reshape(-1, block)
            * scales.reshape(-1, 1)).reshape(-1)


def _pad_flat(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def int8_payload_bytes(numel: int, block: int) -> float:
    """Wire payload of a block-quantized vector: int8 values + one f32
    scale per block (padding to the block grid included)."""
    padded = numel + ((-numel) % block)
    return padded * 1.0 + (padded // block) * 4.0


def int8_wire_bytes(kind: str, numel: int, n: int,
                    block: Optional[int] = None) -> float:
    """Bytes one rank sends for a quantized `kind` ("all_reduce" or
    "reduce_scatter") of `numel` f32 elements over `n` ranks, as the
    collectives below move them: the all_reduce pads the vector to
    n * block (pass 1 and pass 2 each move (n-1)/n of the payload), the
    reduce_scatter pads each of the n rows to the block (one pass)."""
    if n <= 1:
        return 0.0
    block = block or edconfig.comm_quant_block
    if kind == "all_reduce":
        padded = numel + ((-numel) % (n * block))
        return 2.0 * int8_payload_bytes(padded, block) * (n - 1) / n
    if kind == "reduce_scatter":
        cols = numel // n
        cols += (-cols) % block
        return int8_payload_bytes(n * cols, block) * (n - 1) / n
    raise ValueError(f"kind={kind!r}; expected all_reduce|reduce_scatter")


# ------------------------------------------------------- group collectives

def _name(group) -> str:
    return group if isinstance(group, str) else group.group_name


def _all_to_all(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Equal-split all_to_all of a 1-D tensor: chunk j goes to rank j."""
    split = [x.numel() // n] * n
    y = _c10d.all_to_all_single(x.contiguous(), split, split, _name(group))
    return _c10d.wait_tensor(y)


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    y = _c10d.all_gather_into_tensor(x.contiguous(), n, _name(group))
    return _c10d.wait_tensor(y)


def _peer_sum(contrib: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 as a left fold in peer order 0..n-1."""
    acc = contrib[0]
    for j in range(1, contrib.shape[0]):
        acc = acc + contrib[j]
    return acc


def quantized_psum(x: torch.Tensor, group, axis_size: int, *,
                   block: Optional[int] = None,
                   mean: bool = False) -> torch.Tensor:
    """Two-pass block-scaled int8 all_reduce; same shape and dtype as `x`.
    `mean=True` divides the reduced chunk by n before the second
    quantization (better use of the scale than dividing after)."""
    n = axis_size
    if n <= 1:
        return x / n if mean else x
    block = block or edconfig.comm_quant_block
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    numel = flat.numel()
    flat = _pad_flat(flat, n * block)
    chunk = flat.numel() // n
    q, s = quantize_blockwise(flat, block)
    q, s = _all_to_all(q, group, n), _all_to_all(s, group, n)
    reduced = _peer_sum(dequantize_blockwise(q, s, block).reshape(n, chunk))
    if mean:
        reduced = reduced / n
    q2, s2 = quantize_blockwise(reduced, block)
    q2, s2 = _all_gather(q2, group, n), _all_gather(s2, group, n)
    out = dequantize_blockwise(q2, s2, block)
    return out[:numel].reshape(shape).to(dtype)


def quantized_psum_scatter(x: torch.Tensor, group, axis_size: int, *,
                           scatter_dim: int = 0,
                           block: Optional[int] = None,
                           mean: bool = False) -> torch.Tensor:
    """Block-scaled int8 reduce_scatter: rank i gets the reduced slice i
    along `scatter_dim` (the one-hop half of `quantized_psum`)."""
    n = axis_size
    if n <= 1:
        return x / n if mean else x
    block = block or edconfig.comm_quant_block
    dtype = x.dtype
    if scatter_dim != 0:
        x = torch.movedim(x, scatter_dim, 0)
    assert x.shape[0] % n == 0, (tuple(x.shape), n)
    shard_shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    parts = x.to(torch.float32).reshape(n, -1)  # row j = slice j
    cols = parts.shape[1]
    pad = (-cols) % block
    if pad:
        parts = torch.nn.functional.pad(parts, (0, pad))
    # every block lies inside one row, so a row's scales travel with its
    # payload through the same all_to_all
    q, s = quantize_blockwise(parts.reshape(-1), block)
    q, s = _all_to_all(q, group, n), _all_to_all(s, group, n)
    reduced = _peer_sum(dequantize_blockwise(q, s, block).reshape(
        n, cols + pad))
    if pad:
        reduced = reduced[:cols]
    if mean:
        reduced = reduced / n
    out = reduced.reshape(shard_shape).to(dtype)
    if scatter_dim != 0:
        out = torch.movedim(out, 0, scatter_dim)
    return out.contiguous()


def bf16_psum(x: torch.Tensor, group, *, mean: bool = False,
              axis_size: int = 1) -> torch.Tensor:
    """Half-width wire: all_reduce a bf16 cast, cast back."""
    r = _c10d.all_reduce(x.to(torch.bfloat16).contiguous(), "sum",
                         _name(group))
    r = _c10d.wait_tensor(r).to(x.dtype)
    return r / axis_size if mean else r


def bf16_psum_scatter(x: torch.Tensor, group, *, scatter_dim: int = 0,
                      mean: bool = False,
                      axis_size: int = 1) -> torch.Tensor:
    n = axis_size
    y = torch.movedim(x, scatter_dim, 0) if scatter_dim else x
    r = _c10d.reduce_scatter_tensor(y.to(torch.bfloat16).contiguous(), "sum",
                                    n, _name(group))
    r = _c10d.wait_tensor(r).to(x.dtype)
    if scatter_dim:
        r = torch.movedim(r, 0, scatter_dim).contiguous()
    return r / n if mean else r
