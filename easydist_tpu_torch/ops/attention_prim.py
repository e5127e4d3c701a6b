"""The solver-visible attention composite: the port of
easydist_tpu/ops/attention_prim.py.

`attention(q, k, v)` is two custom ops, `easydist_tpu_torch::
ed_attention_fwd` and `::ed_attention_bwd`; the forward's
`register_autograd` calls the backward op, so a `make_fx` trace of a
train step holds both as plain nodes.  Each carries explicit strategies
for the auto-parallel solver (`fxfront/presets.py`):

  batch  S(0)->S(0)   free
  head   S(1)->S(1)   free
  seq    S(2)->S(2)   intrinsic cost: ring permutes or Ulysses
                      all_to_alls, whichever is cheaper on the axis; the
                      winning variant rides the strategy's `meta`

Where the solver picks the seq strategy, emission (`fxfront/emit.py`)
lowers the node to the ring or Ulysses program on the axis's group
(`parallel/`), whose ring blocks are the flash kernels on the card; the
backward node becomes the vjp of the same program (it recomputes the
forward).  Batch and head strategies run the ops on the shard.

The per-shard bodies are the einsum math of the JAX package with its
-1e30 fill, and the backward recomputes the forward: no [t, t]
probability matrix is saved between the two nodes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["attention", "seq_collectives", "seq_strategy_costs",
           "seq_variant"]

_NEG_INF = -1e30


def _probs(q, k, causal: bool, scale: float):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        qi = torch.arange(t_q, device=q.device)[:, None]
        ki = torch.arange(t_k, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, torch.tensor(_NEG_INF, dtype=s.dtype,
                                                  device=s.device))
    return torch.softmax(s, dim=-1)


def _einsum_attention(q, k, v, causal: bool, scale: float):
    return torch.einsum("bhqk,bhkd->bhqd", _probs(q, k, causal, scale), v)


def _einsum_attention_vjp(q, k, v, dout, causal: bool, scale: float):
    """(dq, dk, dv) of `_einsum_attention` at `dout`, by recompute (written
    out: a custom op's body runs below autograd)."""
    p = _probs(q, k, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv


@torch.library.custom_op("easydist_tpu_torch::ed_attention_fwd",
                         mutates_args=())
def _ed_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, scale: float) -> torch.Tensor:
    return _einsum_attention(q, k, v, causal, scale)


@_ed_attention_fwd_op.register_fake
def _(q, k, v, causal, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("easydist_tpu_torch::ed_attention_bwd",
                         mutates_args=())
def _ed_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dout: torch.Tensor, causal: bool, scale: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dq, dk, dv = _einsum_attention_vjp(q, k, v, dout, causal, scale)
    return dq, dk, dv


@_ed_attention_bwd_op.register_fake
def _(q, k, v, dout, causal, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, dout):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = _ed_attention_bwd_op(q, k, v, dout.contiguous(),
                                      ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


_ed_attention_fwd_op.register_autograd(_backward,
                                       setup_context=_setup_context)


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Multi-head attention the auto-parallel solver can see through.
    q, k, v: [batch, heads, seq, head_dim].  Differentiable (the backward
    is its own solver-visible op).  Outside `easydist_compile` it
    evaluates as plain einsum attention."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    return _ed_attention_fwd_op(q, k, v, bool(causal), float(scale))


# ------------------------------------------------------------- cost estimates

def seq_variant(variant: str, heads: int, n: int) -> str:
    """The variant emission runs on an axis of `n`: Ulysses needs the
    heads to divide by `n` (its inner compute is head-sharded), else the
    ring (reference jaxfront/api.py:108-113)."""
    return "ring" if variant == "ulysses" and heads % n != 0 else variant


def seq_collectives(tensor_bytes: float, n: int, backward: bool,
                    variant: str) -> List[Tuple[str, float]]:
    """(kind, bytes) of every collective the seq strategy's program issues
    over an axis of `n`, for a q of `tensor_bytes` across the axis, in the
    units `autoflow.cost_model.collective_wire_bytes` prices: a
    "ppermute" by the bytes it sends, an "all_to_all" by the bytes of the
    whole tensor across the group.  Their wire bytes sum to
    `seq_strategy_costs`' byte terms.

    Ring: K and V (each a t/n slice) hop n-1 times; the backward
    recomputes that and sends dK, dV back (2x).  Ulysses: q, k, v and the
    output through one all_to_all each; the backward recomputes those
    four and moves four more for the cotangents (2x)."""
    mult = 2 if backward else 1
    if variant == "ring":
        return [("ppermute", tensor_bytes / n)] * (2 * (n - 1) * mult)
    return [("all_to_all", float(tensor_bytes))] * (4 * mult)


def seq_strategy_costs(q_shape, dtype_bytes: int, n: int, backward: bool):
    """(ring_seconds, ulysses_seconds) of seq-sharding attention over an
    n-device NVLink axis: the intrinsic prices the solver weighs.

    Ring: per-device wire bytes 2 (n-1)/n kv_bytes, twice in the
    backward.  Ulysses: four all_to_alls, each (n-1)/n^2 of the global
    bytes times the all_to_all penalty, twice in the backward."""
    from easydist_tpu_torch import config as edconfig

    b, h, t, d = q_shape
    tensor_bytes = b * h * t * d * dtype_bytes
    bw = edconfig.nvlink_bandwidth
    lat = edconfig.nvlink_latency
    mult = 2.0 if backward else 1.0

    ring_bytes = 2.0 * (n - 1) / n * tensor_bytes * mult
    ring = ring_bytes / bw + (n - 1) * lat * (2 if backward else 1)

    punish = edconfig.all_to_all_punish_factor if n > 2 else 1.0
    ua_bytes = 4.0 * (n - 1) / (n * n) * tensor_bytes * punish * mult
    ulysses = ua_bytes / bw + 4 * lat * mult
    return ring, ulysses
