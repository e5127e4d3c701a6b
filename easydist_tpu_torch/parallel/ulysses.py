"""Ulysses sequence parallelism: head <-> sequence all_to_all (the port of
easydist_tpu/parallel/ulysses.py).

Inputs arrive sequence-sharded over the axis; an all_to_all regroups each
of q, k, v into head-sharded whole-sequence tensors, every rank runs
ordinary attention on heads/n heads, and a second all_to_all returns the
output to sequence sharding.  The all_to_all is its own adjoint, so the
program is differentiable end to end.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ring_attention import on_seq_shards

_c10d = torch.ops._c10d_functional


def _all_to_all(x, group: str, n: int):
    """Equal-split all_to_all over dim 0 (chunk i goes to rank i)."""
    y = _c10d.all_to_all_single(x.contiguous(), [x.shape[0] // n] * n,
                                [x.shape[0] // n] * n, group)
    return _c10d.wait_tensor(y)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _all_to_all(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None


def all_to_all(x, group: str, n: int):
    """Differentiable equal-split all_to_all over dim 0."""
    return _AllToAll.apply(x, group, n)


def seq_to_heads(x, group: str, n: int):
    """[b, h, t/n, d] -> [b, h/n, t, d]."""
    b, h, t, d = x.shape
    y = x.reshape(b, n, h // n, t, d).movedim(1, 0)
    y = all_to_all(y, group, n)  # [n (seq chunk), b, h/n, t/n, d]
    return y.movedim(0, 2).reshape(b, h // n, n * t, d)


def heads_to_seq(x, group: str, n: int):
    """[b, h/n, t, d] -> [b, h, t/n, d]."""
    b, hn, t, d = x.shape
    y = x.reshape(b, hn, n, t // n, d).movedim(2, 0)
    y = all_to_all(y, group, n)  # [n (head group), b, h/n, t/n, d]
    return y.movedim(0, 1).reshape(b, n * hn, t // n, d)


def ulysses_attention_local(q, k, v, group: str, n: int,
                            causal: bool = True,
                            scale: Optional[float] = None,
                            attn_fn: Optional[Callable] = None):
    """One rank's Ulysses program on its [b, h, t/n, d] chunks (heads
    divisible by `n`)."""
    from easydist_tpu_torch.ops.attention_prim import _einsum_attention

    if q.shape[1] % n:
        raise ValueError(f"Ulysses needs heads ({q.shape[1]}) divisible "
                         f"by the axis ({n})")
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if attn_fn is None:
        def attn_fn(q_, k_, v_):
            return _einsum_attention(q_, k_, v_, causal, scale)
    out = attn_fn(seq_to_heads(q, group, n), seq_to_heads(k, group, n),
                  seq_to_heads(v, group, n))
    return heads_to_seq(out, group, n)


def ulysses_attention_local_vjp(q, k, v, dout, group: str, n: int,
                                causal: bool = True,
                                scale: Optional[float] = None):
    """(dq, dk, dv) of `ulysses_attention_local`: the vjp of the same
    program (it recomputes the forward, its four all_to_alls included,
    and moves four more for the cotangents)."""
    with torch.enable_grad():
        live = [x.detach().requires_grad_() for x in (q, k, v)]
        out = ulysses_attention_local(*live, group, n, causal, scale)
        return torch.autograd.grad(out, live, dout)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None):
    """q, k, v: [batch, heads, seq, head_dim], the same whole tensors on
    every rank of `mesh`; each rank runs the program on its sequence
    chunk and the chunks are gathered back.  Heads must divide by the
    axis."""
    return on_seq_shards(
        lambda q_, k_, v_, group, n, idx: ulysses_attention_local(
            q_, k_, v_, group, n, causal, scale, attn_fn),
        q, k, v, mesh, axis)
