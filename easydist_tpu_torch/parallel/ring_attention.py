"""Ring attention: exact attention over sequence-sharded Q/K/V (the port of
easydist_tpu/parallel/ring_attention.py).

Each rank of the axis holds a sequence chunk of Q, K and V; the K/V
blocks rotate around the ring (a permute over the axis's process group)
while an online softmax accumulates the exact result in f32: memory per
rank is O(seq/n).

Layout [batch, heads, seq_shard, head_dim].  Causal masking uses global
positions from the rank's coordinate on the axis.  The coordinate is a
Python int in each rank's program, so a block that lies wholly in the
rank's future is skipped (no compute, nothing merged: the JAX package's
masked block merges as exactly nothing); the blocks still rotate, since
later ranks need them.

The backward is written out, not left to autograd: autograd would skip
the cotangent hops of blocks a rank never used while its neighbours
wait for them.  It recomputes the forward, takes every visible block's
gradients against the row's logsumexp, and sends the K/V cotangents back
one hop per forward hop, so every rank issues the same collectives.

`block_impl="flash"` computes each block with the flash ops: on the card
the CUDA kernel B1 forward (causal on the diagonal block, full below it;
its normalized output and logsumexp are an (o, m, l = 1) triple of the
online merge) and B2 / B3 for the block gradients.  `"einsum"` is the
JAX package's einsum block (its gradients the plain versions of B2 and
B3).  `None` picks flash on a CUDA tensor and einsum on the CPU, as the
JAX package picks flash on its accelerator.
"""

from __future__ import annotations

from typing import Optional

import torch

_c10d = torch.ops._c10d_functional

_M0 = -1e30 / 2


def _rotate(x, group: str, n: int, idx: int, step: int):
    """Send `x` to the rank `step` ahead on the axis, receive from the rank
    `step` behind (one all_to_all_single with one non-empty split)."""
    numel = x.numel()
    send, recv = [0] * n, [0] * n
    send[(idx + step) % n] = numel
    recv[(idx - step) % n] = numel
    y = _c10d.all_to_all_single(x.contiguous().reshape(-1), recv, send,
                                group)
    return _c10d.wait_tensor(y).reshape(x.shape)


def ring_hop(x, group: str, n: int, idx: int, step: int = 1):
    """`x` of the rank `step` behind on the axis (`step` -1: of the rank
    ahead).  Each hop adds one to `ring_hop.permutes` and the bytes it
    sends to `ring_hop.bytes`."""
    ring_hop.permutes += 1
    ring_hop.bytes += x.numel() * x.element_size()
    return _rotate(x, group, n, idx, step)


ring_hop.permutes = 0
ring_hop.bytes = 0


def _einsum_block(q, k, v, causal_diag: bool, scale: float):
    """One block: (unnormalized out, running max, running denominator),
    f32, with the -1e30 fill on the diagonal block."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal_diag:
        t = q.shape[2]
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(t, device=q.device)[:, None])
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                              device=s.device))
    m = torch.clamp_min(s.amax(dim=-1), _M0)
    p = torch.exp(s - m[..., None])
    if causal_diag:
        p = torch.where(mask, p, torch.zeros((), dtype=p.dtype,
                                             device=p.device))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()), m, p.sum(dim=-1)


def _flash_block(q, k, v, causal_diag: bool, scale: float):
    from easydist_tpu_torch.ops.flash_attention import flash_fwd

    b, h, t, _ = q.shape
    out, lse = flash_fwd(q, k, v, causal_diag, scale)
    m = lse.reshape(b, h, t)
    return out.float(), m, torch.ones_like(m)


def _einsum_block_grads(q, k, v, do, lse, delta, causal_diag: bool,
                        scale: float):
    from easydist_tpu_torch.ops.flash_attention import (_flash_bwd_dkv_xla,
                                                        _flash_bwd_dq_xla)

    dq = _flash_bwd_dq_xla(q, k, v, do, lse, delta, causal_diag, scale)
    return (dq, *_flash_bwd_dkv_xla(q, k, v, do, lse, delta, causal_diag,
                                    scale))


def _flash_block_grads(q, k, v, do, lse, delta, causal_diag: bool,
                       scale: float):
    from easydist_tpu_torch.ops.flash_attention import (flash_bwd_dkv,
                                                        flash_bwd_dq)

    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal_diag, scale)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal_diag, scale))


_BLOCKS = {"flash": (_flash_block, _flash_block_grads),
           "einsum": (_einsum_block, _einsum_block_grads)}


def _ring_forward(q, k, v, group, n, idx, causal, scale, block_impl):
    """(out f32, lse f32 [b, h, t], the K/V blocks in arrival order)."""
    block = _BLOCKS[block_impl][0]
    b, h, t, d = q.shape
    o_acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    m_acc = torch.full((b, h, t), _M0, dtype=torch.float32, device=q.device)
    l_acc = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    blocks = [(k, v)]
    for r in range(n):
        k_blk, v_blk = blocks[r]
        src = (idx - r) % n  # block r came from rank (idx - r) mod n
        if not causal or src <= idx:
            o_b, m_b, l_b = block(q, k_blk, v_blk, causal and src == idx,
                                  scale)
            m_new = torch.maximum(m_acc, m_b)
            alpha = torch.exp(m_acc - m_new)
            beta = torch.exp(m_b - m_new)
            o_acc = o_acc * alpha[..., None] + o_b * beta[..., None]
            l_acc = l_acc * alpha + l_b * beta
            m_acc = m_new
        if r < n - 1:
            blocks.append((ring_hop(k_blk, group, n, idx),
                           ring_hop(v_blk, group, n, idx)))
    l_safe = torch.clamp_min(l_acc, 1e-30)
    return o_acc / l_safe[..., None], m_acc + torch.log(l_safe), blocks


def _resolve(q, scale, block_impl):
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if block_impl is None:
        block_impl = "flash" if q.is_cuda else "einsum"
    return scale, block_impl


def ring_attention_local(q, k, v, group: str, n: int, idx: int,
                         causal: bool = True, scale: Optional[float] = None,
                         block_impl: Optional[str] = None):
    """One rank's ring: q, k, v its [b, h, t/n, d] chunks, `group` the
    axis's process-group name, `n` its size, `idx` the rank's coordinate
    on it.  Returns the rank's chunk of the output in q's dtype.  Not
    differentiable by autograd: `ring_attention_local_vjp` is its vjp."""
    scale, block_impl = _resolve(q, scale, block_impl)
    out, _, _ = _ring_forward(q, k, v, group, n, idx, causal, scale,
                              block_impl)
    return out.to(q.dtype)


def ring_attention_local_vjp(q, k, v, dout, group: str, n: int, idx: int,
                             causal: bool = True,
                             scale: Optional[float] = None,
                             block_impl: Optional[str] = None):
    """(dq, dk, dv) of `ring_attention_local` at `dout`: the vjp of the
    same program.  It recomputes the forward (its K/V hops included),
    takes each visible block's gradients against the whole row's
    logsumexp and delta = rowsum(dO * O) (flash blocks: the kernels B2
    and B3), and sends the K/V cotangents back along the ring, one hop
    for each forward hop, as autograd of the forward would.  Every rank
    issues the same collectives in the same order, skipped blocks or
    not."""
    scale, block_impl = _resolve(q, scale, block_impl)
    grads_of = _BLOCKS[block_impl][1]
    out, lse, blocks = _ring_forward(q, k, v, group, n, idx, causal, scale,
                                     block_impl)
    b, h, t, _ = q.shape
    lse = lse.reshape(b * h, t)
    delta = (dout.float() * out).sum(dim=-1).reshape(b * h, t)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = dv = None
    for r in reversed(range(n)):
        k_blk, v_blk = blocks[r]
        if dk is not None:  # the cotangents of hop r come back
            dk = ring_hop(dk, group, n, idx, -1)
            dv = ring_hop(dv, group, n, idx, -1)
        else:
            dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        src = (idx - r) % n
        if not causal or src <= idx:
            dq_b, dk_b, dv_b = grads_of(q, k_blk, v_blk, dout, lse, delta,
                                        causal and src == idx, scale)
            dq = dq + dq_b.float()
            dk = dk + dk_b.float()
            dv = dv + dv_b.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal, scale, block_impl):
        ctx.save_for_backward(q, k, v)
        ctx.args = (group, n, idx, causal, scale, block_impl)
        return ring_attention_local(q, k, v, group, n, idx, causal, scale,
                                    block_impl)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ring_attention_local_vjp(q, k, v, dout.contiguous(),
                                              *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


class _SeqChunk(torch.autograd.Function):
    """Replicated [.., t, ..] -> this rank's t/n chunk along `dim`; the
    backward all_gathers the chunks' cotangents."""

    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.args = (dim, group, n)
        size = x.shape[dim] // n
        return x.narrow(dim, idx * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _gather(g, dim, group, n), None, None, None, None


class _SeqGather(torch.autograd.Function):
    """This rank's chunk -> the replicated whole along `dim`; the backward
    keeps the rank's chunk of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.args = (dim, n, idx)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, n, idx = ctx.args
        size = g.shape[dim] // n
        return (g.narrow(dim, idx * size, size).contiguous(), None, None,
                None, None)


def _gather(x, dim: int, group: str, n: int):
    y = _c10d.all_gather_into_tensor(torch.movedim(x, dim, 0).contiguous(),
                                     n, group)
    return torch.movedim(_c10d.wait_tensor(y), 0, dim).contiguous()


def _axis(mesh, axis: str):
    if mesh is None:
        raise ValueError("ring and Ulysses attention need a DeviceMesh "
                         "(GPTConfig.attn_mesh for attention='ring')")
    names = list(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not a mesh axis {tuple(names)}")
    dim = names.index(axis)
    return (mesh.get_group(dim).group_name, int(mesh.size(dim)),
            int(mesh.get_local_rank(dim)))


def on_seq_shards(local_fn, q, k, v, mesh, axis: str):
    """Run `local_fn(q, k, v, group, n, idx)` on this rank's sequence
    chunks of the replicated q, k, v and return the replicated output
    (differentiable: chunking and gathering are each other's adjoint)."""
    group, n, idx = _axis(mesh, axis)
    if n == 1:
        return local_fn(q, k, v, group, 1, 0)
    if q.shape[2] % n:
        raise ValueError(f"seq {q.shape[2]} does not divide by the "
                         f"{axis!r} axis of {n}")
    q, k, v = (_SeqChunk.apply(x, 2, group, n, idx) for x in (q, k, v))
    return _SeqGather.apply(local_fn(q, k, v, group, n, idx), 2, group, n,
                            idx)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None,
                   block_impl: Optional[str] = None):
    """Exact attention with q, k, v [batch, heads, seq, head_dim] (the same
    whole tensors on every rank of `mesh`, a DeviceMesh) computed by the
    ring over mesh axis `axis`: each rank runs the ring on its sequence
    chunk, and the chunks are gathered back (seq divisible by the axis)."""
    return on_seq_shards(
        lambda q_, k_, v_, group, n, idx: _RingAttention.apply(
            q_, k_, v_, group, n, idx, causal, scale, block_impl),
        q, k, v, mesh, axis)
