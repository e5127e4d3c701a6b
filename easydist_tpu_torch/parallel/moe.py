"""Mixture-of-Experts with expert parallelism: the port of
easydist_tpu/parallel/moe.py.

Switch top-1 or GShard top-2 routing with per-expert capacity buffers,
dense dispatch (einsum with one-hot masks, no dynamic shapes), experts
sharded over the `ep` mesh axis and the tokens exchanged with
`all_to_all_single` on its process group.  No kernel of its own.

The JAX package runs the layer as one shard_map program; here each rank
runs its own: it passes the global tokens and expert weights (or their
`moe_params_from_numpy` copy), takes its own block of tokens and experts,
and gets its block of the output back.  The exchanges are autograd-aware
(`_functional_collectives.all_to_all_single_autograd`), so gradients
flow to the router and the experts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from easydist_tpu_torch import comm, resolve_device

from ._axes import local_block, mesh_axis


@dataclass
class MoEConfig:
    n_experts: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    # experts per token: 1 = Switch routing, 2 = GShard-style top-2 (gates
    # renormalized over the selected experts)
    top_k: int = 1


def moe_init(cfg: MoEConfig, generator: torch.Generator,
             device=None) -> Dict:
    """Random float32 parameters drawn from `generator`, placed on
    `device` (default: the card).  The numbers differ from the JAX
    package's `moe_init`; carry its weights with `moe_params_from_numpy`."""
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    return {
        "router": normal(cfg.d_model, cfg.n_experts) * 0.02,
        "w_in": normal(cfg.n_experts, cfg.d_model, cfg.d_ff)
        / math.sqrt(cfg.d_model),
        "w_out": normal(cfg.n_experts, cfg.d_ff, cfg.d_model)
        / math.sqrt(cfg.d_ff),
    }


def moe_params_from_numpy(tree, device=None) -> Dict:
    """The JAX package's MoE parameters (numpy arrays) as tensors on
    `device` (default: the card)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def capacity_of(cfg: MoEConfig, n_local: int) -> int:
    """Per-expert buffer slots of one rank's `n_local` tokens."""
    return max(1, int(math.ceil(n_local * cfg.top_k * cfg.capacity_factor
                                / cfg.n_experts)))


def _routing(probs, n_experts: int, capacity: int, top_k: int, dtype):
    """Top-k routing with per-expert capacity shared across slots.

    Returns (dispatch [n, E, C] summed over slots, per-slot combine
    weights as a list of ([n, E, C] dispatch_s, gate_s [n]) pairs,
    onehot_all [n, E] for the aux loss)."""
    topk_probs, topk_idx = torch.topk(probs, top_k, dim=-1)  # [n, k]
    if top_k == 1:
        gates = topk_probs  # Switch: gate by the raw router probability
    else:
        gates = topk_probs / torch.clamp_min(
            topk_probs.sum(dim=-1, keepdim=True), 1e-9)

    counts = torch.zeros((probs.shape[1],), dtype=probs.dtype,
                         device=probs.device)
    slot_dispatch = []
    onehot_all = torch.zeros_like(probs)
    for s in range(top_k):
        onehot = F.one_hot(topk_idx[:, s], n_experts).to(dtype)
        pos = counts[None, :] + torch.cumsum(onehot, dim=0) - 1.0
        pos_tok = (pos * onehot).sum(dim=-1)
        keep = (pos_tok < capacity).to(dtype)
        # a dropped token's position is past the buffer: its one-hot row
        # is all zeros, as jax.nn.one_hot gives for an out-of-range index
        pos_oh = F.one_hot(pos_tok.long().clamp(0, capacity), capacity + 1
                           )[:, :capacity].to(dtype)
        disp = onehot[:, :, None] * pos_oh[:, None, :] * keep[:, None, None]
        slot_dispatch.append((disp, gates[:, s] * keep))
        counts = counts + (onehot * keep[:, None]).sum(dim=0)
        onehot_all = onehot_all + onehot
    dispatch = sum(d for d, _ in slot_dispatch)
    return dispatch, slot_dispatch, onehot_all


def _a2a(x, group):
    """all_to_all over dim 0 (equal splits), differentiable."""
    from torch.distributed._functional_collectives import \
        all_to_all_single_autograd

    return all_to_all_single_autograd(x.contiguous(), None, None, group)


class _MeanAllReduce(torch.autograd.Function):
    """pmean over a group; its adjoint is the same pmean of the
    cotangents (every rank's output is the one mean)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return comm.all_reduce_sum(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_sum(g, ctx.group) / ctx.n, None, None


def moe_local(x, router, w_in, w_out, *, group, ep: int, n_experts: int,
              capacity: int, top_k: int = 1):
    """One rank's layer: x [n_local, d]; w_in / w_out the rank's expert
    block [E/ep, ...].  Returns (y [n_local, d], aux averaged over the
    group)."""
    logits = x @ router  # [n, E]
    probs = torch.softmax(logits, dim=-1)
    dispatch, slot_dispatch, onehot = _routing(probs, n_experts, capacity,
                                               top_k, x.dtype)
    buffers = torch.einsum("nec,nd->ecd", dispatch, x)  # [E, C, d]
    e_loc = n_experts // ep
    c, d = buffers.shape[1], buffers.shape[2]
    # to the expert owners: rank r gets experts [r*E/ep, (r+1)*E/ep) of
    # every rank; their capacity slots concatenate in source-rank order
    got = _a2a(buffers, group).reshape(ep, e_loc, c, d)
    got = got.permute(1, 0, 2, 3).reshape(e_loc, ep * c, d)
    h = F.gelu(torch.einsum("ecd,edf->ecf", got, w_in), approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, w_out)  # [E/ep, C*ep, d]
    out = out.reshape(e_loc, ep, c, d).permute(1, 0, 2, 3)
    out = _a2a(out, group).reshape(n_experts, c, d)  # [E, C, d]
    y = sum(torch.einsum("nec,ecd->nd", disp, out) * gate_s[:, None]
            for disp, gate_s in slot_dispatch)
    # Switch load-balancing loss: E * sum_e frac_tokens_e * mean_prob_e,
    # averaged over ranks (assignment fractions normalized by top_k)
    frac = onehot.mean(dim=0) / max(top_k, 1)
    aux = n_experts * (frac * probs.mean(dim=0)).sum()
    return y, _MeanAllReduce.apply(aux, group, ep)


def moe_layer(params: Dict, x, mesh, cfg: MoEConfig,
              axis: str = "ep") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [tokens, d_model], the same on every rank; experts sharded over
    `axis`.  Returns (this rank's block of the output [tokens/ep,
    d_model], aux loss averaged over the axis)."""
    ax = mesh_axis(mesh, axis)
    ep = ax.size
    if cfg.n_experts % ep != 0:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                         f"ep axis size {ep}")
    x_loc = local_block(x, 0, ep, ax.index, "token")
    return moe_local(
        x_loc, params["router"],
        local_block(params["w_in"], 0, ep, ax.index, "expert"),
        local_block(params["w_out"], 0, ep, ax.index, "expert"),
        group=ax.group, ep=ep, n_experts=cfg.n_experts,
        capacity=capacity_of(cfg, x_loc.shape[0]), top_k=cfg.top_k)


def moe_reference(params: Dict, x, cfg: MoEConfig, n_devices: int = 1):
    """Single-device reference with the same semantics (a per-token loop
    with the same slot-major capacity accounting as `_routing`), used by
    the tests."""
    n_local = x.shape[0] // n_devices
    capacity = capacity_of(cfg, n_local)
    ys, auxes = [], []
    for s in range(n_devices):
        xs = x[s * n_local:(s + 1) * n_local]
        probs_t = torch.softmax(xs @ params["router"], dim=-1)
        probs = probs_t.detach().cpu().numpy()
        order = np.argsort(-probs, axis=-1)[:, :cfg.top_k]  # [n, k]
        topk = np.take_along_axis(probs, order, axis=-1)
        gates = topk if cfg.top_k == 1 else \
            topk / np.maximum(topk.sum(-1, keepdims=True), 1e-9)
        counts = np.zeros(cfg.n_experts, np.int64)
        out = torch.zeros_like(xs)
        onehot_frac = np.zeros(cfg.n_experts)
        for k in range(cfg.top_k):
            for i in range(xs.shape[0]):
                e = int(order[i, k])
                onehot_frac[e] += 1
                if counts[e] >= capacity:
                    continue
                counts[e] += 1
                h = F.gelu(xs[i] @ params["w_in"][e], approximate="tanh")
                out[i] = out[i] + (h @ params["w_out"][e]) * float(gates[i, k])
        ys.append(out)
        frac = torch.as_tensor(onehot_frac / xs.shape[0] / max(cfg.top_k, 1),
                               dtype=xs.dtype, device=xs.device)
        auxes.append(cfg.n_experts * (frac * probs_t.mean(dim=0)).sum())
    return torch.cat(ys), torch.stack(auxes).mean()
