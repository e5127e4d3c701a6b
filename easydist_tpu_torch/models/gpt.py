"""GPT-2-style decoder transformer in PyTorch: the port of
easydist_tpu/models/gpt.py's forwards, serving steps (bucketed and
paged KV, with the speculative verify steps) and train steps (`gpt_loss`,
`make_gpt_train_step` with Adam; `make_gpt_pipeline_step`, the blocks
pipelined over a mesh axis).

Functional, like the JAX model: parameters are the JAX package's nested
dict/list with the same keys and layouts (`w` is [n_in, n_out]; no
transposed `nn.Linear`), so `params_from_numpy` carries the JAX
package's weights across.  Params stay float32 and are cast to
`cfg.dtype` at each use; logits are `x.float() @ wte.T`.

Four differences from the JAX functions, all deliberate:
  * the KV cache and the page arena are written IN PLACE (`index_put_`
    into the tensors the caller passed, which are also returned) where
    the JAX package returns new ones and relies on buffer donation —
    callers that need the old cache clone it first;
  * row and chunk cache writes clamp their start so the write fits,
    exactly as `jax.lax.dynamic_update_slice` does;
  * the page arena holds one extra page, the drop page, which takes the
    writes the JAX package discards with `mode="drop"` (see
    `init_kv_pages`);
  * `GPTConfig.scan_layers` keeps the layer-stacked params, but every
    forward loops over the layer index (torch has no stable scan), so
    `make_fx` unrolls what the JAX package traces once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as _pytree

from easydist_tpu_torch import resolve_device, torch_dtype

from .optim import adam_init, adam_update, value_and_grad

_tree_map = _pytree.tree_map


@dataclass
class GPTConfig:
    vocab: int = 50257
    seq: int = 1024
    dim: int = 768
    heads: int = 12
    layers: int = 12
    dtype: str = "float32"  # compute dtype; params stay float32
    # attention backend of the full forward: "einsum" (plain torch),
    # "flash" (ops.flash_attention: the CUDA kernels B1-B3 on the card),
    # "auto" (ops.attention_prim: the composite whose batch / head /
    # sequence (ring or Ulysses) sharding the auto-parallel solver picks
    # per mesh axis) or "ring" (parallel.ring_attention over the DeviceMesh
    # `attn_mesh`'s axis `attn_axis`)
    attention: str = "einsum"
    attn_mesh: object = None
    attn_axis: str = "sp"
    # per-block rematerialization of the full forward: "none", "full"
    # (`torch.utils.checkpoint` around each block: the backward recomputes
    # the block's forward) or "dots" (a selective checkpoint that saves
    # the outputs of mm / addmm / bmm / baddbmm and recomputes the rest)
    remat: str = "none"
    # layer-stacked params: params["blocks"] is one block pytree whose
    # leaves have a leading dim of `layers` (`stack_gpt_blocks`).  torch has
    # no stable scan, so every forward loops over the layer index and
    # `make_fx` unrolls the loop: the trace grows with depth where the JAX
    # package's `lax.scan` is traced once
    scan_layers: bool = False

    @staticmethod
    def small(**kw):
        return GPTConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab=128, seq=32, dim=32, heads=4, layers=2)
        base.update(kw)
        return GPTConfig(**base)


def gpt_init(cfg: GPTConfig, generator: torch.Generator,
             device=None) -> Dict:
    """Random float32 parameters drawn from `generator` (on its own
    device), then placed on `device` (default: the card).  The numbers
    differ from the JAX package's `gpt_init` for any seed; carry JAX
    weights across with `params_from_numpy` instead."""
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    def ln():
        return {"g": torch.ones(cfg.dim, device=device),
                "b": torch.zeros(cfg.dim, device=device)}

    def linear(n_in, n_out, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(n_in)
        return {"w": normal(n_in, n_out) * scale,
                "b": torch.zeros(n_out, device=device)}

    params = {
        "wte": normal(cfg.vocab, cfg.dim) * 0.02,
        "wpe": normal(cfg.seq, cfg.dim) * 0.01,
        "blocks": [],
        "ln_f": ln(),
    }
    proj_scale = 1.0 / math.sqrt(cfg.dim) / math.sqrt(2.0 * cfg.layers)
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln1": ln(),
            "attn": {"qkv": linear(cfg.dim, 3 * cfg.dim),
                     "proj": linear(cfg.dim, cfg.dim, proj_scale)},
            "ln2": ln(),
            "mlp": {"fc": linear(cfg.dim, 4 * cfg.dim),
                    "proj": linear(4 * cfg.dim, cfg.dim, proj_scale)},
        })
    if cfg.scan_layers:
        params["blocks"] = stack_gpt_blocks(params["blocks"])
    return params


def stack_gpt_blocks(blocks):
    """Per-layer block list -> one layer-stacked pytree (leading dim L)."""
    return _tree_map(lambda *xs: torch.stack(xs), *blocks)


def _block_list(params, cfg):
    """Per-layer block pytrees whether `params["blocks"]` is a list or the
    scan_layers layer-stacked form (views of the stacked leaves)."""
    blocks = params["blocks"]
    if cfg.scan_layers:
        return [_tree_map(lambda p, i=i: p[i], blocks)
                for i in range(cfg.layers)]
    return list(blocks)


def params_from_numpy(tree, device=None):
    """The JAX package's parameters (the nested dict/list that
    `jax.tree.map(np.asarray, params)` gives) as torch tensors on `device`
    (default: the card), same keys, same layouts."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x)).to(device)

    return conv(tree)


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)  # population variance
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _mlp(x, blk, dtype):
    h = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"]).to(dtype)
    h = F.gelu(h @ blk["mlp"]["fc"]["w"].to(dtype)
               + blk["mlp"]["fc"]["b"].to(dtype), approximate="tanh")
    return x + (h @ blk["mlp"]["proj"]["w"].to(dtype)
                + blk["mlp"]["proj"]["b"].to(dtype))


def _qkv(x, p_at, dtype):
    qkv = x @ p_at["qkv"]["w"].to(dtype) + p_at["qkv"]["b"].to(dtype)
    return qkv.chunk(3, dim=-1)


def _attention(x, p, cfg: GPTConfig, dtype, return_kv: bool = False):
    if cfg.attention not in ("einsum", "flash", "auto", "ring"):
        raise ValueError(f"GPTConfig.attention={cfg.attention!r}: one of "
                         f"'einsum', 'flash', 'auto', 'ring'")
    heads = cfg.heads
    b, t, d = x.shape
    hd = d // heads
    q, k, v = _qkv(x, p, dtype)

    def split_heads(t_):
        return t_.reshape(b, t, heads, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if cfg.attention == "auto":
        from easydist_tpu_torch.ops.attention_prim import attention

        out = attention(q, k, v, causal=True)
    elif cfg.attention == "flash":
        from easydist_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(q, k, v, True)
    elif cfg.attention == "ring":
        from easydist_tpu_torch.parallel import ring_attention

        out = ring_attention(q, k, v, cfg.attn_mesh, axis=cfg.attn_axis,
                             causal=True)
    else:
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        qi = torch.arange(t, device=x.device)[:, None]
        ki = torch.arange(t, device=x.device)[None, :]
        # the JAX model fills with -1e9 in the compute dtype (ops/ uses
        # -1e30)
        att = torch.where(ki <= qi, att, torch.tensor(
            -1e9, dtype=att.dtype, device=att.device))
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", att, v)
    out = out.transpose(1, 2).reshape(b, t, d)
    out = out @ p["proj"]["w"].to(dtype) + p["proj"]["b"].to(dtype)
    if return_kv:
        return out, k, v  # k, v: [b, heads, t, hd], pre-projection
    return out


def _block(blk, x, cfg: GPTConfig, dtype):
    x = x + _attention(
        _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype),
        blk["attn"], cfg, dtype)
    return _mlp(x, blk, dtype)


def _block_fn(cfg: GPTConfig, dtype):
    """`_block` under `cfg.remat`."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown GPTConfig.remat {cfg.remat!r}; "
                         f"expected none|full|dots")
    if cfg.remat == "none":
        return lambda blk, x: _block(blk, x, cfg, dtype)
    from torch.utils.checkpoint import checkpoint

    from easydist_tpu_torch.schedule.remat import dots_context, tag_dots_region

    if cfg.remat == "full":
        return lambda blk, x: checkpoint(_block, blk, x, cfg, dtype,
                                         use_reentrant=False)

    def dots(blk, x):
        return checkpoint(_block, blk, x, cfg, dtype, use_reentrant=False,
                          context_fn=dots_context)

    return lambda blk, x: tag_dots_region(dots, blk, x)


def gpt_apply(params, cfg: GPTConfig, tokens):
    """tokens: int [batch, seq] -> logits float32 [batch, seq, vocab]."""
    dtype = torch_dtype(cfg.dtype)
    block = _block_fn(cfg, dtype)
    tokens = tokens.long()
    x = params["wte"][tokens].to(dtype) \
        + params["wpe"].to(dtype)[None, :tokens.shape[1]]
    for blk in _block_list(params, cfg):
        x = block(blk, x)
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return x.float() @ params["wte"].T


def gpt_loss(params, cfg: GPTConfig, tokens, targets):
    """Mean next-token negative log-likelihood (f32)."""
    logp = F.log_softmax(gpt_apply(params, cfg, tokens), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None]).mean()


def make_gpt_train_step(cfg: GPTConfig, lr=1e-4):
    """Returns (train_step, init_state): state = (params, adam state);
    train_step(state, tokens, targets) -> ((params, opt), loss), a new
    state (nothing is updated in place).  init_state(generator,
    device=None) draws the params with `gpt_init`."""

    def init_state(generator: torch.Generator, device=None):
        params = gpt_init(cfg, generator, device=device)
        return (params, adam_init(params))

    def train_step(state, tokens, targets):
        params, opt = state
        loss, grads = value_and_grad(
            lambda p: gpt_loss(p, cfg, tokens, targets), params)
        new_params, new_opt = adam_update(params, grads, opt, lr=lr)
        return (new_params, new_opt), loss

    return train_step, init_state



def make_gpt_pipeline_step(cfg: GPTConfig, mesh, n_microbatches: int,
                           lr: float = 1e-4, axis: str = "pp",
                           data_axis=None, schedule: str = "gpipe",
                           n_virtual: int = 1):
    """Pipeline-parallel GPT training (the port of the JAX package's
    `make_gpt_pipeline_step`): the transformer blocks are pipelined over
    the mesh axis `axis` (`parallel.pipeline.spmd_pipeline_grad` with the
    head as its aux loss), the embedding sits in front of the pipelined
    middle and the final norm and tied head behind it.

    Every rank embeds the microbatches (stage 0 feeds them in), the last
    stage runs the head and the loss, and the pipeline returns the input
    gradients and the head's gradients summed over the pipeline group, so
    every rank forms the tied `wte` gradient as the JAX package does,
    embedding part + head part, and applies the same Adam update to the
    shared leaves.  A rank keeps only its own blocks: state = (params,
    adam state) with params {"wte", "wpe", "blocks": this rank's blocks in
    chunk order, "ln_f"}; `train_step.layers` lists their global indices.
    `mesh` may be `parallel.pipeline.LocalStages(n)`: every stage in this
    process, the whole model in the state.  `train_step.loss_and_grads(
    params, tokens, targets)` gives the loss and gradients without the
    update; `train_step.pipe.stats` each stage's P2P traffic.

    schedule "gpipe" / "remat" / "1f1b"; n_virtual > 1 interleaves chunks.
    Requires cfg.layers % (n_stages * n_virtual) == 0.  Returns
    (train_step, init_state): train_step(state, tokens, targets) ->
    (state, loss) with tokens [n_microbatches, mb, seq];
    init_state(generator, device=None, params=None) draws `gpt_init` (or
    takes the full `params`) and keeps this rank's part."""
    from easydist_tpu_torch import comm
    from easydist_tpu_torch.parallel._axes import local_block, mesh_axis
    from easydist_tpu_torch.parallel.pipeline import (LocalStages,
                                                      PipelineConfig,
                                                      spmd_pipeline_grad)

    if isinstance(mesh, LocalStages):
        n_stages, stage = mesh.n, None
    else:
        ax = mesh_axis(mesh, axis)
        n_stages, stage = ax.size, ax.index
    V = max(1, n_virtual)
    n_chunks = n_stages * V
    if cfg.layers % n_chunks != 0:
        raise ValueError(f"layers {cfg.layers} not divisible by "
                         f"{n_chunks} pipeline stages x virtual chunks")
    per_stage = cfg.layers // n_chunks
    owned = list(range(cfg.layers)) if stage is None else [
        (k * n_stages + stage) * per_stage + i
        for k in range(V) for i in range(per_stage)]
    dtype = torch_dtype(cfg.dtype)

    def stage_fn(stage_blocks, x):
        for i in range(per_stage):
            x = _block(_tree_map(lambda p: p[i], stage_blocks), x, cfg,
                       dtype)
        return x

    def head_loss(x_mb, targets_mb, hp):
        x = _layernorm(x_mb, hp["ln_f"]["g"], hp["ln_f"]["b"])
        logp = F.log_softmax(x.float() @ hp["wte"].T, dim=-1)
        return -torch.gather(logp, -1, targets_mb.long()[..., None]).mean()

    pipe_grad = spmd_pipeline_grad(
        stage_fn, head_loss, mesh,
        PipelineConfig(n_stages, n_microbatches, axis_name=axis,
                       schedule=schedule, data_axis=data_axis, n_virtual=V),
        aux=True)

    n_own = len(owned)

    def stack_blocks(blocks):
        # this rank's blocks -> [chunks, per_stage, ...] leading dims
        if cfg.scan_layers:
            return _tree_map(lambda p: p.reshape(
                (n_own // per_stage, per_stage) + tuple(p.shape[1:])),
                blocks)
        chunks = [_tree_map(lambda *xs: torch.stack(xs),
                            *blocks[c * per_stage:(c + 1) * per_stage])
                  for c in range(len(blocks) // per_stage)]
        return _tree_map(lambda *xs: torch.stack(xs), *chunks)

    def loss_and_grads(params, tokens_mb, targets_mb):
        tokens_mb = tokens_mb.long()
        seq = tokens_mb.shape[-1]
        with torch.enable_grad():
            wte = params["wte"].detach().requires_grad_()
            wpe = params["wpe"].detach().requires_grad_()
            x_mb = wte[tokens_mb].to(dtype) + wpe.to(dtype)[None, None, :seq]
        hp = {"ln_f": params["ln_f"], "wte": params["wte"]}
        loss, sgrads, dx_mb, dhp = pipe_grad(
            stack_blocks(params["blocks"]), x_mb.detach(), targets_mb, hp)
        x_emb = x_mb
        if data_axis is not None:
            dax = mesh_axis(mesh, data_axis)
            x_emb = local_block(x_mb, 1, dax.size, dax.index)
        dwte_emb, dwpe = torch.autograd.grad(x_emb, [wte, wpe], dx_mb)
        if data_axis is not None:
            dwte_emb = comm.all_reduce_sum(dwte_emb, dax.group)
            dwpe = comm.all_reduce_sum(dwpe, dax.group)
        if cfg.scan_layers:
            dblocks = _tree_map(
                lambda g: g.reshape((n_own,) + tuple(g.shape[2:])), sgrads)
        else:
            dblocks = [_tree_map(lambda g: g[c][i], sgrads)
                       for c in range(n_own // per_stage)
                       for i in range(per_stage)]
        grads = {"wte": dwte_emb + dhp["wte"], "wpe": dwpe,
                 "blocks": dblocks, "ln_f": dhp["ln_f"]}
        return loss, {k: grads[k] for k in params}

    def init_state(generator=None, device=None, params=None):
        full = params if params is not None else gpt_init(cfg, generator,
                                                          device=device)
        if cfg.scan_layers:
            idx = torch.tensor(owned)
            blocks = _tree_map(
                lambda p: p.index_select(0, idx.to(p.device)),
                full["blocks"])
        else:
            blocks = [full["blocks"][i] for i in owned]
        local = {k: (v if k != "blocks" else blocks)
                 for k, v in full.items()}
        return (local, adam_init(local))

    def train_step(state, tokens_mb, targets_mb):
        params, opt = state
        loss, grads = loss_and_grads(params, tokens_mb, targets_mb)
        new_params, new_opt = adam_update(params, grads, opt, lr=lr)
        return (new_params, new_opt), loss

    train_step.layers = owned
    train_step.pipe = pipe_grad
    train_step.loss_and_grads = loss_and_grads
    return train_step, init_state


# --------------------------------------------------------- KV-cache decode


def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int, dtype=None,
                  device=None):
    """Zeroed KV cache {"k", "v"}: [layers, batch, heads, max_len,
    head_dim] on `device` (default: the card).  `dtype=None`/"auto"
    stores at the compute dtype."""
    if max_len > cfg.seq:
        raise ValueError(
            f"max_len {max_len} exceeds the learned position table "
            f"(cfg.seq={cfg.seq})")
    device = resolve_device(device)
    hd = cfg.dim // cfg.heads
    dt = torch_dtype(cfg.dtype if dtype in (None, "auto") else dtype)
    shape = (cfg.layers, batch, cfg.heads, max_len, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _cache_write_row(cache_layer, new, pos):
    """Write one new K or V row per sequence, in place: cache_layer
    [b, h, T, hd], new [b, h, hd], pos int [b] -> cache_layer.  The
    position clamps into [0, T-1] as `dynamic_update_slice` clamps."""
    b, _, t, _ = cache_layer.shape
    p = pos.long().clamp(0, t - 1)
    rows = torch.arange(b, device=cache_layer.device)
    cache_layer[rows, :, p] = new.to(cache_layer.dtype)
    return cache_layer


def _cache_write_chunk(cache_layer, new, start):
    """Write a fixed-size chunk of K or V rows per sequence, in place:
    cache_layer [b, h, T, hd], new [b, h, c, hd], start int [b] ->
    cache_layer.  The start clamps into [0, T-c] as
    `dynamic_update_slice` clamps."""
    b, _, t, _ = cache_layer.shape
    c = new.shape[2]
    s = start.long().clamp(0, t - c)
    pos = s[:, None] + torch.arange(c, device=cache_layer.device)[None, :]
    rows = torch.arange(b, device=cache_layer.device)[:, None]
    # advanced indices on dims 0 and 2 put [b, c] first: value [b, c, h, hd]
    cache_layer[rows, :, pos] = new.transpose(1, 2).to(cache_layer.dtype)
    return cache_layer


def gpt_prefill(params, cfg: GPTConfig, cache, tokens, lengths):
    """Prompt pass: run `tokens` (int [batch, t], padded) through the
    model, write every position's K/V into `cache` (in place), and return
    (cache, logits [batch, vocab]) at each row's last real position
    (`lengths` - 1)."""
    dtype = torch_dtype(cfg.dtype)
    tokens = tokens.long()
    b, t = tokens.shape
    x = params["wte"][tokens].to(dtype) + params["wpe"].to(dtype)[None, :t]
    ks, vs = [], []
    for blk in _block_list(params, cfg):
        attn_out, k, v = _attention(
            _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype),
            blk["attn"], cfg, dtype, return_kv=True)
        x = x + attn_out
        ks.append(k)
        vs.append(v)
        x = _mlp(x, blk, dtype)
    cache["k"][:, :, :, :t] = torch.stack(ks).to(cache["k"].dtype)
    cache["v"][:, :, :, :t] = torch.stack(vs).to(cache["v"].dtype)
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    rows = torch.arange(b, device=x.device)
    last = x[rows, lengths.long() - 1]
    return cache, last.float() @ params["wte"].T


def _chunk_hidden(params, cfg: GPTConfig, cache, tokens, start):
    """The trunk `gpt_prefill_chunk` and `gpt_verify_step` share: run
    `tokens` (int [batch, s]) at absolute positions `start + [0..s)` (int
    [batch]), write their K/V into `cache` (in place) at those positions
    (clamped as `_cache_write_chunk` clamps), attend the FULL cache window
    with a `key_pos <= query_pos` mask, and return the final hidden
    states [batch, s, dim] after ln_f."""
    from easydist_tpu_torch.ops import chunk_attention

    dtype = torch_dtype(cfg.dtype)
    heads = cfg.heads
    b, s = tokens.shape
    hd = cfg.dim // heads
    abs_pos = start[:, None] + torch.arange(s, device=tokens.device)[None]
    x = params["wte"][tokens.long()].to(dtype) \
        + params["wpe"][abs_pos].to(dtype)
    for li, blk in enumerate(_block_list(params, cfg)):
        p_at = blk["attn"]
        h_in = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype)
        q, k, v = _qkv(h_in, p_at, dtype)
        q = q.reshape(b, s, heads, hd).transpose(1, 2)
        k = k.reshape(b, s, heads, hd).transpose(1, 2)
        v = v.reshape(b, s, heads, hd).transpose(1, 2)
        ck = _cache_write_chunk(cache["k"][li], k, start)
        cv = _cache_write_chunk(cache["v"][li], v, start)
        att = chunk_attention(q, ck.to(dtype), cv.to(dtype), abs_pos)
        att = att.transpose(1, 2).reshape(b, s, cfg.dim)
        x = x + (att @ p_at["proj"]["w"].to(dtype)
                 + p_at["proj"]["b"].to(dtype))
        x = _mlp(x, blk, dtype)
    return _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])


def _last_real_logits(params, x, start, lengths):
    """Logits [batch, vocab] at each row's last real position of a chunk
    whose hidden states `x` [batch, c, dim] start at `start` (int
    [batch]); garbage for rows whose chunk does not hold `lengths - 1`."""
    b, c_len = x.shape[:2]
    rel_last = (lengths.long() - 1 - start).clamp(0, c_len - 1)
    last = x[torch.arange(b, device=x.device), rel_last]
    return last.float() @ params["wte"].T


def gpt_prefill_chunk(params, cfg: GPTConfig, cache, tokens, start_pos,
                      lengths):
    """One fixed-size prefill chunk: run `tokens` (int [batch, chunk]) at
    absolute positions `start_pos + [0..chunk)` (int [batch]), write the
    chunk's K/V into `cache` (in place) at those positions, and return
    (cache, logits [batch, vocab]) taken at each row's last real position
    — valid for rows whose chunk holds `lengths - 1`, garbage otherwise.

    Attends the FULL cache window with a `key_pos <= query_pos` mask, so
    the traced shape is independent of how much prompt is cached: one
    compiled signature per bucket, and restored prefix chunks are
    consumed exactly as if recomputed."""
    start = start_pos.long()
    x = _chunk_hidden(params, cfg, cache, tokens, start)
    return cache, _last_real_logits(params, x, start, lengths)


def gpt_verify_step(params, cfg: GPTConfig, cache, tokens, pos):
    """Speculative-decoding verify step: score `tokens` (int [batch, s] —
    each row is [last committed token, draft_0, ..., draft_{s-2}]) at
    absolute positions `pos + [0..s)` in ONE forward, write their K/V
    into `cache` (in place) at those positions, and return (cache,
    logits [batch, s, vocab]) for ALL s positions, so the host can accept
    the longest greedily-matching draft prefix.

    The trunk is `gpt_prefill_chunk`'s with s as the chunk length: the
    write starts at `pos` (clamped as `_cache_write_chunk` clamps; one
    traced signature per (bucket, s)) and attention over the full cache
    window is masked to `key_pos <= query_pos`, so position i's logits
    equal what `gpt_decode_step` gives after feeding the first i tokens
    one by one — rejected-draft rows written past the accept boundary are
    the stale rows the mask keeps out of every later step.  Callers must
    guarantee pos + s <= T (the write would otherwise be clamped onto
    committed rows)."""
    x = _chunk_hidden(params, cfg, cache, tokens, pos.long())
    return cache, x.float() @ params["wte"].T


def gpt_decode_step(params, cfg: GPTConfig, cache, token, pos):
    """One cached decode step: feed `token` (int [batch]) at position
    `pos` (int [batch], == current sequence length per row), write its
    K/V into `cache` (in place), and return (cache, logits [batch,
    vocab]).  Attention is `ops.decode_attention`: the CUDA kernel on the
    card, the plain version on the CPU."""
    from easydist_tpu_torch.ops import decode_attention

    dtype = torch_dtype(cfg.dtype)
    heads = cfg.heads
    b = token.shape[0]
    hd = cfg.dim // heads
    pos = pos.to(torch.int32)
    x = params["wte"][token.long()].to(dtype) \
        + params["wpe"][pos.long()].to(dtype)
    for li, blk in enumerate(_block_list(params, cfg)):
        p_at = blk["attn"]
        h_in = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype)
        q, k, v = _qkv(h_in, p_at, dtype)
        q = q.reshape(b, heads, hd)
        ck = _cache_write_row(cache["k"][li], k.reshape(b, heads, hd), pos)
        cv = _cache_write_row(cache["v"][li], v.reshape(b, heads, hd), pos)
        att = decode_attention(q, ck.to(dtype), cv.to(dtype), pos + 1)
        x = x + (att.reshape(b, cfg.dim) @ p_at["proj"]["w"].to(dtype)
                 + p_at["proj"]["b"].to(dtype))
        x = _mlp(x, blk, dtype)
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return cache, x.float() @ params["wte"].T


# ------------------------------------------------------- paged KV decode
#
# Page-table variants of the serving forwards: K/V lives in one
# preallocated page arena ({"k", "v"}: [layers, n_pages + 1, heads,
# page_tokens, head_dim]) and each sequence's int32 page-table row says
# which arena page holds each `page_tokens`-token window.  The arena is
# written in place, as the contiguous cache is.  Unmapped entries hold
# the sentinel `n_pages`, which is the index of the arena's last page,
# the drop page: writes through a sentinel land there (the JAX package
# discards them with mode="drop"; torch's indexed writes have no such
# mode, and clamping the sentinel onto a real page would race a live
# row's write to the same place).  Every read takes the allocatable view
# `layer[:n_pages]` and clips page ids into it, so the drop page is never
# read and the gathered cache equals the JAX package's.


def init_kv_pages(cfg: GPTConfig, n_pages: int, page_tokens: int,
                  dtype=None, quant_dtype=None, quant_block: int = 0,
                  device=None):
    """Zeroed page arena {"k", "v"}: [layers, n_pages + 1, heads,
    page_tokens, head_dim] on `device` (default: the card): `n_pages`
    allocatable pages and the drop page.  Pages replace the batch axis
    of `init_kv_cache` at the same dim index.

    `quant_dtype="int8"` stores the payload block-scaled int8 and adds a
    parallel scale arena {"k_scale", "v_scale"}: [layers, n_pages + 1,
    heads, page_tokens, head_dim // block] f32 (`quant_block` 0 = one
    block per row).  The scale keys are the quant signal every paged
    forward branches on."""
    if n_pages < 1:
        raise ValueError(f"n_pages must be >= 1, got {n_pages}")
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    device = resolve_device(device)
    hd = cfg.dim // cfg.heads
    dt = torch_dtype(cfg.dtype if dtype in (None, "auto") else dtype)
    shape = (cfg.layers, n_pages + 1, cfg.heads, page_tokens, hd)
    if quant_dtype in (None, "none"):
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if quant_dtype != "int8":
        raise ValueError(f"quant_dtype must be None/'none'/'int8', "
                         f"got {quant_dtype!r}")
    block = quant_block or hd
    if hd % block:
        raise ValueError(f"quant_block {block} must divide head_dim {hd}")
    sshape = shape[:-1] + (hd // block,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}


def _arena_pages(pages) -> int:
    """Allocatable pages of an `init_kv_pages` arena (the last page is
    the drop page)."""
    return pages["k"].shape[1] - 1


def _pages_write_row(pages_layer, new, write_page, offset):
    """Write one new K or V row per sequence through the page table, in
    place: pages_layer [n_pages + 1, h, pt, hd], new [b, h, hd],
    write_page int [b] (the page holding each row's current window; the
    sentinel, i.e. the drop page, for dead rows), offset int [b].  The two
    advanced indices put the batch dim in front of the update."""
    pages_layer[write_page.long(), :, offset.long()] = new.to(
        pages_layer.dtype)
    return pages_layer


def _kv_operand(pages_layer, dtype):
    """An arena layer as decode attention's K/V operand: in its storage
    dtype where widening it to the compute dtype is exact (the same dtype,
    or bfloat16 pages under float32 compute — attention reads K/V in f32
    either way), else cast as the JAX model casts it."""
    if pages_layer.dtype == dtype or (pages_layer.dtype == torch.bfloat16
                                      and dtype == torch.float32):
        return pages_layer
    return pages_layer.to(dtype)


def _pages_write_rows(pages_layer, new, write_page, offset):
    """Write `s` consecutive K or V rows per sequence through the page
    table, in place: pages_layer [n_pages + 1, h, pt, hd], new [b, h, s,
    hd], write_page / offset int [b, s] (per position — a run of s
    positions may straddle a page boundary, so each resolves its own
    page).  The advanced indices broadcast to [b, s] in front of the
    update; sentinel pages are the drop page, so dead rows touch no
    allocatable page."""
    pages_layer[write_page.long(), :, offset.long()] = \
        new.transpose(1, 2).to(pages_layer.dtype)
    return pages_layer


def _chunk_hidden_paged(params, cfg: GPTConfig, pages, table, tokens,
                        start, wp, off):
    """`_chunk_hidden` against the page arena, the trunk
    `gpt_prefill_chunk_paged` and `gpt_verify_step_paged` share: the s
    positions' K/V rows land (in place) in arena page `wp` at offset
    `off` (int [batch, s] each, per position), int8 pages quantizing on
    write; attention gathers the virtual contiguous cache [batch, heads,
    max_pages * page_tokens, head_dim] through `table` AFTER the write,
    so the chunk attends its own fresh rows (plain torch, as the JAX
    package leaves it to XLA).  Returns the hidden states [batch, s, dim]
    after ln_f."""
    from easydist_tpu_torch.ops import (chunk_attention, gather_pages,
                                        kv_dequantize, kv_quantize)

    dtype = torch_dtype(cfg.dtype)
    heads = cfg.heads
    b, s = tokens.shape
    n_pages = _arena_pages(pages)
    quant_nb = pages["k_scale"].shape[-1] if "k_scale" in pages else 0
    hd = cfg.dim // heads
    tbl = table.long()
    abs_pos = start[:, None] + torch.arange(s, device=tokens.device)[None]
    x = params["wte"][tokens.long()].to(dtype) \
        + params["wpe"][abs_pos].to(dtype)
    for li, blk in enumerate(_block_list(params, cfg)):
        p_at = blk["attn"]
        h_in = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype)
        q, k, v = _qkv(h_in, p_at, dtype)
        q = q.reshape(b, s, heads, hd).transpose(1, 2)
        k = k.reshape(b, s, heads, hd).transpose(1, 2)
        v = v.reshape(b, s, heads, hd).transpose(1, 2)
        if quant_nb:
            # quantize-on-commit: the page stores block-scaled int8, the
            # scale page rides the same write/gather indices
            k, sk = kv_quantize(k, quant_nb)
            v, sv = kv_quantize(v, quant_nb)
            psk = _pages_write_rows(pages["k_scale"][li], sk, wp, off)
            psv = _pages_write_rows(pages["v_scale"][li], sv, wp, off)
        pk = _pages_write_rows(pages["k"][li], k, wp, off)
        pv = _pages_write_rows(pages["v"][li], v, wp, off)
        if quant_nb:
            ck = kv_dequantize(gather_pages(pk[:n_pages], tbl),
                               gather_pages(psk[:n_pages], tbl), dtype)
            cv = kv_dequantize(gather_pages(pv[:n_pages], tbl),
                               gather_pages(psv[:n_pages], tbl), dtype)
        else:
            ck = gather_pages(pk[:n_pages], tbl)
            cv = gather_pages(pv[:n_pages], tbl)
        att = chunk_attention(q, ck.to(dtype), cv.to(dtype), abs_pos)
        att = att.transpose(1, 2).reshape(b, s, cfg.dim)
        x = x + (att @ p_at["proj"]["w"].to(dtype)
                 + p_at["proj"]["b"].to(dtype))
        x = _mlp(x, blk, dtype)
    return _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])


def gpt_prefill_chunk_paged(params, cfg: GPTConfig, pages, table, tokens,
                            start_pos, lengths):
    """`gpt_prefill_chunk` with the cache indirected through a page table:
    `pages` is the arena (written in place), `table` int [batch,
    max_pages] maps each row's windows to arena pages (sentinel-padded),
    and the chunk's K/V is written INTO the row's page for window
    `start_pos // page_tokens` — no staging cache and no restore copy; a
    restored prefix is table entries pointing at the trie's pages.
    Returns (pages, logits [batch, vocab]) at each row's last real
    position.  Requires tokens.shape[1] == page_tokens."""
    b, c_len = tokens.shape
    pt = pages["k"].shape[3]
    if c_len != pt:
        raise ValueError(f"paged prefill chunk {c_len} != page_tokens {pt} "
                         f"(chunks must fill exactly one page)")
    start = start_pos.long()
    # the page receiving this chunk (the drop page for inactive rows),
    # every position of it at its own offset
    wp = table.long().gather(1, (start // pt)[:, None]).expand(b, c_len)
    off = torch.arange(c_len, device=tokens.device)[None].expand(b, c_len)
    x = _chunk_hidden_paged(params, cfg, pages, table, tokens, start, wp,
                            off)
    return pages, _last_real_logits(params, x, start, lengths)


def gpt_verify_step_paged(params, cfg: GPTConfig, pages, table, tokens,
                          pos):
    """`gpt_verify_step` against the page arena: the s positions' K/V
    rows land (in place) through the table per position (window
    `(pos + i) // page_tokens`, offset `(pos + i) % page_tokens` — a
    verify window may straddle a page boundary, unlike page-aligned
    prefill chunks; a window past the table's end goes to the drop page,
    as the JAX package's out-of-range take drops it), and attention
    gathers the virtual contiguous cache through the table as the paged
    prefill chunk does (plain torch).  Int8 pages quantize on write and
    dequantize after the gather.  Returns (pages, logits [batch, s,
    vocab]) for all s positions.  Callers must have every touched window
    mapped (or the whole row sentinel — dead rows drop); rejected
    positions live in mapped pages until the host truncates the table
    tail past the reservation."""
    s = tokens.shape[1]
    pt = pages["k"].shape[3]
    start = pos.long()
    tbl = table.long()
    abs_pos = start[:, None] + torch.arange(s, device=tokens.device)[None]
    # per-position page + offset: [b, s] each (sentinel rows stay
    # sentinel through the gather, so every write of a dead row drops)
    win = abs_pos // pt
    inside = win < tbl.shape[1]
    wp = torch.where(inside, tbl.gather(1, win.clamp(max=tbl.shape[1] - 1)),
                     torch.full_like(win, _arena_pages(pages)))
    x = _chunk_hidden_paged(params, cfg, pages, table, tokens, start, wp,
                            abs_pos % pt)
    return pages, x.float() @ params["wte"].T


def gpt_decode_step_paged(params, cfg: GPTConfig, pages, table, token,
                          pos):
    """`gpt_decode_step` against the page arena: the new token's K/V row
    lands (in place) in the page holding window `pos // page_tokens` at
    offset `pos % page_tokens`, and attention runs through
    `ops.paged_decode_attention` (B5 on exact pages, B6 on int8 pages,
    the plain versions on the CPU).  The arena reaches the kernel in its
    storage dtype, as a view: no arena-sized copy per layer.  The table's
    fixed [batch, max_pages] shape keeps ONE traced signature across
    every per-row length."""
    from easydist_tpu_torch.ops import kv_quantize, paged_decode_attention

    dtype = torch_dtype(cfg.dtype)
    heads = cfg.heads
    b = token.shape[0]
    pt = pages["k"].shape[3]
    n_pages = _arena_pages(pages)
    quant_nb = pages["k_scale"].shape[-1] if "k_scale" in pages else 0
    hd = cfg.dim // heads
    pos = pos.to(torch.int32)
    tbl = table.to(torch.int32)
    wp = tbl.long().gather(1, (pos.long() // pt)[:, None])[:, 0]
    off = pos.long() % pt
    x = params["wte"][token.long()].to(dtype) \
        + params["wpe"][pos.long()].to(dtype)
    for li, blk in enumerate(_block_list(params, cfg)):
        p_at = blk["attn"]
        h_in = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype)
        q, k, v = _qkv(h_in, p_at, dtype)
        q = q.reshape(b, heads, hd)
        k = k.reshape(b, heads, hd)
        v = v.reshape(b, heads, hd)
        if quant_nb:
            k, sk = kv_quantize(k, quant_nb)
            v, sv = kv_quantize(v, quant_nb)
            psk = _pages_write_row(pages["k_scale"][li], sk, wp, off)
            psv = _pages_write_row(pages["v_scale"][li], sv, wp, off)
        pk = _pages_write_row(pages["k"][li], k, wp, off)
        pv = _pages_write_row(pages["v"][li], v, wp, off)
        if quant_nb:
            # int8 pages stream to the kernel as stored; it dequantizes
            # inside its loop (the plain version after the gather)
            att = paged_decode_attention(
                q, pk[:n_pages], pv[:n_pages], tbl, pos + 1,
                k_scale=psk[:n_pages], v_scale=psv[:n_pages])
        else:
            att = paged_decode_attention(
                q, _kv_operand(pk[:n_pages], dtype),
                _kv_operand(pv[:n_pages], dtype), tbl, pos + 1)
        x = x + (att.reshape(b, cfg.dim) @ p_at["proj"]["w"].to(dtype)
                 + p_at["proj"]["b"].to(dtype))
        x = _mlp(x, blk, dtype)
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return pages, x.float() @ params["wte"].T
