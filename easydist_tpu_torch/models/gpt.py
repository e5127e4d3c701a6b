"""GPT-2-style decoder transformer in PyTorch: the port of
easydist_tpu/models/gpt.py's forwards, serving steps and train step
(`gpt_loss`, `make_gpt_train_step` with Adam).

Functional, like the JAX model: parameters are the JAX package's nested
dict/list with the same keys and layouts (`w` is [n_in, n_out]; no
transposed `nn.Linear`), so `params_from_numpy` carries the JAX
package's weights across.  Params stay float32 and are cast to
`cfg.dtype` at each use; logits are `x.float() @ wte.T`.

Two differences from the JAX functions, both deliberate:
  * the KV cache is written IN PLACE (`index_put_` into the cache the
    caller passed, which is also returned) where the JAX package returns
    a new cache and relies on buffer donation — callers that need the
    old cache clone it first;
  * row and chunk cache writes clamp their start so the write fits,
    exactly as `jax.lax.dynamic_update_slice` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from easydist_tpu_torch import resolve_device, torch_dtype

from .optim import adam_init, adam_update, value_and_grad


@dataclass
class GPTConfig:
    vocab: int = 50257
    seq: int = 1024
    dim: int = 768
    heads: int = 12
    layers: int = 12
    dtype: str = "float32"  # compute dtype; params stay float32
    # attention backend of the full forward: "einsum" (plain torch) or
    # "flash" (ops.flash_attention: the CUDA kernels B1-B3 on the card);
    # "ring" and "auto" are not ported yet
    attention: str = "einsum"

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
    return params


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
    if cfg.attention not in ("einsum", "flash"):
        raise NotImplementedError(
            f"GPTConfig.attention={cfg.attention!r} is not ported yet; the "
            f"port has the 'einsum' and 'flash' backends")
    heads = cfg.heads
    b, t, d = x.shape
    hd = d // heads
    q, k, v = _qkv(x, p, dtype)

    def split_heads(t_):
        return t_.reshape(b, t, heads, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if cfg.attention == "flash":
        from easydist_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(q, k, v, True)
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


def gpt_apply(params, cfg: GPTConfig, tokens):
    """tokens: int [batch, seq] -> logits float32 [batch, seq, vocab]."""
    dtype = torch_dtype(cfg.dtype)
    tokens = tokens.long()
    x = params["wte"][tokens].to(dtype) \
        + params["wpe"].to(dtype)[None, :tokens.shape[1]]
    for blk in params["blocks"]:
        x = x + _attention(
            _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype),
            blk["attn"], cfg, dtype)
        x = _mlp(x, blk, dtype)
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
    for blk in params["blocks"]:
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
    from easydist_tpu_torch.ops import chunk_attention

    dtype = torch_dtype(cfg.dtype)
    heads = cfg.heads
    b, c_len = tokens.shape
    hd = cfg.dim // heads
    start = start_pos.long()
    abs_pos = start[:, None] + torch.arange(c_len, device=tokens.device)[None]
    x = params["wte"][tokens.long()].to(dtype) \
        + params["wpe"][abs_pos].to(dtype)
    for li, blk in enumerate(params["blocks"]):
        p_at = blk["attn"]
        h_in = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"]).to(dtype)
        q, k, v = _qkv(h_in, p_at, dtype)
        q = q.reshape(b, c_len, heads, hd).transpose(1, 2)
        k = k.reshape(b, c_len, heads, hd).transpose(1, 2)
        v = v.reshape(b, c_len, heads, hd).transpose(1, 2)
        ck = _cache_write_chunk(cache["k"][li], k, start)
        cv = _cache_write_chunk(cache["v"][li], v, start)
        att = chunk_attention(q, ck.to(dtype), cv.to(dtype), abs_pos)
        att = att.transpose(1, 2).reshape(b, c_len, cfg.dim)
        x = x + (att @ p_at["proj"]["w"].to(dtype)
                 + p_at["proj"]["b"].to(dtype))
        x = _mlp(x, blk, dtype)
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    rel_last = (lengths.long() - 1 - start).clamp(0, c_len - 1)
    last = x[torch.arange(b, device=x.device), rel_last]
    return cache, last.float() @ params["wte"].T


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
    for li, blk in enumerate(params["blocks"]):
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
