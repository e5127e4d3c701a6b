"""Llama-style decoder in PyTorch (RMSNorm, rotary embeddings, SwiGLU,
grouped-query attention): the port of easydist_tpu/models/llama.py's
forwards, serving steps (bucketed and paged KV, with the speculative
verify steps) and train step (`llama_loss`, `make_llama_train_step` with
Adam).

Functional, like the JAX model: parameters are the JAX package's nested
dict/list with the same keys and layouts (`w*` is [n_in, n_out]), so
`params_from_numpy` (re-exported from models/gpt.py) carries the JAX
package's weights across.  Params stay float32 and are cast to
`cfg.dtype` at each use; logits are `x.float() @ wte.T` (the LM head is
tied to `wte`, as in the JAX model).  RoPE rotates interleaved pairs
(dims 2i, 2i+1), the JAX model's layout, not HF's `rotate_half`.

The cache and the page arena store ROPED keys at kv_heads granularity;
every attention repeats K/V to the full heads GQA-style
(`repeat_interleave` on the head dim: query head h reads kv head
h // (heads // kv_heads), the map the decode kernels use) after the
write, so the bucketed and paged layouts attend identical operands.

The port's differences from the JAX functions are GPT's
(models/gpt.py): caches and arenas are written in place, row and chunk
writes clamp their start as `dynamic_update_slice` does, and the arena
holds one extra page, the drop page, for the writes the JAX package
discards with mode="drop".
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from easydist_tpu_torch import resolve_device, torch_dtype

from .gpt import (_arena_pages, _cache_write_chunk, _cache_write_row,
                  _kv_operand, _last_real_logits, _pages_write_row,
                  _pages_write_rows, params_from_numpy)
from .optim import adam_init, adam_update, value_and_grad

__all__ = ["LlamaConfig", "llama_init", "llama_apply", "llama_loss",
           "make_llama_train_step", "init_kv_cache", "llama_prefill",
           "llama_prefill_chunk", "llama_verify_step", "llama_decode_step",
           "init_kv_pages", "llama_prefill_chunk_paged",
           "llama_verify_step_paged", "llama_decode_step_paged",
           "params_from_numpy"]


@dataclass
class LlamaConfig:
    vocab: int = 32000
    seq: int = 2048
    dim: int = 4096
    heads: int = 32
    kv_heads: int = 32
    layers: int = 32
    ffn_dim: int = 11008
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"  # compute dtype; params stay float32

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab=128, seq=32, dim=32, heads=4, kv_heads=2, layers=2,
                    ffn_dim=64, dtype="float32")
        base.update(kw)
        return LlamaConfig(**base)


def llama_init(cfg: LlamaConfig, generator: torch.Generator,
               device=None) -> Dict:
    """Random float32 parameters drawn from `generator` (on its own
    device), then placed on `device` (default: the card).  The numbers
    differ from the JAX package's `llama_init` for any seed; carry JAX
    weights across with `params_from_numpy` instead."""
    device = resolve_device(device)
    hd = cfg.dim // cfg.heads

    def normal(scale, *shape):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return x.mul_(scale).to(device)

    def ones():
        return torch.ones(cfg.dim, device=device)

    params = {"wte": normal(0.02, cfg.vocab, cfg.dim), "blocks": [],
              "norm_f": ones()}
    scale = 1.0 / math.sqrt(cfg.dim)
    for _ in range(cfg.layers):
        params["blocks"].append({
            "attn_norm": ones(),
            "wq": normal(scale, cfg.dim, cfg.heads * hd),
            "wk": normal(scale, cfg.dim, cfg.kv_heads * hd),
            "wv": normal(scale, cfg.dim, cfg.kv_heads * hd),
            "wo": normal(scale, cfg.heads * hd, cfg.dim),
            "ffn_norm": ones(),
            "w_gate": normal(scale, cfg.dim, cfg.ffn_dim),
            "w_up": normal(scale, cfg.dim, cfg.ffn_dim),
            "w_down": normal(1.0 / math.sqrt(cfg.ffn_dim), cfg.ffn_dim,
                             cfg.dim),
        })
    return params


def _rmsnorm(x, g, eps=1e-5):
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * g


def _freqs(d: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def _rotate(x, cos, sin):
    """Rotate the interleaved pairs (x[..., 2i], x[..., 2i+1]) of `x` by
    angles whose cos / sin broadcast against x[..., 0::2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def _rope(x, theta):
    """x: [b, h, t, d]; rotate pairs along d with position-dependent
    angles (positions 0..t-1)."""
    t, d = x.shape[2], x.shape[3]
    pos = torch.arange(t, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * _freqs(d, theta, x.device)[None, :]    # [t, d/2]
    return _rotate(x, torch.cos(ang), torch.sin(ang))


def _rope_at(x, pos, theta):
    """x: [b, n, d] single-position heads rotated at absolute positions
    `pos` (int [b]) — the decode-time form of `_rope`."""
    d = x.shape[-1]
    ang = pos.float()[:, None] * _freqs(d, theta, x.device)[None, :]
    return _rotate(x, torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :])


def _rope_abs(x, pos, theta):
    """x: [b, n, c, d] chunk heads rotated at absolute positions `pos`
    (int [b, c]) — the chunked-prefill form of `_rope` / `_rope_at`."""
    d = x.shape[-1]
    ang = pos.float()[..., None] * _freqs(d, theta, x.device)  # [b, c, d/2]
    return _rotate(x, torch.cos(ang)[:, None], torch.sin(ang)[:, None])


def _repeat_kv(x, cfg: LlamaConfig):
    """[b, kv_heads, ...] -> [b, heads, ...]: each kv head repeated
    heads // kv_heads times in place (`jnp.repeat(x, rep, axis=1)`)."""
    rep = cfg.heads // cfg.kv_heads
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def _split_heads(y, n: int, hd: int):
    b, t = y.shape[:2]
    return y.reshape(b, t, n, hd).transpose(1, 2)


def _qkv(hx, blk, cfg: LlamaConfig, dtype):
    """Projected q [.., heads, hd], k and v [.., kv_heads, hd] of a
    normed input [b, t, dim] as [b, n, t, hd]."""
    hd = cfg.dim // cfg.heads
    return (_split_heads(hx @ blk["wq"].to(dtype), cfg.heads, hd),
            _split_heads(hx @ blk["wk"].to(dtype), cfg.kv_heads, hd),
            _split_heads(hx @ blk["wv"].to(dtype), cfg.kv_heads, hd))


def _ffn(x, blk, dtype):
    hx = _rmsnorm(x, blk["ffn_norm"]).to(dtype)
    gated = F.silu(hx @ blk["w_gate"].to(dtype)) * (hx @ blk["w_up"].to(dtype))
    return x + gated @ blk["w_down"].to(dtype)


def _causal_attention(q, k, v, cfg: LlamaConfig):
    """Masked einsum attention of the full forward: q [b, heads, t, hd],
    k / v [b, kv_heads, t, hd] (repeated here)."""
    t, hd = q.shape[2], q.shape[3]
    k, v = _repeat_kv(k, cfg), _repeat_kv(v, cfg)
    att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    qi = torch.arange(t, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    att = torch.where(ki <= qi, att, torch.tensor(-1e9, dtype=att.dtype,
                                                  device=att.device))
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def _merge_heads(out, cfg: LlamaConfig):
    b, _, t, hd = out.shape
    return out.transpose(1, 2).reshape(b, t, cfg.heads * hd)


def _roped_block(x, blk, cfg: LlamaConfig, dtype):
    """One block's attention input: (q, k) roped at 0..t-1, and v."""
    q, k, v = _qkv(_rmsnorm(x, blk["attn_norm"]).to(dtype), blk, cfg, dtype)
    q = _rope(q.float(), cfg.rope_theta).to(dtype)
    k = _rope(k.float(), cfg.rope_theta).to(dtype)
    return q, k, v


def llama_apply(params, cfg: LlamaConfig, tokens):
    """tokens: int [batch, seq] -> logits float32 [batch, seq, vocab]."""
    dtype = torch_dtype(cfg.dtype)
    x = params["wte"][tokens.long()].to(dtype)
    for blk in params["blocks"]:
        q, k, v = _roped_block(x, blk, cfg, dtype)
        x = x + _merge_heads(_causal_attention(q, k, v, cfg), cfg) \
            @ blk["wo"].to(dtype)
        x = _ffn(x, blk, dtype)
    x = _rmsnorm(x, params["norm_f"])
    return x.float() @ params["wte"].T


def llama_loss(params, cfg: LlamaConfig, tokens, targets):
    """Mean next-token negative log-likelihood (f32)."""
    logp = F.log_softmax(llama_apply(params, cfg, tokens), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None]).mean()


def make_llama_train_step(cfg: LlamaConfig, lr=1e-4):
    """Returns (train_step, init_state): state = (params, adam state);
    train_step(state, tokens, targets) -> ((params, opt), loss), a new
    state.  init_state(generator, device=None) draws `llama_init`."""

    def init_state(generator: torch.Generator, device=None):
        params = llama_init(cfg, generator, device=device)
        return (params, adam_init(params))

    def train_step(state, tokens, targets):
        params, opt = state
        loss, grads = value_and_grad(
            lambda p: llama_loss(p, cfg, tokens, targets), params)
        new_params, new_opt = adam_update(params, grads, opt, lr=lr)
        return (new_params, new_opt), loss

    return train_step, init_state


# --------------------------------------------------------- KV-cache decode


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None):
    """Zeroed KV cache {"k", "v"}: [layers, batch, kv_heads, max_len,
    head_dim] on `device` (default: the card).  No position-table bound:
    RoPE extends to any max_len."""
    device = resolve_device(device)
    hd = cfg.dim // cfg.heads
    dt = torch_dtype(cfg.dtype if dtype in (None, "auto") else dtype)
    shape = (cfg.layers, batch, cfg.kv_heads, max_len, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def llama_prefill(params, cfg: LlamaConfig, cache, tokens, lengths):
    """Prompt pass: fill `cache` (in place) with the prompt's roped K and
    V and return (cache, logits [batch, vocab]) at each row's last real
    position.  Positions < length compute exactly what `llama_apply`
    computes."""
    dtype = torch_dtype(cfg.dtype)
    tokens = tokens.long()
    b, t = tokens.shape
    x = params["wte"][tokens].to(dtype)
    ks, vs = [], []
    for blk in params["blocks"]:
        q, k, v = _roped_block(x, blk, cfg, dtype)
        ks.append(k)
        vs.append(v)
        x = x + _merge_heads(_causal_attention(q, k, v, cfg), cfg) \
            @ blk["wo"].to(dtype)
        x = _ffn(x, blk, dtype)
    cache["k"][:, :, :, :t] = torch.stack(ks).to(cache["k"].dtype)
    cache["v"][:, :, :, :t] = torch.stack(vs).to(cache["v"].dtype)
    x = _rmsnorm(x, params["norm_f"])
    last = x[torch.arange(b, device=x.device), lengths.long() - 1]
    return cache, last.float() @ params["wte"].T


def _chunk_hidden(params, cfg: LlamaConfig, cache, tokens, start):
    """The trunk `llama_prefill_chunk` and `llama_verify_step` share:
    `tokens` (int [batch, s]) at absolute positions `start + [0..s)`, K
    roped there, K/V written (in place) at kv_heads granularity, attention
    over the FULL cache window masked to `key_pos <= query_pos`, the
    cache GQA-repeated after the write.  Returns the final hidden states
    [batch, s, dim] after norm_f."""
    from easydist_tpu_torch.ops import chunk_attention

    dtype = torch_dtype(cfg.dtype)
    s = tokens.shape[1]
    abs_pos = start[:, None] + torch.arange(s, device=tokens.device)[None]
    x = params["wte"][tokens.long()].to(dtype)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(_rmsnorm(x, blk["attn_norm"]).to(dtype), blk, cfg,
                       dtype)
        q = _rope_abs(q.float(), abs_pos, cfg.rope_theta).to(dtype)
        k = _rope_abs(k.float(), abs_pos, cfg.rope_theta).to(dtype)
        ck = _cache_write_chunk(cache["k"][li], k, start)
        cv = _cache_write_chunk(cache["v"][li], v, start)
        att = chunk_attention(q, _repeat_kv(ck.to(dtype), cfg),
                              _repeat_kv(cv.to(dtype), cfg), abs_pos)
        x = x + _merge_heads(att, cfg) @ blk["wo"].to(dtype)
        x = _ffn(x, blk, dtype)
    return _rmsnorm(x, params["norm_f"])


def llama_prefill_chunk(params, cfg: LlamaConfig, cache, tokens, start_pos,
                        lengths):
    """One fixed-size prefill chunk (the llama mirror of
    `gpt.gpt_prefill_chunk`): `tokens` (int [batch, chunk]) at absolute
    positions `start_pos + [0..chunk)`, their roped K/V written into
    `cache` (in place).  Returns (cache, logits [batch, vocab]) at each
    row's last real position — valid for rows whose chunk holds
    `lengths - 1`."""
    start = start_pos.long()
    x = _chunk_hidden(params, cfg, cache, tokens, start)
    return cache, _last_real_logits(params, x, start, lengths)


def llama_verify_step(params, cfg: LlamaConfig, cache, tokens, pos):
    """Speculative-decoding verify step (the llama mirror of
    `gpt.gpt_verify_step`): score `tokens` (int [batch, s] — the last
    committed token and s-1 drafts) at absolute positions `pos + [0..s)`
    in one forward through the chunk trunk.  Returns (cache, logits
    [batch, s, vocab]).  Callers must guarantee pos + s <= T."""
    x = _chunk_hidden(params, cfg, cache, tokens, pos.long())
    return cache, x.float() @ params["wte"].T


def llama_decode_step(params, cfg: LlamaConfig, cache, token, pos):
    """One cached decode step: (cache, logits [batch, vocab]) for `token`
    (int [batch]) at absolute position `pos` (int [batch]).  Q and the new
    K are roped at `pos`; the cached keys were roped when written.  The
    cache is repeated to full heads and attention is
    `ops.decode_attention`: B4 on the card, the plain version on the
    CPU."""
    from easydist_tpu_torch.ops import decode_attention

    dtype = torch_dtype(cfg.dtype)
    b = token.shape[0]
    hd = cfg.dim // cfg.heads
    pos = pos.to(torch.int32)
    x = params["wte"][token.long()].to(dtype)
    for li, blk in enumerate(params["blocks"]):
        hx = _rmsnorm(x, blk["attn_norm"]).to(dtype)
        q = (hx @ blk["wq"].to(dtype)).reshape(b, cfg.heads, hd)
        k = (hx @ blk["wk"].to(dtype)).reshape(b, cfg.kv_heads, hd)
        v = (hx @ blk["wv"].to(dtype)).reshape(b, cfg.kv_heads, hd)
        q = _rope_at(q.float(), pos, cfg.rope_theta).to(dtype)
        k = _rope_at(k.float(), pos, cfg.rope_theta).to(dtype)
        ck = _cache_write_row(cache["k"][li], k, pos)
        cv = _cache_write_row(cache["v"][li], v, pos)
        att = decode_attention(q, _repeat_kv(ck.to(dtype), cfg),
                               _repeat_kv(cv.to(dtype), cfg), pos + 1)
        x = x + att.reshape(b, cfg.heads * hd) @ blk["wo"].to(dtype)
        x = _ffn(x, blk, dtype)
    x = _rmsnorm(x, params["norm_f"])
    return cache, x.float() @ params["wte"].T


# ------------------------------------------------------- paged KV decode
#
# The arena ({"k", "v"}: [layers, n_pages + 1, kv_heads, page_tokens,
# head_dim], the last page the drop page, as in models/gpt.py) stores
# ROPED keys at kv_heads granularity, so page memory scales with kv_heads.
# The chunk and verify forwards gather the virtual contiguous cache
# through the table and repeat it to full heads after the gather; the
# decode step hands the kv_heads arena to the kernel, which maps query
# head h to kv head h // (heads // kv_heads).


def init_kv_pages(cfg: LlamaConfig, n_pages: int, page_tokens: int,
                  dtype=None, quant_dtype=None, quant_block: int = 0,
                  device=None):
    """Zeroed page arena {"k", "v"}: [layers, n_pages + 1, kv_heads,
    page_tokens, head_dim] on `device` (default: the card): `n_pages`
    allocatable pages and the drop page.  `quant_dtype="int8"` stores
    the payload block-scaled int8 plus a parallel {"k_scale", "v_scale"}
    f32 scale arena ([..., head_dim // block]; `quant_block` 0 = one
    block per row); the scale keys are the quant signal every paged
    forward branches on."""
    if n_pages < 1:
        raise ValueError(f"n_pages must be >= 1, got {n_pages}")
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    device = resolve_device(device)
    hd = cfg.dim // cfg.heads
    dt = torch_dtype(cfg.dtype if dtype in (None, "auto") else dtype)
    shape = (cfg.layers, n_pages + 1, cfg.kv_heads, page_tokens, hd)
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


def _pages_write_chunk(pages_layer, new, write_page):
    """Write one full page per row, in place: pages_layer [n_pages + 1,
    n, pt, hd], new [b, n, pt, hd], write_page int [b] (the drop page
    for dead rows)."""
    pages_layer[write_page.long()] = new.to(pages_layer.dtype)
    return pages_layer


def _chunk_hidden_paged(params, cfg: LlamaConfig, pages, table, tokens,
                        start, write):
    """`_chunk_hidden` against the page arena, the trunk the paged
    prefill chunk and verify step share: `write(pages_layer, new)` lands
    the s positions' roped K/V rows (and their scales, int8 pages
    quantizing on write) in place; attention gathers the virtual
    contiguous cache through `table` after the write, repeated to full
    heads (plain torch).  Returns the hidden states after norm_f."""
    from easydist_tpu_torch.ops import (chunk_attention, gather_pages,
                                        kv_dequantize, kv_quantize)

    dtype = torch_dtype(cfg.dtype)
    s = tokens.shape[1]
    n_pages = _arena_pages(pages)
    quant_nb = pages["k_scale"].shape[-1] if "k_scale" in pages else 0
    tbl = table.long()
    abs_pos = start[:, None] + torch.arange(s, device=tokens.device)[None]
    x = params["wte"][tokens.long()].to(dtype)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(_rmsnorm(x, blk["attn_norm"]).to(dtype), blk, cfg,
                       dtype)
        q = _rope_abs(q.float(), abs_pos, cfg.rope_theta).to(dtype)
        k = _rope_abs(k.float(), abs_pos, cfg.rope_theta).to(dtype)
        if quant_nb:
            # roped keys quantize; the GQA repeat follows the gather on
            # payload and scales alike, so dequantization commutes
            k, sk = kv_quantize(k, quant_nb)
            v, sv = kv_quantize(v, quant_nb)
            psk = write(pages["k_scale"][li], sk)
            psv = write(pages["v_scale"][li], sv)
        pk = write(pages["k"][li], k)
        pv = write(pages["v"][li], v)

        def virtual(p):
            return gather_pages(p[:n_pages], tbl, n_heads=cfg.heads)

        if quant_nb:
            kf = kv_dequantize(virtual(pk), virtual(psk), dtype)
            vf = kv_dequantize(virtual(pv), virtual(psv), dtype)
        else:
            kf, vf = virtual(pk).to(dtype), virtual(pv).to(dtype)
        att = chunk_attention(q, kf, vf, abs_pos)
        x = x + _merge_heads(att, cfg) @ blk["wo"].to(dtype)
        x = _ffn(x, blk, dtype)
    return _rmsnorm(x, params["norm_f"])


def llama_prefill_chunk_paged(params, cfg: LlamaConfig, pages, table,
                              tokens, start_pos, lengths):
    """`llama_prefill_chunk` through a page table: the chunk's roped K and
    V fill the row's own page for window `start_pos // page_tokens` (in
    place; no staging cache), and attention gathers the virtual
    contiguous cache through the table, GQA-repeated after the gather.
    Returns (pages, logits [batch, vocab]) at each row's last real
    position.  Requires tokens.shape[1] == page_tokens."""
    c_len = tokens.shape[1]
    pt = pages["k"].shape[3]
    if c_len != pt:
        raise ValueError(f"paged prefill chunk {c_len} != page_tokens {pt} "
                         f"(chunks must fill exactly one page)")
    start = start_pos.long()
    wp = table.long().gather(1, (start // pt)[:, None])[:, 0]
    x = _chunk_hidden_paged(params, cfg, pages, table, tokens, start,
                            lambda layer, new: _pages_write_chunk(
                                layer, new, wp))
    return pages, _last_real_logits(params, x, start, lengths)


def llama_verify_step_paged(params, cfg: LlamaConfig, pages, table, tokens,
                            pos):
    """`llama_verify_step` against the page arena: the s positions' roped
    K/V rows land through the table per position (a verify window may
    straddle a page boundary; a window past the table's end goes to the
    drop page, as the JAX package's out-of-range take drops it), and
    attention gathers the virtual contiguous cache, GQA-repeated after
    the gather.  Returns (pages, logits [batch, s, vocab])."""
    s = tokens.shape[1]
    pt = pages["k"].shape[3]
    start = pos.long()
    tbl = table.long()
    abs_pos = start[:, None] + torch.arange(s, device=tokens.device)[None]
    win = abs_pos // pt
    inside = win < tbl.shape[1]
    wp = torch.where(inside, tbl.gather(1, win.clamp(max=tbl.shape[1] - 1)),
                     torch.full_like(win, _arena_pages(pages)))
    off = abs_pos % pt
    x = _chunk_hidden_paged(params, cfg, pages, table, tokens, start,
                            lambda layer, new: _pages_write_rows(
                                layer, new, wp, off))
    return pages, x.float() @ params["wte"].T


def llama_decode_step_paged(params, cfg: LlamaConfig, pages, table, token,
                            pos):
    """`llama_decode_step` against the page arena: the new roped K/V row
    lands (in place) at window `pos // page_tokens`, offset
    `pos % page_tokens`, and attention runs through
    `ops.paged_decode_attention` over the kv_heads arena (B5 on exact
    pages, B6 on int8 pages, the plain versions on the CPU; the kernels
    map query head -> kv head, the plain versions gather then repeat)."""
    from easydist_tpu_torch.ops import kv_quantize, paged_decode_attention

    dtype = torch_dtype(cfg.dtype)
    b = token.shape[0]
    pt = pages["k"].shape[3]
    n_pages = _arena_pages(pages)
    quant_nb = pages["k_scale"].shape[-1] if "k_scale" in pages else 0
    hd = cfg.dim // cfg.heads
    pos = pos.to(torch.int32)
    tbl = table.to(torch.int32)
    wp = tbl.long().gather(1, (pos.long() // pt)[:, None])[:, 0]
    off = pos.long() % pt
    x = params["wte"][token.long()].to(dtype)
    for li, blk in enumerate(params["blocks"]):
        hx = _rmsnorm(x, blk["attn_norm"]).to(dtype)
        q = (hx @ blk["wq"].to(dtype)).reshape(b, cfg.heads, hd)
        k = (hx @ blk["wk"].to(dtype)).reshape(b, cfg.kv_heads, hd)
        v = (hx @ blk["wv"].to(dtype)).reshape(b, cfg.kv_heads, hd)
        q = _rope_at(q.float(), pos, cfg.rope_theta).to(dtype)
        k = _rope_at(k.float(), pos, cfg.rope_theta).to(dtype)
        if quant_nb:
            k, sk = kv_quantize(k, quant_nb)
            v, sv = kv_quantize(v, quant_nb)
            psk = _pages_write_row(pages["k_scale"][li], sk, wp, off)
            psv = _pages_write_row(pages["v_scale"][li], sv, wp, off)
        pk = _pages_write_row(pages["k"][li], k, wp, off)
        pv = _pages_write_row(pages["v"][li], v, wp, off)
        if quant_nb:
            att = paged_decode_attention(
                q, pk[:n_pages], pv[:n_pages], tbl, pos + 1,
                k_scale=psk[:n_pages], v_scale=psv[:n_pages])
        else:
            att = paged_decode_attention(
                q, _kv_operand(pk[:n_pages], dtype),
                _kv_operand(pv[:n_pages], dtype), tbl, pos + 1)
        x = x + att.reshape(b, cfg.heads * hd) @ blk["wo"].to(dtype)
        x = _ffn(x, blk, dtype)
    x = _rmsnorm(x, params["norm_f"])
    return pages, x.float() @ params["wte"].T
