"""Port GPT forwards (easydist_tpu_torch.models.gpt) against the JAX
package from the same weights: full-forward logits, chunked prefill and
cached decode (caches and logits), one-shot prefill, the clamped cache
writes, and weight transfer.

Weights come from the JAX package's `gpt_init` and cross with
`params_from_numpy`; tokens come from numpy seeds.  Tolerance: rtol 1e-4
/ atol 1e-5 in float32.  The port writes caches in place, so every port
call gets a clone of the cache the JAX call sees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.models import gpt as jg
from easydist_tpu_torch.models import gpt as tg

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def model():
    cfg_j = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(3))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tg.GPTConfig.tiny(), params_t


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _cache_pair(cfg_j, batch, seed, max_len=None):
    """A random (not zero) cache, so writes that land in the wrong place
    show up: JAX arrays and a port clone."""
    rs = np.random.RandomState(seed)
    shape = (cfg_j.layers, batch, cfg_j.heads, max_len or cfg_j.seq,
             cfg_j.dim // cfg_j.heads)
    k = rs.standard_normal(shape).astype(np.float32)
    v = rs.standard_normal(shape).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def test_params_from_numpy_keeps_keys_and_layouts(model):
    _, params_j, cfg_t, params_t = model
    flat_j = jax.tree_util.tree_leaves_with_path(params_j)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.numpy(), params_t)))
    for path, leaf in flat_j:
        node = params_t
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # w stays [n_in, n_out]
    assert tuple(params_t["blocks"][0]["attn"]["qkv"]["w"].shape) == \
        (cfg_t.dim, 3 * cfg_t.dim)


def test_gpt_init_has_the_jax_tree_structure(model):
    cfg_j, params_j, cfg_t, _ = model
    p = tg.gpt_init(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    shapes_t = jax.tree.map(lambda t: tuple(t.shape), p)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), params_j)
    assert shapes_t == shapes_j


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tg.GPTConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.gpt_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.init_kv_cache(cfg, 1, 8)


def test_gpt_apply_logits_match_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (2, cfg_j.seq))
    ref = jax.jit(lambda p, t: jg.gpt_apply(p, cfg_j, t))(
        params_j, jnp.asarray(toks, jnp.int32))
    out = tg.gpt_apply(params_t, cfg_t, torch.as_tensor(toks))
    assert out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("starts,lengths,max_len", [
    ([0, 0], [5, 8], 32),         # first chunk, both rows finish in it
    ([8, 16], [13, 40], 32),      # later chunks over a cached prefix
    ([8, 12], [14, 20], 16),      # start 12 > T - chunk: the write clamps
])
def test_prefill_chunk_matches_jax(model, starts, lengths, max_len):
    cfg_j, params_j, cfg_t, params_t = model
    rs = np.random.RandomState(1)
    toks = rs.randint(0, cfg_j.vocab, (2, 8)).astype(np.int32)
    cache_j, cache_t = _cache_pair(cfg_j, 2, seed=2, max_len=max_len)
    start = np.asarray(starts, np.int32)
    L = np.asarray(lengths, np.int32)
    ref_cache, ref_logits = jax.jit(
        lambda p, c, t, s, l: jg.gpt_prefill_chunk(p, cfg_j, c, t, s, l))(
        params_j, cache_j, jnp.asarray(toks), jnp.asarray(start),
        jnp.asarray(L))
    out_cache, logits = tg.gpt_prefill_chunk(
        params_t, cfg_t, cache_t, torch.from_numpy(toks),
        torch.from_numpy(start), torch.from_numpy(L))
    assert out_cache is cache_t  # written in place
    _close(logits, ref_logits)
    _close(out_cache["k"], ref_cache["k"])
    _close(out_cache["v"], ref_cache["v"])


@pytest.mark.parametrize("pos,max_len", [([0, 7], 32), ([31, 12], 32),
                                         ([20, 3], 16)])
def test_decode_step_matches_jax(model, pos, max_len):
    cfg_j, params_j, cfg_t, params_t = model
    cache_j, cache_t = _cache_pair(cfg_j, 2, seed=4, max_len=max_len)
    token = np.asarray([5, 77], np.int32)
    p = np.asarray(pos, np.int32)   # 20 > T-1 = 15: the write clamps
    ref_cache, ref_logits = jax.jit(
        lambda pr, c, t, q: jg.gpt_decode_step(pr, cfg_j, c, t, q))(
        params_j, cache_j, jnp.asarray(token), jnp.asarray(p))
    ptr = cache_t["k"].data_ptr()
    out_cache, logits = tg.gpt_decode_step(
        params_t, cfg_t, cache_t, torch.from_numpy(token),
        torch.from_numpy(p))
    assert out_cache["k"].data_ptr() == ptr
    _close(logits, ref_logits)
    _close(out_cache["k"], ref_cache["k"])
    _close(out_cache["v"], ref_cache["v"])


def test_prefill_one_shot_matches_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    toks = np.random.RandomState(5).randint(0, cfg_j.vocab, (2, 16))
    toks = toks.astype(np.int32)
    L = np.asarray([16, 9], np.int32)
    cache_j, cache_t = _cache_pair(cfg_j, 2, seed=6)
    ref_cache, ref_logits = jg.gpt_prefill(params_j, cfg_j, cache_j,
                                           jnp.asarray(toks), jnp.asarray(L))
    out_cache, logits = tg.gpt_prefill(params_t, cfg_t, cache_t,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(L))
    _close(logits, ref_logits)
    _close(out_cache["k"], ref_cache["k"])


def test_cached_decode_equals_full_forward(model):
    """Prefill a prompt chunk by chunk, decode 3 tokens: each step's
    logits equal gpt_apply's at that position."""
    _, _, cfg_t, params_t = model
    cache = tg.init_kv_cache(cfg_t, 1, cfg_t.seq, device="cpu")
    seq = [int(x) for x in np.random.RandomState(7).randint(0, 128, 11)]
    for s in (0, 8):
        chunk = (seq[s:s + 8] + [0] * 8)[:8]
        cache, logits = tg.gpt_prefill_chunk(
            params_t, cfg_t, cache, torch.tensor([chunk]),
            torch.tensor([s]), torch.tensor([len(seq)]))
    for _ in range(3):
        full = tg.gpt_apply(params_t, cfg_t, torch.tensor([seq]))[0, -1]
        _close(logits[0], full)
        nxt = int(torch.argmax(logits[0]))
        cache, logits = tg.gpt_decode_step(
            params_t, cfg_t, cache, torch.tensor([nxt]),
            torch.tensor([len(seq)]))
        seq.append(nxt)


def test_bf16_forward_is_finite_and_casts_at_use(model):
    _, _, _, params_t = model
    cfg = tg.GPTConfig.tiny(dtype="bfloat16")
    cache = tg.init_kv_cache(cfg, 2, cfg.seq, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    cache, logits = tg.gpt_decode_step(params_t, cfg, cache,
                                       torch.tensor([1, 2]),
                                       torch.tensor([0, 3]))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert params_t["wte"].dtype == torch.float32  # params stay f32


def test_flash_attention_config_not_ported(model):
    """Every attention config of the JAX package is ported: "auto" (the
    solver-visible composite) gives the JAX package's "auto" logits;
    "ring" without a mesh and an unknown backend raise ValueError."""
    cfg_j, params_j, _, params_t = model
    tokens = np.random.RandomState(12).randint(0, cfg_j.vocab,
                                               (2, cfg_j.seq))
    want = jg.gpt_apply(params_j, jg.GPTConfig.tiny(attention="auto"),
                        jnp.asarray(tokens))
    got = tg.gpt_apply(params_t, tg.GPTConfig.tiny(attention="auto"),
                       torch.from_numpy(tokens))
    _close(got.numpy(), want)
    for attention, match in (("ring", "attn_mesh"), ("sparse", "one of")):
        cfg = tg.GPTConfig.tiny(attention=attention)
        with pytest.raises(ValueError, match=match):
            tg.gpt_apply(params_t, cfg, torch.zeros(1, 4, dtype=torch.int64))


def test_flash_attention_config_matches_einsum(model):
    """attention="flash" (the plain versions of B1 on the CPU) against
    the einsum forward from the same weights, at the JAX package's bar
    for the same comparison (rtol 1e-3 / atol 1e-4,
    tests/test_models/test_models_e2e.py:133-145)."""
    _, _, cfg_t, params_t = model
    tokens = torch.from_numpy(
        np.random.RandomState(11).randint(0, cfg_t.vocab, (2, cfg_t.seq)))
    flash = tg.gpt_apply(params_t, tg.GPTConfig.tiny(attention="flash"),
                         tokens)
    einsum = tg.gpt_apply(params_t, cfg_t, tokens)
    np.testing.assert_allclose(flash.numpy(), einsum.numpy(), rtol=1e-3,
                               atol=1e-4)
