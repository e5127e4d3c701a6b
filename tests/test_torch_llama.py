"""Port llama (easydist_tpu_torch.models.llama) against the JAX package
from the same weights, on `LlamaConfig.tiny()` (4 query heads over 2 KV
heads, so every attention takes the GQA head map): the full forward and
the loss, the RoPE forms, one-shot and chunked prefill, the decode and
verify steps on the bucketed cache, the three paged steps on exact and
int8 pages, and one Adam train step.  Then the JAX tests' own claims
(tests/test_models/test_decode.py): the cache is kv_heads-shaped, RoPE
decodes past cfg.seq, and cached and chunked greedy decoding equal the
uncached forward.

Weights come from the JAX package's `llama_init` and cross with
`params_from_numpy`; tokens and caches come from numpy seeds.  Tolerance:
rtol 1e-4 / atol 1e-5 in float32 (tests/test_ops/test_flash_attention.py
:28); the int8 quantizer bitwise on the same inputs (`torch.round` and
`jnp.rint` both round half to even), the int8 pages' payload bitwise and
their f32 scales (amax / 127 of the forward's f32 K and V) at the f32
bar; the int8 logit drift within 0.25 x the logit spread
(tests/test_serve/test_kv_quant.py:146-151).  The port writes caches in
place, so every port call gets a clone of what the JAX call sees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.models import llama as jl
from easydist_tpu_torch.models import llama as tl

RTOL, ATOL = 1e-4, 1e-5
PT = 8           # page tokens
NP = 12          # allocatable pages
# 3 rows x 4 windows; row 2 is dead past its first page
TABLE = np.array([[3, 7, 1, 9], [0, 5, 2, 11], [6, NP, NP, NP]], np.int32)


@pytest.fixture(scope="module")
def model():
    cfg_j = jl.LlamaConfig.tiny()
    params_j = jl.llama_init(cfg_j, jax.random.PRNGKey(0))
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(), params_t


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _i32(*rows):
    a = np.asarray(rows, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _cache_pair(cfg, batch, seed, max_len=None):
    """A random (not zero) kv_heads-shaped cache, so writes that land in
    the wrong place show up: JAX arrays and a port clone."""
    rs = np.random.RandomState(seed)
    shape = (cfg.layers, batch, cfg.kv_heads, max_len or cfg.seq,
             cfg.dim // cfg.heads)
    k = rs.standard_normal(shape).astype(np.float32)
    v = rs.standard_normal(shape).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def test_params_and_init_have_the_jax_tree(model):
    cfg_j, params_j, cfg_t, params_t = model
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params_j),
                            jax.tree_util.tree_leaves(
                                jax.tree.map(lambda t: t.numpy(), params_t))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))
    mine = tl.llama_init(cfg_t, torch.Generator().manual_seed(0),
                         device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda a: tuple(a.shape), params_j)
    assert tuple(mine["blocks"][0]["wk"].shape) == (32, 2 * 8)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tl.LlamaConfig.tiny()
    for fn in (lambda: tl.llama_init(cfg, torch.Generator()),
               lambda: tl.init_kv_cache(cfg, 1, 8),
               lambda: tl.init_kv_pages(cfg, 2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_apply_and_loss_match_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, cfg_j.vocab, (2, cfg_j.seq)).astype(np.int32)
    targets = rs.randint(0, cfg_j.vocab, (2, cfg_j.seq)).astype(np.int32)
    _close(tl.llama_apply(params_t, cfg_t, torch.from_numpy(tokens)),
           jl.llama_apply(params_j, cfg_j, jnp.asarray(tokens)))
    _close(tl.llama_loss(params_t, cfg_t, torch.from_numpy(tokens),
                         torch.from_numpy(targets)),
           jl.llama_loss(params_j, cfg_j, jnp.asarray(tokens),
                         jnp.asarray(targets)))


def test_rope_forms_match_jax():
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 4, 8, 16)).astype(np.float32)
    for theta in (10000.0, 500000.0):
        _close(tl._rope(torch.from_numpy(x), theta),
               jl._rope(jnp.asarray(x), theta))
        pj, pt = _i32(5, 700)
        _close(tl._rope_at(torch.from_numpy(x[:, :, 0]), pt, theta),
               jl._rope_at(jnp.asarray(x[:, :, 0]), pj, theta))
        pj, pt = _i32([2, 5, 7], [0, 3, 1000])
        _close(tl._rope_abs(torch.from_numpy(x[:, :, :3]), pt, theta),
               jl._rope_abs(jnp.asarray(x[:, :, :3]), pj, theta))
    # the decode and chunk rotations are columns of the batch rotation
    full = tl._rope(torch.from_numpy(x), 10000.0)
    for t in (0, 3, 7):
        at = tl._rope_at(torch.from_numpy(x[:, :, t]),
                         torch.tensor([t, t]), 10000.0)
        torch.testing.assert_close(at, full[:, :, t], atol=1e-5, rtol=0)


def test_prefill_matches_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    cj, ct = _cache_pair(cfg_j, 2, 1)
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, cfg_j.vocab, (2, 11)).astype(np.int32)
    lj, lt = _i32(11, 6)
    cj, logits_j = jl.llama_prefill(params_j, cfg_j, cj, jnp.asarray(tokens),
                                    lj)
    ct, logits_t = tl.llama_prefill(params_t, cfg_t, ct,
                                    torch.from_numpy(tokens), lt)
    _close(logits_t, logits_j)
    for k in cj:
        _close(ct[k], cj[k])


def test_prefill_chunk_decode_and_verify_match_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    cj, ct = _cache_pair(cfg_j, 3, 4)
    rs = np.random.RandomState(5)
    tokens = rs.randint(0, cfg_j.vocab, (3, 8)).astype(np.int32)
    sj, st = _i32(0, 8, 24)
    lj, lt = _i32(5, 14, 40)     # row 2's start clamps to T - chunk
    cj, logits_j = jl.llama_prefill_chunk(params_j, cfg_j, cj,
                                          jnp.asarray(tokens), sj, lj)
    ct, logits_t = tl.llama_prefill_chunk(params_t, cfg_t, ct,
                                          torch.from_numpy(tokens), st, lt)
    _close(logits_t, logits_j)
    for k in cj:
        _close(ct[k], cj[k])
    tj, tt = _i32(4, 9, 1)
    pj, pt = _i32(5, 14, 31)
    cj, logits_j = jl.llama_decode_step(params_j, cfg_j, cj, tj, pj)
    ct, logits_t = tl.llama_decode_step(params_t, cfg_t, ct, tt, pt)
    _close(logits_t, logits_j)
    for k in cj:
        _close(ct[k], cj[k])
    vj, vt = _i32([3, 5, 7], [1, 2, 3], [9, 9, 9])
    pj, pt = _i32(6, 15, 20)
    cj, logits_j = jl.llama_verify_step(params_j, cfg_j, cj, vj, pj)
    ct, logits_t = tl.llama_verify_step(params_t, cfg_t, ct, vt, pt)
    assert tuple(logits_t.shape) == (3, 3, cfg_t.vocab)
    _close(logits_t, logits_j)
    for k in cj:
        _close(ct[k], cj[k])


def _allocatable(pages):
    return {k: v[:, :NP].numpy() for k, v in pages.items()}


def _arena_pair(cfg_j, cfg_t, quant):
    """A random exact arena (JAX, port clone), or zeroed int8 arenas."""
    if quant:
        return (jl.init_kv_pages(cfg_j, NP, PT, quant_dtype="int8"),
                tl.init_kv_pages(cfg_t, NP, PT, quant_dtype="int8",
                                 device="cpu"))
    rs = np.random.RandomState(6)
    shape = (cfg_j.layers, NP, cfg_j.kv_heads, PT, cfg_j.dim // cfg_j.heads)
    pj, pt = {}, {}
    for k in ("k", "v"):
        a = rs.standard_normal(shape).astype(np.float32)
        pj[k] = jnp.asarray(a)
        pt[k] = torch.cat([torch.from_numpy(a.copy()),
                           torch.zeros((shape[0], 1) + shape[2:])], dim=1)
    return pj, pt


def _same_arena(pt_, pj, quant):
    """Exact pages and the int8 scales at the f32 bar (the scales are
    f32 amax / 127 of K and V, which carry the forward's f32 rounding);
    the int8 payload bitwise."""
    for k in pj:
        if quant and k in ("k", "v"):
            np.testing.assert_array_equal(_allocatable(pt_)[k],
                                          np.asarray(pj[k]), err_msg=k)
        else:
            _close(_allocatable(pt_)[k], pj[k])


def test_kv_quantize_is_bitwise_the_jax_one():
    from easydist_tpu.ops import kv_quantize as jax_kv_quantize
    from easydist_tpu_torch.ops import kv_quantize

    rs = np.random.RandomState(8)
    x = rs.standard_normal((3, 2, 5, 16)).astype(np.float32)
    # exact ties of round-half-to-even: 127 * k / 2 over a block amax of 127
    x[0, 0, 0] = np.arange(16) / 2.0 - 3.5
    x[0, 0, 0, -1] = 127.0
    for nb in (1, 4):
        qj, sj = jax_kv_quantize(jnp.asarray(x), nb)
        qt, st = kv_quantize(torch.from_numpy(x), nb)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_paged_steps_match_jax(model, quant):
    cfg_j, params_j, cfg_t, params_t = model
    pj, pt_ = _arena_pair(cfg_j, cfg_t, quant)
    tbl_j, tbl_t = jnp.asarray(TABLE), torch.from_numpy(TABLE)
    rs = np.random.RandomState(7)
    for c0 in (0, PT):
        tokens = rs.randint(0, cfg_j.vocab, (3, PT)).astype(np.int32)
        sj, st = _i32(c0, c0, 0)
        lj, lt = _i32(13, 16, 3)
        pj, logits_j = jl.llama_prefill_chunk_paged(
            params_j, cfg_j, pj, tbl_j, jnp.asarray(tokens), sj, lj)
        pt_, logits_t = tl.llama_prefill_chunk_paged(
            params_t, cfg_t, pt_, tbl_t, torch.from_numpy(tokens), st, lt)
        _close(logits_t, logits_j)
        _same_arena(pt_, pj, quant)
    tj, tt = _i32(4, 9, 2)
    pj_, pt_pos = _i32(13, 16, 3)
    pj, logits_j = jl.llama_decode_step_paged(params_j, cfg_j, pj, tbl_j, tj,
                                              pj_)
    pt_, logits_t = tl.llama_decode_step_paged(params_t, cfg_t, pt_, tbl_t,
                                               tt, pt_pos)
    _close(logits_t, logits_j)
    _same_arena(pt_, pj, quant)
    # a verify window that straddles the page boundary at 16
    vj, vt = _i32([3, 5, 7], [1, 2, 3], [9, 9, 9])
    pj_, pt_pos = _i32(14, 17, 4)
    pj, logits_j = jl.llama_verify_step_paged(params_j, cfg_j, pj, tbl_j, vj,
                                              pj_)
    pt_, logits_t = tl.llama_verify_step_paged(params_t, cfg_t, pt_, tbl_t,
                                               vt, pt_pos)
    _close(logits_t, logits_j)
    _same_arena(pt_, pj, quant)


def _teacher_forced(params, cfg, pages, prompt, forced, n_new=6):
    """Paged prefill of `prompt`, then decode steps fed `forced` (or the
    greedy ids when None); returns (ids, logits per step)."""
    table = torch.arange(4, dtype=torch.int32)[None]
    toks = list(prompt) + [0] * PT
    for c0 in range(0, len(prompt), PT):
        pages, lg = tl.llama_prefill_chunk_paged(
            params, cfg, pages, table, torch.tensor([toks[c0:c0 + PT]]),
            torch.tensor([c0]), torch.tensor([len(prompt)]))
    steps = [lg[0]]
    cur = [int(torch.argmax(lg[0]))] if forced is None else forced
    for i in range(n_new - 1):
        pages, lg = tl.llama_decode_step_paged(
            params, cfg, pages, table, torch.tensor([cur[i]]),
            torch.tensor([len(prompt) + i]))
        steps.append(lg[0])
        if forced is None:
            cur.append(int(torch.argmax(lg[0])))
    return cur, torch.stack(steps)


def test_int8_drift_within_the_jax_bar(model):
    _, _, cfg_t, params_t = model
    prompt = list(range(1, 14))
    ids, exact = _teacher_forced(
        params_t, cfg_t, tl.init_kv_pages(cfg_t, 4, PT, device="cpu"),
        prompt, None)
    _, quant = _teacher_forced(
        params_t, cfg_t, tl.init_kv_pages(cfg_t, 4, PT, quant_dtype="int8",
                                          device="cpu"), prompt, ids)
    spread = float((exact.amax(-1) - exact.amin(-1)).max())
    drift = float((exact - quant).abs().max())
    assert 0 < drift <= 0.25 * spread, (drift, spread)


def test_train_step_matches_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    from easydist_tpu.models.optim import adam_init as jax_adam_init
    from easydist_tpu_torch.models.optim import adam_init

    rs = np.random.RandomState(9)
    tokens = rs.randint(0, cfg_j.vocab, (2, 16)).astype(np.int32)
    targets = rs.randint(0, cfg_j.vocab, (2, 16)).astype(np.int32)
    step_j, _ = jl.make_llama_train_step(cfg_j)
    step_t, init_t = tl.make_llama_train_step(cfg_t)
    (pj, _), loss_j = step_j((params_j, jax_adam_init(params_j)),
                             jnp.asarray(tokens), jnp.asarray(targets))
    (pt, opt), loss_t = step_t((params_t, adam_init(params_t)),
                               torch.from_numpy(tokens),
                               torch.from_numpy(targets))
    _close(loss_t.detach(), loss_j)
    for a, b in zip(jax.tree_util.tree_leaves(pj),
                    jax.tree_util.tree_leaves(
                        jax.tree.map(lambda t: t.detach().numpy(), pt))):
        _close(b, a)
    fresh = init_t(torch.Generator().manual_seed(0), device="cpu")
    assert len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.numpy(), fresh))) == \
        3 * len(jax.tree_util.tree_leaves(params_j)) + 1


# ------------------------------------- the JAX tests' claims, on the port


def test_cache_is_kv_heads_shaped(model):
    _, _, cfg_t, _ = model
    cache = tl.init_kv_cache(cfg_t, 2, 16, device="cpu")
    assert tuple(cache["k"].shape) == (cfg_t.layers, 2, cfg_t.kv_heads, 16,
                                       cfg_t.dim // cfg_t.heads)
    pages = tl.init_kv_pages(cfg_t, 6, PT, quant_dtype="int8", device="cpu")
    assert tuple(pages["k"].shape) == (cfg_t.layers, 7, cfg_t.kv_heads, PT,
                                       8)
    assert tuple(pages["k_scale"].shape) == (cfg_t.layers, 7, cfg_t.kv_heads,
                                             PT, 1)


def test_rope_decodes_past_cfg_seq(model):
    _, _, cfg_t, params_t = model
    cache = tl.init_kv_cache(cfg_t, 1, cfg_t.seq * 2, device="cpu")
    cache, logits = tl.llama_prefill(params_t, cfg_t, cache,
                                     torch.tensor([[1, 2, 3]]),
                                     torch.tensor([3]))
    tok, pos = logits.argmax(-1), torch.tensor([cfg_t.seq + 5])
    for _ in range(4):
        cache, logits = tl.llama_decode_step(params_t, cfg_t, cache, tok,
                                             pos)
        tok, pos = logits.argmax(-1), pos + 1
    assert tuple(logits.shape) == (1, cfg_t.vocab)
    assert bool(torch.isfinite(logits).all())


def _uncached(params, cfg, prompt, n_new):
    cur, out = list(prompt), []
    for _ in range(n_new):
        logits = tl.llama_apply(params, cfg, torch.tensor([cur]))
        out.append(int(torch.argmax(logits[0, len(cur) - 1])))
        cur.append(out[-1])
    return out


@pytest.mark.parametrize("chunk", [None, 4], ids=["one_shot", "chunked"])
def test_greedy_parity_vs_full_forward(model, chunk):
    _, _, cfg_t, params_t = model
    prompts = [[3, 14, 15, 9, 2, 6, 26, 5, 3, 1], [11, 5, 7]]
    for prompt in prompts:
        cache = tl.init_kv_cache(cfg_t, 1, cfg_t.seq, device="cpu")
        if chunk is None:
            cache, logits = tl.llama_prefill(params_t, cfg_t, cache,
                                             torch.tensor([prompt]),
                                             torch.tensor([len(prompt)]))
        else:
            toks = prompt + [0] * chunk
            for c0 in range(0, len(prompt), chunk):
                cache, logits = tl.llama_prefill_chunk(
                    params_t, cfg_t, cache,
                    torch.tensor([toks[c0:c0 + chunk]]),
                    torch.tensor([c0]), torch.tensor([len(prompt)]))
        got = [int(logits.argmax(-1))]
        for i in range(5):
            cache, logits = tl.llama_decode_step(
                params_t, cfg_t, cache, torch.tensor([got[-1]]),
                torch.tensor([len(prompt) + i]))
            got.append(int(logits.argmax(-1)))
        assert got == _uncached(params_t, cfg_t, prompt, 6)


def test_train_llama_example_runs_on_the_cpu():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", "torch",
                                      "train_llama.py"),
         "--device", "cpu", "--steps", "2"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    losses = [float(line.split()[-1]) for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
