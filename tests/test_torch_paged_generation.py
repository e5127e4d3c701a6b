"""The port's paged KV serving (easydist_tpu_torch.models.gpt paged
forwards, serve.GenerationSession with kv_layout="paged") held against
the JAX package from the same weights (`params_from_numpy`): paged
prefill/decode logits and arenas (exact at rtol 1e-4 / atol 1e-5; int8
within one scale step per element and the JAX drift bar), dead-row
writes that touch no allocatable page, greedy ids equal to the JAX paged
session's and the port's bucketed session's, one decode and one prefill
signature, zero-copy restores, page recycling, the int8 session, and
the JAX validation rules of the paged and int8 knobs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.models import gpt as jg
from easydist_tpu.serve import GenerationSession as JaxSession
from easydist_tpu.serve import ServeConfig as JaxServeConfig
from easydist_tpu_torch.fxfront import easydist_compile
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.serve import (GenerationSession, PrefixCache,
                                      ServeConfig, ServeMetrics)

RTOL, ATOL = 1e-4, 1e-5
PT, NP = 8, 10          # page tokens (the tiny config's prefill chunk), pages
# tests/test_serve/test_paged_generation.py:63-66
MIXED = [[3, 14, 15, 9, 2],                     # shorter than one chunk
         [5, 6, 7, 8, 9, 10, 11, 12, 13],       # crosses a chunk
         [1, 2],
         [9] * 20]                              # crosses a page mid-decode
# tests/test_serve/test_kv_quant.py:56-57
QUANT_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8, 7],
                 [1, 2, 3, 9, 9, 9, 4], [5, 5]]


@pytest.fixture(scope="module")
def model():
    cfg_j = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(0))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tg.GPTConfig.tiny(), params_t


def _config(layout="paged", cls=ServeConfig, **kw):
    kw.setdefault("decode_buckets", (32,))
    kw.setdefault("max_decode_slots", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("prefill_batch", 2)
    return cls(kv_layout=layout, **kw)


def _serve(params, cfg, prompts, n_new=5, layout="paged", **kw):
    sess = GenerationSession.for_gpt(params, cfg, config=_config(layout,
                                                                 **kw),
                                     device="cpu", compile_key=None)
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    return [f.result(timeout=5)["ids"] for f in futs], sess


@pytest.fixture(scope="module")
def jax_paged_mixed(model):
    cfg_j, params_j, _, _ = model
    sess = JaxSession.for_gpt(params_j, cfg_j,
                              config=_config(cls=JaxServeConfig))
    futs = [sess.submit(p, max_new_tokens=5) for p in MIXED]
    sess.run_until_drained()
    return [f.result(timeout=5)["ids"] for f in futs]


# ------------------------------------------------------- model level


def _arena_pair(cfg, seed):
    """A random (not zero) arena, so writes that land in the wrong place
    show up: JAX arrays [L, NP, ...] and the port's copy with its drop
    page [L, NP + 1, ...]."""
    rs = np.random.RandomState(seed)
    shape = (cfg.layers, NP + 1, cfg.heads, PT, cfg.dim // cfg.heads)
    arena = {k: rs.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    return ({k: jnp.asarray(a[:, :NP]) for k, a in arena.items()},
            {k: torch.from_numpy(a.copy()) for k, a in arena.items()})


# row 0 maps windows 0-1, row 1 windows 0-2, row 2 is dead (all sentinel)
TABLE = np.array([[3, 7, NP, NP], [1, 2, 5, NP], [NP] * 4], np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _allocatable(arena):
    """A copy of the allocatable pages (the drop page left out)."""
    return {k: t[:, :NP].numpy().copy() for k, t in arena.items()}


def test_init_kv_pages_has_the_drop_page(model):
    _, _, cfg_t, _ = model
    exact = tg.init_kv_pages(cfg_t, 6, 8, device="cpu")
    assert sorted(exact) == ["k", "v"]
    assert tuple(exact["k"].shape) == (2, 7, 4, 8, 8)
    quant = tg.init_kv_pages(cfg_t, 6, 8, quant_dtype="int8", quant_block=4,
                             device="cpu")
    assert quant["k"].dtype == torch.int8
    assert tuple(quant["k_scale"].shape) == (2, 7, 4, 8, 2)
    with pytest.raises(ValueError, match="must divide"):
        tg.init_kv_pages(cfg_t, 6, 8, quant_dtype="int8", quant_block=3,
                         device="cpu")


def test_prefill_and_decode_paged_match_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    pj, pt_ = _arena_pair(cfg_j, 0)
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, cfg_j.vocab, (3, PT)).astype(np.int32)
    start = np.array([8, 16, 0], np.int32)
    lengths = np.array([13, 20, 1], np.int32)
    pj, lj = jg.gpt_prefill_chunk_paged(
        params_j, cfg_j, pj, jnp.asarray(TABLE), jnp.asarray(tokens),
        jnp.asarray(start), jnp.asarray(lengths))
    pt_, lt = tg.gpt_prefill_chunk_paged(
        params_t, cfg_t, pt_, torch.from_numpy(TABLE),
        torch.from_numpy(tokens), torch.from_numpy(start),
        torch.from_numpy(lengths))
    _close(lt.numpy(), lj)
    for k in pj:
        _close(_allocatable(pt_)[k], pj[k])
    token = np.array([4, 9, 0], np.int32)
    pos = np.array([13, 20, 0], np.int32)
    pj, lj = jg.gpt_decode_step_paged(params_j, cfg_j, pj,
                                      jnp.asarray(TABLE), jnp.asarray(token),
                                      jnp.asarray(pos))
    pt_, lt = tg.gpt_decode_step_paged(params_t, cfg_t, pt_,
                                       torch.from_numpy(TABLE),
                                       torch.from_numpy(token),
                                       torch.from_numpy(pos))
    _close(lt.numpy(), lj)
    for k in pj:
        _close(_allocatable(pt_)[k], pj[k])


def test_dead_rows_write_no_allocatable_page(model):
    _, _, cfg_t, params_t = model
    _, arena = _arena_pair(cfg_t, 2)
    before = _allocatable(arena)
    dead = torch.full((3, 4), NP, dtype=torch.int32)
    tg.gpt_prefill_chunk_paged(params_t, cfg_t, arena, dead,
                               torch.ones(3, PT, dtype=torch.int32),
                               torch.zeros(3, dtype=torch.int32),
                               torch.ones(3, dtype=torch.int32))
    tg.gpt_decode_step_paged(params_t, cfg_t, arena, dead,
                             torch.ones(3, dtype=torch.int32),
                             torch.tensor([0, 5, 31], dtype=torch.int32))
    after = _allocatable(arena)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    # a live row beside dead ones changes its own page and nothing else
    table = torch.from_numpy(TABLE)
    tg.gpt_decode_step_paged(params_t, cfg_t, arena, table,
                             torch.ones(3, dtype=torch.int32),
                             torch.tensor([13, 20, 0], dtype=torch.int32))
    moved = {int(p) for p in
             np.nonzero((_allocatable(arena)["k"] != after["k"]).any(
                 axis=(0, 2, 3, 4)))[0]}
    assert moved == {7, 5}


def _int8_run(mod, params, cfg, pages, table, forced=None, n_new=5):
    """Prefill a 13-token prompt in page chunks, then decode n_new - 1
    steps (teacher-forced on `forced`); returns (pages, tokens, logits
    per step)."""
    prompt = list(range(1, 14))
    toks = prompt + [0] * PT
    lg = None
    for c0 in range(0, len(prompt), PT):
        pages, lg = mod.gpt_prefill_chunk_paged(
            params, cfg, pages, table, _arr(mod, [toks[c0:c0 + PT]]),
            _arr(mod, [c0]), _arr(mod, [len(prompt)]))
    steps = [np.asarray(lg[0])]
    cur = [int(np.argmax(steps[0]))] if forced is None else forced
    for i in range(n_new - 1):
        pages, lg = mod.gpt_decode_step_paged(
            params, cfg, pages, table, _arr(mod, [cur[i]]),
            _arr(mod, [len(prompt) + i]))
        steps.append(np.asarray(lg[0]))
        if forced is None:
            cur.append(int(np.argmax(steps[-1])))
    return pages, cur, steps


def _arr(mod, x):
    """int32 `x` as the module's array type (jax or torch)."""
    arr = np.asarray(x, np.int32)
    return jnp.asarray(arr) if mod is jg else torch.from_numpy(arr)


def test_int8_paged_arenas_and_logits_match_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    table = np.arange(4, dtype=np.int32)[None]
    pj = jg.init_kv_pages(cfg_j, 4, PT, quant_dtype="int8", quant_block=4)
    pt_ = tg.init_kv_pages(cfg_t, 4, PT, quant_dtype="int8", quant_block=4,
                           device="cpu")
    _, exact_toks, exact = _int8_run(
        tg, params_t, cfg_t, tg.init_kv_pages(cfg_t, 4, PT, device="cpu"),
        torch.from_numpy(table))
    pj, _, lj = _int8_run(jg, params_j, cfg_j, pj, jnp.asarray(table),
                          forced=exact_toks)
    pt_, _, lt = _int8_run(tg, params_t, cfg_t, pt_,
                           torch.from_numpy(table), forced=exact_toks)
    # dequantized arenas within one scale step per element
    from easydist_tpu_torch.ops import kv_dequantize

    for k in ("k", "v"):
        mine = kv_dequantize(pt_[k][:, :4], pt_[f"{k}_scale"][:, :4])
        theirs = kv_dequantize(torch.from_numpy(np.array(pj[k])),
                               torch.from_numpy(np.array(pj[f"{k}_scale"])))
        step = torch.maximum(pt_[f"{k}_scale"][:, :4], torch.from_numpy(
            np.array(pj[f"{k}_scale"]))).repeat_interleave(4, dim=-1)
        assert bool(((mine - theirs).abs() <= step + 1e-6).all())
    spread = max(float(e.max() - e.min()) for e in exact)
    # the JAX drift bar (test_kv_quant.py:146-151), against the JAX int8
    # arm and against the port's exact arm
    for ref in (lj, exact):
        drift = max(float(np.abs(a - b).max()) for a, b in zip(lt, ref))
        assert drift <= 0.25 * spread, (drift, spread)


def _to_copy_inputs(gm):
    return [tuple(n.args[0].meta["val"].shape)
            for n in gm.graph.nodes
            if n.op == "call_function"
            and n.target == torch.ops.aten._to_copy.default]


@pytest.mark.parametrize("compute,store", [("float32", None),
                                           ("bfloat16", None),
                                           ("float32", "bfloat16")])
def test_exact_decode_passes_the_arena_without_a_copy(model, compute,
                                                      store):
    _, _, _, params_t = model
    cfg = tg.GPTConfig.tiny(dtype=compute)
    arena = tg.init_kv_pages(cfg, NP, PT, dtype=store, device="cpu")
    step = easydist_compile(lambda a, p, t, tok, pos:
                            tg.gpt_decode_step_paged(p, cfg, a, t, tok, pos))
    gm = step.get_compiled(arena, params_t, torch.from_numpy(TABLE),
                           torch.ones(3, dtype=torch.int32),
                           torch.tensor([13, 20, 0], dtype=torch.int32)
                           ).graph_module
    layer = tuple(arena["k"].shape[1:])
    allocatable = (NP,) + layer[1:]
    assert not [s for s in _to_copy_inputs(gm)
                if s in (layer, allocatable)]


# ------------------------------------------------------------- session


def test_ids_equal_jax_paged_and_port_bucketed(model, jax_paged_mixed):
    _, _, cfg_t, params_t = model
    paged, sess = _serve(params_t, cfg_t, MIXED)
    bucketed, _ = _serve(params_t, cfg_t, MIXED, layout="bucketed")
    assert paged == jax_paged_mixed
    assert paged == bucketed
    stats = sess.stats()
    assert stats["decode_signatures"]["size"] == 1
    assert stats["prefill_signatures"]["size"] == 1
    assert stats["buckets"][32]["kv_table_mapped"] == 0


def test_one_decode_one_prefill_signature_across_waves(model):
    _, _, cfg_t, params_t = model
    _, sess = _serve(params_t, cfg_t, MIXED, n_new=6)
    futs = [sess.submit([7] * n, max_new_tokens=3) for n in (1, 6, 15, 23)]
    sess.run_until_drained()
    assert all(f.result(timeout=5)["finish_reason"] == "length"
               for f in futs)
    stats = sess.stats()
    assert stats["decode_signatures"]["size"] == 1
    assert stats["prefill_signatures"]["size"] == 1
    # the bucketed programs were never traced
    assert sess._decode_c.cache_stats()["size"] == 0
    assert sess._restore_c.cache_stats()["size"] == 0


def test_zero_copy_restore_saves_the_restored_pages(model):
    _, _, cfg_t, params_t = model
    sess = GenerationSession.for_gpt(params_t, cfg_t, config=_config(),
                                     device="cpu", compile_key=None)
    shared = list(range(1, 17))                 # 2 whole pages of 8
    a = sess.submit(shared + [20], max_new_tokens=3)
    sess.run_until_drained()
    assert sess.metrics.counter("copy_on_restore_bytes_saved") == 0
    b = sess.submit(shared + [21], max_new_tokens=3)
    sess.run_until_drained()
    pool = sess._pools[32]
    assert sess.metrics.counter("copy_on_restore_bytes_saved") == \
        2 * pool.page_bytes
    assert sess.metrics.counter("prefix_tokens_reused") == 16
    control, _ = _serve(params_t, cfg_t, [shared + [20], shared + [21]],
                        n_new=3, enable_prefix_cache=False)
    assert [a.result()["ids"], b.result()["ids"]] == control


def test_more_requests_than_slots_recycle_pages(model):
    _, _, cfg_t, params_t = model
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg_t.vocab, size=3 + i % 7).tolist()
               for i in range(8)]
    ids, sess = _serve(params_t, cfg_t, prompts, n_new=4)
    bucketed, _ = _serve(params_t, cfg_t, prompts, n_new=4,
                         layout="bucketed")
    assert ids == bucketed
    st = sess.stats()["buckets"][32]
    assert st["active"] == 0 and st["kv_table_mapped"] == 0
    pool = sess._pools[32]
    trie_pages = sum(1 for n in pool.trie._walk() if "page" in n.kv)
    assert st["kv_pool"]["in_use"] == trie_pages
    assert st["kv_pool"]["allocs"] > st["kv_pool"]["n_pages"] - 1 or \
        st["kv_pool"]["frees"] > 0


def test_arena_written_in_place_and_gauges(model):
    _, _, cfg_t, params_t = model
    sess = GenerationSession.for_gpt(params_t, cfg_t, config=_config(),
                                     device="cpu", compile_key=None)
    sess.submit(list(range(1, 13)), max_new_tokens=4)
    sess.step()
    pool = sess._pools[32]
    ptrs = {k: t.data_ptr() for k, t in pool.arena.items()}
    sess.run_until_drained()
    assert {k: t.data_ptr() for k, t in pool.arena.items()} == ptrs
    # 12 prompt + 4 new = 16 tokens: 2 pages reserved (the peak); after
    # the last retire only the trie's committed prefix page stays
    assert pool.pool.stats()["peak_in_use"] == 2
    assert pool.pool.in_use == 1
    gauges = sess.metrics.snapshot()["gauges"]
    assert gauges["kv_pages_in_use"] == 1
    assert 0.0 < gauges["kv_page_utilization"] <= 1.0
    assert gauges["kv_quant_bytes_saved"] == 0


def test_int8_session(model):
    _, _, cfg_t, params_t = model
    exact, esess = _serve(params_t, cfg_t, QUANT_PROMPTS, n_new=6)
    got, sess = _serve(params_t, cfg_t, QUANT_PROMPTS, n_new=6,
                       kv_quant_dtype="int8")
    pool, epool = sess._pools[32], esess._pools[32]
    assert {k: t.dtype for k, t in pool.arena.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
        "v_scale": torch.float32}
    assert pool.page_bytes < epool.page_bytes
    assert pool.model_page_bytes == epool.page_bytes
    assert sess.metrics.snapshot()["gauges"]["kv_quant_bytes_saved"] > 0
    again, _ = _serve(params_t, cfg_t, QUANT_PROMPTS, n_new=6,
                      kv_quant_dtype="int8")
    assert again == got                 # rint quantization: deterministic
    flat_e = [t for ids in exact for t in ids]
    flat_g = [t for ids in got for t in ids]
    match = sum(a == b for a, b in zip(flat_e, flat_g)) / len(flat_e)
    assert match >= 0.7, (match, exact, got)


def test_bf16_arena_under_f32_compute(model):
    _, _, cfg_t, params_t = model
    want, _ = _serve(params_t, cfg_t, QUANT_PROMPTS, n_new=6)
    got, sess = _serve(params_t, cfg_t, QUANT_PROMPTS, n_new=6,
                       kv_cache_dtype="bfloat16")
    assert sess._pools[32].arena["k"].dtype == torch.bfloat16
    assert sorted(sess._pools[32].arena) == ["k", "v"]
    flat_w = [t for ids in want for t in ids]
    flat_g = [t for ids in got for t in ids]
    assert sum(a == b for a, b in zip(flat_w, flat_g)) / len(flat_w) >= 0.7


def test_audit_raises_on_broken_bookkeeping(model):
    _, _, cfg_t, params_t = model
    _, sess = _serve(params_t, cfg_t, MIXED[:1])
    pool = sess._pools[32]
    sess._audit_kv(pool, "clean")
    pool.table.map(1, 0, pool.pool.alloc())
    pool.table.map(0, 0, pool.table.mapped(1)[0])  # shared without share()
    with pytest.raises(RuntimeError, match="refcount 1"):
        sess._audit_kv(pool, "test")


def test_small_arena_and_missing_hooks_raise(model):
    _, _, cfg_t, params_t = model
    sess = GenerationSession.for_gpt(params_t, cfg_t, device="cpu",
                                     config=_config(kv_arena_pages=3),
                                     compile_key=None)
    with pytest.raises(ValueError, match="cannot hold"):
        sess.submit([1, 2], max_new_tokens=2)
        sess.step()
    with pytest.raises(ValueError, match="requires model_prefill_chunk"):
        GenerationSession(params_t, model_prefill_chunk=lambda *a: None,
                          model_decode=lambda *a: None,
                          init_cache=lambda *a: None, device="cpu",
                          config=_config())


@pytest.mark.parametrize("kw", [
    # tests/test_serve/test_paged_generation.py:305-318
    dict(kv_layout="ragged"),
    dict(prefill_chunk=8, kv_layout="paged", kv_page_tokens=4),
    dict(kv_layout="paged", kv_arena_pages=-1),
    # tests/test_serve/test_kv_quant.py:268-282
    dict(kv_quant_dtype="fp4"),
    dict(kv_quant_dtype="int8"),
    dict(kv_quant_dtype="int8", kv_layout="paged",
         kv_cache_dtype="bfloat16"),
    dict(kv_quant_block=-1),
    dict(kv_host_tier_bytes=-1),
    dict(kv_host_tier_bytes=1 << 20),
    dict(kv_host_tier_bytes=1 << 20, kv_layout="paged",
         enable_prefix_cache=False),
])
def test_config_rejected_like_jax(kw):
    with pytest.raises(ValueError):
        JaxServeConfig(decode_buckets=(32,), **kw)
    with pytest.raises(ValueError):
        ServeConfig(decode_buckets=(32,), **kw)


def test_config_accepted_and_host_tier_not_ported():
    sc = ServeConfig(decode_buckets=(32,), kv_layout="paged",
                     kv_quant_dtype="int8", kv_quant_block=4,
                     kv_page_tokens=32, prefill_chunk=64)
    assert sc.kv_quant_dtype == "int8" and sc.kv_page_tokens == 32
    with pytest.raises(NotImplementedError, match="host tier"):
        ServeConfig(decode_buckets=(32,), kv_layout="paged",
                    kv_host_tier_bytes=1 << 20)


def test_prefix_cache_evict_hook_and_page_refs():
    evicted = []
    trie = PrefixCache(chunk=4, byte_budget=300, on_evict=evicted.append)
    a = trie.commit([], [1, 2, 3, 4], {"page": 0}, nbytes=100)
    b = trie.commit([a], [5, 6, 7, 8], {"page": 1}, nbytes=100)
    c = trie.commit([], [9, 9, 9, 9], {"page": 2}, nbytes=100)
    assert trie.bytes_used == 300
    trie.pin([a, b])
    assert trie.evict_lru() and evicted == [c]
    assert not trie.evict_lru()                 # everything left is pinned
    trie.unpin([a, b])
    # room for 200 bytes: the LRU unpinned leaf (b) goes, then a's bytes
    # fit beside the new node
    assert trie.commit([], [8, 8, 8, 8], {"page": 3}, nbytes=200)
    assert [n.kv["page"] for n in evicted] == [2, 1]
    assert trie.bytes_used == 300
    assert trie.check_invariants() == []


def test_metrics_kv_recorders():
    m = ServeMetrics()
    m.record_kv_pool(4, 24, 8, quant_bytes_saved=512)
    m.record_copy_on_restore_saved(100)
    m.record_copy_on_restore_saved(28)
    snap = m.snapshot()
    assert snap["gauges"]["kv_pages_in_use"] == 4
    assert snap["gauges"]["kv_page_utilization"] == 24 / 32
    assert snap["gauges"]["kv_quant_bytes_saved"] == 512
    assert snap["counters"]["copy_on_restore_bytes_saved"] == 128
    m.record_kv_pool(0, 0, 8)
    assert m.snapshot()["gauges"]["kv_page_utilization"] == 1.0
