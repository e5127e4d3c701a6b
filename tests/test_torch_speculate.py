"""The port's speculative decoding (easydist_tpu_torch.models.gpt verify
steps, serve.speculate, GenerationSession with speculate_k > 0) held
against the JAX package from the same weights (`params_from_numpy`):
the verify steps' logits and caches at rtol 1e-4 / atol 1e-5 (bucketed,
paged exact and int8, a window straddling a page boundary, a dead row),
their write locality, the drafters' proposals exactly, speculative
sessions' ids equal to the JAX speculative session's and to the port's
uncached re-forward, the signature closure of the JAX tests, the paged
rollback, and the knob validation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.models import gpt as jg
from easydist_tpu.serve import GenerationSession as JaxSession
from easydist_tpu.serve import ServeConfig as JaxServeConfig
from easydist_tpu.serve import speculate as jspec
from easydist_tpu_torch.kv import audit_page_table
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.serve import (GenerationSession, NGramDrafter,
                                      ServeConfig, SmallModelDrafter,
                                      accept_length)

RTOL, ATOL = 1e-4, 1e-5
PT, NP = 8, 10          # page tokens (the tiny config's prefill chunk), pages
# tests/test_serve/test_speculate.py:23-24
REPETITIVE = [[5, 6, 5, 6, 5, 6, 5], [9, 3, 9, 3, 9, 3, 9, 3, 9],
              [1, 2, 3, 1, 2, 3, 1]]


@pytest.fixture(scope="module")
def model():
    cfg_j = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(0))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tg.GPTConfig.tiny(), params_t


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _config(layout="bucketed", spec_k=0, cls=ServeConfig, **kw):
    base = dict(decode_buckets=(32,), max_decode_slots=2,
                prefill_chunk=8, prefill_batch=2, kv_layout=layout,
                speculate_k=spec_k)
    base.update(kw)
    return cls(**base)


def _drain(sess, prompts, max_new):
    futs = [sess.submit(p, max_new_tokens=max_new) for p in prompts]
    sess.run_until_drained()
    return [f.result(timeout=5)["ids"] for f in futs]


def _session(params, cfg, config, **kw):
    return GenerationSession.for_gpt(params, cfg, config=config,
                                     device="cpu", compile_key=None, **kw)


def _uncached(params, cfg, prompt, n_new):
    cur, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n_new):
            logits = tg.gpt_apply(params, cfg, torch.tensor([cur]))
            out.append(int(torch.argmax(logits[0, len(cur) - 1])))
            cur.append(out[-1])
    return out


# ------------------------------------------------------- verify steps


def test_verify_step_matches_jax(model):
    cfg_j, params_j, cfg_t, params_t = model
    rs = np.random.RandomState(0)
    shape = (cfg_j.layers, 2, cfg_j.heads, cfg_j.seq, cfg_j.dim // cfg_j.heads)
    cache = {k: rs.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    tokens = rs.randint(0, cfg_j.vocab, (2, 4)).astype(np.int32)
    pos = np.array([10, 28], np.int32)          # row 1 ends at the wall
    cj, lj = jg.gpt_verify_step(params_j, cfg_j,
                                {k: jnp.asarray(v) for k, v in cache.items()},
                                jnp.asarray(tokens), jnp.asarray(pos))
    ct, lt = tg.gpt_verify_step(
        params_t, cfg_t, {k: torch.from_numpy(v.copy())
                          for k, v in cache.items()},
        torch.from_numpy(tokens), torch.from_numpy(pos))
    assert tuple(lt.shape) == (2, 4, cfg_t.vocab)
    _close(lt.numpy(), lj)
    for k in cache:
        _close(ct[k].numpy(), cj[k])


def test_verify_writes_only_at_pos_window(model):
    """tests/test_serve/test_speculate.py::TestVerifyWriteLocality: rows
    below pos and past pos + k + 1 stay bitwise, the window changes."""
    _, _, cfg, params = model
    k = 3
    rs = np.random.RandomState(0)
    shape = (cfg.layers, 1, cfg.heads, cfg.seq, cfg.dim // cfg.heads)
    old = {kk: rs.standard_normal(shape).astype(np.float32)
           for kk in ("k", "v")}
    p = 10
    new, logits = tg.gpt_verify_step(
        params, cfg, {kk: torch.from_numpy(v.copy()) for kk, v in old.items()},
        torch.tensor([[4, 5, 6, 7]], dtype=torch.int32),
        torch.tensor([p], dtype=torch.int32))
    assert tuple(logits.shape) == (1, k + 1, cfg.vocab)
    for kk in ("k", "v"):
        old_a, new_a = old[kk], new[kk].numpy()
        assert (old_a[:, :, :, :p] == new_a[:, :, :, :p]).all()
        assert (old_a[:, :, :, p + k + 1:] == new_a[:, :, :, p + k + 1:]).all()
        assert not (old_a[:, :, :, p:p + k + 1]
                    == new_a[:, :, :, p:p + k + 1]).all()


# row 0's window 6..9 straddles windows 0 and 1; row 1 is mid-page;
# row 2 is dead (all sentinel)
VERIFY_TABLE = np.array([[3, 7, NP, NP], [1, 2, 5, NP], [NP] * 4], np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_verify_step_paged_matches_jax(model, quant):
    cfg_j, params_j, cfg_t, params_t = model
    rs = np.random.RandomState(3)
    hd = cfg_j.dim // cfg_j.heads
    shape = (cfg_j.layers, NP + 1, cfg_j.heads, PT, hd)
    if quant:
        arena = {k: rs.randint(-127, 128, shape).astype(np.int8)
                 for k in ("k", "v")}
        arena.update({k: rs.uniform(0.001, 0.02, shape[:-1] + (2,))
                      .astype(np.float32) for k in ("k_scale", "v_scale")})
    else:
        arena = {k: rs.standard_normal(shape).astype(np.float32)
                 for k in ("k", "v")}
    tokens = rs.randint(0, cfg_j.vocab, (3, 4)).astype(np.int32)
    pos = np.array([6, 17, 0], np.int32)
    pj, lj = jg.gpt_verify_step_paged(
        params_j, cfg_j, {k: jnp.asarray(a[:, :NP]) for k, a in arena.items()},
        jnp.asarray(VERIFY_TABLE), jnp.asarray(tokens), jnp.asarray(pos))
    pt_, lt = tg.gpt_verify_step_paged(
        params_t, cfg_t, {k: torch.from_numpy(a.copy())
                          for k, a in arena.items()},
        torch.from_numpy(VERIFY_TABLE), torch.from_numpy(tokens),
        torch.from_numpy(pos))
    # the dead row's logits are garbage nobody reads
    _close(lt[:2].numpy(), np.asarray(lj)[:2])
    for k in arena:
        got = pt_[k][:, :NP].numpy()
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, np.asarray(pj[k]))
        else:
            _close(got, pj[k])
    # only the live rows' pages changed: 3 and 7 (row 0's straddle), 5
    # (row 1's window 17 // 8 = 2)
    moved = {int(p) for p in np.nonzero(
        (pt_["k"][:, :NP].numpy() != arena["k"][:, :NP]).any(
            axis=(0, 2, 3, 4)))[0]}
    assert moved == {3, 7, 5}


# ------------------------------------------------------------ drafters


def test_accept_length_matches_jax():
    rs = np.random.RandomState(0)
    cases = [([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 2, 9]),
             ([1, 2, 3], [9, 2, 3]), ([], [1, 2]), ([1, 9, 3], [1, 2, 3])]
    cases += [(rs.randint(0, 3, 4).tolist(), rs.randint(0, 3, 5).tolist())
              for _ in range(20)]
    for d, t in cases:
        assert accept_length(d, t) == jspec.accept_length(d, t)
    assert accept_length([1, 9, 3], [1, 2, 3]) == 1


def test_ngram_drafter_matches_jax():
    rs = np.random.RandomState(1)
    seqs = [[5, 6, 7, 8, 5, 6], [1, 2, 3, 1, 2, 9, 1, 2], [1, 2, 3, 4, 5],
            [4, 4, 2, 4, 4]] + [rs.randint(0, 4, n).tolist()
                                for n in (6, 9, 14, 23, 40)]
    mine, theirs = NGramDrafter(), jspec.NGramDrafter()
    for rid, seq in enumerate(seqs):
        for k in (1, 2, 4):
            # growing prefixes exercise the incremental index
            for cut in range(1, len(seq) + 1):
                assert mine.propose(rid, seq[:cut], k) == \
                    theirs.propose(rid, seq[:cut], k), (seq[:cut], k)
    assert NGramDrafter().propose(0, [5, 6, 7, 8, 5, 6], 2) == [7, 8]
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=1, min_ngram=2)


def test_small_model_drafter_matches_jax(model):
    """Proposals equal the JAX drafter's (exact ids) and the draft
    model's own uncached greedy; a committed sequence that diverges from
    what was fed resyncs to what a fresh drafter proposes; `forget`
    drops the request's cache; one draft signature in total."""
    cfg_j, params_j, cfg_t, params_t = model
    mine = SmallModelDrafter(
        params_t,
        model_decode=lambda p, c, t, pos: tg.gpt_decode_step(p, cfg_t, c, t,
                                                             pos),
        init_cache=lambda b, L: tg.init_kv_cache(cfg_t, b, L, device="cpu"),
        max_len=cfg_t.seq, device="cpu")
    theirs = jspec.SmallModelDrafter(
        params_j,
        model_decode=lambda p, c, t, pos: jg.gpt_decode_step(p, cfg_j, c, t,
                                                             pos),
        init_cache=lambda b, L: jg.init_kv_cache(cfg_j, b, L),
        max_len=cfg_j.seq)
    prompt = [3, 14, 15, 9, 2]
    got = mine.propose(0, prompt, 4)
    assert got == theirs.propose(0, prompt, 4)
    assert got == _uncached(params_t, cfg_t, prompt, 4)
    committed = prompt + [1, 7]                 # the target went elsewhere
    assert mine.propose(0, committed, 3) == theirs.propose(0, committed, 3)
    fresh = SmallModelDrafter(
        params_t,
        model_decode=lambda p, c, t, pos: tg.gpt_decode_step(p, cfg_t, c, t,
                                                             pos),
        init_cache=lambda b, L: tg.init_kv_cache(cfg_t, b, L, device="cpu"),
        max_len=cfg_t.seq, device="cpu")
    assert mine.propose(0, committed, 3) == fresh.propose(0, committed, 3)
    assert mine.cache_stats()["size"] == 1 and mine.n_states == 1
    mine.forget(0)
    assert mine.n_states == 0


# ------------------------------------------------------------ sessions


@pytest.fixture(scope="module")
def jax_spec_ids(model):
    """The JAX package's speculative sessions on the shared traffic:
    bucketed k=3 (12 new tokens) and paged k=4 (9 new tokens)."""
    cfg_j, params_j, _, _ = model
    out = {}
    for layout, k, n in (("bucketed", 3, 12), ("paged", 4, 9)):
        sess = JaxSession.for_gpt(params_j, cfg_j, config=_config(
            layout, spec_k=k, cls=JaxServeConfig))
        out[layout] = _drain(sess, REPETITIVE, n)
    return out


@pytest.mark.parametrize("layout,k,n_new", [("bucketed", 3, 12),
                                            ("paged", 4, 9)])
def test_speculative_session_matches_jax_and_uncached(model, jax_spec_ids,
                                                      layout, k, n_new):
    _, _, cfg, params = model
    sess = _session(params, cfg, _config(layout, spec_k=k))
    ids = _drain(sess, REPETITIVE, n_new)
    assert ids == jax_spec_ids[layout]
    for p, got in zip(REPETITIVE, ids):
        assert got == _uncached(params, cfg, p, n_new)
    st = sess.stats()
    c = st["metrics"]["counters"]
    assert c["verify_steps"] > 0
    # the JAX tests' closure (TestSignatureClosure): one verify signature
    # per bucket, one in total paged; a second wave adds none
    _drain(sess, [[2, 8, 2, 8, 2, 8]], 10)
    assert sess.stats()["verify_signatures"]["size"] == 1
    assert sess.stats()["decode_signatures"]["size"] == 1
    if layout == "paged":
        pool = sess._pools[32]
        assert audit_page_table(pool.pool, pool.table, trie=pool.trie) == []
        assert c["speculative_rollback_audits"] == c["verify_steps"]


def test_speculation_metrics(model):
    """tests/test_serve/test_speculate.py::TestSpeculationMetrics."""
    _, _, cfg, params = model
    sess = _session(params, cfg, _config(spec_k=3))
    _drain(sess, REPETITIVE, 12)
    m = sess.stats()["metrics"]
    c, g = m["counters"], m["gauges"]
    assert c["verify_steps"] > 0 and c["draft_tokens_proposed"] > 0
    assert 0 < c["draft_tokens_accepted"] <= c["draft_tokens_proposed"]
    assert g["acceptance_rate"] == pytest.approx(
        c["draft_tokens_accepted"] / c["draft_tokens_proposed"])
    assert c["tokens_generated"] == 3 * (12 - 1)
    assert c["verify_host_us"] > 0


@pytest.mark.parametrize("layout", ["bucketed", "paged"])
def test_self_draft_accepts_everything(model, layout):
    """tests/test_serve/test_speculate.py::TestDraftModelDrafterGPT: the
    target drafting for itself accepts every proposal, with one draft
    signature, and every request's draft cache is forgotten on
    retire."""
    _, _, cfg, params = model
    sess = _session(params, cfg, _config(
        layout, spec_k=4, speculate_drafter="draft_model"),
        draft_model=(params, cfg))
    ids = _drain(sess, REPETITIVE[:2], 9)
    assert ids == [_uncached(params, cfg, p, 9) for p in REPETITIVE[:2]]
    m = sess.stats()["metrics"]
    assert m["gauges"]["acceptance_rate"] == pytest.approx(1.0)
    drafter = sess._drafter
    assert drafter.cache_stats()["size"] == 1 and drafter.n_states == 0


class _LateMissDrafter:
    """Self-drafting that proposes wrong tokens after the first one once
    the sequence holds `late` tokens: the round then accepts one draft,
    so the slot survives a round whose window spilled past its
    reservation."""

    def __init__(self, inner, late: int):
        self.inner, self.late = inner, late

    def propose(self, rid, ids, k):
        d = self.inner.propose(rid, ids, k)
        if d and len(ids) >= self.late:
            d = d[:1] + [(t + 1) % 128 for t in d[1:]]
        return d

    def forget(self, rid):
        self.inner.forget(rid)


def test_paged_rollback_releases_spill_pages(model):
    """A 7-token prompt with 9 new tokens reserves 2 pages (16
    positions).  Round 1 at pos 7 commits 5; round 2 at pos 12 maps a
    spill page for positions 12..16, accepts one draft and survives, so
    the rollback must release the spill page; the ids stay the plain
    greedy ids and every page is free after the drain."""
    _, _, cfg, params = model
    inner = SmallModelDrafter(
        params,
        model_decode=lambda p, c, t, pos: tg.gpt_decode_step(p, cfg, c, t,
                                                             pos),
        init_cache=lambda b, L: tg.init_kv_cache(cfg, b, L, device="cpu"),
        max_len=cfg.seq, device="cpu")
    sess = _session(params, cfg, _config("paged", spec_k=4),
                    drafter=_LateMissDrafter(inner, late=13))
    ids = _drain(sess, [REPETITIVE[0]], 9)[0]
    assert ids == _uncached(params, cfg, REPETITIVE[0], 9)
    c = sess.stats()["metrics"]["counters"]
    assert c["speculative_rollback_pages_released"] > 0
    assert c["speculative_rollback_audits"] == c["verify_steps"]
    pool = sess._pools[32]
    assert pool.pool.in_use == 0 and inner.n_states == 0
    assert audit_page_table(pool.pool, pool.table, trie=pool.trie) == []


def test_eos_mid_verify_round_retires_exactly(model):
    _, _, cfg, params = model
    prompt = REPETITIVE[0]
    ref = _uncached(params, cfg, prompt, 12)
    eos = ref[len(ref) // 2]
    outs = []
    for k in (0, 3):
        sess = GenerationSession.for_gpt(params, cfg, config=_config(
            spec_k=k), device="cpu", compile_key=None, eos_id=eos)
        fut = sess.submit(prompt, max_new_tokens=12)
        sess.run_until_drained()
        outs.append(fut.result(timeout=5))
    assert outs[0] == outs[1] and outs[1]["finish_reason"] == "eos"


def test_knob_validation(model):
    _, _, cfg, params = model
    for kw, match in ((dict(spec_k=-1), "speculate_k"),
                      (dict(spec_k=2, speculate_drafter="oracle"),
                       "speculate_drafter"),
                      (dict(spec_k=31), "headroom")):
        for cls in (ServeConfig, JaxServeConfig):
            with pytest.raises(ValueError, match=match):
                _config(cls=cls, **kw)
    with pytest.raises(ValueError, match="drafter"):
        _session(params, cfg, _config(spec_k=2,
                                      speculate_drafter="draft_model"))
    with pytest.raises(ValueError, match="model_verify"):
        GenerationSession(
            params, model_prefill=lambda p, c, t, l: tg.gpt_prefill(
                p, cfg, c, t, l),
            model_decode=lambda p, c, t, pos: tg.gpt_decode_step(
                p, cfg, c, t, pos),
            init_cache=lambda b, L, dt=None: tg.init_kv_cache(
                cfg, b, L, dtype=dt, device="cpu"),
            config=_config(spec_k=2), device="cpu")


def test_speculate_k_default_from_config(monkeypatch):
    from easydist_tpu_torch import config as edconfig

    monkeypatch.setattr(edconfig, "speculate_k", 2)
    monkeypatch.setattr(edconfig, "speculate_drafter", "draft_model")
    sc = ServeConfig(decode_buckets=(32,))
    assert (sc.speculate_k, sc.speculate_drafter) == (2, "draft_model")
