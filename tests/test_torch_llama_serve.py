"""`GenerationSession.for_llama` (easydist_tpu_torch.serve) on the CPU,
held against the JAX package's `for_llama` sessions from the same
weights (`LlamaConfig.tiny()`: 4 query heads over 2 KV heads): greedy ids
on the bucketed and paged layouts and on int8 pages
(tests/test_serve/test_paged_generation.py:117, test_llama_gqa_parity),
and speculative decoding with the n-gram drafter and with the JAX test's
small llama as the draft model (tests/test_serve/test_speculate.py
:249-275).  The exact layouts are also held against an arm the reference
passes as well: the uncached re-forward's greedy ids."""

import jax
import numpy as np
import pytest
import torch

from easydist_tpu.models import llama as jl
from easydist_tpu.serve import GenerationSession as JaxSession
from easydist_tpu.serve import ServeConfig as JaxServeConfig
from easydist_tpu_torch.models import llama as tl
from easydist_tpu_torch.serve import GenerationSession, ServeConfig

MIXED = [[3, 14, 15, 9, 2],                     # shorter than one chunk
         [5, 6, 7, 8, 9, 10, 11, 12, 13],       # crosses a chunk
         [1, 2],
         [9] * 20]                              # crosses a page mid-decode
REPETITIVE = [[5, 6, 5, 6, 5, 6, 5], [9, 3, 9, 3, 9, 3, 9, 3, 9],
              [1, 2, 3, 1, 2, 3, 1]]
DRAFT = dict(dim=16, heads=2, kv_heads=1, ffn_dim=32, layers=1)


def _kw(layout="bucketed", **kw):
    base = dict(decode_buckets=(32,), max_decode_slots=2, prefill_chunk=8,
                prefill_batch=2, kv_layout=layout)
    base.update(kw)
    return base


def _port(params, cfg, prompts, n_new, draft_model=None, session_kw=None,
          **kw):
    sess = GenerationSession.for_llama(params, cfg, config=ServeConfig(**kw),
                                       device="cpu", draft_model=draft_model,
                                       **(session_kw or {}))
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    return [f.result(timeout=5)["ids"] for f in futs], sess


def _jax(params, cfg, prompts, n_new, draft_model=None, **kw):
    sess = JaxSession.for_llama(params, cfg, config=JaxServeConfig(**kw),
                                draft_model=draft_model)
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    return [f.result(timeout=5)["ids"] for f in futs]


def _carry(params_j):
    return tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                device="cpu")


@pytest.fixture(scope="module")
def model():
    """The tiny GQA llama of the JAX serving tests (PRNGKey(1)), both
    packages' weights."""
    cfg_j = jl.LlamaConfig.tiny()
    params_j = jl.llama_init(cfg_j, jax.random.PRNGKey(1))
    return cfg_j, params_j, tl.LlamaConfig.tiny(), _carry(params_j)


def _uncached(params, cfg, prompt, n_new):
    cur, out = list(prompt), []
    for _ in range(n_new):
        logits = tl.llama_apply(params, cfg, torch.tensor([cur]))
        out.append(int(torch.argmax(logits[0, len(cur) - 1])))
        cur.append(out[-1])
    return out


@pytest.mark.parametrize("layout,quant", [("bucketed", None),
                                          ("paged", None),
                                          ("paged", "int8")],
                         ids=["bucketed", "paged", "int8"])
def test_ids_equal_the_jax_session(model, layout, quant):
    cfg_j, params_j, cfg_t, params_t = model
    kw = _kw(layout, **({"kv_quant_dtype": quant} if quant else {}))
    # compile_key=None: a private signature cache, so the counts below are
    # this session's alone
    got, sess = _port(params_t, cfg_t, MIXED, 5,
                      session_kw={"compile_key": None}, **kw)
    assert got == _jax(params_j, cfg_j, MIXED, 5, **kw)
    if quant is None:
        assert got == [_uncached(params_t, cfg_t, p, 5) for p in MIXED]
    stats = sess.stats()
    assert stats["decode_signatures"]["size"] == 1
    if layout == "paged":
        pool = next(iter(sess._pools.values()))
        # the arena is kv_heads-shaped: 2 KV heads under 4 query heads
        assert pool.arena["k"].shape[2] == cfg_t.kv_heads
        assert stats["prefill_signatures"]["size"] == 1
    if quant:
        assert sess.metrics.snapshot()["gauges"]["kv_quant_bytes_saved"] > 0


@pytest.mark.parametrize("layout", ["bucketed", "paged"])
def test_speculation_matches_plain_and_jax(layout):
    # the JAX speculation tests' target (PRNGKey(0)) and draft (PRNGKey(1))
    cfg_j = jl.LlamaConfig.tiny()
    params_j = jl.llama_init(cfg_j, jax.random.PRNGKey(0))
    dcfg_j = jl.LlamaConfig.tiny(**DRAFT)
    dparams_j = jl.llama_init(dcfg_j, jax.random.PRNGKey(1))
    cfg_t, params_t = tl.LlamaConfig.tiny(), _carry(params_j)
    draft = (_carry(dparams_j), tl.LlamaConfig.tiny(**DRAFT))
    plain, _ = _port(params_t, cfg_t, REPETITIVE, 10, **_kw(layout))
    assert plain == _jax(params_j, cfg_j, REPETITIVE, 10, **_kw(layout))
    assert plain == [_uncached(params_t, cfg_t, p, 10) for p in REPETITIVE]
    ngram, sess = _port(params_t, cfg_t, REPETITIVE, 10,
                        **_kw(layout, speculate_k=3))
    assert ngram == plain
    assert sess.stats()["verify_signatures"]["size"] == 1
    drafted, sess = _port(params_t, cfg_t, REPETITIVE[:2], 8,
                          draft_model=draft,
                          **_kw(layout, speculate_k=3,
                                speculate_drafter="draft_model"))
    assert drafted == [p[:8] for p in plain[:2]]
    counters = sess.metrics.snapshot()["counters"]
    assert counters["draft_tokens_proposed"] > 0
    assert drafted == _jax(params_j, cfg_j, REPETITIVE[:2], 8,
                           draft_model=(dparams_j, dcfg_j),
                           **_kw(layout, speculate_k=3,
                                 speculate_drafter="draft_model"))


def test_prompts_past_cfg_seq(model):
    # RoPE has no learned position table: no max_prompt_len, and a bucket
    # longer than cfg.seq serves a prompt longer than cfg.seq
    _, _, cfg_t, params_t = model
    prompt = list(range(1, 41))
    got, _ = _port(params_t, cfg_t, [prompt], 4,
                   **_kw(decode_buckets=(64,)))
    assert got == [_uncached(params_t, cfg_t, prompt, 4)]


def test_params_must_live_on_the_session_device(model):
    _, _, cfg_t, params_t = model
    with pytest.raises(ValueError, match="place them there first"):
        GenerationSession.for_llama(params_t, cfg_t, device="meta",
                                    config=ServeConfig(**_kw()))
    from easydist_tpu_torch.serve import generation

    GenerationSession.for_llama(params_t, cfg_t, device="cpu",
                                config=ServeConfig(**_kw()))
    key = (("llama", tuple(vars(cfg_t).values()), "cpu"), None)
    assert key in generation._COMPILED_MEMO
