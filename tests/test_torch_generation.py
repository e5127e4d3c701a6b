"""The port's `GenerationSession` (easydist_tpu_torch.serve) on the
bucketed layout, held against the JAX package: greedy ids equal the JAX
uncached re-forward from the same weights (the bar of the JAX dryrun's
serving section, __graft_entry__.py), prefix cache on/off give the same
ids, one decode signature serves every step, and the counters add up."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.models import gpt as jg
from easydist_tpu.serve import ServeConfig as JaxServeConfig
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.serve import (GenerationSession, PrefixCache,
                                      ReplicaDrainingError,
                                      RequestTooLargeError, ServeConfig)

N_NEW = 5
DRYRUN_PROMPTS = [[3, 14, 15, 9, 2], [11, 5]]
SHARED = list(range(1, 17))
PREFIX_PROMPTS = [SHARED + [20, 21], [3, 14, 15, 9, 2], SHARED + [30],
                  [9] * 20, SHARED + [40, 41, 42]]


@pytest.fixture(scope="module")
def model():
    cfg_j = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(7))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tg.GPTConfig.tiny(), params_t


def _jax_uncached_greedy(apply, params, prompt, n_new=N_NEW):
    cur, out = list(prompt), []
    for _ in range(n_new):
        logits = apply(params, jnp.asarray([cur], jnp.int32))
        nxt = int(jnp.argmax(logits[0, len(cur) - 1]))
        out.append(nxt)
        cur.append(nxt)
    return out


def _port_uncached_greedy(params, cfg, prompt, n_new=N_NEW):
    cur, out = list(prompt), []
    for _ in range(n_new):
        logits = tg.gpt_apply(params, cfg, torch.tensor([cur]))
        nxt = int(torch.argmax(logits[0, len(cur) - 1]))
        out.append(nxt)
        cur.append(nxt)
    return out


def _serve(params, cfg, prompts, config, n_new=N_NEW, **kw):
    sess = GenerationSession.for_gpt(params, cfg, config=config,
                                     device="cpu", **kw)
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    return sess, [f.result(timeout=5) for f in futs]


def test_ids_equal_jax_uncached_reforward(model):
    cfg_j, params_j, cfg_t, params_t = model
    apply = jax.jit(lambda p, t: jg.gpt_apply(p, cfg_j, t))
    ref = [_jax_uncached_greedy(apply, params_j, p) for p in DRYRUN_PROMPTS]
    # compile_key=None: a private signature cache, not the process memo
    # that other sessions of this config share
    sess, res = _serve(params_t, cfg_t, DRYRUN_PROMPTS,
                       ServeConfig(decode_buckets=(cfg_t.seq,),
                                   max_decode_slots=2), compile_key=None)
    assert [r["ids"] for r in res] == ref
    assert all(r["finish_reason"] == "length" for r in res)
    stats = sess.stats()
    assert stats["decode_signatures"]["size"] == 1
    assert stats["prefill_signatures"]["size"] == 1


def test_prefix_cache_on_off_same_ids(model):
    _, _, cfg_t, params_t = model
    base = dict(decode_buckets=(cfg_t.seq,), max_decode_slots=2,
                prefill_chunk=8, prefill_batch=2)
    s_on, on = _serve(params_t, cfg_t, PREFIX_PROMPTS, ServeConfig(**base))
    _, off = _serve(params_t, cfg_t, PREFIX_PROMPTS,
                    ServeConfig(enable_prefix_cache=False, **base))
    ids = [r["ids"] for r in on]
    assert ids == [r["ids"] for r in off]
    assert ids == [_port_uncached_greedy(params_t, cfg_t, p)
                   for p in PREFIX_PROMPTS]
    trie = s_on.stats()["buckets"][cfg_t.seq]["prefix_cache"]
    assert trie["hits"] > 0
    assert s_on._pools[cfg_t.seq].trie.check_invariants() == []
    assert s_on.metrics.counter("prefix_tokens_reused") > 0


def test_metrics_counters_and_in_place_pool(model):
    _, _, cfg_t, params_t = model
    sess = GenerationSession.for_gpt(
        params_t, cfg_t, device="cpu",
        config=ServeConfig(decode_buckets=(cfg_t.seq,), max_decode_slots=2,
                           prefill_chunk=8, prefill_batch=2))
    futs = [sess.submit(p, max_new_tokens=N_NEW) for p in PREFIX_PROMPTS[:3]]
    sess.step()
    pool = sess._pools[cfg_t.seq]
    ptrs = (pool.cache["k"].data_ptr(), pool.staging["k"].data_ptr())
    sess.run_until_drained()
    assert (pool.cache["k"].data_ptr(),
            pool.staging["k"].data_ptr()) == ptrs
    ids = [f.result(timeout=5)["ids"] for f in futs]
    m = sess.metrics
    assert m.counter("requests_submitted") == 3
    assert m.counter("requests_completed") == 3
    assert m.counter("prefills") == 3
    # each request's first id comes from its prefill, the rest from decode
    assert m.counter("tokens_generated") == sum(len(x) - 1 for x in ids)
    assert m.counter("decode_steps") >= N_NEW - 1
    assert m.counter("prefill_chunks") >= 3
    snap = m.snapshot()
    assert snap["latency"]["ttft"]["count"] == 3
    assert snap["prefill_padding_ratio"] >= 1.0
    assert sess.stats()["queue_depth"] == 0 and sess.is_drained


def test_eos_and_bucket_full_retire(model):
    _, _, cfg_t, params_t = model
    first = _port_uncached_greedy(params_t, cfg_t, [3, 14, 15], 1)[0]
    sess, res = _serve(params_t, cfg_t, [[3, 14, 15]],
                       ServeConfig(decode_buckets=(cfg_t.seq,),
                                   max_decode_slots=1), eos_id=first)
    assert res[0] == {"ids": [first], "finish_reason": "eos"}
    sess, res = _serve(params_t, cfg_t, [[1] * 29],
                       ServeConfig(decode_buckets=(cfg_t.seq,),
                                   max_decode_slots=1), n_new=10)
    assert res[0]["finish_reason"] == "bucket_full"
    assert len(res[0]["ids"]) == cfg_t.seq - 29 + 1


def test_bf16_session_completes(model):
    _, _, _, params_t = model
    cfg = tg.GPTConfig.tiny(dtype="bfloat16")
    sess, res = _serve(params_t, cfg, DRYRUN_PROMPTS,
                       ServeConfig(decode_buckets=(cfg.seq,),
                                   max_decode_slots=2))
    assert [len(r["ids"]) for r in res] == [N_NEW, N_NEW]
    assert sess._pools[cfg.seq].cache["k"].dtype == torch.bfloat16


def test_submit_errors_and_close(model):
    _, _, cfg_t, params_t = model
    sess = GenerationSession.for_gpt(
        params_t, cfg_t, device="cpu",
        config=ServeConfig(decode_buckets=(cfg_t.seq,)))
    with pytest.raises(ValueError, match="empty prompt"):
        sess.submit([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        sess.submit([1], max_new_tokens=0)
    with pytest.raises(RequestTooLargeError):
        sess.submit([1] * cfg_t.seq)
    fut = sess.submit([1, 2], max_new_tokens=2)
    sess.close()
    assert len(fut.result(timeout=5)["ids"]) == 2
    with pytest.raises(ReplicaDrainingError):
        sess.submit([1])


def test_for_gpt_checks_buckets_and_param_device(model):
    _, _, cfg_t, params_t = model
    with pytest.raises(ValueError, match="exceed the model's maximum"):
        GenerationSession.for_gpt(params_t, cfg_t, device="cpu",
                                  config=ServeConfig(decode_buckets=(64,)))
    with pytest.raises(ValueError, match="params live on"):
        GenerationSession.for_gpt(params_t, cfg_t, device="meta")


@pytest.mark.parametrize("kw,exc", [
    # the paged knobs follow the JAX rules
    # (tests/test_serve/test_paged_generation.py:309-312, test_kv_quant.py)
    (dict(kv_layout="paged", decode_buckets=(32,), prefill_chunk=8,
          kv_page_tokens=4), ValueError),
    # speculation and ServeEngine are ported: their fields follow the JAX
    # rules (tests/test_serve/test_speculate.py TestKnobValidation,
    # tests/test_resilience/test_serve_degradation.py)
    (dict(speculate_k=31, decode_buckets=(32,)), ValueError),
    (dict(decode_buckets=(96,), prefill_chunk=64), ValueError),
    (dict(kv_cache_dtype="not_a_dtype"), ValueError),
    (dict(kv_quant_dtype="int8"), ValueError),
    (dict(retry_jitter=1.5), ValueError),
    (dict(kv_layout="paged", kv_page_tokens=16), ValueError),
    (dict(speculate_k=2, speculate_drafter="model"), ValueError),
])
def test_serve_config_validation(kw, exc):
    with pytest.raises(exc):
        ServeConfig(**kw)
    with pytest.raises(exc):
        JaxServeConfig(**kw)
    assert ServeConfig(speculate_k=2, max_queue=8).speculate_k == 2
    assert ServeConfig(kv_cache_dtype="bfloat16").kv_cache_dtype == "bfloat16"
    assert ServeConfig(kv_layout="paged").kv_layout == "paged"


def test_prefix_cache_commit_match_evict():
    def kv():
        return {"k": torch.zeros(2, 2, 4, 2), "v": torch.zeros(2, 2, 4, 2)}

    nbytes = 2 * 2 * 2 * 4 * 2 * 4
    trie = PrefixCache(chunk=4, byte_budget=2 * nbytes)
    a = trie.commit([], [1, 2, 3, 4], kv())
    b = trie.commit([a], [5, 6, 7, 8], kv())
    assert trie.bytes_used == 2 * nbytes
    n, nodes = trie.match([1, 2, 3, 4, 5, 6, 7, 8, 9], max_tokens=8)
    assert n == 8 and nodes == [a, b]
    trie.pin(nodes)
    assert trie.commit([], [9, 9, 9, 9], kv()) is None  # all pinned
    trie.unpin(nodes)
    c = trie.commit([], [9, 9, 9, 9], kv())   # evicts leaf b
    assert c is not None and trie.evictions == 1
    assert trie.match([1, 2, 3, 4, 5, 6, 7, 8])[0] == 4
    assert trie.commit([], [1, 2], kv()) is None  # partial chunk
    assert trie.check_invariants() == []
    assert trie.stats()["nodes"] == 2
