"""The port's GenerationSession lifecycle, mirroring
tests/test_serve/test_lifecycle.py (drain, evacuate and resume, close,
replica labels) on the bucketed and the paged layouts, plus what the
fleet router builds on: hot-page and prefix-path export/import (a fresh
session that imports them hits its prefix cache and keeps its ids),
`prefix_affinity`, `bucket_chunk`, `snapshot_inflight`, the
`fleet.replica.crash` point and the one-shot prefill path — ids held
against the JAX package's sessions from the same weights and the port's
uncached re-forward."""

import jax
import numpy as np
import pytest
import torch

from easydist_tpu.models import gpt as jg
from easydist_tpu.serve import GenerationSession as JaxSession
from easydist_tpu.serve import ServeConfig as JaxServeConfig
from easydist_tpu_torch.kv import audit_page_table
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.resilience import InjectedFault, faultinject
from easydist_tpu_torch.serve import (GenerationSession, ReplicaDrainingError,
                                      ServeConfig)

CHUNK = 4
LAYOUTS = ["bucketed", "paged"]


@pytest.fixture(scope="module")
def model():
    cfg_j = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(0))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tg.GPTConfig.tiny(), params_t


def _sc(layout="bucketed", cls=ServeConfig, **kw):
    return cls(decode_buckets=(32,), max_decode_slots=2, prefill_chunk=CHUNK,
               kv_layout=layout, **kw)


def _mk(model, layout="bucketed", **kw):
    _, _, cfg, params = model
    return GenerationSession.for_gpt(params, cfg, config=_sc(layout),
                                     device="cpu", compile_key=None, **kw)


def _greedy(model, prompt, n_new):
    _, _, cfg, params = model
    cur, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n_new):
            logits = tg.gpt_apply(params, cfg, torch.tensor([cur]))
            out.append(int(torch.argmax(logits[0, len(cur) - 1])))
            cur.append(out[-1])
    return out


def _no_orphans(sess):
    """The checks of the JAX package's FLEET003 on a drained session: no
    live work, no pinned trie node, consistent trie (and page table)."""
    assert sess.is_drained
    for pool in sess._pools.values():
        if pool.trie is not None:
            assert pool.trie.check_invariants() == []
            assert all(n.refcount == 0 for n in pool.trie._walk())
        if hasattr(pool, "table"):
            assert audit_page_table(pool.pool, pool.table,
                                    trie=pool.trie) == []
            assert all(pool.table.n_mapped(i) == 0
                       for i in range(pool.n_slots))


@pytest.mark.parametrize("layout", LAYOUTS)
class TestDrain:
    def test_drain_retires_inflight_then_rejects(self, model, layout):
        sess = _mk(model, layout)
        prompt = [3, 14, 15, 9, 2]
        fut = sess.submit(prompt, max_new_tokens=4)
        sess.step()
        pages = sess.drain()  # blocks until drained, returns hot pages
        assert fut.result(timeout=5)["ids"] == _greedy(model, prompt, 4)
        assert sess.is_draining and sess.is_drained
        assert pages, "warmed trie exported no pages"
        with pytest.raises(ReplicaDrainingError):
            sess.submit([1, 2], max_new_tokens=1)
        _no_orphans(sess)

    def test_drain_nowait_flips_flag_only(self, model, layout):
        sess = _mk(model, layout)
        fut = sess.submit([5, 6, 7], max_new_tokens=3)
        assert sess.drain(wait=False) is None
        assert sess.is_draining and not sess.is_drained
        sess.run_until_drained()
        assert fut.result(timeout=5)["finish_reason"] == "length"
        assert sess.is_drained

    def test_queue_depth_tracks_lifecycle(self, model, layout):
        sess = _mk(model, layout)
        assert sess.queue_depth == 0
        sess.submit([1, 2, 3], max_new_tokens=2)
        sess.submit([4, 5, 6], max_new_tokens=2)
        assert sess.queue_depth == 2
        sess.run_until_drained()
        assert sess.queue_depth == 0
        assert sess.metrics.snapshot()["gauges"]["queue_depth"] == 0

    def test_hot_pages_import_into_a_fresh_session(self, model, layout):
        """drain()'s hot pages, imported by a fresh session, make a
        prompt with that prefix hit the prefix cache with equal ids —
        across layouts too (paged pages are materialized tensors)."""
        prompt = list(range(1, 14))                 # 3 whole chunks + 1
        sess = _mk(model, layout)
        sess.submit(prompt, max_new_tokens=3)
        pages = sess.drain()
        want = _greedy(model, prompt + [20, 21], 3)
        for other in LAYOUTS:
            fresh = _mk(model, other)
            assert fresh.import_hot_pages(pages) == 3
            assert fresh.prefix_affinity(prompt + [20, 21]) == 12
            fut = fresh.submit(prompt + [20, 21], max_new_tokens=3)
            fresh.run_until_drained()
            assert fut.result(timeout=5)["ids"] == want
            assert fresh.metrics.counter("prefix_tokens_reused") == 12


@pytest.mark.parametrize("layout", LAYOUTS)
class TestEvacuate:
    def test_evacuate_returns_resumable_descriptors(self, model, layout):
        sess = _mk(model, layout)
        prompt = [3, 14, 15, 9, 2]
        want = _greedy(model, prompt, 6)
        fut = sess.submit(prompt, max_new_tokens=6)
        for _ in range(3):
            sess.step()  # decode a few tokens
        descs = sess.evacuate()
        out = fut.result(timeout=5)
        assert out["finish_reason"] == "evacuated"
        assert 0 < len(out["ids"]) < 6
        assert out["ids"] == want[:len(out["ids"])]  # bitwise prefix
        assert sess.is_drained
        assert len(descs) == 1
        d = descs[0]
        assert d["prompt"] == prompt and d["ids"] == out["ids"]
        # resuming prompt+partial elsewhere completes the exact sequence
        sess2 = _mk(model, layout)
        fut2 = sess2.submit(d["prompt"] + d["ids"],
                            max_new_tokens=6 - len(d["ids"]))
        sess2.run_until_drained()
        assert out["ids"] + fut2.result(timeout=5)["ids"] == want

    def test_evacuate_pending_request_yields_empty_partial(self, model,
                                                           layout):
        sess = _mk(model, layout)
        fut = sess.submit([1, 2, 3], max_new_tokens=3)
        descs = sess.evacuate()  # never admitted
        assert fut.result(timeout=5) == {"ids": [],
                                         "finish_reason": "evacuated"}
        assert descs[0]["ids"] == []

    def test_evacuate_trie_has_no_orphaned_pins(self, model, layout):
        sess = _mk(model, layout)
        sess.submit([3, 14, 15, 9, 2, 7, 8], max_new_tokens=4)
        sess.submit(list(range(1, 12)), max_new_tokens=4)
        for _ in range(2):
            sess.step()
        assert {d["stage"] for d in sess.snapshot_inflight()} \
            <= {"queued", "prefill", "decode"}
        sess.evacuate()
        _no_orphans(sess)

    def test_evacuate_forgets_draft_caches(self, model, layout):
        _, _, cfg, params = model
        sess = GenerationSession.for_gpt(
            params, cfg, config=_sc(layout, speculate_k=2,
                                    speculate_drafter="draft_model"),
            device="cpu", compile_key=None, draft_model=(params, cfg))
        sess.submit([3, 14, 15, 9, 2], max_new_tokens=12)
        for _ in range(3):
            sess.step()
        assert sess._drafter.n_states == 1
        sess.evacuate()
        assert sess._drafter.n_states == 0


class TestClose:
    def test_close_is_idempotent_and_releases_pools(self, model):
        sess = _mk(model)
        fut = sess.submit([9, 8, 7], max_new_tokens=2)
        sess.close()
        assert fut.result(timeout=5)["finish_reason"] == "length"
        assert sess._pools == {}
        sess.close()  # second close is a no-op
        with pytest.raises(ReplicaDrainingError):
            sess.submit([1], max_new_tokens=1)


class TestReplicaLabels:
    def test_replica_id_threads_through_metrics(self, model, tmp_path):
        from easydist_tpu_torch.runtime.perfdb import PerfDB

        sess = _mk(model, replica_id="r7")
        assert sess.replica_id == "r7"
        assert sess.metrics.replica_id == "r7"
        assert sess.stats()["replica_id"] == "r7"
        db = sess.metrics.export(db=PerfDB(str(tmp_path / "perf.db")),
                                 persist=False)
        assert db.get_op_perf("serving", "engine[r7]")


# ------------------------------------------------- fleet trie access


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefix_path_export_import_and_affinity(model, layout):
    prompt = list(range(1, 14))
    src = _mk(model, layout)
    assert src.bucket_chunk(prompt) == CHUNK
    assert src.prefix_affinity(prompt) == 0
    src.submit(prompt, max_new_tokens=2)
    src.run_until_drained()
    assert src.prefix_affinity(prompt) == 12
    before = {b: p.trie.stats() for b, p in src._pools.items()}
    path = src.export_prefix_path(prompt)
    assert [key for key, _ in path] == [tuple(prompt[i:i + CHUNK])
                                        for i in (0, 4, 8)]
    # export and affinity do not touch LRU ticks or hit counters
    assert {b: p.trie.stats() for b, p in src._pools.items()} == before
    for kv in (kv for _, kv in path):
        assert sorted(kv) == ["k", "v"]
        assert tuple(kv["k"].shape) == (2, 4, CHUNK, 8)
    dst = _mk(model, layout)
    assert dst.import_prefix_path(prompt, path) == 3
    assert dst.import_prefix_path(prompt, path) == 3   # first commit wins
    fut = dst.submit(prompt, max_new_tokens=3)
    dst.run_until_drained()
    assert fut.result(timeout=5)["ids"] == _greedy(model, prompt, 3)
    assert dst.metrics.counter("prefix_tokens_reused") == 12
    assert dst.bucket_chunk(list(range(40))) is None


def test_replica_crash_point_fires_at_step(model):
    sess = _mk(model)
    fut = sess.submit([3, 14, 15, 9, 2], max_new_tokens=6)
    with faultinject.fault_plan("fleet.replica.crash@2"):
        sess.step()
        snap = sess.snapshot_inflight()
        with pytest.raises(InjectedFault):
            sess.step()
    assert snap[0]["future"] is fut and snap[0]["stage"] == "decode"
    # the crashed step produced nothing: the snapshot's ids resume exactly
    assert sess.snapshot_inflight()[0]["ids"] == snap[0]["ids"]
    d = snap[0]
    other = _mk(model)
    f2 = other.submit(d["prompt"] + d["ids"],
                      max_new_tokens=d["max_new"] - len(d["ids"]))
    other.run_until_drained()
    assert d["ids"] + f2.result(timeout=5)["ids"] == \
        _greedy(model, [3, 14, 15, 9, 2], 6)


# ------------------------------------------------------ one-shot prefill

PROMPTS = [[3, 14, 15, 9, 2], [5, 6, 7, 8, 9, 10, 11, 12, 13], [1, 2]]


def test_one_shot_prefill_matches_jax_and_chunked(model):
    """Without `model_prefill_chunk` the session prefills each prompt in
    one pow2-padded call (one signature per padded length) and decodes
    the same ids as the JAX package's one-shot session (on the prompts
    of one padded length) and the chunked path."""
    cfg_j, params_j, cfg, params = model
    jsess = JaxSession(
        params_j,
        model_prefill=lambda p, c, t, l: jg.gpt_prefill(p, cfg_j, c, t, l),
        model_decode=lambda p, c, t, pos: jg.gpt_decode_step(p, cfg_j, c, t,
                                                             pos),
        init_cache=lambda b, L, dt=None: jg.init_kv_cache(cfg_j, b, L,
                                                          dtype=dt),
        config=_sc(cls=JaxServeConfig))
    sess = GenerationSession(
        params,
        model_prefill=lambda p, c, t, l: tg.gpt_prefill(p, cfg, c, t, l),
        model_decode=lambda p, c, t, pos: tg.gpt_decode_step(p, cfg, c, t,
                                                             pos),
        init_cache=lambda b, L, dt=None: tg.init_kv_cache(
            cfg, b, L, dtype=dt, device="cpu"),
        config=_sc(), device="cpu")
    outs = []
    for s, prompts in ((jsess, PROMPTS[::2]), (sess, PROMPTS),
                       (_mk(model), PROMPTS)):
        futs = [s.submit(p, max_new_tokens=5) for p in prompts]
        s.run_until_drained()
        outs.append([f.result(timeout=5)["ids"] for f in futs])
    assert outs[1] == outs[2] and outs[1][::2] == outs[0]
    st = sess.stats()
    # padded lengths 8 and 16
    assert st["prefill_signatures"]["size"] == 2
    assert st["decode_signatures"]["size"] == 1
    with pytest.raises(ValueError, match="model_prefill"):
        GenerationSession(params, model_decode=sess._decode_c,
                          init_cache=lambda b, L, dt=None: None,
                          device="cpu")
