"""The port's request-shaped serving (easydist_tpu_torch.serve: batcher,
admission, ServeEngine) held against the JAX package: `pack_requests`
and `scatter_results` equal to the JAX functions on the same numpy
requests; the whole of tests/test_serve/test_batcher.py and
tests/test_resilience/test_serve_degradation.py on the port's engine
(clock-driven where the JAX tests are, `compile=False`, on the CPU); the
engine's fault points; and a ServeEngine over the tiny GPT forward,
compiled by the port's `easydist_compile`, against the JAX ServeEngine's
outputs at rtol 1e-4."""

import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from easydist_tpu.models import gpt as jg
from easydist_tpu.serve import Request as JaxRequest
from easydist_tpu.serve import ServeConfig as JaxServeConfig
from easydist_tpu.serve import ServeEngine as JaxServeEngine
from easydist_tpu.serve import pack_requests as jax_pack
from easydist_tpu.serve import scatter_results as jax_scatter
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.resilience import faultinject
from easydist_tpu_torch.runtime.perfdb import PerfDB
from easydist_tpu_torch.serve import (CircuitOpenError,
                                      DeadlineExceededError,
                                      EngineStoppedError, ExecTimeoutError,
                                      LatencyHistogram, QueueFullError,
                                      Request, RequestQueue,
                                      RequestTooLargeError, ServeConfig,
                                      ServeEngine, ServeMetrics,
                                      pack_requests, retry_transient,
                                      scatter_results, select_bucket)
from easydist_tpu_torch.serve.admission import (is_oom_error,
                                                is_transient_error)


def _engine(fn, cfg, **kw):
    return ServeEngine(fn, cfg, compile=False, device="cpu", **kw)


# ------------------------------------------------- pack / scatter parity


def _pair(arg_lists):
    return ([Request(args=a) for a in arg_lists],
            [JaxRequest(args=a) for a in arg_lists])


@pytest.mark.parametrize("case", ["seq", "exact", "scalar", "multi"])
def test_pack_and_scatter_equal_jax(case):
    rs = np.random.RandomState(0)
    if case == "seq":
        args = [(rs.rand(n).astype(np.float32),) for n in (3, 5, 2)]
        buckets, seqs = (4, 8), (4, 8)
    elif case == "exact":
        args = [(rs.randint(0, 9, (4, 2)).astype(np.int32),)
                for _ in range(5)]
        buckets, seqs = (2, 8), None
    elif case == "scalar":
        args = [(rs.rand(n).astype(np.float32), 7) for n in (6, 1)]
        buckets, seqs = (2,), (8,)
    else:
        args = [(rs.rand(n, 3).astype(np.float32),
                 rs.randint(0, 5, n).astype(np.int32)) for n in (7, 2, 9, 4)]
        buckets, seqs = (4,), (8, 16)
    mine, theirs = _pair(args)
    got, meta = pack_requests(mine, buckets, seqs, pad_value=-1)
    want, jmeta = jax_pack(theirs, buckets, seqs, pad_value=-1)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert (meta.n_real, meta.batch_bucket, meta.orig_lens,
            meta.padded_lens) == (jmeta.n_real, jmeta.batch_bucket,
                                  jmeta.orig_lens, jmeta.padded_lens)
    # outputs: a batched leaf per array arg, and a nested pytree; the
    # port's scatter takes tensors (one host copy) or numpy
    arrays = [g for g in got if isinstance(g, np.ndarray)]
    outs = {"a": arrays[0] * 2, "b": [arrays[-1]]}
    t_outs = {"a": torch.from_numpy(outs["a"]), "b": [torch.from_numpy(
        outs["b"][0])]}
    for unpad in (True, False):
        want_rows = jax_scatter(outs, jmeta, unpad)
        for o in (outs, t_outs):
            rows = scatter_results(o, meta, unpad)
            assert len(rows) == len(want_rows)
            for r, w in zip(rows, want_rows):
                np.testing.assert_array_equal(r["a"], w["a"])
                np.testing.assert_array_equal(r["b"][0], w["b"][0])


def test_scatter_keeps_bfloat16_on_the_host():
    reqs = [Request(args=(np.zeros(3, np.float32),)) for _ in range(2)]
    _, meta = pack_requests(reqs, (2,), (4,))
    out = torch.arange(8, dtype=torch.bfloat16).reshape(2, 4)
    rows = scatter_results(out, meta)
    assert rows[0].dtype == torch.bfloat16 and tuple(rows[0].shape) == (3,)


# ------------------------------------------------------------ test_batcher


def test_select_bucket_smallest_fitting():
    assert select_bucket(1, (2, 4, 8)) == 2
    assert select_bucket(3, (2, 4, 8)) == 4
    assert select_bucket(4, (2, 4, 8)) == 4
    assert select_bucket(8, (8, 4, 2)) == 8  # order-insensitive
    assert select_bucket(9, (2, 4, 8)) is None


def _reqs(lengths, dtype=np.float32):
    return [Request(args=(np.arange(n, dtype=dtype),)) for n in lengths]


def test_pack_pads_seq_and_batch():
    batched, meta = pack_requests(_reqs([3, 5, 2]), (4, 8), (4, 8),
                                  pad_value=0)
    (x,) = batched
    assert x.shape == (4, 8)  # batch 3 -> bucket 4, max seq 5 -> bucket 8
    assert meta.n_real == 3 and meta.batch_bucket == 4
    assert meta.padded_lens == (8,)
    np.testing.assert_array_equal(x[0, :3], np.arange(3))
    assert (x[0, 3:] == 0).all()  # seq padding is pad_value
    np.testing.assert_array_equal(x[3], x[2])  # batch pad repeats last row


def test_pack_scatter_round_trip():
    lengths = [3, 5, 2, 7]
    batched, meta = pack_requests(_reqs(lengths), (4,), (8,), pad_value=0)
    outs = scatter_results(batched[0] * 2.0, meta)
    for n, o in zip(lengths, outs):
        assert o.shape == (n,)
        np.testing.assert_array_equal(o, np.arange(n) * 2.0)
    kept = scatter_results(batched[0], meta, unpad_outputs=False)
    assert all(o.shape == (8,) for o in kept)


def test_pack_errors():
    with pytest.raises(RequestTooLargeError):
        pack_requests(_reqs([9]), (4,), (8,))
    with pytest.raises(RequestTooLargeError):
        pack_requests(_reqs([1] * 5), (4,), (8,))
    with pytest.raises(ValueError, match="heterogeneous"):
        pack_requests(_reqs([2, 3]), (4,), None)
    batched, meta = pack_requests(_reqs([3, 3]), (2,), None)
    assert batched[0].shape == (2, 3) and meta.padded_lens == (None,)
    reqs = [Request(args=(np.zeros(2), 5)), Request(args=(np.zeros(2), 5))]
    batched, _ = pack_requests(reqs, (2,), (4,))
    assert batched[1] == 5  # shared scalar, not batched
    with pytest.raises(ValueError, match="scalar"):
        pack_requests([Request(args=(np.zeros(2), 5)),
                       Request(args=(np.zeros(2), 6))], (2,), (4,))


def test_shape_class_separates_incompatible_requests():
    a = Request(args=(np.zeros((3, 2), np.float32),))
    b = Request(args=(np.zeros((5, 2), np.float32),))
    c = Request(args=(np.zeros((3, 4), np.float32),))
    d = Request(args=(np.zeros((3, 2), np.int32),))
    assert a.shape_class() == b.shape_class()
    assert a.shape_class() != c.shape_class()
    assert a.shape_class() != d.shape_class()


def test_queue_put_and_drain():
    q = RequestQueue(max_depth=2)
    assert q.put(Request(args=()))
    assert q.put(Request(args=()))
    assert not q.put(Request(args=()))
    assert q.depth() == 2
    q = RequestQueue(max_depth=16)
    for _ in range(5):
        q.put(Request(args=()))
    got = q.drain(max_n=3, max_wait_s=0.0, stop=threading.Event())
    assert len(got) == 3 and q.depth() == 2


def test_engine_backpressure_rejects_when_full():
    eng = _engine(lambda x: x, ServeConfig(
        batch_buckets=(2,), seq_buckets=(4,), max_queue=2))
    eng.submit(np.zeros(2, np.float32))
    eng.submit(np.zeros(2, np.float32))
    with pytest.raises(QueueFullError):
        eng.submit(np.zeros(2, np.float32))
    assert eng.metrics.counter("requests_rejected") == 1
    eng.stop()


def test_engine_rejects_oversized_at_submit():
    eng = _engine(lambda x: x, ServeConfig(batch_buckets=(2,),
                                           seq_buckets=(4,)))
    with pytest.raises(RequestTooLargeError):
        eng.submit(np.zeros(5, np.float32))


def test_stop_fails_pending_requests():
    eng = _engine(lambda x: x, ServeConfig(batch_buckets=(2,),
                                           seq_buckets=(4,)))
    fut = eng.submit(np.zeros(2, np.float32))
    eng.stop()
    with pytest.raises(EngineStoppedError):
        fut.result(timeout=1)


@pytest.mark.parametrize("from_config", [False, True])
def test_deadline_expiry_surfaces_timeout_not_hang(from_config):
    cfg = ServeConfig(batch_buckets=(2,), seq_buckets=(4,), max_wait_ms=1.0,
                      default_deadline_ms=1.0 if from_config else None)
    eng = _engine(lambda x: x, cfg)
    fut = eng.submit(np.zeros(2, np.float32),
                     deadline_ms=None if from_config else 1.0)
    time.sleep(0.05)  # let it expire while queued
    with eng:
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=2)
    assert eng.metrics.counter("requests_timed_out") == 1


def test_retry_transient_policy():
    calls, sleeps = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("collective UNAVAILABLE: transient link flap")
        return 42

    assert retry_transient(flaky, max_retries=3, backoff_s=0.01,
                           sleep=sleeps.append) == 42
    assert calls["n"] == 3 and sleeps == [0.01, 0.02]

    def always():
        raise RuntimeError("UNAVAILABLE forever")

    with pytest.raises(RuntimeError):
        retry_transient(always, max_retries=2, backoff_s=0,
                        sleep=lambda _: None)
    calls["n"] = 0

    def broken():
        calls["n"] += 1
        raise ValueError("bad shapes")

    with pytest.raises(ValueError):
        retry_transient(broken, max_retries=5, backoff_s=0,
                        sleep=lambda _: None)
    assert calls["n"] == 1


def test_error_classification():
    assert is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    assert is_oom_error(torch.cuda.OutOfMemoryError("boom"))
    assert is_oom_error(RuntimeError("CUDA out of memory. Tried to "
                                     "allocate 2.00 GiB"))
    assert not is_transient_error(RuntimeError("RESOURCE_EXHAUSTED"))
    assert not is_transient_error(torch.cuda.OutOfMemoryError("x"))
    assert is_transient_error(RuntimeError("server UNAVAILABLE"))
    assert not is_transient_error(ValueError("UNAVAILABLE"))  # typed out


def test_engine_retries_transient_batch_failures():
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("stream ABORTED (transient)")
        return x + 1

    eng = _engine(flaky, ServeConfig(batch_buckets=(2,), seq_buckets=(4,),
                                     max_wait_ms=1.0, retry_backoff_ms=0.1))
    with eng:
        out = eng.infer(np.zeros(4, np.float32), timeout=5)
    np.testing.assert_array_equal(out, np.ones(4))
    assert calls["n"] == 2
    assert eng.metrics.counter("transient_retries") == 1


def test_oom_degrades_to_smaller_bucket():
    seen_batches = []

    def fn(x):
        seen_batches.append(x.shape[0])
        if x.shape[0] >= 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return x * 3

    eng = _engine(fn, ServeConfig(batch_buckets=(2, 4), seq_buckets=(4,),
                                  max_wait_ms=20.0))
    with eng:
        futs = [eng.submit(np.full(4, i, np.float32)) for i in range(4)]
        outs = [f.result(timeout=10) for f in futs]
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full(4, i * 3.0))
    assert eng.stats()["disabled_batch_buckets"] == [4]
    assert eng.metrics.counter("oom_degradations") == 1
    assert seen_batches[0] == 4 and sorted(seen_batches[1:]) == [2, 2]


def test_oom_with_no_smaller_bucket_fails_requests():
    def fn(x):
        raise RuntimeError("RESOURCE_EXHAUSTED")

    eng = _engine(fn, ServeConfig(batch_buckets=(2,), seq_buckets=(4,),
                                  max_wait_ms=1.0))
    with eng:
        fut = eng.submit(np.zeros(2, np.float32))
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            fut.result(timeout=5)
    assert eng.metrics.counter("requests_failed") == 1


def test_concurrent_submits_scatter_correctly():
    eng = _engine(lambda x: x * 2.0, ServeConfig(
        batch_buckets=(2, 4, 8), seq_buckets=(8, 16), max_wait_ms=2.0,
        max_queue=256))
    results, errors = {}, []

    def client(cid):
        rng = np.random.RandomState(cid)
        try:
            for _ in range(10):
                x = rng.rand(int(rng.randint(1, 17))).astype(np.float32)
                np.testing.assert_array_equal(eng.infer(x, timeout=30),
                                              x * 2.0)
            results[cid] = True
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append((cid, e))

    with eng:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errors and len(results) == 8
    assert eng.metrics.counter("requests_completed") == 80
    occ = eng.metrics.batch_occupancy()
    assert occ is not None and 0.0 < occ <= 1.0


def test_latency_histogram_percentiles():
    h = LatencyHistogram()
    for v in [0.001] * 90 + [0.5] * 10:
        h.observe(v)
    assert h.total == 100
    assert h.percentile(50) <= 0.002
    assert h.percentile(99) >= 0.5
    snap = h.snapshot()
    assert snap["count"] == 100 and snap["p99_s"] >= snap["p50_s"]


def test_metrics_export_lands_in_perfdb(tmp_path):
    m = ServeMetrics()
    m.inc("requests_completed", 5)
    m.record_batch(n_real=3, bucket=4, execute_s=0.01)
    assert m.compile_cache_hit_rate() is None
    m.inc("compile_cache_hits", 3)
    m.inc("compile_cache_misses", 1)
    assert m.compile_cache_hit_rate() == 0.75
    db = PerfDB(path=str(tmp_path / "perf.db"))
    m.export(db=db, sub_key="unit")
    hist = db.get_op_perf("serving", "unit")
    assert len(hist) == 1
    assert hist[0]["counters"]["requests_completed"] == 5
    assert hist[0]["batch_occupancy"] == 0.75
    m.export(db=db, sub_key="unit")
    assert len(PerfDB(path=str(tmp_path / "perf.db")).get_op_perf(
        "serving", "unit")) == 2


def test_serving_history_readback(tmp_path, monkeypatch):
    """Engine export -> the port's PerfDB at `config.prof_db_path`."""
    from easydist_tpu_torch import config as edconfig

    monkeypatch.setattr(edconfig, "prof_db_path", str(tmp_path / "perf.db"))
    eng = _engine(lambda x: x + 1, ServeConfig(
        batch_buckets=(2,), seq_buckets=(4,), max_wait_ms=1.0))
    with eng:
        eng.infer(np.zeros(3, np.float32), timeout=10)
        eng.export_metrics(sub_key="roundtrip")
    hist = PerfDB().get_op_perf("serving", "roundtrip")
    assert len(hist) == 1
    assert hist[0]["counters"]["requests_completed"] == 1
    assert hist[0]["batch_occupancy"] == 0.5


# ----------------------------------------------- test_serve_degradation


def _deg_engine(fn, **cfg_kw):
    cfg = ServeConfig(batch_buckets=cfg_kw.pop("batch_buckets", (1,)),
                      max_wait_ms=1.0,
                      max_retries=cfg_kw.pop("max_retries", 0), **cfg_kw)
    return _engine(fn, cfg)


def test_health_happy_path():
    with _deg_engine(lambda a: np.asarray(a) + 1.0) as engine:
        out = engine.infer(np.zeros(2, np.float32), timeout=30)
        np.testing.assert_array_equal(out, np.ones(2, np.float32))
        h = engine.health()
    assert h["ready"] and not h["degraded"]
    assert h["breaker_state"] == "disabled"
    assert "breaker" not in engine.stats()


def test_watchdog_abandons_wedged_dispatch():
    sleep_s = {"v": 0.5}

    def wedged(a):
        time.sleep(sleep_s["v"])
        return a * 2.0

    x = np.arange(2, dtype=np.float32)
    with _deg_engine(wedged, exec_timeout_ms=100.0) as engine:
        with pytest.raises(ExecTimeoutError):
            engine.infer(x, timeout=30)
        sleep_s["v"] = 0.0
        out = engine.infer(x, timeout=30)
    np.testing.assert_array_equal(out, x * 2.0)
    assert engine.metrics.counter("exec_timeouts") == 1
    assert engine.health()["degraded"]


def test_breaker_trips_sheds_probes_recovers():
    boom = {"on": True}
    now = {"t": 100.0}

    def model(a):
        if boom["on"]:
            raise RuntimeError("boom")  # non-transient, non-OOM
        return a * 2.0

    x = np.ones(2, np.float32)
    engine = _deg_engine(model, breaker_failure_threshold=2,
                         breaker_cooldown_ms=150.0)
    engine.breaker.clock = lambda: now["t"]   # the breaker on a test clock
    with engine:
        for _ in range(2):
            with pytest.raises(RuntimeError):
                engine.infer(x, timeout=30)
        with pytest.raises(CircuitOpenError) as ei:
            engine.submit(x)
        assert ei.value.retry_after_s == pytest.approx(0.15)
        h = engine.health()
        assert not h["ready"] and h["breaker_state"] == "open"
        assert h["requests_shed"] == 1
        now["t"] += 0.2  # past the cooldown: one probe is admitted
        boom["on"] = False
        np.testing.assert_array_equal(engine.infer(x, timeout=30), x * 2.0)
        assert engine.breaker.state == "closed"
        assert engine.health()["ready"]
    snap = engine.stats()["breaker"]
    assert snap["consecutive_failures"] == 0 and snap["times_opened"] == 1


def test_breaker_reopen_on_failed_probe():
    def model(a):
        raise RuntimeError("boom")

    now = {"t": 0.0}
    x = np.ones(2, np.float32)
    engine = _deg_engine(model, breaker_failure_threshold=1,
                         breaker_cooldown_ms=100.0)
    engine.breaker.clock = lambda: now["t"]
    with engine:
        with pytest.raises(RuntimeError):
            engine.infer(x, timeout=30)
        now["t"] += 0.15
        with pytest.raises(RuntimeError):   # the half-open probe fails
            engine.infer(x, timeout=30)
        with pytest.raises(CircuitOpenError):
            engine.submit(x)


def test_retry_jitter_and_deadline():
    calls, slept = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise RuntimeError("transient wobble")
        return "ok"

    assert retry_transient(flaky, max_retries=3, backoff_s=0.1, jitter=0.5,
                           sleep=slept.append, rng=lambda: 1.0) == "ok"
    assert slept == pytest.approx([0.15, 0.3, 0.6])
    slept.clear()

    def failing():
        raise RuntimeError("transient wobble")

    with pytest.raises(RuntimeError, match="wobble"):
        retry_transient(failing, max_retries=5, backoff_s=1.0,
                        sleep=slept.append, deadline_t=100.5,
                        clock=lambda: 100.0)
    assert slept == []


def test_config_validation():
    for kw in (dict(retry_jitter=1.5), dict(exec_timeout_ms=0.0),
               dict(breaker_failure_threshold=-1),
               dict(breaker_cooldown_ms=0.0), dict(batch_buckets=()),
               dict(batch_buckets=(0,)), dict(seq_buckets=())):
        for cls in (ServeConfig, JaxServeConfig):
            with pytest.raises(ValueError):
                cls(**kw)


# ------------------------------------------------------ fault points


def test_fault_points_drive_degrade_and_watchdog():
    """`serve.oom_bucket` at the first batch disables its bucket and
    re-packs into the smaller one; `serve.exec_timeout` with a watchdog
    raises ExecTimeoutError and the next batch is served; a request with
    deadline_ms=0 raises DeadlineExceededError."""
    cfg = ServeConfig(batch_buckets=(1, 2), seq_buckets=(4,),
                      max_wait_ms=20.0, exec_timeout_ms=200.0,
                      max_retries=0)
    eng = _engine(lambda x: x * 3, cfg)
    x = np.ones(4, np.float32)
    with eng:
        with faultinject.fault_plan("serve.oom_bucket@1"):
            futs = [eng.submit(x * i) for i in (1, 2)]
            outs = [f.result(timeout=10) for f in futs]
            assert faultinject.unfired() == []
        assert eng.stats()["disabled_batch_buckets"] == [2]
        for i, o in zip((1, 2), outs):
            np.testing.assert_array_equal(o, x * i * 3)
        with faultinject.fault_plan("serve.exec_timeout@1"):
            with pytest.raises(ExecTimeoutError):
                eng.infer(x, timeout=10)
        np.testing.assert_array_equal(eng.infer(x, timeout=10), x * 3)
        with pytest.raises(DeadlineExceededError):
            eng.infer(x, deadline_ms=0, timeout=10)
        np.testing.assert_array_equal(eng.infer(x, timeout=10), x * 3)
    h = eng.health()
    assert h["oom_degradations"] == 1 and h["exec_timeouts"] == 1


# ---------------------------------------------------- GPT end to end


def test_gpt_engine_matches_jax_engine():
    """ServeEngine over the tiny GPT forward: the port (compiled by its
    `easydist_compile`, params as `state`) and the JAX engine, same
    weights and requests; outputs agree at rtol 1e-4 and each equals the
    same compiled function on the request alone at its seq bucket."""
    cfg_j = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(0))
    cfg_t = tg.GPTConfig.tiny()
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    kw = dict(batch_buckets=(1, 4), seq_buckets=(16, 32), max_wait_ms=20.0)
    rs = np.random.RandomState(7)
    reqs = [rs.randint(0, cfg_j.vocab, n).astype(np.int32)
            for n in (5, 16, 30, 9)]
    jeng = JaxServeEngine(lambda p, t: jg.gpt_apply(p, cfg_j, t),
                          JaxServeConfig(**kw), state=params_j)
    eng = ServeEngine(lambda p, t: tg.gpt_apply(p, cfg_t, t),
                      ServeConfig(**kw), state=params_t, device="cpu")
    assert eng.warmup([reqs[0]]) == 4
    outs = []
    for e in (jeng, eng):
        with e:
            futs = [e.submit(r) for r in reqs]
            outs.append([f.result(timeout=120) for f in futs])
    for r, want, got in zip(reqs, *outs):
        assert got.shape == (len(r), cfg_t.vocab)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        alone = np.zeros((1, 16 if len(r) <= 16 else 32), np.int32)
        alone[0, :len(r)] = r
        ref = eng._fn(params_t, torch.from_numpy(alone))[0, :len(r)]
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-5)
    st = eng.stats()
    assert st["distinct_executables"] == 4
    assert st["counters"]["compile_cache_misses"] == 4
    assert st["counters"]["requests_completed"] == 4
    # the requests alone ran at warmed shapes: still one trace a bucket
    assert st["backend_cache"]["size"] == 4
    assert eng.bucket_for(3) == 4
