"""`easydist_tpu_torch.fleet.transport` on the CPU, held against the JAX
package's transport: page digests and `manifest_key` equal the JAX
package's on the same f32, bf16 and int8 pages (scale planes included),
the port's in-flight damage (one flipped bit) is caught in every dtype
and aborts the commit, and the hardened `send_pages` wrapper retries,
backs off and commits idempotently as the JAX one does
(tests/test_fleet/test_transport.py)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import easydist_tpu.fleet.transport as jtp
import easydist_tpu_torch.fleet.transport as ttp
from easydist_tpu.resilience import faultinject as jfi
from easydist_tpu_torch.resilience import faultinject as tfi

CHUNK = 4
DTYPES = ("float32", "bfloat16", "int8")


def _np_page(dtype, seed, scales=False):
    """One page {k, v[, k_scale, v_scale]} as numpy arrays of `dtype`."""
    rng = np.random.RandomState(seed)
    shape = (2, 3, CHUNK, 8)
    if dtype == "int8":
        kv = {k: rng.randint(-127, 128, shape).astype(np.int8)
              for k in ("k", "v")}
        if scales:
            kv.update({f"{k}_scale": rng.rand(2, 3, CHUNK, 1)
                       .astype(np.float32) for k in ("k", "v")})
        return kv
    x = {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}
    if dtype == "bfloat16":
        return {k: v.astype(ml_dtypes.bfloat16) for k, v in x.items()}
    return x


def _tensor(a):
    """The same bytes as a torch tensor (bf16 through its raw bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _paths(dtype, n=3, scales=False):
    np_path = [(tuple(range(j * CHUNK, (j + 1) * CHUNK)),
                _np_page(dtype, j, scales)) for j in range(n)]
    t_path = [(toks, {k: _tensor(v) for k, v in kv.items()})
              for toks, kv in np_path]
    return np_path, t_path


class _FakeSession:
    def __init__(self):
        self.imported = []

    def import_prefix_path(self, prompt, path):
        self.imported.append((list(prompt), list(path)))
        return len(path)


class TestDigests:
    @pytest.mark.parametrize("dtype,scales", [
        ("float32", False), ("bfloat16", False), ("int8", False),
        ("int8", True)])
    def test_manifest_equals_jax(self, dtype, scales):
        np_path, t_path = _paths(dtype, scales=scales)
        mj = jtp.page_manifest(np_path, src="p0", dst="d0")
        mt = ttp.page_manifest(t_path, src="p0", dst="d0")
        assert mt == mj
        assert ttp.manifest_key(mt) == jtp.manifest_key(mj)
        assert ttp.verify_manifest(mj, t_path) == []
        assert ttp.path_nbytes(t_path) == jtp.path_nbytes(np_path)

    def test_dtype_and_shape_enter_the_digest(self):
        _, t_path = _paths("float32")
        m = ttp.page_manifest(t_path)
        toks, kv = t_path[0]
        as_int = [(toks, {k: v.view(torch.int32) for k, v in kv.items()})]
        assert ttp.verify_manifest(m, as_int + t_path[1:])
        flat = [(toks, {k: v.reshape(-1) for k, v in kv.items()})]
        assert ttp.verify_manifest(m, flat + t_path[1:])


class TestCorruption:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_bit_flip_changes_the_digest(self, dtype):
        """The JAX package's +1e-3 leaves a bfloat16 value >= 0.5 as it
        was; the port's flipped bit damages every dtype."""
        np_path, t_path = _paths(dtype)
        if dtype == "bfloat16":
            first = np_path[-1][1]["k"].copy()
            first.flat[0] = 0.75
            bumped = first.astype(np.float32)
            bumped.flat[0] += 1e-3
            assert bumped.astype(ml_dtypes.bfloat16).flat[0] == first.flat[0]
        m = ttp.page_manifest(t_path)
        damaged = ttp._corrupt_in_flight(t_path)
        problems = ttp.verify_manifest(m, damaged)
        assert len(problems) == 1 and "sha256 mismatch" in problems[0]
        # the caller's tensors are untouched
        assert ttp.verify_manifest(m, t_path) == []
        raw = [kv["k"].contiguous().view(-1).view(torch.uint8)
               for kv in (damaged[-1][1], t_path[-1][1])]
        assert int((raw[0] != raw[1]).sum()) == 1

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_corrupt_transfer_aborts_then_resends_pristine(self, dtype):
        _, t_path = _paths(dtype)
        want = {k: v.clone() for k, v in t_path[-1][1].items()}
        tp, dst = ttp.InProcessTransport(), _FakeSession()
        with tfi.fault_plan("fleet.transport.page_corrupt@*"):
            with pytest.raises(ttp.PageCorruptError, match="corrupt"):
                tp.send_pages(t_path, dst, [0, 1, 2, 3, 4], retries=0)
        assert dst.imported == [] and tp.pages_moved == 0
        with tfi.fault_plan("fleet.transport.page_corrupt@1"):
            n = tp.send_pages(t_path, dst, [0, 1, 2, 3, 4], retries=2,
                              sleep=lambda s: None)
            assert tfi.unfired() == []
        assert n == len(t_path) and len(dst.imported) == 1
        _, committed = dst.imported[0][1][-1]
        for name in want:
            assert torch.equal(committed[name], want[name])
            assert torch.equal(t_path[-1][1][name], want[name])
        assert [e["event"] for e in tp.transitions()] == [
            "rejected", "rejected", "committed"]


def _send_twin(plan, **kw):
    """`send_pages` on both packages under one fault plan: the sleeps,
    the outcome and the commit events (jitter drawn from one fixed
    value, not `random.random`)."""
    kw.setdefault("rng", lambda: 0.5)
    out = []
    for tp_mod, fi, path in ((jtp, jfi, _paths("float32")[0]),
                             (ttp, tfi, _paths("float32")[1])):
        tp, dst, sleeps = tp_mod.InProcessTransport(), _FakeSession(), []
        with fi.fault_plan(plan):
            try:
                res = tp.send_pages(path, dst, [0, 1, 2, 3, 4],
                                    sleep=sleeps.append, **kw)
            except tp_mod.TransportError as e:
                res = type(e).__name__
            unfired = fi.unfired()
        out.append((res, sleeps, len(dst.imported),
                    [e["event"] for e in tp.transitions()], unfired))
    return out


@pytest.mark.parametrize("plan,kw", [
    ("", {}),
    ("fleet.transport.stall@1,fleet.transport.stall@2",
     dict(retries=2, backoff_s=0.01, jitter=0.0)),
    ("fleet.transport.stall@1", dict(retries=1, backoff_s=0.01,
                                     jitter=0.5, rng=lambda: 1.0)),
    ("fleet.transport.stall@*", dict(retries=2)),
    ("fleet.transport.stall@*", dict(deadline_s=0.005, retries=10,
                                     backoff_s=0.01, jitter=0.0,
                                     clock=lambda: 0.0)),
    ("fleet.transport.page_corrupt@1", dict(retries=2)),
])
def test_send_pages_retries_as_jax(plan, kw):
    got_j, got_t = _send_twin(plan, **kw)
    assert got_t == got_j


def test_idempotent_commit_and_bounded_memory():
    _, path = _paths("float32")
    tp, dst = ttp.InProcessTransport(keep=2, keep_commits=3), _FakeSession()
    prompt = [0, 1, 2, 3, 4, 5, 6, 7, 9]
    assert tp.transfer(path, dst, prompt) == tp.transfer(path, dst, prompt)
    assert len(dst.imported) == 1 and tp.commits_deduped == 1
    with tfi.fault_plan("fleet.transport.page_corrupt@1"):
        tp.transfer(path, dst, prompt)  # a damaged duplicate: a no-op
        assert tfi.unfired() == [("fleet.transport.page_corrupt", 1)]
    for i in range(6):
        tp.transfer(path[:1], dst, [i])
    assert len(tp._committed) == 3 and len(tp.manifests) == 2
    assert tp.transfer([], dst, [1]) == 0


@pytest.fixture(scope="module")
def paged_src():
    from easydist_tpu_torch.models import gpt as tg
    from easydist_tpu_torch.serve import GenerationSession, ServeConfig

    cfg = tg.GPTConfig.tiny()
    params = tg.gpt_init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")

    def mk(rid):
        sc = ServeConfig(decode_buckets=(cfg.seq,), max_decode_slots=2,
                         prefill_chunk=8, prefill_batch=2,
                         kv_layout="paged")
        return GenerationSession.for_gpt(params, cfg, config=sc,
                                         replica_id=rid, device="cpu")

    return cfg, mk


def test_corrupt_paged_handoff_aborts_before_pool_commit(paged_src):
    """A bit-flipped page in a paged handoff aborts before anything
    touches the destination's page pool; a clean retry commits and the
    page-table audit stays clean (tests/test_fleet/test_failover.py:352)."""
    from easydist_tpu_torch.kv import audit_page_table

    cfg, mk = paged_src
    prompt = list(range(1, 14))
    src = mk("src")
    src.submit(prompt, max_new_tokens=2)
    src.run_until_drained()
    path = src.export_prefix_path(prompt)
    assert path and all(kv["k"].dtype == torch.float32 for _, kv in path)
    dst = mk("dst")
    dst.submit([7, 8, 9], max_new_tokens=2)
    dst.run_until_drained()
    pool = dst._pools[cfg.seq]
    free_before = pool.pool.n_free
    tp = ttp.InProcessTransport()
    with tfi.fault_plan("fleet.transport.page_corrupt@*"):
        with pytest.raises(ttp.PageCorruptError, match="corrupt"):
            tp.send_pages(path, dst, prompt, retries=0)
    assert pool.pool.n_free == free_before
    assert audit_page_table(pool.pool, pool.table, trie=pool.trie) == []
    assert dst.prefix_affinity(prompt) == 0
    assert tp.send_pages(path, dst, prompt) > 0
    assert dst.prefix_affinity(prompt) > 0
    assert audit_page_table(pool.pool, pool.table, trie=pool.trie) == []


def test_fault_points_catalogued():
    for point in ("fleet.transport.stall", "fleet.transport.page_corrupt",
                  "fleet.probe.flap", "autoscale.metrics.stale",
                  "autoscale.scaleup.fail"):
        assert point in tfi.FAULT_POINTS
        assert tfi.parse_plan(f"{point}@2") == {point: 2}
