"""The port's host KV tier (easydist_tpu_torch.kv.tier) held against the
JAX package: `page_digest` equal to the JAX digest (hex) on the same
float32 and int8 pages; the whole of tests/test_kv/test_host_tier.py
(bitwise put/get round trips, LRU host eviction under the byte budget,
manifest failure as a miss, the `kv.tier.fetch_corrupt` and
`kv.tier.host_oom` drills) on the port's tier; chunked copies of tensors
(bfloat16 included) bitwise; and a paged session with the tier that
demotes, promotes bitwise (the promoted page's digest equals its export
before demotion, scales included on int8) and keeps the JAX session's
ids."""

import jax
import numpy as np
import pytest
import torch

from easydist_tpu.kv.tier import page_digest as jax_page_digest
from easydist_tpu.models import gpt as jg
from easydist_tpu.serve import GenerationSession as JaxSession
from easydist_tpu.serve import ServeConfig as JaxServeConfig
from easydist_tpu_torch.kv import audit_page_table, is_host_ref
from easydist_tpu_torch.kv.tier import HostTier, TierError, page_digest
from easydist_tpu_torch.models import gpt as tg
from easydist_tpu_torch.resilience import faultinject
from easydist_tpu_torch.serve import GenerationSession, ServeConfig

from chip_smoke import watch_promotions

# tests/test_serve/test_kv_quant.py:62: each prompt spans 3 full pages;
# five of them overflow a 12-page arena, forcing demotions in pass 1 and
# promotions in pass 2
TIER_PROMPTS = [list(range(i, i + 24)) for i in range(1, 6)]


def _page(seed=0, tokens=8, head=16, quantized=False):
    """One trie page's arena leaves — quantized pages carry the scale
    planes so the manifest covers them too (test_host_tier.py:_page)."""
    rng = np.random.default_rng(seed)
    if quantized:
        return {
            "k": rng.integers(-127, 128, (tokens, head), dtype=np.int8),
            "v": rng.integers(-127, 128, (tokens, head), dtype=np.int8),
            "k_scale": rng.random((tokens, 1), dtype=np.float32),
            "v_scale": rng.random((tokens, 1), dtype=np.float32),
        }
    return {"k": rng.random((tokens, head), dtype=np.float32),
            "v": rng.random((tokens, head), dtype=np.float32)}


def _nbytes(page):
    return sum(a.nbytes for a in page.values())


def _flip(t):
    """Flip the first byte of a stored host tensor, in place."""
    t.reshape(-1).view(torch.uint8)[0] ^= 0xFF


class TestPageDigest:
    @pytest.mark.parametrize("quantized", [False, True],
                             ids=["float32", "int8"])
    def test_equals_jax_digest(self, quantized):
        for seed in range(3):
            page = _page(seed, quantized=quantized)
            want = jax_page_digest(page)
            assert page_digest(page) == want
            assert page_digest({k: torch.from_numpy(v)
                                for k, v in page.items()}) == want

    def test_insensitive_to_dict_order(self):
        page = _page(0)
        reordered = {k: page[k] for k in reversed(list(page))}
        assert page_digest(page) == page_digest(reordered)

    def test_sensitive_to_bytes_dtype_and_name(self):
        page = _page(0)
        base = page_digest(page)
        flipped = {k: v.copy() for k, v in page.items()}
        flipped["k"].reshape(-1).view(np.uint8)[0] ^= 0xFF
        assert page_digest(flipped) != base
        renamed = {("kk" if k == "k" else k): v for k, v in page.items()}
        assert page_digest(renamed) != base
        recast = dict(page, k=page["k"].astype(np.float64))
        assert page_digest(recast) != base

    def test_covers_scale_leaves(self):
        page = _page(0, quantized=True)
        desynced = {k: v.copy() for k, v in page.items()}
        desynced["k_scale"][0, 0] += 1.0
        assert page_digest(desynced) != page_digest(page)

    def test_bfloat16_names_its_dtype(self):
        x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
        bf = x.to(torch.bfloat16)
        as_bits = bf.view(torch.int16)
        assert page_digest({"k": bf}) != page_digest({"k": as_bits})
        assert page_digest({"k": bf}) != page_digest({"k": bf.float()})


class TestRoundTrip:
    def test_put_get_is_bitwise(self):
        tier = HostTier(byte_budget=1 << 20)
        page = _page(1)
        assert tier.put("n1", page)
        assert "n1" in tier
        got = tier.get("n1")
        assert sorted(got) == sorted(page)
        for name in page:
            np.testing.assert_array_equal(got[name].numpy(), page[name])
        s = tier.stats()
        assert s["demotions"] == 1 and s["promotions"] == 1
        assert s["bytes_used"] == _nbytes(page)
        assert tier.check_invariants() == []

    def test_quantized_page_round_trips_with_scales(self):
        tier = HostTier(byte_budget=1 << 20)
        page = _page(2, quantized=True)
        assert tier.put("q", page)
        got = tier.get("q")
        assert got["k"].dtype == torch.int8
        assert got["k_scale"].dtype == torch.float32
        for name in page:
            np.testing.assert_array_equal(got[name].numpy(), page[name])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
    def test_chunked_tensor_copy_is_bitwise(self, dtype):
        """A tensor page copied 24 bytes at a time (not a multiple of
        the row) comes back with the same bits and the same digest."""
        g = torch.Generator().manual_seed(3)
        page = {"k": (torch.randn(2, 3, 8, 16, generator=g) * 50).to(dtype),
                "v": (torch.randn(2, 3, 8, 16, generator=g) * 50).to(dtype)}
        tier = HostTier(byte_budget=1 << 20, chunk_bytes=24)
        assert tier.put("t", page)
        got = tier.get("t")
        for k in page:
            assert got[k].dtype == dtype
            assert torch.equal(got[k].view(torch.uint8),
                               page[k].view(torch.uint8))
        assert page_digest(got) == page_digest(page)

    def test_unknown_key_raises_keyerror(self):
        tier = HostTier(byte_budget=1 << 20)
        with pytest.raises(KeyError):
            tier.get("missing")

    def test_drop_frees_bytes(self):
        tier = HostTier(byte_budget=1 << 20)
        page = _page(3)
        tier.put("n", page)
        tier.drop("n")
        assert "n" not in tier
        assert tier.bytes_used == 0
        tier.drop("n")  # idempotent
        assert tier.check_invariants() == []


class TestBudget:
    def test_negative_budget_rejected(self):
        with pytest.raises(ValueError):
            HostTier(byte_budget=-1)

    def test_zero_budget_stores_nothing(self):
        tier = HostTier(byte_budget=0)
        assert not tier.put("n", _page(0))
        assert tier.stats()["entries"] == 0

    def test_oversize_page_rejected(self):
        page = _page(0)
        tier = HostTier(byte_budget=_nbytes(page) - 1)
        assert not tier.put("n", page)
        assert tier.bytes_used == 0

    def test_lru_eviction_under_budget(self):
        page = _page(0)
        tier = HostTier(byte_budget=2 * _nbytes(page))
        tier.put("a", _page(10))
        tier.put("b", _page(11))
        tier.get("a")                 # refresh "a" -> "b" is now LRU
        tier.put("c", _page(12))
        assert "a" in tier and "c" in tier and "b" not in tier
        assert tier.stats()["host_evictions"] == 1
        assert tier.bytes_used <= tier.byte_budget
        assert tier.check_invariants() == []


class TestManifest:
    def test_corrupt_entry_drops_and_raises(self):
        tier = HostTier(byte_budget=1 << 20)
        tier.put("n", _page(4))
        _flip(tier._entries["n"].arrays["v"])   # host bit rot
        with pytest.raises(TierError):
            tier.get("n")
        assert "n" not in tier        # caller sees a miss and recomputes
        assert tier.stats()["manifest_failures"] == 1
        assert tier.bytes_used == 0
        assert tier.check_invariants() == []

    def test_check_invariants_flags_corruption_and_drift(self):
        tier = HostTier(byte_budget=1 << 20)
        tier.put("n", _page(5))
        _flip(tier._entries["n"].arrays["k"])
        problems = tier.check_invariants()
        assert any("manifest" in p for p in problems)
        tier.bytes_used += 13
        problems = tier.check_invariants()
        assert any("accounting drift" in p for p in problems)


class TestFaultDrills:
    def test_fetch_corrupt_refetches_once(self):
        tier = HostTier(byte_budget=1 << 20)
        page = _page(6, quantized=True)
        with faultinject.fault_plan("kv.tier.fetch_corrupt@1"):
            assert tier.put("n", page)
            assert faultinject.unfired() == []
        assert tier.stats()["fetch_retries"] == 1
        got = tier.get("n")           # the stored copy is the CLEAN one
        for name in page:
            np.testing.assert_array_equal(got[name].numpy(), page[name])
        assert tier.check_invariants() == []

    def test_host_oom_pauses_hold_and_warn(self):
        tier = HostTier(byte_budget=1 << 20)
        with faultinject.fault_plan("kv.tier.host_oom@1"):
            assert not tier.put("a", _page(7))
            assert faultinject.unfired() == []
        assert tier.paused
        assert not tier.put("b", _page(8))   # paused: no further demotion
        assert tier.stats()["entries"] == 0
        tier.resume()
        assert not tier.paused
        assert tier.put("c", _page(9))
        assert "c" in tier

    def test_plan_grammar_and_catalog(self):
        plan = faultinject.parse_plan(
            "serve.oom_bucket@2,serve.oom_bucket@5,kv.tier.host_oom@*")
        assert plan == {"serve.oom_bucket": frozenset({2, 5}),
                        "kv.tier.host_oom": "*"}
        with pytest.raises(faultinject.FaultPlanError, match="did you mean"):
            faultinject.parse_plan("serve.oom_bucket_@1")
        # the serving points, and the training points of the elastic loop,
        # the checkpoints and the restore across a topology change
        assert {"serve.oom_bucket", "serve.exec_timeout",
                "kv.tier.fetch_corrupt", "kv.tier.host_oom",
                "fleet.replica.crash", "ckpt.write.partial",
                "ckpt.manifest.corrupt", "preempt.sigterm", "step.nan_grad",
                "data.stall", "elastic.restore.chunk_corrupt",
                "elastic.mesh.shrink", "elastic.restore.oom"} == \
            set(faultinject.FAULT_POINTS)


# ------------------------------------------------------------- sessions


@pytest.fixture(scope="module")
def model():
    cfg_j = jg.GPTConfig.tiny()
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(0))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tg.GPTConfig.tiny(), params_t


def _config(cls=ServeConfig, **kw):
    base = dict(decode_buckets=(32,), max_decode_slots=2, prefill_chunk=8,
                prefill_batch=2, kv_layout="paged", kv_arena_pages=12,
                kv_host_tier_bytes=1 << 20)
    base.update(kw)
    return cls(**base)


def _run(sess, prompts, n_new=4):
    futs = [sess.submit(p, max_new_tokens=n_new) for p in prompts]
    sess.run_until_drained()
    return [f.result(timeout=5)["ids"] for f in futs]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_session_demotes_promotes_bitwise(model, quant):
    cfg_j, params_j, cfg_t, params_t = model
    jsess = JaxSession.for_gpt(params_j, cfg_j, config=_config(
        JaxServeConfig, kv_quant_dtype=quant))
    want = [_run(jsess, TIER_PROMPTS) for _ in range(2)]
    sess = GenerationSession.for_gpt(params_t, cfg_t, config=_config(
        kv_quant_dtype=quant), device="cpu", compile_key=None)
    sess._pool_for(32)
    pool = sess._pools[32]
    seen = watch_promotions(sess, pool.tier)
    got = [_run(sess, TIER_PROMPTS) for _ in range(2)]
    assert got == want
    assert got[1] == got[0]
    s = pool.tier.stats()
    assert s["demotions"] > 0 and s["promotions"] > 0, s
    assert s["manifest_failures"] == 0
    assert seen and all(ok for _, ok in seen), seen
    assert audit_page_table(pool.pool, pool.table, trie=pool.trie,
                            tier=pool.tier) == []
    c = sess.metrics.snapshot()["counters"]
    assert c["prefix_tokens_reused"] > 0
    assert pool.demote_s > 0 and pool.promote_s > 0


def test_corrupt_fetch_drill_keeps_ids(model):
    """`kv.tier.fetch_corrupt` armed once during a session: the manifest
    catches it, the tier refetches once, and the ids do not change."""
    _, _, cfg, params = model
    ids = []
    retries = []
    for plan in ("", "kv.tier.fetch_corrupt@1"):
        sess = GenerationSession.for_gpt(params, cfg, config=_config(),
                                         device="cpu", compile_key=None)
        with faultinject.fault_plan(plan):
            ids.append([_run(sess, TIER_PROMPTS) for _ in range(2)])
            assert faultinject.unfired() == []
        retries.append(sess._pools[32].tier.stats()["fetch_retries"])
    assert ids[0] == ids[1] and retries == [0, 1]


def test_host_oom_falls_back_to_eviction(model):
    """`kv.tier.host_oom` pauses demotion; admission then evicts device
    pages instead, and the ids stay the same."""
    _, _, cfg, params = model
    base = GenerationSession.for_gpt(params, cfg, config=_config(),
                                     device="cpu", compile_key=None)
    want = _run(base, TIER_PROMPTS)
    sess = GenerationSession.for_gpt(params, cfg, config=_config(),
                                     device="cpu", compile_key=None)
    with faultinject.fault_plan("kv.tier.host_oom@1"):
        got = _run(sess, TIER_PROMPTS)
    pool = sess._pools[32]
    assert got == want and pool.tier.paused
    assert pool.tier.stats()["demotions"] == 0
    assert not any(is_host_ref(n.kv) for n in pool.trie._walk())
    assert pool.trie.evictions > 0
