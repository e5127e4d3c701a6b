"""Layers 2, 2b, 4, 5, 8, 11 and 13 of the port's analyzer — the lints
over traced programs — each on a seeded bug that fires it and a clean
case that does not, and against the JAX package's rule on the
counterpart case where one exists (tests/test_analyze/
test_{jaxpr,alias,serve,reshard,resilience}_rules.py,
tests/test_comm/test_overlap.py): the same rule ids.

The port's programs are `make_fx` GraphModules: COLL001/004 read each
collective's group name and operand dtype (`meta["val"]`), COLL002 holds
every rank's program of a mesh to one collective sequence per group (on
torch's fake process group of 8 ranks), OVL002 reads the hooked flush's
issue log, SERVE001-003 ask whether a program writes its cache in place
and masks its attention with an arange-derived comparison, ALIAS001-003
read a program's views, in-place writes and state pairs."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import easydist_tpu.analyze as ja
import easydist_tpu_torch.analyze as ta
from easydist_tpu_torch import config as tconfig

JAX_CONSTANTS = dict(peak_flops=4.9e13, hbm_bandwidth=8.1e11,
                     nvlink_bandwidth=2e11, nvlink_latency=1e-6)
_c10d = torch.ops._c10d_functional


def ids(findings):
    return [f.rule_id for f in findings]


def trace(fn, *args):
    return make_fx(fn, tracing_mode="fake")(*args)


# ------------------------------------------------ COLL001 / COLL004

def _psum(x, dtype=None):
    y = x if dtype is None else x.to(dtype)
    return _c10d.wait_tensor(_c10d.all_reduce(y, "sum", "dp_group"))


def _jax_psum(cpu_devices, dtype=None):
    from jax.sharding import Mesh, PartitionSpec as P

    from easydist_tpu.utils.jax_compat import shard_map

    mesh = Mesh(np.array(cpu_devices), ("dp",))
    body = (lambda x: jax.lax.psum(x if dtype is None else x.astype(dtype),
                                   "dp"))
    fn = shard_map(body, mesh=mesh, in_specs=(P("dp"),), out_specs=P(),
                   check_vma=False)
    return jax.make_jaxpr(fn)(jnp.arange(16.0)).jaxpr


def test_coll001_unknown_group_and_coll004_int8_match_jax(cpu_devices):
    gm = trace(lambda x: _psum(x), torch.arange(16.0))
    assert ta.lint_program(gm, {"dp_group": "dp"}) == []
    j = _jax_psum(cpu_devices)
    assert ja.lint_jaxpr(j, {"dp": 8}) == []
    # a mesh that lost the axis (a mis-wired mesh handoff)
    port = ta.lint_program(gm, {"tp_group": "tp"})
    assert ids(port) == ids(ja.lint_jaxpr(j, {"tp": 8})) == ["COLL001"]
    gm8 = trace(lambda x: _psum(x, torch.int8), torch.arange(16.0))
    j8 = _jax_psum(cpu_devices, jnp.int8)
    assert ids(ta.lint_program(gm8, {"dp_group": "dp"})) \
        == ids(ja.lint_jaxpr(j8, {"dp": 8})) == ["COLL004"]
    # one device: no mesh to name, the dtype rule still holds
    assert ids(ta.lint_fn(lambda x: _psum(x, torch.int8),
                          torch.arange(16.0))) == ["COLL004"]


def test_quantized_two_pass_fence_is_clean():
    """The int8 fence moves int8 by all_to_all / all_gather and sums in
    f32: no COLL004 (the JAX test's `quantized_psum` case)."""
    from easydist_tpu_torch.comm.quant import quantized_psum

    gm = trace(lambda x: quantized_psum(x, "dp_group", 8),
               torch.arange(4096.0))
    kinds = {n.target for n in gm.graph.nodes if n.op == "call_function"}
    assert _c10d.all_to_all_single.default in kinds
    assert ta.lint_program(gm, {"dp_group": "dp"}) == []


def test_coll005_has_no_counterpart():
    """`make_fx` unrolls loops: a while over a collective predicate
    traces to straight-line code and the lint emits no COLL005."""
    def body(x):
        for _ in range(3):
            x = _psum(x) + 1.0
        return x

    gm = trace(body, torch.arange(16.0))
    assert not [n for n in gm.graph.nodes if "while" in str(n.target)]
    assert "COLL005" in ta.RULES
    assert ta.lint_program(gm, {"dp_group": "dp"}) == []


# ------------------------------------------------------------ COLL002

@pytest.fixture
def fake8(monkeypatch, tmp_path):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch.fxfront import set_device_mesh

    monkeypatch.setattr(tconfig, "discovery_device", "cpu")
    monkeypatch.setattr(tconfig, "prof_db_path", str(tmp_path / "p.db"))
    monkeypatch.setattr(tconfig, "discovery_cache_dir",
                        str(tmp_path / "disc"))
    monkeypatch.setattr(tconfig, "enable_compile_cache", False)
    for k, v in JAX_CONSTANTS.items():
        monkeypatch.setattr(tconfig, k, v)
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    yield
    set_device_mesh(None)
    dist.destroy_process_group()


def _mlp_result(shape, names):
    from easydist_tpu_torch.fxfront import easydist_compile, make_device_mesh
    from easydist_tpu_torch.models.mlp import make_mlp_train_step, mlp_init

    gen = torch.Generator().manual_seed(0)
    params = mlp_init(gen, sizes=(512, 2048, 512), device="cpu")
    x = torch.randn(512, 512, generator=gen)
    mesh = make_device_mesh(shape, names, device_type="cpu")
    compiled = easydist_compile(make_mlp_train_step(lr=0.05), mesh=mesh,
                                compile_only=True)
    return compiled, compiled(params, x, x), mesh


def test_coll002_rank_programs_agree_then_disagree(fake8):
    import itertools

    from easydist_tpu_torch.analyze.fx_rules import (collective_sequence,
                                                     fake_propagate)

    compiled, res, mesh = _mlp_result((4, 2), ("dp", "tp"))
    rep = compiled.analyze()
    assert not [f for f in rep.findings if f.rule_id.startswith("COLL")]
    assert res.program_lint_stats["rank_programs"] == 8
    assert res.program_lint_stats["seconds"] > 0
    programs = {}
    for c in itertools.product(range(4), range(2)):
        gm, _ = res.program_for(list(c))
        fake_propagate(gm, res.rank_fakes())
        programs[c] = gm
    assert collective_sequence(programs[(0, 0)])
    assert ta.lint_rank_programs(programs, mesh) == []
    # seeded: rank (2, 1) drops its first collective, so its dp group
    # (the ranks sharing tp coordinate 1) and its tp group disagree
    gm = programs[(2, 1)]
    node = next(n for n in gm.graph.nodes
                if ta.fx_rules.collective_of(n) is not None)
    node.replace_all_uses_with(node.args[0])
    gm.graph.erase_node(node)
    found = ta.lint_rank_programs(programs, mesh)
    assert ids(found) and set(ids(found)) == {"COLL002"}
    assert all(f.severity == "error" for f in found)
    assert any("[2, 1]" in f.message for f in found)


# ------------------------------------------------------------ COLL003

def _leaves():
    rng = np.random.RandomState(0)
    return [rng.randn(n).astype(np.float32) for n in (300, 300, 300, 50)]


@pytest.mark.parametrize("bug", ["clean", "overlap", "gap", "off_by_one"])
def test_coll003_bucket_plan_matches_jax(bug):
    from easydist_tpu.comm.bucketer import plan_buckets as jplan

    from easydist_tpu_torch.comm.bucketer import plan_buckets as tplan

    np_leaves = _leaves()
    t_leaves = [torch.from_numpy(x) for x in np_leaves]
    plans = (jplan(np_leaves, 2048, [True] * 4),
             tplan(t_leaves, 2048, [True] * 4))
    for b in plans:
        if bug == "overlap":
            b[-1].indices.append(0)
            b[-1].nbytes += 1200
        elif bug == "gap":
            dropped = b[-1].indices.pop()
            b[-1].nbytes -= np_leaves[dropped].nbytes
        elif bug == "off_by_one":
            b[0].nbytes -= 4
    got = ta.lint_bucket_plan(t_leaves, plans[1])
    assert ids(got) == ids(ja.lint_bucket_plan(np_leaves, plans[0]))
    assert ids(got) == ([] if bug == "clean" else ["COLL003"])


def test_bucketed_reduce_raises_coll003(monkeypatch):
    from easydist_tpu_torch.comm import bucketer

    real = bucketer.plan_buckets

    def short_plan(*a):
        plan = real(*a)
        plan[0].nbytes -= 4
        return plan

    leaves = [torch.ones(8), torch.ones(4)]
    assert bucketer.bucketed_reduce(leaves, [False, False], 1 << 20,
                                    lambda flat, b: flat)[1].shape == (4,)
    monkeypatch.setattr(bucketer, "plan_buckets", short_plan)
    with pytest.raises(ta.AnalysisError, match="COLL003"):
        bucketer.bucketed_reduce(leaves, [False, False], 1 << 20,
                                 lambda flat, b: flat)
    monkeypatch.setattr(tconfig, "analyze_raise", False)
    assert len(bucketer.bucketed_reduce(leaves, [False, False], 1 << 20,
                                        lambda flat, b: flat)) == 2


# ------------------------------------------------------------ OVL001/002

@pytest.fixture
def one_rank(monkeypatch, tmp_path):
    import torch.distributed as dist

    monkeypatch.setattr(tconfig, "comm_quant_dtype", "none")
    monkeypatch.setattr(tconfig, "comm_bucket_bytes", 0)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_ovl001_bad_order_raises_before_the_fallback(one_rank, monkeypatch):
    from easydist_tpu_torch.comm.overlap import overlapped_reduce_gradients

    leaves = [torch.ones(4), torch.ones(2)]
    assert ids(ta.lint_overlap_plan(leaves, [0, 0])) \
        == ids(ja.lint_overlap_plan([jnp.ones(4), jnp.ones(2)], [0, 0])) \
        == ["OVL001"]
    assert ta.lint_overlap_plan(leaves, [1, 0]) == []
    grads = {"w": torch.ones(16, 16), "b": torch.ones(16)}
    with pytest.raises(ta.AnalysisError, match="OVL001"):
        overlapped_reduce_gradients(grads, one_rank, 1,
                                    emission_order=[0, 0])
    monkeypatch.setattr(tconfig, "analyze_raise", False)
    out = overlapped_reduce_gradients(grads, one_rank, 1,
                                      emission_order=[0, 0])
    assert torch.equal(out["w"], grads["w"])


def _chain_loss(p, x):
    return ((x @ p["a"]) @ p["b"]).sum()


@pytest.mark.parametrize("pin_chain", [True, False])
def test_ovl002_issue_log(one_rank, pin_chain):
    """Flat order puts `a` first, but the backward produces `b`'s
    gradient first: unpinned, unit 1 is issued before unit 0 (one
    OVL002, as the JAX flush with its barrier dropped gives one);
    pinned, the flush holds `b` back and issues the plan's order."""
    from easydist_tpu_torch.comm.overlap import overlapped_value_and_grad

    p = {"a": torch.randn(8, 8), "b": torch.randn(8, 8)}
    found = ta.lint_overlap_fn(overlapped_value_and_grad, _chain_loss, p,
                               torch.randn(4, 8), group=one_rank,
                               axis_size=1, emission_order=[0, 1],
                               pin_chain=pin_chain)
    assert ids(found) == ([] if pin_chain else ["OVL002"])


def test_ovl002_hook_on_a_broken_log():
    log = {"units": 3, "issued": [0, 2, 2], "pin_chain": True}
    assert ids(ta.lint_issue_log(log)) == ["OVL002", "OVL002"]
    with pytest.raises(ta.AnalysisError, match="OVL002"):
        ta.check_issue_log(log)
    assert ta.lint_issue_log({"units": 2, "issued": [0, 1]}) == []


# --------------------------------------------------------------- RES

def test_res001_guard_trace_identity(fake8):
    from easydist_tpu_torch.fxfront import make_device_mesh
    from easydist_tpu_torch.models.mlp import mlp_apply, mlp_init
    from easydist_tpu_torch.parallel import ddp_step
    from easydist_tpu_torch.resilience.guard import init_guard_state

    mesh = make_device_mesh((8,), ("dp",), device_type="cpu")
    params = mlp_init(torch.Generator().manual_seed(0), sizes=(16, 32, 16),
                      device="cpu")
    x = torch.randn(16, 16)

    def loss(p, xb, yb):
        return torch.mean((mlp_apply(p, xb) - yb) ** 2)

    off = ddp_step(loss, mesh, lr=0.05, step_guard=False)
    default = ddp_step(loss, mesh, lr=0.05)
    assert ta.audit_guard_parity(default, off, (params, x, x)) == []
    guarded = ddp_step(loss, mesh, lr=0.05, step_guard=True)
    found = ta.audit_guard_parity(
        lambda s, a, b: guarded((s, init_guard_state()), a, b)[0][0],
        lambda s, a, b: off(s, a, b)[0], (params, x, x))
    assert ids(found) == ["RES001"]


def test_res002_res003_over_a_checkpoint_root(tmp_path):
    from easydist_tpu_torch.runtime.checkpoint import save_checkpoint

    root = str(tmp_path)
    state = {"w": torch.arange(8.0)}
    save_checkpoint(root, state, 1)
    save_checkpoint(root, state, 2)
    assert ta.audit_checkpoint_root(root) == []
    assert ta.audit_checkpoint_root(str(tmp_path / "none")) == []
    os.makedirs(os.path.join(root, "step_1_torn"))
    os.makedirs(os.path.join(root, "step_0"))        # torn, superseded
    os.makedirs(os.path.join(root, "step_9"))        # torn, newest
    os.makedirs(os.path.join(root, ".tmp_step_3_ab"))
    arrays = os.path.join(root, "step_2", "arrays")
    with open(os.path.join(arrays, sorted(os.listdir(arrays))[0]),
              "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    found = ta.audit_checkpoint_root(root)
    assert sorted(ids(found)) == ["RES002", "RES003", "RES003", "RES003"]
    assert [f.severity for f in found if f.rule_id == "RES002"] == ["error"]


# ------------------------------------------------------------ SERVE

def _compiled(fn, *args, **kw):
    from easydist_tpu_torch.fxfront import easydist_compile

    return easydist_compile(fn, **kw).get_compiled(*args)


def _masked_attention(cache, q, pos):
    t = cache["k"].shape[1]
    s = q @ cache["k"].transpose(-1, -2)
    keys = torch.arange(t)[None, :]
    s = torch.where(keys <= pos[:, None], s, torch.full_like(s, -1e30))
    return torch.softmax(s, -1) @ cache["k"]


def _step_in_place(cache, q, pos):
    cache["k"][torch.arange(q.shape[0]), pos] = q
    return cache, _masked_attention(cache, q, pos)


def _step_new_cache(cache, q, pos):
    k = cache["k"].clone()
    k[torch.arange(q.shape[0]), pos] = q
    new = {"k": k}
    return new, _masked_attention(new, q, pos)


def _step_unmasked(cache, q, pos):
    cache["k"][torch.arange(q.shape[0]), pos] = q
    s = q @ cache["k"].transpose(-1, -2)
    return cache, torch.softmax(s, -1) @ cache["k"]


def _serve_args():
    return ({"k": torch.zeros(2, 8, 4)}, torch.randn(2, 4),
            torch.tensor([1, 3]))


@pytest.mark.parametrize("fn,want", [
    (_step_in_place, ([], [], [])),
    (_step_new_cache, (["SERVE001"], ["SERVE002"], ["SERVE003"])),
    (_step_unmasked, ([], ["SERVE002"], ["SERVE003"])),
])
def test_serve_program_arms(fn, want):
    res = _compiled(fn, *_serve_args())
    assert ids(ta.audit_decode_donation(res)) == want[0]
    assert ids(ta.audit_chunked_prefill(res)) == want[1]
    assert ids(ta.audit_speculative_rewind(res)) == want[2]
    sev = [f.severity for f in ta.audit_chunked_prefill(res)]
    assert sev == (["warning"] if fn is _step_new_cache
                   else ["error"] if fn is _step_unmasked else [])


def test_serve001_donate_state_off_and_warning_never_raises():
    res = _compiled(_step_in_place, *_serve_args(), donate_state=False)
    found = ta.check_decode_donation(res)
    assert ids(found) == ["SERVE001"] and found[0].severity == "warning"


@pytest.mark.parametrize("n_acc,want", [(1, []), (2, ["SERVE003"])])
def test_serve003_bookkeeping_matches_jax(n_acc, want):
    kw = dict(draft=[5, 6, 7], target=[5, 9, 7, 1], n_accepted=n_acc)
    assert ids(ta.audit_speculative_rewind(**kw)) \
        == ids(ja.audit_speculative_rewind(**kw)) == want


def test_serve003_paged_rollback_arm_and_prefix_cache():
    from easydist_tpu_torch.kv import PagePool, PageTable
    from easydist_tpu_torch.serve.prefix_cache import PrefixCache

    pool, table = PagePool(6, 4), PageTable(2, 3, 6)
    table.map(0, 0, pool.alloc())
    assert ta.audit_speculative_rewind(pool=pool, table=table) == []
    pid = pool.alloc()
    table.map(1, 0, pid)
    pool.release(pid)                     # released under a live row
    found = ta.audit_speculative_rewind(pool=pool, table=table)
    assert set(ids(found)) == {"SERVE003"}
    trie = PrefixCache(4, 1 << 20)
    trie.commit([], [1, 2, 3, 4], {"page": 0}, nbytes=64)
    assert ta.audit_prefix_cache(trie) == []
    trie.bytes_used += 1
    assert ids(ta.audit_prefix_cache(trie)) == ["SERVE002"]
    with pytest.raises(ta.AnalysisError, match="SERVE002"):
        ta.check_prefix_cache(trie)


# -------------------------------------------------------------- KVQ

def _arena(lib, bad=None):
    zeros = lib.zeros
    i8, f32 = (jnp.int8, jnp.float32) if lib is jnp else \
        (torch.int8, torch.float32)
    a = {"k": zeros((2, 5, 4, 8), dtype=i8), "v": zeros((2, 5, 4, 8),
                                                        dtype=i8),
         "k_scale": zeros((2, 5, 4, 2), dtype=f32),
         "v_scale": zeros((2, 5, 4, 2), dtype=f32)}
    if bad == "missing":
        del a["v_scale"]
    elif bad == "shape":
        a["k_scale"] = zeros((2, 5, 4, 3), dtype=f32)
    elif bad == "exact":
        a = {"k": zeros((2, 5, 4, 8), dtype=f32), "v": zeros(
            (2, 5, 4, 8), dtype=f32), "k_scale": zeros((2, 5, 4, 2),
                                                       dtype=f32)}
    return a


@pytest.mark.parametrize("bad", [None, "missing", "shape", "exact"])
def test_kvq001_matches_jax(bad):
    got = ids(ta.audit_quant_arena(_arena(torch, bad)))
    assert got == ids(ja.audit_quant_arena(_arena(jnp, bad)))
    assert got == ([] if bad is None else ["KVQ001"])


def test_kvq002_int8_reaching_a_matmul():
    def dequant(q, k8, s):
        return q @ (k8.float() * s).transpose(0, 1)

    def raw(q, k8, s):
        return (q.to(torch.int8) @ k8.transpose(0, 1)).float() * s.sum()

    args = (torch.randn(2, 8), torch.zeros(4, 8, dtype=torch.int8),
            torch.ones(4, 1))
    assert ta.audit_quant_program(trace(dequant, *args)) == []
    found = ta.audit_quant_program(trace(raw, *args))
    assert ids(found) == ["KVQ002", "KVQ002"]


def test_kvq003_and_the_quant_session_audits():
    """A tier whose manifest no longer verifies fires KVQ003 in both
    packages; a live int8 paged session runs KVQ001-003 and SERVE / ALIAS
    audits with no finding."""
    from easydist_tpu_torch.kv.tier import HostTier

    tier = HostTier(1 << 20)
    assert tier.put("a", {"k": torch.arange(16.0)})
    assert ta.audit_tier_roundtrip(tier) == []
    tier._entries["a"].arrays["k"][3] += 1.0      # bit rot on the host
    assert ids(ta.audit_tier_roundtrip(tier)) == ["KVQ003"]
    broken = types.SimpleNamespace(check_invariants=lambda: ["sha256"])
    assert ids(ta.audit_tier_roundtrip(broken)) \
        == ids(ja.audit_tier_roundtrip(broken)) == ["KVQ003"]

    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_init
    from easydist_tpu_torch.serve import GenerationSession, ServeConfig

    cfg = GPTConfig.tiny()
    params = gpt_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ta.reset_hook_tally()
    sess = GenerationSession.for_gpt(
        params, cfg, device="cpu", compile_key=None,
        config=ServeConfig(decode_buckets=(32,), prefill_chunk=8,
                           kv_layout="paged", kv_quant_dtype="int8",
                           kv_host_tier_bytes=1 << 20, kv_arena_pages=8))
    futs = [sess.submit(list(range(1, 18)), max_new_tokens=4),
            sess.submit(list(range(1, 18)), max_new_tokens=4)]
    sess.run_until_drained()
    assert all(len(f.result()["ids"]) == 4 for f in futs)
    tally = ta.hook_tally()
    for rule in ("SERVE001", "SERVE002", "ALIAS004", "KVQ001", "KVQ002",
                 "KVQ003"):
        assert tally[rule]["runs"] >= 1, tally
    assert all(row["findings"] == 0 for row in tally.values()), tally


# ---------------------------------------------------------- RESHARD

def test_reshard001_matches_jax():
    ok = types.SimpleNamespace(peak_live_bytes=lambda: 100,
                               chunked_bound=lambda: 100)
    bad = types.SimpleNamespace(peak_live_bytes=lambda: 101,
                                chunked_bound=lambda: 100)
    assert ta.audit_reshard_plan(ok) == ja.audit_reshard_plan(ok) == []
    assert ids(ta.audit_reshard_plan(bad)) \
        == ids(ja.audit_reshard_plan(bad)) == ["RESHARD001"]
    with pytest.raises(ta.AnalysisError, match="RESHARD001"):
        ta.check_reshard_plan(bad)


def test_reshard002_restored_layout(fake8):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from easydist_tpu_torch.fxfront import make_device_mesh

    mesh = make_device_mesh((8,), ("dp",), device_type="cpu")
    shard = DTensor.from_local(torch.ones(2, 4), mesh, [Shard(0)],
                               run_check=False)
    rep = DTensor.from_local(torch.ones(16, 4), mesh, [Replicate()],
                             run_check=False)
    tmpl = {"w": shard, "host": torch.ones(3)}
    assert ta.audit_restored_state({"w": shard, "host": torch.ones(3)},
                                   tmpl) == []
    found = ta.audit_restored_state({"w": rep, "host": torch.ones(3)}, tmpl)
    assert ids(found) == ["RESHARD002"]
    assert ids(ta.audit_restored_state({"w": shard}, tmpl)) == ["RESHARD002"]


# ------------------------------------------------------------ ALIAS

def _stale_view(state, x):
    v = state["w"][0]
    state["w"].mul_(2.0)
    return state, v + x


def _fresh_view(state, x):
    state["w"].mul_(2.0)
    return state, state["w"][0] + x


def _disjoint_rows(state, x):
    v = state["w"][0]
    state["w"][1].mul_(2.0)
    return state, v + x


@pytest.mark.parametrize("fn,want", [(_stale_view, ["ALIAS001"]),
                                     (_fresh_view, []),
                                     (_disjoint_rows, [])])
def test_alias001_view_read_after_an_in_place_write(fn, want):
    res = _compiled(fn, {"w": torch.ones(2, 4)}, torch.ones(4))
    assert ids(ta.audit_program_aliases(res.traced, res.state_pairs)) == want
    assert ids(res.analyze(include_memory=False).findings) == want


def test_alias001_jax_counterpart():
    inner = jax.jit(lambda s: s * 2.0, donate_argnums=0)
    bad = jax.make_jaxpr(lambda x: inner(x) + x)(jnp.zeros(4)).jaxpr
    good = jax.make_jaxpr(lambda x: inner(x))(jnp.zeros(4)).jaxpr
    assert ids(ja.audit_jaxpr_donation(bad)) == ["ALIAS001"]
    assert ja.audit_jaxpr_donation(good) == []


def _two_outs(state, x):
    return state["a"] * 2, state["a"] + 1, x.sum()


def test_alias002_alias003_state_pairs(monkeypatch):
    args = ({"a": torch.ones(4)}, torch.ones(4))
    with pytest.raises(ta.AnalysisError, match="ALIAS002"):
        _compiled(_two_outs, *args, state_io={0: 0, 1: 0})
    monkeypatch.setattr(tconfig, "analyze_raise", False)
    assert ta.audit_donation_pairs(_compiled(_two_outs, *args,
                                             state_io={0: 0})) == []
    res = _compiled(_two_outs, *args, state_io={0: 0, 1: 0})
    assert ids(ta.audit_donation_pairs(res)) == ["ALIAS002"]
    res = _compiled(_two_outs, *args, state_io={2: 0})
    assert ids(ta.audit_donation_pairs(res)) == ["ALIAS003"]
    res = _compiled(_two_outs, *args, state_io={7: 0})
    assert ids(ta.audit_donation_pairs(res)) == ["ALIAS003"]
    # one storage through two paired positions: raised at the first call
    from easydist_tpu_torch.fxfront import easydist_compile

    t = torch.ones(4)
    monkeypatch.setattr(tconfig, "analyze_raise", True)
    with pytest.raises(ta.AnalysisError, match="ALIAS002"):
        easydist_compile(lambda s: ({"a": s["a"] + 1, "b": s["b"] + 1},))(
            {"a": t, "b": t})


def test_alias004_host_aliases_match_jax():
    cache = torch.zeros(4, 8)
    assert ta.audit_host_aliases({"cache": cache},
                                 {"trie": [cache[1].clone()]}) == []
    found = ta.audit_host_aliases({"cache": cache}, {"trie": [cache[1]]})
    jc = jnp.zeros((4, 8))
    assert ids(found) == ids(ja.audit_host_aliases({"cache": jc},
                                                   {"trie": [jc]})) \
        == ["ALIAS004"]
    with pytest.raises(ta.AnalysisError, match="ALIAS004"):
        ta.check_host_aliases({"cache": cache}, {"trie": {"kv": cache}})
