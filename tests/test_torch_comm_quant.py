"""The port's quantized and bucketed gradient collectives (`comm/quant.py`,
`comm/bucketer.py`, `comm/reduce.py`) and the solver fence they repair,
against the JAX package's (tests/test_comm/test_{quant,bucketer,
dp_quant}.py).

  * quantize / dequantize: bitwise on the same numpy inputs;
  * the quantizable-leaf set and the bucket plans: equal on GPT-2's
    leaves (tiny and small widths);
  * `quantized_psum` / `_scatter` / `bf16_psum` on gloo worlds 2 and 4:
    within the JAX tests' bars of the exact sum (0.03 / 0.05 / 0.02 of
    the largest magnitude), and within one quantization step (the
    largest magnitude / 127) of the JAX function on a CPU mesh of the
    same size;
  * ddp / zero2 / zero3 under int8 (256 KiB buckets, min numel 512):
    3 losses within atol / rtol 1e-2 of the JAX steps' and of the exact
    run's (test_dp_quant.py:54-122);
  * the solver's fence: under int8 on a gloo (2,) mesh, the bytes the
    emitted program's collectives send at run time equal what the solve
    priced (the fence used to send the exact f32 collective while the
    solver priced the compressed one), and 3 compiled losses stay within
    1e-2 of eager (test_dp_quant.py:138-164).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tests import test_torch_fxfront_ranks as ranks

SCEN = "tests.test_torch_comm_ranks:"
JAX_CONSTANTS = dict(peak_flops=4.9e13, hbm_bandwidth=8.1e11,
                     nvlink_bandwidth=2e11, nvlink_latency=1e-6)


def _mlp(seed, sizes=(32, 64, 32), batch=64):
    rs = np.random.RandomState(seed)
    params = [{"w": (rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
               "b": (0.1 * rs.randn(b)).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    x = rs.randn(batch, sizes[0]).astype(np.float32)
    y = rs.randn(batch, sizes[-1]).astype(np.float32)
    return params, x, y


# ------------------------------------------------------- block scaling

@pytest.mark.parametrize("n,block,scale", [(4096, 256, 10.0),
                                           (2048, 128, 1.0),
                                           (512, 256, 0.0)])
def test_quantize_dequantize_bitwise(n, block, scale):
    from easydist_tpu.comm import (dequantize_blockwise as jdq,
                                   quantize_blockwise as jq)
    from easydist_tpu_torch.comm import (dequantize_blockwise,
                                         quantize_blockwise)

    x = (np.random.RandomState(n).randn(n) * scale).astype(np.float32)
    x[:8] = np.array([0.5, -0.5, 1.5, 2.5, 127.0, -127.0, 0.0, 3.5],
                     np.float32) * (scale / 127.0)  # ties round to even
    q, s = quantize_blockwise(torch.from_numpy(x), block)
    jq_, js = jq(jnp.asarray(x), block)
    assert np.array_equal(q.numpy(), np.asarray(jq_))
    assert np.array_equal(s.numpy(), np.asarray(js))
    back = dequantize_blockwise(q, s, block).numpy()
    assert back.tobytes() == np.asarray(jdq(jq_, js, block)).tobytes()
    if scale == 0.0:  # all-zero blocks: scale 1.0, exact
        assert np.all(s.numpy() == 1.0) and np.all(back == 0.0)


def test_payload_bytes_match_jax():
    from easydist_tpu.comm.quant import int8_payload_bytes as jbytes
    from easydist_tpu_torch.comm import int8_payload_bytes, int8_wire_bytes

    for numel in (1, 255, 256, 1000, 4096, 50304 * 768):
        assert int8_payload_bytes(numel, 256) == jbytes(numel, 256)
    # the all_reduce pads to n * block, the reduce_scatter each row
    assert int8_wire_bytes("all_reduce", 1000, 4, 256) == \
        2 * int8_payload_bytes(1024, 256) * 3 / 4
    assert int8_wire_bytes("reduce_scatter", 16 * 30, 8, 256) == \
        int8_payload_bytes(8 * 256, 256) * 7 / 8


# ---------------------------------------------- leaf sets and bucket plans

def _jax_gpt_leaves(cfg_kw):
    from easydist_tpu.models.gpt import GPTConfig, gpt_init

    shapes = jax.eval_shape(lambda: gpt_init(GPTConfig(**cfg_kw),
                                             jax.random.PRNGKey(0)))
    kps, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(jax.tree_util.keystr(kp), tuple(s.shape)) for kp, s in kps]


def _port_gpt_leaves(cfg_kw):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree

    from easydist_tpu_torch.models.gpt import GPTConfig, gpt_init

    with FakeTensorMode():
        params = gpt_init(GPTConfig(**cfg_kw), torch.Generator(),
                          device="cpu")
    kps, _ = pytree.tree_flatten_with_path(params)
    return params, [(pytree.keystr(kp), tuple(x.shape)) for kp, x in kps]


GPT2_SMALL = dict(vocab=50304, seq=1024, dim=768, heads=12, layers=12)
GPT2_TINY = dict(vocab=128, seq=32, dim=32, heads=4, layers=2)


@pytest.mark.parametrize("cfg_kw", [GPT2_TINY, GPT2_SMALL],
                         ids=["tiny", "small"])
def test_quantizable_set_matches_jax(monkeypatch, cfg_kw):
    from easydist_tpu import config as jconfig
    from easydist_tpu.comm import leaf_quantizable as jq
    from easydist_tpu_torch import config as tconfig
    from easydist_tpu_torch.comm import leaf_quantizable

    monkeypatch.setattr(jconfig, "comm_quant_dtype", "int8")
    monkeypatch.setattr(tconfig, "comm_quant_dtype", "int8")
    jleaves = _jax_gpt_leaves(cfg_kw)
    _, tleaves = _port_gpt_leaves(cfg_kw)
    assert sorted(jleaves) == sorted(tleaves)
    want = {p for p, s in jleaves if jq(p, int(np.prod(s)))}
    got = {p for p, s in tleaves if leaf_quantizable(p, int(np.prod(s)))}
    assert got == want
    if cfg_kw is GPT2_SMALL:
        # wte, wpe and the four weight matrices of each of the 12 blocks
        assert (len(got), len(tleaves)) == (50, 148)


@pytest.mark.parametrize("bucket_bytes", [0, 16 << 10, 1 << 20])
def test_bucket_plans_match_jax(monkeypatch, bucket_bytes):
    from easydist_tpu import config as jconfig
    from easydist_tpu.comm import leaf_quantizable as jq
    from easydist_tpu.comm import plan_buckets as jplan
    from easydist_tpu.models.gpt import GPTConfig, gpt_init
    from easydist_tpu_torch import config as tconfig
    from easydist_tpu_torch.comm import (keyed_leaves, leaf_quantizable,
                                         plan_buckets)

    monkeypatch.setattr(jconfig, "comm_quant_dtype", "int8")
    monkeypatch.setattr(tconfig, "comm_quant_dtype", "int8")
    monkeypatch.setattr(jconfig, "comm_quant_min_numel", 512)
    monkeypatch.setattr(tconfig, "comm_quant_min_numel", 512)
    jparams = gpt_init(GPTConfig(**GPT2_TINY), jax.random.PRNGKey(0))
    kps, _ = jax.tree_util.tree_flatten_with_path(jparams)
    jleaves = [leaf for _, leaf in kps]
    jflags = [jq(jax.tree_util.keystr(kp), leaf.size) for kp, leaf in kps]
    want = [(b.indices, b.nbytes, b.quantize)
            for b in jplan(jleaves, bucket_bytes, jflags)]
    tparams, _ = _port_gpt_leaves(GPT2_TINY)
    leaves, paths, _, order = keyed_leaves(tparams)
    ordered = [leaves[i] for i in order]
    assert [paths[i] for i in order] == [jax.tree_util.keystr(kp)
                                        for kp, _ in kps]
    flags = [leaf_quantizable(paths[i], leaves[i].numel()) for i in order]
    got = [(b.indices, b.nbytes, b.quantize)
           for b in plan_buckets(ordered, bucket_bytes, flags)]
    assert got == want


def test_pack_unpack_bitwise_roundtrip():
    from easydist_tpu_torch.comm import pack, plan_buckets, unpack

    rs = np.random.RandomState(0)
    leaves = [torch.from_numpy(rs.randn(*s).astype(np.float32))
              for s in ((64, 32), (32,), (128, 64), (16, 8))]
    for b in plan_buckets(leaves, 1 << 20, [True] * 4):
        for i, leaf in unpack(pack(leaves, b), b, leaves).items():
            assert torch.equal(leaf, leaves[i])


# ------------------------------------------------ collectives on gloo

def _quant_inputs(world):
    rs = np.random.RandomState(world)
    return dict(vec=rs.randn(world, 1000).astype(np.float32),
                vec_bf16=rs.randn(world, 64, 33).astype(np.float32),
                scat=rs.randn(world, 16, 30).astype(np.float32),
                vec5=rs.randn(world, 256).astype(np.float32))


def _jax_quant(world, cpu_devices, inp):
    from easydist_tpu.comm import (bf16_psum, quantized_psum,
                                   quantized_psum_scatter)
    from easydist_tpu.utils.jax_compat import shard_map

    mesh = Mesh(np.array(cpu_devices[:world]), ("dp",))

    def run(body, x, out_spec=P()):
        return np.asarray(shard_map(body, mesh=mesh, in_specs=P("dp"),
                                    out_specs=out_spec,
                                    check_vma=False)(jnp.asarray(x)),
                          np.float32)

    vb = jnp.asarray(inp["vec_bf16"]).astype(jnp.bfloat16)
    return {
        "psum": run(lambda v: quantized_psum(v[0], "dp", world),
                    inp["vec"]),
        "pmean_bf16": np.asarray(shard_map(
            lambda v: quantized_psum(v[0], "dp", world, mean=True),
            mesh=mesh, in_specs=P("dp"), out_specs=P(),
            check_vma=False)(vb), np.float32),
        "scatter": run(lambda v: quantized_psum_scatter(v[0], "dp", world,
                                                        mean=True),
                       inp["scat"], P("dp")),
        "bf16": run(lambda v: bf16_psum(v[0], "dp"), inp["vec5"]),
    }


@pytest.fixture(scope="module", params=(2, 4))
def comm_runs(request, tmp_path_factory, cpu_devices):
    """One spawn a world: the collectives, then the dp / ZeRO modes."""
    world = request.param
    inp = _quant_inputs(world)
    data = {"ddp": _mlp(10), "zero2": _mlp(20), "zero3": _mlp(30)}
    out = ranks.spawn(SCEN + "comm_cases", world,
                      tmp_path_factory.mktemp(f"comm{world}"), quant=inp,
                      data=data)
    return (world, out, _jax_quant(world, cpu_devices, inp),
            _jax_dp_int8(world, cpu_devices, data))


@pytest.fixture
def quant_runs(comm_runs):
    world, out, jax_quant, _ = comm_runs
    return world, [r["quant"] for r in out], jax_quant


@pytest.fixture
def dp_quant_runs(comm_runs):
    world, out, _, jax_dp = comm_runs
    return world, out, jax_dp


BARS = {"psum": 0.03, "pmean_bf16": 0.05, "scatter": 0.03, "bf16": 0.02}


@pytest.mark.parametrize("what", sorted(BARS))
def test_collectives_within_jax_bars(quant_runs, what):
    world, out, jax_res = quant_runs
    for rank, r in enumerate(out):
        got = np.asarray(r[what], np.float32)
        exact = np.asarray(r[what + "_exact"], np.float32)
        top = np.max(np.abs(exact))
        extra = 1e-3 if what == "pmean_bf16" else 1e-6
        np.testing.assert_allclose(got, exact, rtol=0,
                                   atol=BARS[what] * top + extra)
        # within one quantization step of the JAX function's result
        want = jax_res[what]
        if what == "scatter":
            n = want.shape[0] // world
            want = want[rank * n:(rank + 1) * n]
        step = np.max(np.abs(want)) / 127.0
        if what == "bf16":  # one bf16 ulp of the largest sum instead
            step = np.max(np.abs(want)) * 2.0 ** -7
        np.testing.assert_allclose(got, want, rtol=0, atol=step + 1e-6)


def test_quantized_psum_deterministic_and_replicated(quant_runs):
    world, out, _ = quant_runs
    assert out[0]["dtype_bf16"] == "torch.bfloat16"
    for r in out:
        assert np.array_equal(r["psum"], r["psum_again"])
        assert np.array_equal(r["psum"], out[0]["psum"])
        wire, snap = r["fence_wire"]
        # 1000 elements < comm_quant_min_numel: the exact fence, and the
        # bytes its collective sent equal what the counters recorded
        assert snap["quantized_launches"] == 0
        assert wire == snap["bytes_on_wire"]


# ----------------------------------------------------- dp / ZeRO under int8

def _jax_dp_int8(world, cpu_devices, data, steps=3):
    from easydist_tpu import config as jconfig
    from easydist_tpu.models.mlp import mlp_apply
    from easydist_tpu.parallel import ddp_step, zero2_step, zero3_step

    def loss_fn(p, x, y):
        return jnp.mean((mlp_apply(p, x) - y) ** 2)

    mesh = Mesh(np.array(cpu_devices[:world]), ("dp",))
    saved = {k: getattr(jconfig, k) for k in
             ("comm_quant_dtype", "comm_bucket_bytes",
              "comm_quant_min_numel")}
    jconfig.comm_quant_dtype, jconfig.comm_bucket_bytes = "int8", 256 << 10
    jconfig.comm_quant_min_numel = 512
    res = {}
    try:
        for mode in ("ddp", "zero2", "zero3"):
            params, x, y = (jax.tree.map(jnp.asarray, t) for t in data[mode])
            losses = []
            if mode == "ddp":
                step, state = ddp_step(loss_fn, mesh, lr=0.05), params
            elif mode == "zero2":
                step, init = zero2_step(loss_fn, mesh, lr=1e-2)
                state = (params, init(params), jnp.zeros((), jnp.int32))
            else:
                step, init = zero3_step(loss_fn, mesh, lr=1e-2)
                state = init(params)
            for _ in range(steps):
                state, loss = step(state, x, y)
                losses.append(float(loss))
            res[mode] = losses
    finally:
        for k, v in saved.items():
            setattr(jconfig, k, v)
    return res


@pytest.mark.parametrize("mode", ["ddp", "zero2", "zero3"])
def test_dp_int8_parity(dp_quant_runs, mode):
    _, out, jax_losses = dp_quant_runs
    for r in out:
        losses_q, _, snap = r["int8"][mode]
        assert snap["quantized_launches"] > 0, snap
        assert snap["bytes_on_wire"] < snap["bytes_fp32_equiv"], snap
        np.testing.assert_allclose(losses_q, jax_losses[mode], atol=1e-2,
                                   rtol=1e-2)
        np.testing.assert_allclose(losses_q, r["exact"][mode][0], atol=1e-2,
                                   rtol=1e-2)
        losses_b, _, snap_b = r["bf16"][mode]
        assert snap_b["quantized_launches"] > 0, snap_b
        np.testing.assert_allclose(losses_b, r["exact"][mode][0], atol=1e-2,
                                   rtol=1e-2)


def test_sensitive_leaves_stay_exact(dp_quant_runs):
    """The bias leaves (matched by comm_quant_skip) ride an exact bucket
    beside the quantized one, as in the JAX package."""
    _, out, _ = dp_quant_runs
    snap = out[0]["int8"]["ddp"][2]
    assert snap["quantized_launches"] >= 1
    assert snap["launches"] > snap["quantized_launches"]


# --------------------------------------------- the fence: emitted == priced

def _closed_form_wire(kind, nbytes, n, min_numel=512, block=256):
    """What one rank sends for a priced (kind, value bytes) of an f32
    value under the JAX fence's rule, computed here from first
    principles: a reduction of >= min_numel elements as the two-pass int8
    collective (pad to n * block; reduce_scatter rows to the block), every
    other collective at its ring bytes."""
    numel = int(nbytes // 4)
    if kind == "all_reduce" and numel >= min_numel:
        padded = -(-numel // (n * block)) * n * block
        return 2.0 * (padded + padded // block * 4) * (n - 1) / n
    if kind == "reduce_scatter" and numel >= min_numel:
        cols = -(-(numel // n) // block) * block
        return n * cols * (1 + 4 / block) * (n - 1) / n
    if kind == "all_reduce":
        return 2.0 * nbytes * (n - 1) / n
    if kind == "all_to_all":
        return nbytes * (n - 1) / (n * n)
    return nbytes * (n - 1) / n


@pytest.fixture(scope="module")
def auto_run(tmp_path_factory):
    params, x, y = _mlp(50, sizes=(256, 512, 256), batch=2048)
    out = ranks.spawn(SCEN + "auto_int8", 2,
                      tmp_path_factory.mktemp("auto_int8"), params=params,
                      x=x, y=y, constants=JAX_CONSTANTS)
    return out


def test_auto_int8_emitted_bytes_equal_priced(auto_run):
    for r in auto_run:
        priced = sum(_closed_form_wire(k, b, 2) for k, _, b in r["priced"][0])
        assert any(k in ("all_reduce", "reduce_scatter")
                   for k, _, _ in r["priced"][0]), r["priced"]
        # every step's collectives sent, at run time, what was priced
        for wire in r["runtime_wire"]:
            assert wire == pytest.approx(priced, rel=1e-9), (
                wire, priced, r["emitted"])
        # and the emitter, the solver and the counters agree edge by edge
        assert sorted((k, v, w) for _, k, v, w, _ in r["emitted"]) == \
            sorted(tuple(p) for p in r["priced_wire"][0])
        fences = [e for e in r["emitted"]
                  if e[1] in ("all_reduce", "reduce_scatter")]
        assert sum(e[3] for e in fences) == pytest.approx(
            r["counters"]["bytes_on_wire"])
        assert r["counters"]["quantized_launches"] == sum(
            e[4] == "int8" for e in fences) > 0


def test_auto_int8_losses_near_eager(auto_run):
    for r in auto_run:
        for lc, le in zip(r["losses_c"], r["losses_e"]):
            assert abs(lc - le) <= 1e-2 * max(1.0, abs(le))
