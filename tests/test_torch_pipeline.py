"""The port's pipelines (`parallel/pipeline.py`, `models/gpt.py`'s
`make_gpt_pipeline_step`) against the JAX package's
(tests/test_parallel/test_pipeline.py), on gloo ranks of world 4.

The same numpy-seeded stages, microbatches and targets go through the
JAX package's `spmd_pipeline` / `spmd_pipeline_grad` on the conftest's
CPU mesh and through the port, one process a rank: forwards (plain,
interleaved, hybrid pp x tp with `param_spec`) at rtol 1e-5 / atol 1e-6,
losses and gradients of gpipe, remat, 1f1b and interleaved 1f1b, and
1f1b with `data_axis` on (2, 2), at rtol 1e-4 / atol 1e-6 (the JAX
tests' bars), each rank's rows against the JAX package's.  Each rank's
P2P traffic and its live residual sets (1f1b: at most the tables'
`ring` per chunk; gpipe: all M) are checked against the tables.  The
tiny GPT's pipelined steps (gpipe; 1f1b with n_virtual=2, flash
attention through its plain version) hold 3-step losses and parameters
against the JAX package's.  `_1f1b_schedule_tables` equals the JAX one
over a grid of (S, V, M).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from easydist_tpu.parallel import PipelineConfig as JConfig
from easydist_tpu.parallel import spmd_pipeline as j_pipeline
from easydist_tpu.parallel import spmd_pipeline_grad as j_pipeline_grad
from easydist_tpu.parallel.pipeline import \
    _1f1b_schedule_tables as j_tables
from easydist_tpu_torch.parallel.pipeline import (_1f1b_schedule_tables,
                                                  _gpipe_tables,
                                                  schedule_tables)
from tests import test_torch_fxfront_ranks as ranks

S, M, MB, D = 4, 8, 2, 8
RTOL_F, ATOL_F = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 1e-6
GPT = dict(vocab=64, seq=16, dim=32, heads=4, layers=8)
GPT_RUNS = (("gpipe", 1), ("1f1b", 2))
SCENARIO = "tests.test_torch_parallel_ranks:pipeline_modes"


def _stages(rs, n):
    return {"b": (0.1 * rs.randn(n, D)).astype(np.float32),
            "w": (rs.randn(n, D, D) / np.sqrt(D)).astype(np.float32)}


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _loss_fn(o, t):
    return jnp.mean((o - t) ** 2)


def _jax_runs(cpu_devices, stages4, stages8, x, tgt, gpt):
    mesh = Mesh(np.array(cpu_devices[:4]), ("pp",))
    j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    s4, s8, jx, jt = j(stages4), j(stages8), jnp.asarray(x), jnp.asarray(tgt)
    res = {"fwd": np.asarray(j_pipeline(_stage_fn, mesh, JConfig(S, M))(
        s4, jx)),
        "fwd_v2": np.asarray(j_pipeline(_stage_fn, mesh, JConfig(
            S, M, n_virtual=2))(s8, jx))}
    for sched, V in (("gpipe", 1), ("remat", 1), ("1f1b", 1), ("1f1b", 2),
                     ("gpipe", 2)):
        loss, grads = jax.jit(j_pipeline_grad(
            _stage_fn, _loss_fn, mesh,
            JConfig(S, M, schedule=sched, n_virtual=V)))(
                s4 if V == 1 else s8, jx, jt)
        res[f"{sched}_v{V}"] = (float(loss), jax.tree.map(np.asarray, grads))
    mesh_dp = Mesh(np.array(cpu_devices[:4]).reshape(2, 2), ("pp", "dp"))
    two = jax.tree.map(lambda a: a[:2], s4)
    loss, grads = jax.jit(j_pipeline_grad(
        _stage_fn, _loss_fn, mesh_dp,
        JConfig(2, M, schedule="1f1b", data_axis="dp")))(two, jx, jt)
    res["dp_1f1b"] = (float(loss), jax.tree.map(np.asarray, grads))
    res["gpt"] = _jax_gpt(cpu_devices, **gpt)
    return res


def _jax_gpt(cpu_devices, params, cfg, tokens, targets, steps, runs):
    from easydist_tpu.models.gpt import GPTConfig, make_gpt_pipeline_step
    from easydist_tpu.models.optim import adam_init

    mesh = Mesh(np.array(cpu_devices[:4]), ("pp",))
    out = {}
    for sched, V in runs:
        step, _ = make_gpt_pipeline_step(GPTConfig(**cfg), mesh,
                                         tokens.shape[0], lr=1e-4,
                                         schedule=sched, n_virtual=V)
        p = jax.tree.map(jnp.asarray, params)
        state, losses = (p, adam_init(p)), []
        step = jax.jit(step)
        for _ in range(steps):
            state, loss = step(state, jnp.asarray(tokens),
                               jnp.asarray(targets))
            losses.append(float(loss))
        out[f"{sched}_v{V}"] = (losses, jax.tree.map(np.asarray, state[0]))
    return out


def _gpt_inputs():
    from easydist_tpu.models.gpt import GPTConfig, gpt_init

    params = jax.tree.map(np.asarray, gpt_init(GPTConfig(**GPT),
                                               jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    tokens = rs.randint(0, GPT["vocab"], (4, 2, GPT["seq"])).astype(np.int32)
    targets = rs.randint(0, GPT["vocab"], (4, 2, GPT["seq"])).astype(
        np.int32)
    return dict(params=params, cfg=GPT, tokens=tokens, targets=targets,
                steps=3, runs=GPT_RUNS)


def _inputs():
    rs = np.random.RandomState(0)
    stages4, stages8 = _stages(rs, 4), _stages(rs, 8)
    x = rs.randn(M, MB, D).astype(np.float32)
    tgt = rs.randn(M, MB, D).astype(np.float32)
    return stages4, stages8, x, tgt


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_devices):
    stages4, stages8, x, tgt = _inputs()
    gpt = _gpt_inputs()
    port = ranks.spawn(SCENARIO, 4, tmp_path_factory.mktemp("pipeline"),
                       stages4=stages4, stages8=stages8, x=x, tgt=tgt,
                       gpt={**gpt, "cfg": {**GPT, "attention": "flash"}})
    return port, _jax_runs(cpu_devices, stages4, stages8, x, tgt, gpt)


@pytest.mark.parametrize("key", ["fwd", "fwd_v2"])
def test_forward_matches_jax(runs, key):
    port, want = runs
    for r in port:
        np.testing.assert_allclose(r[key], want[key], rtol=RTOL_F,
                                   atol=ATOL_F)


def _rows(grads, rank, n_stages, V):
    """The JAX package's stage-stacked grads as rank `rank` holds them."""
    pick = [k * n_stages + rank for k in range(V)]
    return {k: v[pick] for k, v in grads.items()}


@pytest.mark.parametrize("key", ["gpipe_v1", "remat_v1", "1f1b_v1",
                                 "1f1b_v2", "gpipe_v2"])
def test_grads_match_jax(runs, key):
    port, want = runs
    w_loss, w_grads = want[key]
    V = int(key[-1])
    for rank, r in enumerate(port):
        loss, grads, _, _ = r[key]
        np.testing.assert_allclose(loss, w_loss, rtol=RTOL_F, atol=ATOL_F)
        for name, g in _rows(w_grads, rank, S, V).items():
            np.testing.assert_allclose(grads[name], g, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key", ["gpipe_v1", "remat_v1", "1f1b_v1",
                                 "1f1b_v2", "gpipe_v2"])
def test_traffic_and_live_sets(runs, key):
    """Each rank sends one activation per forward unit and one gradient
    per backward unit that has a neighbour, and receives as many; 1f1b
    keeps at most `ring` residual sets alive per chunk, gpipe all M."""
    port, _ = runs
    sched, V = key[:-3], int(key[-1])
    J = S * V
    for rank, r in enumerate(port):
        _, _, stats, ring = r[key]
        last_unit = J - 1 in [k * S + rank for k in range(V)]
        first_unit = 0 in [k * S + rank for k in range(V)]
        sends = M * (V - last_unit) + M * (V - first_unit)
        assert stats["sends"] == stats["recvs"] == sends, stats
        assert stats["send_bytes"] == sends * MB * D * 4
        if sched == "1f1b":
            assert max(stats["max_live"]) <= ring
            assert ring == _1f1b_schedule_tables(S, V, M)["ring"]
            assert ring < M or V > 1
        else:
            assert stats["max_live"] == [M] * V


def test_data_axis_1f1b_matches_jax(runs):
    port, want = runs
    w_loss, w_grads = want["dp_1f1b"]
    for rank, r in enumerate(port):
        loss, grads = r["dp_1f1b"]
        np.testing.assert_allclose(loss, w_loss, rtol=RTOL_F, atol=ATOL_F)
        for name, g in _rows(w_grads, rank // 2, 2, 1).items():
            np.testing.assert_allclose(grads[name], g, rtol=RTOL, atol=ATOL)


def test_param_spec_forward(runs):
    """(2, 2) "pp" x "tp": w cut over tp and the stage gathering its
    columns (the JAX test_hybrid_pp_dp_tp form); every rank's output
    equals the plain two-stage model's."""
    port, _ = runs
    stages4, _, x, _ = _inputs()
    want = []
    for i in range(M):
        h = x[i]
        for s in range(2):
            h = np.tanh(h @ stages4["w"][s] + stages4["b"][s])
        want.append(h)
    for r in port:
        np.testing.assert_allclose(r["tp_fwd"], np.stack(want),
                                   rtol=RTOL_F, atol=ATOL_F)


@pytest.mark.parametrize("run", [f"{s}_v{v}" for s, v in GPT_RUNS])
def test_gpt_pipeline_step_matches_jax(runs, run):
    port, want = runs
    w_losses, w_params = want["gpt"][run]
    for r in port:
        losses, params, layers = r["gpt"][run]
        np.testing.assert_allclose(losses, w_losses, rtol=RTOL_F,
                                   atol=ATOL_F)
        for key in ("wte", "wpe"):
            np.testing.assert_allclose(params[key], w_params[key],
                                       rtol=RTOL, atol=1e-5)
        d = GPT["dim"]
        for i, layer in enumerate(layers):
            got, ref = params["blocks"][i], w_params["blocks"][layer]
            # the key third of the qkv bias has a zero gradient in exact
            # arithmetic (softmax ignores a shift of every score of a
            # row), so Adam turns either package's rounding noise there
            # into +-lr steps: it is left out
            for part in (got, ref):
                b = part["attn"]["qkv"]["b"]
                part["attn"]["qkv"]["b"] = np.concatenate([b[:d],
                                                           b[2 * d:]])
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("S_,V,M_", [(1, 1, 1), (2, 1, 4), (4, 1, 8),
                                     (4, 1, 11), (2, 2, 4), (4, 2, 8),
                                     (4, 2, 10), (3, 3, 7), (8, 1, 3)])
def test_1f1b_tables_equal_jax(S_, V, M_):
    for fwd_only in (False, True):
        got = _1f1b_schedule_tables(S_, V, M_, fwd_only=fwd_only)
        want = j_tables(S_, V, M_, fwd_only=fwd_only)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("S_,V,M_", [(2, 1, 4), (4, 2, 8), (3, 1, 5)])
def test_gpipe_tables_mirror_forward(S_, V, M_):
    """Every (stage, microbatch) gets one forward and one backward unit,
    and a backward unit comes one supertick after its successor's."""
    t = _gpipe_tables(S_, V, M_)
    J = S_ * V
    when_b = {}
    for u in range(t["n_superticks"]):
        for s in range(S_):
            if t["b_ok"][u, s]:
                when_b[(int(t["k_b"][u, s]) * S_ + s, int(t["m_b"][u, s]))] = u
    assert len(when_b) == J * M_ == int(t["f_ok"].sum())
    for (j, m), u in when_b.items():
        if j < J - 1:
            assert when_b[(j + 1, m)] == u - 1
    with pytest.raises(ValueError, match="schedule"):
        schedule_tables("zigzag", S_, V, M_)
