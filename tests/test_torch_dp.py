"""The port's manual data-parallel and ZeRO modes (`parallel/dp.py`,
`comm/`, `torchfront`'s parallel_mode) against the JAX package's
(tests/test_parallel/test_dp.py), on gloo ranks of world 2 and 4.

The same numpy-seeded MLP weights and batch go through the JAX package's
`ddp_step` / `zero2_step` / `zero3_step` on the conftest's CPU mesh and
through the port's steps, one process a rank; each also with K=2
gradient accumulation.  Bars: losses rtol 1e-5 / atol 1e-6, parameters
and Adam moments after 3 steps rtol 1e-4 / atol 1e-6 (the JAX tests'
gradient and Adam bars).  The leaf sizes (16, 30, 6) leave some leaves
indivisible by 4, so world 4 also runs the replicated-leaf path.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from easydist_tpu.models.mlp import mlp_apply
from easydist_tpu.parallel import ddp_step, zero2_step, zero3_step
from tests import test_torch_fxfront_ranks as ranks

WORLDS = (2, 4)
STEPS = 3
SIZES = (16, 30, 6)
MODES = ("ddp", "ddp_k2", "zero2", "zero2_k2", "zero3", "zero3_k2")
RTOL_LOSS, ATOL_LOSS = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 1e-6
SCENARIO = "tests.test_torch_parallel_ranks:dp_modes"


def _data(seed=0):
    rs = np.random.RandomState(seed)
    params = [{"w": (rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
               "b": (0.1 * rs.randn(b)).astype(np.float32)}
              for a, b in zip(SIZES[:-1], SIZES[1:])]
    x = rs.randn(64, SIZES[0]).astype(np.float32)
    y = rs.randn(64, SIZES[-1]).astype(np.float32)
    return params, x, y


def _loss(params, x, y):
    return jnp.mean((mlp_apply(params, x) - y) ** 2)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(jax.device_get(a)), tree)


def _jax_modes(world, cpu_devices, params, x, y):
    mesh = Mesh(np.array(cpu_devices[:world]), ("dp",))
    p0 = jax.tree.map(jnp.asarray, params)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    res = {}
    for k in (None, 2):
        tag = "" if k is None else f"_k{k}"
        step = ddp_step(_loss, mesh, lr=0.1, grad_accum_microbatches=k)
        p, losses = p0, []
        for _ in range(STEPS):
            p, loss = step(p, jx, jy)
            losses.append(float(loss))
        res["ddp" + tag] = (losses, _np(p))
        step, init_opt = zero2_step(_loss, mesh, lr=1e-3,
                                    grad_accum_microbatches=k)
        state = (p0, init_opt(p0), jnp.zeros((), jnp.int32))
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, jx, jy)
            losses.append(float(loss))
        res["zero2" + tag] = (losses, _np(state))
        step, init_state = zero3_step(_loss, mesh, lr=1e-3,
                                      grad_accum_microbatches=k)
        state = init_state(p0)
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, jx, jy)
            losses.append(float(loss))
        res["zero3" + tag] = (losses, _np(state))
    return res


def _jax_torchfront(world, cpu_devices, params, x, y):
    from easydist_tpu.torchfront import make_torch_train_step
    from tests.test_torch_parallel_ranks import mlp_module

    mesh = Mesh(np.array(cpu_devices[:world]), ("dp",))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    res = {}
    for mode, opt, lr in (("ddp", "sgd", 0.1), ("zero2", "adam", 1e-3),
                          ("zero3", "adam", 1e-3)):
        for train in (False, True):
            step, init = make_torch_train_step(
                mlp_module(params), (torch.from_numpy(x),),
                lambda p, t: jnp.mean((p - t) ** 2),
                optimizer="adam" if train else opt,
                lr=1e-3 if train else lr, mesh=mesh, parallel_mode=mode,
                train=train)
            state, losses = init(), []
            key = jax.random.PRNGKey(0)
            for _ in range(STEPS):
                if train:
                    state, loss = step(state, key, jx, jy)
                else:
                    state, loss = step(state, jx, jy)
                losses.append(float(loss))
            res[mode + ("_train" if train else "")] = losses
    return res


@pytest.fixture(scope="module", params=WORLDS)
def dp_runs(request, tmp_path_factory, cpu_devices):
    world = request.param
    params, x, y = _data()
    out = ranks.spawn(SCENARIO, world, tmp_path_factory.mktemp(f"dp{world}"),
                      params=params, x=x, y=y, steps=STEPS)
    return (world, out, _jax_modes(world, cpu_devices, params, x, y),
            _jax_torchfront(world, cpu_devices, params, x, y), params)


def _rank_view(mode, jax_state, rank, world):
    """The JAX package's global state as rank `rank` holds it."""
    def block(a):
        if a.ndim and a.shape[0] % world == 0:
            n = a.shape[0] // world
            return a[rank * n:(rank + 1) * n]
        return a

    if mode.startswith("ddp"):
        return jax_state
    params, opt, count = jax_state
    if mode.startswith("zero2"):
        # moments of a sharded leaf are [world, d0/world, ...] globally
        return (params, jax.tree.map(
            lambda m: m[rank:rank + 1] if m.ndim > 1 and m.shape[0] == world
            and m.ndim > 0 else m, opt), count)
    return (jax.tree.map(block, params), jax.tree.map(block, opt), count)


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax(dp_runs, mode):
    world, out, want, _, _ = dp_runs
    w_losses, w_state = want[mode]
    for rank, r in enumerate(out):
        losses, state = r[mode]
        np.testing.assert_allclose(losses, w_losses, rtol=RTOL_LOSS,
                                   atol=ATOL_LOSS)
        want_state = _rank_view(mode, w_state, rank, world)
        got = jax.tree.leaves(state)
        ref = jax.tree.leaves(want_state)
        assert len(got) == len(ref)
        for g, w in zip(got, ref):
            assert np.shape(g) == np.shape(w), (mode, np.shape(g),
                                                np.shape(w))
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _leaf_sizes(params):
    return [np.asarray(a) for a in jax.tree.leaves(params)]


def test_collectives_from_the_graph(dp_runs):
    """Each rank's step traces with make_fx; its collectives by kind
    equal what the leaves give: ddp one all_reduce per gradient (and the
    loss's); zero2 a reduce_scatter and an all_gather per leaf whose dim
    0 divides the axis, an all_reduce per other leaf; zero3 the same
    reductions, the all_gathers of the forward and those of the backward
    (`parallel.dp._Regather`)."""
    world, out, _, _, params = dp_runs
    leaves = _leaf_sizes(params)
    shard = [a for a in leaves if a.shape[0] % world == 0]
    repl = [a for a in leaves if a.shape[0] % world]
    nbytes = sum(a.nbytes for a in leaves)
    for r in out:
        assert r["graph_ddp"] == {"all_reduce": (len(leaves) + 1,
                                                 nbytes + 4)}
        want = {"reduce_scatter_tensor": (len(shard),
                                          sum(a.nbytes for a in shard)),
                "all_gather_into_tensor": (len(shard), sum(
                    a.nbytes for a in shard) // world),
                "all_reduce": (len(repl) + 1,
                               sum(a.nbytes for a in repl) + 4)}
        assert r["graph_zero2"] == want
        # zero3 gathers each sharded leaf for the forward and again for
        # the backward when the backward reads it: the weights of every
        # layer but the first (whose input needs no gradient)
        again = [np.asarray(layer["w"]) for layer in params[1:]
                 if layer["w"].shape[0] % world == 0]
        want3 = dict(want)
        want3["all_gather_into_tensor"] = (
            len(shard) + len(again),
            (sum(a.nbytes for a in shard) + sum(a.nbytes for a in again))
            // world)
        assert r["graph_zero3"] == want3


def test_comm_counters(dp_runs):
    """The ring byte counters: ddp moves 2 (n-1)/n of every gradient a
    step; zero2 (n-1)/n of the sharded leaves' and 2 (n-1)/n of the
    others'; K=2 doubles both (one reduction a microbatch)."""
    world, out, _, _, params = dp_runs
    leaves = _leaf_sizes(params)
    f = (world - 1) / world
    ddp = 2 * f * sum(a.nbytes for a in leaves) * STEPS
    zero2 = STEPS * sum(a.nbytes * (f if a.shape[0] % world == 0
                                    else 2 * f) for a in leaves)
    for r in out:
        assert math.isclose(r["counters_ddp"]["bytes_on_wire"], ddp)
        assert r["counters_ddp"]["launches"] == len(leaves) * STEPS
        assert math.isclose(r["counters_ddp_k2"]["bytes_on_wire"], 2 * ddp)
        assert math.isclose(r["counters_zero2"]["bytes_on_wire"], zero2)
        assert math.isclose(r["counters_zero2_k2"]["bytes_on_wire"],
                            2 * zero2)


@pytest.mark.parametrize("mode", ["ddp", "zero2", "zero3", "ddp_train",
                                  "zero2_train", "zero3_train"])
def test_torchfront_mode_matches_jax(dp_runs, mode):
    """make_torch_train_step(parallel_mode=...) on the MLP module, eval
    export (ddp SGD, zero2 / zero3 Adam) and train=True (Adam; the module
    has no dropout or batch norm, so both packages compute the one
    global-batch step)."""
    _, out, _, want, _ = dp_runs
    for r in out:
        np.testing.assert_allclose(r["torchfront"][mode], want[mode],
                                   rtol=RTOL_LOSS, atol=ATOL_LOSS)


@pytest.mark.parametrize("knob,value", [("comm_quant_dtype", "int8"),
                                        ("comm_bucket_bytes", 1 << 20),
                                        ("comm_overlap", True)])
def test_comm_knobs_raise(monkeypatch, knob, value):
    from easydist_tpu_torch import config as tconfig
    from easydist_tpu_torch.parallel import ddp_step as port_ddp

    monkeypatch.setattr(tconfig, knob, value)
    with pytest.raises(NotImplementedError, match="item 7"):
        port_ddp(lambda p, x: x.sum(), mesh=None)


@pytest.mark.parametrize("make", ["ddp_step", "zero2_step", "zero3_step"])
def test_step_guard_raises(make):
    from easydist_tpu_torch import parallel

    with pytest.raises(NotImplementedError, match="item 7"):
        getattr(parallel, make)(lambda p, x: x.sum(), mesh=None,
                                step_guard=True)
