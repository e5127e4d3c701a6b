"""`easydist_compile(pp_stages=...)` of the port (`fxfront/pp_compile.py`
over `parallel/auto_pipeline.py`) against the JAX package's
(tests/test_jaxfront/test_pp_compile.py, tests/test_parallel/
test_auto_pipeline.py), on gloo ranks: (2,) "pp" (world 2) and (2, 2)
"pp" x "dp" (world 4).

The same numpy-seeded 4-layer tanh MLP loss and three batches go through
both packages' hybrid train step: 3-step losses at rtol 1e-5 / atol 1e-6
and the exported parameters at rtol 1e-4 / atol 1e-6 (the JAX tests'
bars), per schedule (gpipe, remat, 1f1b with Adam; gpipe with SGD); a
split_point marker is honoured by both; `make_torch_pp_train_step`
matches the JAX package's.  A residual that skips every stage boundary
of a 4-stage split trains to the unsplit loss and gradients.
`_balanced_splits` equals the JAX one on the same FLOP lists, and every
loud error of the JAX entry holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from easydist_tpu.jaxfront.api import easydist_compile as j_compile
from easydist_tpu.parallel.auto_pipeline import \
    _balanced_splits as j_balanced
from easydist_tpu_torch.fxfront import easydist_compile
from easydist_tpu_torch.parallel.auto_pipeline import _balanced_splits
from tests import test_torch_fxfront_ranks as ranks

D, N_LAYERS, STEPS = 16, 4, 3
RTOL_F, ATOL_F = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 1e-6
RUNS = ("gpipe_adam", "remat_adam", "1f1b_adam", "gpipe_sgd")
SCENARIO = "tests.test_torch_parallel_ranks:pp_compile_modes"


def _data():
    rs = np.random.RandomState(0)
    params = {f"w{i}": (0.3 * rs.randn(D, D)).astype(np.float32)
              for i in range(N_LAYERS)}
    batches = [(rs.randn(16, D).astype(np.float32),
                rs.randn(16, D).astype(np.float32)) for _ in range(STEPS)]
    return params, batches


def _loss(params, x, y, mark=False):
    from easydist_tpu.parallel import split_point

    h = x
    for i in range(N_LAYERS):
        h = jnp.tanh(h @ params[f"w{i}"])
        if mark and i == 0:
            h = split_point(h)
    return jnp.mean((h - y) ** 2)


def _jax_runs(world, cpu_devices, params, batches):
    shape, names = ((2,), ("pp",)) if world == 2 else ((2, 2), ("pp", "dp"))
    mesh = Mesh(np.array(cpu_devices[:world]).reshape(shape), names)
    p0 = jax.tree.map(jnp.asarray, params)
    bs = [tuple(map(jnp.asarray, b)) for b in batches]
    res = {}
    for run in RUNS + ("marked",):
        sched, opt = ("1f1b", "adam") if run == "marked" else run.split("_")
        loss_fn = (lambda p, x, y: _loss(p, x, y, mark=True)) \
            if run == "marked" else _loss
        compiled = j_compile(loss_fn, mesh=mesh, pp_stages=2,
                             n_microbatches=4, schedule=sched, lr=1e-2,
                             optimizer=opt)
        state = compiled.init_state(p0, *bs[0])
        losses = []
        for b in bs:
            state, loss = compiled(state, *b)
            losses.append(float(loss))
        res[run] = (losses, jax.tree.map(np.asarray,
                                         compiled.export_state_dict(state)))
    if world == 2:
        res["torchfront"] = _jax_torchfront(mesh, params, batches)
    return res


def _jax_torchfront(mesh, params, batches):
    from easydist_tpu.torchfront import make_torch_pp_train_step

    layers = []
    for i in range(N_LAYERS):
        lin = torch.nn.Linear(D, D, bias=False)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(params[f"w{i}"]).T)
        layers += [lin, torch.nn.Tanh()]
    compiled, p0 = make_torch_pp_train_step(
        torch.nn.Sequential(*layers), (torch.from_numpy(batches[0][0]),),
        lambda o, t: jnp.mean((o - t) ** 2), mesh, pp_stages=2,
        n_microbatches=4, lr=1e-2)
    bs = [tuple(map(jnp.asarray, b)) for b in batches]
    state = compiled.init_state(p0, *bs[0])
    losses = []
    for b in bs:
        state, loss = compiled(state, *b)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module", params=(2, 4))
def pp_runs(request, tmp_path_factory, cpu_devices):
    world = request.param
    params, batches = _data()
    port = ranks.spawn(SCENARIO, world, tmp_path_factory.mktemp(f"pp{world}"),
                       params=params, batches=batches)
    return world, port, _jax_runs(world, cpu_devices, params, batches)


@pytest.mark.parametrize("run", RUNS)
def test_train_matches_jax(pp_runs, run):
    _, port, want = pp_runs
    w_losses, w_params = want[run]
    for r in port:
        losses, params, _ = r[run]
        np.testing.assert_allclose(losses, w_losses, rtol=RTOL_F,
                                   atol=ATOL_F)
        for k in w_params:
            np.testing.assert_allclose(params[k], w_params[k], rtol=RTOL,
                                       atol=ATOL)


def test_packed_rows_and_traffic(pp_runs):
    """The packed row is the larger stage's leaves (16 x 16 f32 each,
    padded to the siblings), each rank's params are its block of it, and
    its stage sends one boundary activation a microbatch one way and its
    gradient the other."""
    world, port, _ = pp_runs
    n_sib = world // 2
    for r in port:
        elems = max(len(lay) for lay in r["layouts"]) * D * D
        assert sorted(i for lay in r["layouts"] for i in lay) == \
            list(range(N_LAYERS))
        assert r["row_elems"] == -(-elems // n_sib) * n_sib
        assert r["state_bytes"] == r["row_elems"] * 4 // n_sib
        stats = r["gpipe_adam"][2]
        mb = 16 // 4 // n_sib
        assert stats["sends"] == stats["recvs"] == 4
        assert stats["send_bytes"] == 4 * mb * D * 4
        ends, flops = r["split"]
        assert len(ends) == 2 and len(flops) == 2


def test_split_point_honoured(pp_runs):
    _, port, want = pp_runs
    w_losses, _ = want["marked"]
    for r in port:
        losses, ends, n_first = r["marked"]
        np.testing.assert_allclose(losses, w_losses, rtol=RTOL_F,
                                   atol=ATOL_F)
        # stage 0 holds the first mm, its tanh and the marker only
        assert n_first == 3, (ends, n_first)


def test_batch_errors(pp_runs):
    _, port, _ = pp_runs
    for r in port:
        assert "differs from the one this step was built with" in \
            r["changed_batch"]
        assert "not divisible by n_microbatches*batch-siblings" in \
            r["indivisible"]


def test_world_specific_paths(pp_runs):
    """World 4: 4 stages on (4,) "pp", the first layer's output crossing
    all three boundaries (forwarded by the middle stages): the loss and
    every stage's packed-row gradient equal the unsplit ones.  World 2:
    `make_torch_pp_train_step` on an nn.Sequential of the same layers
    matches the JAX package's 3-step losses, and a forward pipeline whose
    boundary carries bool, int64 and f32 values equals the direct call."""
    world, port, want = pp_runs
    if world == 2:
        for r in port:
            np.testing.assert_allclose(r["torchfront"], want["torchfront"],
                                       rtol=RTOL_F, atol=ATOL_F)
            # a bool mask and an int64 count cross the boundary in their
            # own dtypes (the JAX package's f32 transport refuses them)
            got, direct, dtypes = r["typed"]
            assert dtypes == ["torch.bool", "torch.float32", "torch.int64"]
            np.testing.assert_allclose(got, direct, rtol=RTOL_F, atol=ATOL_F)
        return
    params, batches = _data()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    x, y = (torch.from_numpy(a) for a in batches[0])
    from tests.test_torch_parallel_ranks import pp_skip_loss

    loss = torch.stack([pp_skip_loss(tp, x[4 * m:4 * m + 4],
                                     y[4 * m:4 * m + 4])
                        for m in range(4)]).mean()
    grads = torch.autograd.grad(loss, list(tp.values()))
    by_leaf = dict(zip(range(N_LAYERS), grads))
    for r in port:
        got_loss, d_row, widths, layouts, rank = r["skip"]
        assert all(w >= 2 for w in widths), widths
        np.testing.assert_allclose(got_loss, float(loss.detach()),
                                   rtol=RTOL_F, atol=ATOL_F)
        want_row = np.zeros(d_row.shape[-1], np.float32)
        flat = [by_leaf[i].numpy().reshape(-1) for i in layouts[rank]]
        if flat:
            flat = np.concatenate(flat)
            want_row[:flat.size] = flat
        np.testing.assert_allclose(d_row[0], want_row, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flops,n", [
    ([1.0] * 10, 2), ([1.0] * 10, 4), ([5, 1, 1, 1, 1, 1, 5], 3),
    ([100.0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1000], 4),
    ([2.0, 3, 5, 7, 11, 13, 17, 19], 8), ([1e9, 1, 1e9, 1, 1e9], 2)])
def test_balanced_splits_equal_jax(flops, n):
    assert _balanced_splits(flops, n) == j_balanced(flops, n)


def test_too_many_stages_raises():
    with pytest.raises(ValueError, match="n_stages"):
        _balanced_splits([1.0, 2.0], 3)


def _loss_t(params, x):
    return (x @ params["w"]).mean()


@pytest.mark.parametrize("kw", [dict(state_io={}), dict(donate_state=True),
                                dict(compile_only=True)])
def test_non_pp_arguments_refused(kw):
    with pytest.raises(ValueError, match="does not support"):
        easydist_compile(_loss_t, pp_stages=2, mesh=object(), **kw)


def test_needs_a_mesh():
    with pytest.raises(ValueError, match="explicit mesh"):
        easydist_compile(_loss_t, pp_stages=2)


@pytest.mark.parametrize("kw", [dict(schedule="zigzag"),
                                dict(optimizer="lion"),
                                dict(optimizer=(lambda p: p, lambda *a: a),
                                     lr=1e-3)])
def test_bad_schedule_or_optimizer(kw):
    from easydist_tpu_torch.fxfront.pp_compile import PPCompiledFunction

    exc = NotImplementedError if "schedule" in kw else ValueError
    with pytest.raises(exc):
        PPCompiledFunction(_loss_t, object(), 2, 4, **kw)


class _PPMesh:
    mesh_dim_names = ("pp", "tp")


def test_tp_axes_names_6c():
    """tp_axes (ROADMAP queue A item 6c) follows the JAX package's rules
    for the same call: more than one tp axis is NotImplementedError, a pp
    or unknown axis a ValueError, one non-pp axis is taken."""
    with pytest.raises(NotImplementedError, match="one tp axis"):
        easydist_compile(_loss_t, pp_stages=2, mesh=_PPMesh(),
                         tp_axes=("tp", "pp"))
    for bad in (("pp",), ("dp",)):
        with pytest.raises(ValueError, match="non-pp mesh axis"):
            easydist_compile(_loss_t, pp_stages=2, mesh=_PPMesh(),
                             tp_axes=bad)
    assert easydist_compile(_loss_t, pp_stages=2, mesh=_PPMesh(),
                            tp_axes=("tp",)).tp_axes == ("tp",)
