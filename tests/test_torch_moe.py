"""The port's expert-parallel MoE (`parallel/moe.py`) against the JAX
package's (tests/test_parallel/test_moe.py), on gloo ranks of world 4.

The same numpy-seeded router and experts go through the JAX package's
`moe_layer` on its (4,) "ep" CPU mesh and the port's, one process a rank:
each rank's output block and the aux loss against the JAX output and
against both packages' `moe_reference` at rtol 1e-4 / atol 1e-5 (the JAX
test's bar), top-1 (Switch) and top-2 (GShard); the gradients of the
global loss mean(y^2) + 0.01 aux flow to the router and the experts and
equal the JAX package's at rtol 1e-4 / atol 1e-6; the layer's two
all_to_alls move the capacity formula's bytes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from easydist_tpu.parallel.moe import MoEConfig, moe_init, moe_layer, \
    moe_reference
from tests import test_torch_fxfront_ranks as ranks

WORLD, TOKENS = 4, 64
CFGS = {"top1": dict(n_experts=8, d_model=16, d_ff=32, capacity_factor=2.0),
        "top2": dict(n_experts=8, d_model=16, d_ff=32, capacity_factor=2.0,
                     top_k=2)}
SCENARIO = "tests.test_torch_parallel_ranks:moe_modes"


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory, cpu_devices):
    mesh = Mesh(np.array(cpu_devices[:WORLD]), ("ep",))
    x = np.random.RandomState(1).randn(TOKENS, 16).astype(np.float32)
    params, want = {}, {}
    for i, (name, kw) in enumerate(CFGS.items()):
        cfg = MoEConfig(**kw)
        p = moe_init(cfg, jax.random.PRNGKey(i))
        params[name] = jax.tree.map(np.asarray, p)

        def layer(p_, cfg=cfg):
            return moe_layer(p_, jnp.asarray(x), mesh, cfg)

        def loss(p_):
            y_, aux_ = layer(p_)
            return jnp.mean(y_ ** 2) + 0.01 * aux_

        # jitted: one compile of each program (op by op, the shard_map's
        # primitives compiled one at a time took ~60 s of the file)
        y, aux = jax.jit(layer)(p)
        y_ref, aux_ref = moe_reference(p, jnp.asarray(x), cfg,
                                       n_devices=WORLD)
        want[name] = dict(y=np.asarray(y), aux=float(aux),
                          y_ref=np.asarray(y_ref), aux_ref=float(aux_ref),
                          grads=jax.tree.map(np.asarray,
                                             jax.jit(jax.grad(loss))(p)))
    port = ranks.spawn(SCENARIO, WORLD, tmp_path_factory.mktemp("moe"),
                       params=params, x=x, cfgs=CFGS)
    return port, want


def _block(a, rank):
    n = a.shape[0] // WORLD
    return a[rank * n:(rank + 1) * n]


@pytest.mark.parametrize("name", list(CFGS))
def test_output_matches_jax_and_reference(moe_runs, name):
    port, want = moe_runs
    w = want[name]
    for rank, r in enumerate(port):
        got = r[name]
        for ref in (w["y"], w["y_ref"]):
            np.testing.assert_allclose(got["y"], _block(ref, rank),
                                       rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["y_ref"], w["y_ref"], rtol=1e-4,
                                   atol=1e-5)
        for aux in (w["aux"], w["aux_ref"], got["aux_ref"]):
            np.testing.assert_allclose(got["aux"], aux, rtol=1e-4)


@pytest.mark.parametrize("name", list(CFGS))
def test_gradients_flow_and_match_jax(moe_runs, name):
    port, want = moe_runs
    wg = want[name]["grads"]
    for rank, r in enumerate(port):
        g = r[name]["grads"]
        for leaf in g.values():
            assert np.isfinite(leaf).all()
        assert np.abs(g["w_in"]).sum() > 0
        np.testing.assert_allclose(g["router"], wg["router"], rtol=1e-4,
                                   atol=1e-6)
        for k in ("w_in", "w_out"):  # the rank's experts get its grads
            np.testing.assert_allclose(_block(g[k], rank),
                                       _block(wg[k], rank), rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("name", list(CFGS))
def test_all_to_all_bytes(moe_runs, name):
    """Two all_to_alls of the [experts, capacity, d_model] f32 buffers,
    capacity = ceil(tokens/ep * top_k * capacity_factor / experts)."""
    port, _ = moe_runs
    kw = CFGS[name]
    cap = math.ceil(TOKENS // WORLD * kw.get("top_k", 1)
                    * kw["capacity_factor"] / kw["n_experts"])
    nbytes = kw["n_experts"] * cap * kw["d_model"] * 4
    for r in port:
        assert r[name]["graph"]["all_to_all_single"] == (2, 2 * nbytes)
