"""The JAX package's partial-region and inline modules
(`jaxfront/partial_regions.py`, `jaxfront/inline.py`) closed with
evidence: the port needs neither.  Its emitter runs a P-placed chain
locally and fences it with the collective the solver chose
(`fxfront/emit.py`), and `make_fx` traces nested calls into one flat
aten graph.  The JAX package's gates hold the port
(tests/test_jaxfront/test_quality_gate.py::test_partial_deferral_reduces_
collective_bytes, test_partial_deferral_on_hybrid_dp_tp_mesh,
test_partial_region_psum_scatter_fence):

  * the partial pools strictly lower the emitted collective bytes of
    the pinned chain against the no-partial plan, and the port's bytes
    are no more than the JAX package's region on the same chain and
    mesh (per-device result bytes, as `collective_summary` counts
    them; fake group of 8 against the JAX package's 8 CPU devices; the
    gather that hands a sharded output back replicated is the port's
    return convention and is left out);
  * a fence whose consumer wants row shards pays a reduce_scatter, and
    no all_reduce moves the matrix;
  * on gloo (world 4) the numbers equal eager torch at the JAX bars;
  * `log_softmax`, `gelu` and `take_along_dim` trace to aten nodes that
    every one has a rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu_torch import config as edconfig
from tests import test_torch_fxfront_ranks as ranks
from tests import test_torch_parallel_ranks as pr

JAX_CONSTANTS = dict(peak_flops=4.9e13, hbm_bandwidth=8.1e11,
                     nvlink_bandwidth=2e11, nvlink_latency=1e-6)


def _inputs():
    rs = np.random.RandomState(0)
    k, k2 = 512, 64
    deferral = (np.ones((256, k), np.float32),
                (rs.randn(k, k) / k ** 0.5).astype(np.float32),
                (rs.randn(k, k2) / k ** 0.5).astype(np.float32))
    hybrid = ((rs.randn(16, k) / k ** 0.5).astype(np.float32),
              (rs.randn(k, k) / k ** 0.5).astype(np.float32),
              (rs.randn(k, k) / k ** 0.5).astype(np.float32))
    scatter = (rs.randn(16, 64).astype(np.float32),
               rs.randn(64, 32).astype(np.float32))
    return {"deferral": deferral, "hybrid": hybrid, "scatter": scatter}


def _result_bytes(kind, group_bytes, n):
    """Per-device result bytes of one emitted collective (the JAX
    package's `collective_summary` counts those)."""
    return group_bytes / n if kind in ("reduce_scatter", "all_to_all") \
        else group_bytes


def _port_bytes(chain, shape, inputs, pools, monkeypatch):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from easydist_tpu_torch.fxfront import (easydist_compile,
                                            make_device_mesh,
                                            set_device_mesh)

    fn, names = pr.CHAINS[chain]
    monkeypatch.setattr(edconfig, "enable_partial_pools", pools)
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    try:
        mesh = make_device_mesh(shape, names, device_type="cpu")
        res = easydist_compile(fn, mesh=mesh, state_io={},
                               compile_only=True)(
            *[torch.from_numpy(a) for a in inputs])
    finally:
        set_device_mesh(None)
        dist.destroy_process_group()
    sizes = dict(zip(names, shape))
    # the port hands a non-state output back replicated (an all_gather of
    # a sharded output), where the JAX program leaves it sharded: those
    # gathers are the return convention, not the chain's
    outs = {n.name for n in res.traced.graph.output_node().all_input_nodes}
    chain_colls = [c for c in res.collectives
                   if not (c.kind == "all_gather" and c.var in outs)]
    return sum(_result_bytes(c.kind, c.group_bytes, sizes[c.axis])
               for c in chain_colls), res.collectives


def _jax_bytes(chain, shape, inputs, cpu_devices):
    from easydist_tpu.jaxfront import easydist_compile, make_device_mesh
    from easydist_tpu.jaxfront.scope import fix_sharding
    from easydist_tpu.utils.hlo import collective_summary

    def deferral(x, w1, w2):
        x = fix_sharding(x, None, "tp")
        w1 = fix_sharding(w1, "tp", None)
        return jnp.sum(-(x @ w1) @ w2)

    def hybrid(x, w1, w2):
        x = fix_sharding(x, "dp", "tp")
        w1 = fix_sharding(w1, "tp", None)
        return jnp.sum(-(x @ w1) @ w2, axis=1)

    fn = {"deferral": deferral, "hybrid": hybrid}[chain]
    names = ("tp",) if chain == "deferral" else ("dp", "tp")
    mesh = make_device_mesh(shape, names, devices=cpu_devices)
    r = easydist_compile(fn, mesh=mesh, state_io={}).get_compiled(
        *[jnp.asarray(a) for a in inputs])
    return sum(b for _, b in collective_summary(
        r.executable().as_text()).values())


@pytest.fixture(autouse=True)
def _constants(monkeypatch, tmp_path):
    for name, value in JAX_CONSTANTS.items():
        monkeypatch.setattr(edconfig, name, value)
    monkeypatch.setattr(edconfig, "discovery_device", "cpu")
    monkeypatch.setattr(edconfig, "discovery_cache_dir",
                        str(tmp_path / "disc"))


@pytest.mark.parametrize("chain,shape", [("deferral", (8,)),
                                         ("hybrid", (4, 2))])
def test_partial_deferral_reduces_collective_bytes(chain, shape,
                                                   cpu_devices,
                                                   monkeypatch):
    """The counterparts of test_partial_deferral_reduces_collective_bytes
    ((8,) "tp") and test_partial_deferral_on_hybrid_dp_tp_mesh ((4, 2)
    "dp" x "tp"): strictly fewer bytes with the partial pools, and no
    more than the JAX package's deferred region."""
    inputs = _inputs()[chain]
    base, _ = _port_bytes(chain, shape, inputs, False, monkeypatch)
    part, _ = _port_bytes(chain, shape, inputs, True, monkeypatch)
    assert part < base, (part, base)
    assert part <= _jax_bytes(chain, shape, inputs, cpu_devices)


def test_partial_region_psum_scatter_fence(monkeypatch):
    """A partial chain whose consumer wants S(0) is fenced by one
    reduce_scatter of the matrix; the only all_reduce is the scalar
    sum's."""
    _, colls = _port_bytes("scatter", (8,), _inputs()["scatter"], True,
                           monkeypatch)
    kinds = [c.kind for c in colls]
    assert kinds.count("reduce_scatter") == 1, colls
    rs = next(c for c in colls if c.kind == "reduce_scatter")
    assert rs.group_bytes == 16 * 32 * 4
    assert all(c.group_bytes <= 4 for c in colls if c.kind == "all_reduce")


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    inputs = _inputs()
    cases = {"deferral": ("deferral", (4,), inputs["deferral"]),
             "hybrid": ("hybrid", (2, 2), inputs["hybrid"]),
             "scatter": ("scatter", (4,), inputs["scatter"])}
    return cases, ranks.spawn(
        "tests.test_torch_parallel_ranks:partial_chains", 4,
        tmp_path_factory.mktemp("partial"), cases=cases,
        constants=JAX_CONSTANTS)


@pytest.mark.parametrize("key,rtol,atol", [("deferral", 1e-5, 1e-6),
                                           ("hybrid", 1e-4, 1e-5),
                                           ("scatter", 1e-4, 1e-5)])
def test_partial_chains_numerics_on_gloo(gloo_runs, key, rtol, atol):
    """Pools on and off, every rank, against eager torch (the JAX tests'
    bars)."""
    cases, res = gloo_runs
    chain, _, inputs = cases[key]
    want = pr.CHAINS[chain][0](*[torch.from_numpy(a) for a in inputs])
    for r in res:
        for pools in (False, True):
            np.testing.assert_allclose(r[key][pools]["out"], want.numpy(),
                                       rtol=rtol, atol=atol)
        assert sum(b for _, b in r[key][True]["collectives"]) < \
            sum(b for _, b in r[key][False]["collectives"]) or key == \
            "scatter"


def test_inline_needs_no_port():
    """`make_fx` flattens nested calls (the job of jaxfront/inline.py):
    log_softmax, gelu and take_along_dim trace to aten nodes only, and
    every one gets a rule (none falls back to replicate)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from easydist_tpu_torch.fxfront.interpreter import (ShardingAnalyzer,
                                                        node_signature)

    def nested(x, t):
        def inner(y):
            return torch.nn.functional.gelu(y, approximate="tanh")

        lp = torch.nn.functional.log_softmax(inner(x), dim=-1)
        return torch.take_along_dim(lp, t, dim=-1).sum()

    gm = make_fx(nested, tracing_mode="fake")(
        torch.randn(8, 16), torch.zeros(8, 1, dtype=torch.long))
    calls = [n for n in gm.graph.nodes if n.op == "call_function"]
    assert calls and all(isinstance(n.target, torch._ops.OpOverload)
                         and n.target.namespace == "aten" for n in calls)
    analyzer = ShardingAnalyzer(gm, world_size=2)
    rules, _ = analyzer.run()
    assert not analyzer.replicated_on_failure
    for n in calls:
        assert rules[node_signature(n)]["space"] is not None, n.target
