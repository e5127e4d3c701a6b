"""`fix_sharding` and `scoped_region` (the port's `fxfront/scope.py`,
`_apply_user_pins` and the solver arguments of `easydist_compile`),
mirroring the JAX package's tests/test_jaxfront/test_e2e.py:161-175
(a pinned column-sharded weight survives the auto-parallel pipeline) and
:258-295 (a region solved on its own mesh view composes inside a step
compiled on another view).

On gloo CPU ranks: world 2 on a (2,) "d" mesh, world 4 on a (2, 2)
"dp" x "tp" mesh with a (4,) region inside.  The solver prices with the
JAX package's cost constants.  Tolerances: the JAX tests' (rtol 1e-5 /
atol 1e-6 for the pinned forward, rtol 1e-5 for the region's sum).
"""

import numpy as np
import pytest
import torch

from easydist_tpu_torch import config as tconfig
from easydist_tpu_torch.fxfront import easydist_compile, fix_sharding
from easydist_tpu_torch.fxfront import scope
from tests import test_torch_fxfront_ranks as ranks
from tests.test_torch_fxfront_e2e import _jax_constants


@pytest.fixture(scope="module")
def pins_by_world(tmp_path_factory):
    return {world: ranks.spawn("pins", world,
                               tmp_path_factory.mktemp(f"pins{world}"),
                               constants=_jax_constants())
            for world in (2, 4)}


@pytest.fixture(params=[2, 4])
def pins(request, pins_by_world):
    return request.param, pins_by_world[request.param]


def test_fix_sharding_scope(pins):
    """User-pinned shardings survive the pipeline: the forward is right,
    and the pin's strategy is the pinned one on every axis."""
    world, out = pins
    for r in out:
        for shape, row in r.items():
            if shape == "scoped":
                continue
            assert row["err"] <= 1e-5 + 1e-6 and row["plain"] == 0.0
            if shape == (world,):
                assert row["pin"] == [["S(1)"]], row["pin"]
            else:
                assert row["pin"] == [["R"], ["S(1)"]], row["pin"]


def test_pin_shows_in_the_emitted_collectives(pins):
    """The pinned column layout carries through the matmul, and the only
    collective gathers the result along the pinned axis; emitted equals
    priced."""
    world, out = pins
    for r in out:
        for shape, row in r.items():
            if shape == "scoped":
                continue
            axis = "d" if shape == (world,) else "tp"
            assert row["mm"][-1] == ["S(1)"], row["mm"]
            assert row["collectives"] == [(axis, "all_gather", "tanh")]
            for emitted, priced in row["table"].values():
                assert emitted == priced


def test_scoped_region_multi_mesh(pins_by_world):
    """A (4,) region inside a step compiled on (2, 2): one node in the
    outer program, the step's value as the plain function's."""
    for r in pins_by_world[4]:
        s = r["scoped"]
        assert s["nodes"] == ["easydist_tpu_torch.scoped_call.default"]
        np.testing.assert_allclose(s["got"], s["want"], rtol=1e-5)
        np.testing.assert_allclose(s["want"], s["ref"], rtol=1e-5)


def test_fix_sharding_without_a_mesh_returns_its_input():
    x = torch.ones(4, 4)
    assert fix_sharding(x, None, "d") is x


def test_fix_sharding_spec_round_trip():
    spec = scope.encode_spec([None, "tp", ("dp", "tp")])
    assert scope.decode_spec(spec) == [(), ("tp",), ("dp", "tp")]
    assert scope.decode_spec(scope.encode_spec([])) == []


def test_fix_sharding_stays_one_node_and_passes_gradients():
    """Under `make_fx` the pin is one node; its gradient is the identity."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from easydist_tpu_torch.models.optim import value_and_grad

    w = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    op = torch.ops.easydist_tpu_torch.fix_sharding

    def step(w):
        return value_and_grad(lambda w_: (op(w_, ";d") ** 2).sum(), w)

    with torch.no_grad():
        gm = make_fx(step, tracing_mode="fake")(w)
    nodes = [n for n in gm.graph.nodes
             if n.op == "call_function" and n.target is op.default]
    assert len(nodes) == 1 and scope.pinned_axes(nodes[0]) == [(), ("d",)]
    loss, grad = step(w)
    torch.testing.assert_close(grad, 2 * w)


def test_solver_arguments_set_the_knobs(monkeypatch):
    """max_solver_time / liveness_only_input set the solver's knobs as
    the JAX package's easydist_compile does (jaxfront/api.py:1262-1265)."""
    monkeypatch.setattr(tconfig, "solver_time_limit", 60.0)
    monkeypatch.setattr(tconfig, "liveness_only_input", False)
    easydist_compile(lambda x: x, max_solver_time=7.5,
                     liveness_only_input=True)
    assert tconfig.solver_time_limit == 7.5
    assert tconfig.liveness_only_input is True


@pytest.mark.parametrize("arg", ["pp_stages", "n_microbatches", "schedule",
                                 "tp_axes"])
def test_pipeline_arguments_raise(arg):
    """The JAX package's rules for the same call: pp_stages without a mesh
    and a pipeline argument without pp_stages (tp_axes among them) are
    ValueErrors."""
    from easydist_tpu_torch.fxfront import set_device_mesh

    set_device_mesh(None)
    match = "explicit mesh" if arg == "pp_stages" else "only apply with"
    with pytest.raises(ValueError, match=match):
        easydist_compile(lambda x: x, **{arg: 2})


def test_unknown_argument_raises():
    with pytest.raises(TypeError, match="unexpected"):
        easydist_compile(lambda x: x, pipeline_depth=2)
