"""The port's overlapped gradient collectives (`comm/overlap.py`) and its
calibration (`runtime/calibrate.py`, `runtime/profiler.py`), against the
JAX package's (tests/test_comm/test_overlap.py).

  * `grad_emission_order`: backward first, the same layer order as the
    JAX permutation on the same MLP; `schedulable_overlap_fraction` in
    (0, 1), deterministic, 0 when the trace fails;
  * quantization off, on gloo world 2: the overlapped flush (per leaf and
    bucketed), the overlapped K=4 accumulation and the overlapped zero2 /
    zero3 steps bitwise equal to the sequential ones; at world 4 bitwise
    where both plans pack the same (per leaf, the ZeRO paths), within
    1e-6 where the bucket order differs;
  * in the traced overlapped ddp step (8 KiB buckets) the first bucket's
    all_reduce comes before the backward's last matmul;
  * int8 with overlap: 3 losses within 1e-2 of the exact sequential run;
  * calibration: the datasheet rows, the env override, unknown kinds;
    `calibrate` / `calibrate_overlap` on gloo world 2 persist and
    `apply_calibration` reads them back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_fxfront_ranks as ranks
from tests.test_torch_comm_quant import SCEN, _mlp


def _jax_loss(params, x, y):
    from easydist_tpu.models.mlp import mlp_apply

    return jnp.mean((mlp_apply(params, x) - y) ** 2)


def _port_loss(params, x, y):
    from easydist_tpu_torch.models.mlp import mlp_apply

    return torch.mean((mlp_apply(params, x) - y) ** 2)


def _data(layers=3):
    return _mlp(10, sizes=(32,) + (64,) * (layers - 1) + (32,))


# ------------------------------------------------------------- ordering

def test_emission_order_backward_first_like_jax():
    from easydist_tpu.comm import grad_emission_order as jorder
    from easydist_tpu_torch.comm import grad_emission_order, keyed_leaves
    from tests.test_torch_parallel_ranks import from_numpy

    params, x, y = _data()
    jp = jax.tree.map(jnp.asarray, params)
    jkps, _ = jax.tree_util.tree_flatten_with_path(jp)
    jpaths = [jax.tree_util.keystr(kp) for kp, _ in jkps]
    want = [jpaths[i] for i in jorder(_jax_loss, jp, jnp.asarray(x),
                                      jnp.asarray(y))]
    tp = from_numpy(params)
    _, paths, _, _ = keyed_leaves(tp)
    order = grad_emission_order(_port_loss, tp, torch.from_numpy(x),
                                torch.from_numpy(y))
    got = [paths[i] for i in order]
    assert sorted(order) == list(range(len(paths)))
    assert order != list(range(len(paths)))  # backward first

    def layers(ps):
        return [int(p[1]) for p in ps]

    assert layers(got) == layers(want) == sorted(layers(want), reverse=True)


def test_schedulable_overlap_fraction():
    from easydist_tpu_torch.comm import (grad_emission_order,
                                         schedulable_overlap_fraction)
    from tests.test_torch_parallel_ranks import from_numpy

    params, x, y = _data()
    tp, tx, ty = from_numpy(params), torch.from_numpy(x), torch.from_numpy(y)
    frac = schedulable_overlap_fraction(_port_loss, tp, tx, ty)
    assert 0.0 < frac < 1.0, frac
    assert frac == schedulable_overlap_fraction(_port_loss, tp, tx, ty)

    def untraceable(p, x, y):
        raise RuntimeError("not traceable")

    assert schedulable_overlap_fraction(untraceable, tp, tx, ty) == 0.0
    assert grad_emission_order(untraceable, tp, tx, ty) == list(range(6))


# ------------------------------------------------- flushes on gloo ranks

@pytest.fixture(scope="module", params=(2, 4))
def overlap_runs(request, tmp_path_factory):
    world = request.param
    params, x, y = _data()
    int8 = {"ddp": _mlp(10), "zero2": _mlp(20), "zero3": _mlp(30)}
    return world, ranks.spawn(SCEN + "overlap_cases", world,
                              tmp_path_factory.mktemp(f"ovl{world}"),
                              params=params, x=x, y=y, int8_data=int8)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# (case, bitwise at world 4: both plans pack every element the same)
CASES = [("ddp_0", True), ("ddp_262144", False), ("ddp_accum4", False),
         ("zero2_accum0", True), ("zero2_accum4", True),
         ("zero3_accum0", True), ("zero3_accum4", True)]


@pytest.mark.parametrize("case,same_packing", CASES,
                         ids=[c for c, _ in CASES])
def test_overlapped_matches_sequential(overlap_runs, case, same_packing):
    world, out = overlap_runs
    for r in out:
        (l_seq, s_seq), (l_ovl, s_ovl) = r[case]
        if world == 2 or same_packing:
            assert l_seq == l_ovl, (l_seq, l_ovl)
            for a, b in zip(_leaves(s_seq), _leaves(s_ovl)):
                assert a.tobytes() == b.tobytes()
        else:
            np.testing.assert_allclose(l_seq, l_ovl, rtol=1e-6, atol=1e-7)
            for a, b in zip(_leaves(s_seq), _leaves(s_ovl)):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_traced_collective_before_last_backward_node(overlap_runs):
    _, out = overlap_runs
    for r in out:
        first, last_mm = r["traced"]
        assert first < last_mm, (first, last_mm)


@pytest.mark.parametrize("mode", ["ddp", "zero2", "zero3"])
def test_int8_overlapped_loss_parity(overlap_runs, mode):
    _, out = overlap_runs
    for r in out:
        q, exact = r[f"int8_{mode}"]
        np.testing.assert_allclose(q, exact, atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------- calibration

def test_detect_device_constants_datasheet():
    from easydist_tpu_torch.runtime.calibrate import detect_device_constants

    h100 = detect_device_constants("NVIDIA H100 80GB HBM3")
    assert h100 == {"peak_flops": 989e12, "hbm_bandwidth": 3.35e12}
    # first match wins: the PCIe and NVL cards are not the SXM row
    assert detect_device_constants("NVIDIA H100 PCIe")["peak_flops"] == \
        756e12
    assert detect_device_constants("NVIDIA H100 NVL")["hbm_bandwidth"] == \
        3.9e12
    assert detect_device_constants("NVIDIA A100-SXM4-80GB")[
        "hbm_bandwidth"] == 2.039e12
    assert detect_device_constants("cpu") is None
    assert detect_device_constants("Quantum GPU 9000") is None


def test_apply_device_constants_env_override(monkeypatch):
    import importlib

    from easydist_tpu_torch import config as tconfig

    cal = importlib.import_module("easydist_tpu_torch.runtime.calibrate")
    monkeypatch.setattr(cal, "_device_applied", None)
    monkeypatch.setattr(
        cal, "detect_device_constants",
        lambda device_kind=None: {"peak_flops": 275e12,
                                  "hbm_bandwidth": 1.2e12})
    monkeypatch.setattr(tconfig, "peak_flops", 4.9e13)
    monkeypatch.setattr(tconfig, "hbm_bandwidth", 1.0e11)
    monkeypatch.setenv("EASYDIST_PEAK_FLOPS", "7e13")
    assert cal.apply_device_constants(force=True) is True
    assert tconfig.peak_flops == 4.9e13  # the env override wins
    assert tconfig.hbm_bandwidth == 1.2e12


def test_apply_device_constants_noop_on_unknown_kind(monkeypatch):
    import importlib

    from easydist_tpu_torch import config as tconfig

    cal = importlib.import_module("easydist_tpu_torch.runtime.calibrate")
    monkeypatch.setattr(cal, "_device_applied", None)
    monkeypatch.setattr(cal, "detect_device_constants",
                        lambda device_kind=None: None)
    before = tconfig.peak_flops
    assert cal.apply_device_constants(force=True) is False
    assert tconfig.peak_flops == before


def test_calibrate_on_gloo(tmp_path):
    out = ranks.spawn(SCEN + "calibrate_cases", 2, tmp_path)
    for r in out:
        cal = r["calibrate"]
        assert cal["hbm_bandwidth"] > 0 and cal["nvlink_latency"] > 0
        frac = r["overlap"]["comm_overlap_ratio_measured"]
        assert 0.0 <= frac <= 1.0
        assert r["applied"] is True
        # read back from the PerfDB (a 0.0 fraction is a measurement too)
        assert r["after"] == (cal["nvlink_latency"], frac)


# ------------------------------------------------------------- profiler

def test_profiler_reads_the_compiled_program(tmp_path):
    from easydist_tpu_torch.fxfront import easydist_compile
    from easydist_tpu_torch.models.optim import value_and_grad
    from easydist_tpu_torch.runtime.perfdb import PerfDB
    from easydist_tpu_torch.runtime.profiler import (memory_analysis,
                                                     op_cost_analysis,
                                                     profile_compiled,
                                                     serving_history)
    from tests.test_torch_parallel_ranks import from_numpy

    params, x, y = _data()
    tp, tx, ty = from_numpy(params), torch.from_numpy(x), torch.from_numpy(y)

    def step(p, xb, yb):
        loss, g = value_and_grad(_port_loss, p, xb, yb)
        return jax.tree.map(lambda w, d: w - 0.1 * d, p, g), loss

    compiled = easydist_compile(step, donate_state=False)
    result = compiled.get_compiled(tp, tx, ty)
    cost = op_cost_analysis(result)
    # the matmuls of forward and backward: 2*B*in*out each, three a layer
    # but the first layer's input gradient
    dims = [(32, 64), (64, 64), (64, 32)]
    want = sum(2 * 64 * a * b for a, b in dims) * 3 - 2 * 64 * 32 * 64
    assert cost["flops"] == want
    assert cost["flops_total"] > cost["flops"] > 0
    assert cost["bytes accessed"] > 0 and cost["optimal_seconds"] > 0
    mem = memory_analysis(result)
    assert mem["argument_size_in_bytes"] == sum(
        a.nbytes for a in jax.tree.leaves((params, x, y)))
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["planner_peak_bytes"] > 0
    db = PerfDB(str(tmp_path / "perf.db"))
    t = profile_compiled(compiled, (tp, tx, ty), key="mlp", trials=2,
                         warmup=1, db=db)
    assert t > 0 and db.get_op_perf("compiled", "mlp") == t
    assert serving_history(db=db) == []
