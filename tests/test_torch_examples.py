"""The torch twins of examples/jax/ (`examples/torch/{train_gpt,
simple_function,moe_layer,pipeline_gpt,pipeline_1f1b_gpt,
hybrid_pp_tp}.py`) and of examples/serve_gpt.py
(`examples/torch/serve_gpt.py`) at their small sizes on the CPU: the
one-device ones in this process, the multi-rank ones on gloo ranks of world 4 (one
spawn, `tests/test_torch_fxfront_ranks.spawn`).  Each example's `run`
returns its numbers; the checks hold them to eager torch where the
example computes something eager torch can (the function's value, the
pipeline's output), and to finite, decreasing losses where it trains."""

import importlib.util
import math
import os

import numpy as np
import pytest

import tests.test_torch_fxfront_ranks as ranks

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "torch")
SCENARIO = "tests.test_torch_examples:examples_scenario"


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_scenario(rank, world, out):
    import torch.distributed as dist

    res = {}
    res["simple_function"] = load("simple_function").run("cpu", small=True)
    res["moe_layer"] = load("moe_layer").run("cpu", small=True)
    res["pipeline_gpt"] = load("pipeline_gpt").run("cpu", small=True)
    res["pipeline_1f1b_gpt"] = load("pipeline_1f1b_gpt").run(
        "cpu", small=True, steps=3)
    res["hybrid_pp_tp"] = load("hybrid_pp_tp").run("cpu", small=True,
                                                   steps=3)
    dist.barrier()
    return res


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return ranks.spawn(SCENARIO, 4, tmp_path_factory.mktemp("examples"),
                       timeout=400)


def _decreasing(losses):
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses


def test_train_gpt_one_device_resumes(tmp_path):
    mod = load("train_gpt")
    first = mod.run("cpu", small=True, steps=6, ckpt=str(tmp_path), batch=4)
    _decreasing(first["losses"])
    # a second run resumes from the committed step 6: nothing to train
    assert mod.run("cpu", small=True, steps=6, ckpt=str(tmp_path),
                   batch=4)["losses"] == []


def test_serve_gpt_tiny_config():
    # the tiny config (head_dim 8): every request of the concurrent
    # clients answered, one executable a bucket, flash attention's plain
    # version on the CPU (B1 launches only on the card)
    r = load("serve_gpt").run("cpu", clients=3, requests=4, export=False)
    assert r["errors"] == [] and r["requests_completed"] == 12
    assert r["head_dim"] == 8 and r["device"] == "cpu"
    assert 1 <= r["distinct_executables"] <= 4
    assert r["flash_fwd_launches"] == 0
    assert r["p50_ms"] > 0


def test_serve_gpt_main_takes_device(capsys, monkeypatch, tmp_path):
    import json

    from easydist_tpu_torch import config as edconfig

    # main() exports the metrics to the perf database
    monkeypatch.setattr(edconfig, "prof_db_path", str(tmp_path / "perf.db"))
    load("serve_gpt").main(["--device", "cpu", "--clients", "2",
                            "--requests", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["requests_completed"] == 4 and out["device"] == "cpu"


def test_one_process_examples():
    r = load("simple_function").run("cpu", small=True)
    np.testing.assert_allclose(r["result"], r["want"], rtol=1e-5)
    assert r["placements"] is None
    r = load("pipeline_gpt").run("cpu", small=True)
    assert r["shape"] == (8, 4, 32) and r["finite"]
    assert r["max_err"] <= 1e-5
    _decreasing(load("pipeline_1f1b_gpt").run("cpu", small=True,
                                              steps=3)["losses"])


def test_simple_function_over_four_ranks(world4):
    for r in world4:
        got = r["simple_function"]
        np.testing.assert_allclose(got["result"], got["want"], rtol=1e-5)
        assert len(got["placements"]) == 2


def test_moe_layer_over_four_ranks(world4):
    for r in world4:
        got = r["moe_layer"]
        assert got["n"] == 4 and got["experts"] == 8
        assert got["shape"] == (64, 16) and got["finite"]
        assert math.isfinite(got["aux"])
    assert len({r["moe_layer"]["aux"] for r in world4}) == 1


def test_pipelines_over_four_ranks(world4):
    for r in world4:
        got = r["pipeline_gpt"]
        assert got["shape"] == (8, 4, 32) and got["finite"]
        assert got["max_err"] <= 1e-5
        _decreasing(r["pipeline_1f1b_gpt"]["losses"])
    # every rank reports the same loss (the pipeline's psum)
    assert len({tuple(r["pipeline_1f1b_gpt"]["losses"])
                for r in world4}) == 1
    # each rank holds two chunks of the 8 layers, all covered once
    layers = sorted(i for r in world4
                    for i in r["pipeline_1f1b_gpt"]["layers"])
    assert layers == list(range(8))


def test_hybrid_pp_tp_over_four_ranks(world4):
    losses = [r["hybrid_pp_tp"]["losses"] for r in world4]
    for got in losses:
        _decreasing(got)
    np.testing.assert_allclose(losses[0], losses[-1], rtol=1e-6)
    assert set(world4[0]["hybrid_pp_tp"]["tp"]) == {"planned", "sharded"}
