"""Sessions over a mesh (`GenerationSession(mesh=)` / `for_gpt(mesh=)`,
`kv_cache_specs`) of the port against the JAX package's
(tests/test_serve/test_generation.py::test_tp2_sharded_cache_parity,
test_paged_generation.py::test_tp2_parity, test_speculate.py::
test_tp2_spec_parity and test_paged_tp2_spec_parity).

One spawn on gloo (2,) "tp" runs the bucketed, paged, bucketed
speculative and paged speculative sessions over the JAX package's tiny
GPT weights: every rank's ids equal the one-device session's (which
tests/test_torch_generation.py and test_torch_speculate.py hold to the
JAX package's); the speculative runs take verify steps; every program
of the session was compiled on the mesh.
"""

import dataclasses

import jax
import numpy as np
import pytest

from easydist_tpu.models import GPTConfig as JCfg
from easydist_tpu.models import gpt_init as j_init
from easydist_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from easydist_tpu_torch.serve import (GenerationSession, ServeConfig,
                                      kv_cache_specs)
from tests import test_torch_fxfront_ranks as ranks

KW = dict(vocab=128, seq=32, dim=32, heads=4, layers=2)
PROMPTS = [[7, 1, 4, 4], [5, 6, 7, 5, 6, 7, 5, 6], [3, 3, 3]]
N_NEW = 6
RUNS = {"bucketed": dict(decode_buckets=(32,), prefill_chunk=8),
        "paged": dict(decode_buckets=(32,), prefill_chunk=8,
                      kv_layout="paged"),
        "spec": dict(decode_buckets=(32,), prefill_chunk=8, speculate_k=3),
        "paged_spec": dict(decode_buckets=(32,), prefill_chunk=8,
                           speculate_k=3, kv_layout="paged")}


def _drain(sess):
    futs = [sess.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    sess.run_until_drained()
    return [f.result(timeout=5)["ids"] for f in futs]


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, j_init(JCfg.tiny(**KW),
                                           jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def mesh_runs(params, tmp_path_factory):
    return ranks.spawn("tests.test_torch_parallel_ranks:serve_mesh_modes",
                       2, tmp_path_factory.mktemp("serve_mesh"),
                       params=params, cfg_kw=KW, prompts=PROMPTS,
                       n_new=N_NEW, runs=RUNS, timeout=400)


@pytest.mark.parametrize("name", list(RUNS))
def test_tp2_parity(params, mesh_runs, name):
    cfg = GPTConfig.tiny(**KW)
    one = _drain(GenerationSession.for_gpt(
        params_from_numpy(params, device="cpu"), cfg,
        config=ServeConfig(**RUNS[name]), device="cpu"))
    for r in mesh_runs:
        got = r[name]
        assert got["ids"] == one, (name, got["ids"], one)
        assert "decode" in got["picks"]
        if name.endswith("spec"):
            assert got["verify_steps"] > 0
            assert ("verify" if name == "paged_spec"
                    else "verify_bucketed") in got["picks"]


def test_kv_cache_specs():
    from torch.distributed.tensor import Replicate, Shard

    assert kv_cache_specs("tp") == {"k": (Shard(2),), "v": (Shard(2),)}
    spec = kv_cache_specs("tp", ("dp", "tp"))
    assert spec["k"] == (Replicate(), Shard(2)) == spec["v"]
    with pytest.raises(ValueError):
        kv_cache_specs("tp", ("dp",))


def test_memo_keys_on_the_mesh(params):
    """Sessions on the same model and mesh share compiled programs; the
    memo keys on the mesh (None here)."""
    from easydist_tpu_torch.serve import generation as gen

    cfg = GPTConfig.tiny(**KW)
    p = params_from_numpy(params, device="cpu")
    a, b = (GenerationSession.for_gpt(
        p, cfg, device="cpu", config=ServeConfig(decode_buckets=(32,)))
        for _ in range(2))
    assert a._decode_c is b._decode_c and a.mesh is None
    assert (("gpt", dataclasses.astuple(cfg), "cpu"), None) \
        in gen._COMPILED_MEMO
