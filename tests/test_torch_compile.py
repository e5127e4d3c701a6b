"""The port's one-device `easydist_compile` (easydist_tpu_torch.fxfront):
signature cache, replay equal to eager, in-place state threading, and
`infer_state_io` pairing held against the JAX package's on the same
structures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easydist_tpu.jaxfront.api import infer_state_io as jax_infer_state_io
from easydist_tpu_torch.fxfront import easydist_compile, infer_state_io
from easydist_tpu_torch.models import gpt as tg


@pytest.fixture(scope="module")
def tiny():
    cfg = tg.GPTConfig.tiny()
    params = tg.gpt_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _decode_fn(cfg):
    def step(cache, params, token, pos):
        cache, logits = tg.gpt_decode_step(params, cfg, cache, token, pos)
        return cache, torch.argmax(logits, dim=-1).to(torch.int32), logits
    return step


def test_signature_cache_traces_once_per_signature(tiny):
    cfg, params = tiny
    step = easydist_compile(_decode_fn(cfg))
    cache = tg.init_kv_cache(cfg, 2, cfg.seq, device="cpu")
    for t in range(3):
        step(cache, params, torch.tensor([1, 2], dtype=torch.int32),
             torch.tensor([t, t], dtype=torch.int32))
    assert step.cache_stats() == {"size": 1, "hits": 2, "misses": 1}
    cache3 = tg.init_kv_cache(cfg, 3, cfg.seq, device="cpu")
    step(cache3, params, torch.tensor([1, 2, 3], dtype=torch.int32),
         torch.tensor([0, 0, 0], dtype=torch.int32))
    assert step.cache_stats()["size"] == 2
    assert len(step.compiled_signatures()) == 2
    key = step.cache_key(cache, params, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
    assert key in step.compiled_signatures()


def test_replay_equals_eager_bitwise(tiny):
    cfg, params = tiny
    step = easydist_compile(_decode_fn(cfg))
    cache_c = tg.init_kv_cache(cfg, 2, cfg.seq, device="cpu")
    cache_e = tg.init_kv_cache(cfg, 2, cfg.seq, device="cpu")
    tok = torch.tensor([3, 9], dtype=torch.int32)
    for t in range(4):
        pos = torch.tensor([t, 2 * t], dtype=torch.int32)
        _, ids_c, logits_c = step(cache_c, params, tok, pos)
        _, ids_e, logits_e = _decode_fn(cfg)(cache_e, params, tok, pos)
        assert torch.equal(logits_c, logits_e)
        assert torch.equal(ids_c, ids_e)
        tok = ids_c
    assert torch.equal(cache_c["k"], cache_e["k"])
    assert torch.equal(cache_c["v"], cache_e["v"])


def test_paired_cache_keeps_its_storage(tiny):
    cfg, params = tiny
    step = easydist_compile(_decode_fn(cfg))
    cache = tg.init_kv_cache(cfg, 2, cfg.seq, device="cpu")
    ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
    result = step.get_compiled(cache, params, torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32))
    assert result.state_pairs == {0: 0, 1: 1}
    for t in range(3):
        out, _, _ = step(cache, params, torch.tensor([1, 2], dtype=torch.int32),
                         torch.tensor([t, t], dtype=torch.int32))
        assert out["k"] is cache["k"] and out["v"] is cache["v"]
        assert (out["k"].data_ptr(), out["v"].data_ptr()) == ptrs
    assert cache["k"][:, :, :, :3].abs().sum() > 0  # the writes landed


def test_functional_state_output_is_written_back_in_place():
    @easydist_compile
    def bump(state, x):
        return {"a": state["a"] + x}, x * 2

    state = {"a": torch.zeros(4)}
    ptr = state["a"].data_ptr()
    out, y = bump(state, torch.ones(4))
    out, y = bump(state, torch.ones(4))
    assert out["a"] is state["a"] and state["a"].data_ptr() == ptr
    assert torch.equal(state["a"], torch.full((4,), 2.0))
    assert torch.equal(y, torch.full((4,), 2.0))


def test_bare_tensor_argument_is_data_not_state():
    f = easydist_compile(lambda x: x + 1)
    x = torch.zeros(2)
    out = f(x)
    assert f.get_compiled(x).state_pairs == {}
    assert out is not x and torch.equal(x, torch.zeros(2))


def test_python_scalars_key_the_signature_by_value():
    f = easydist_compile(lambda x, n: x * n)
    x = torch.ones(3)
    assert torch.equal(f(x, 2), torch.full((3,), 2.0))
    assert torch.equal(f(x, 3), torch.full((3,), 3.0))
    assert f.cache_stats()["size"] == 2


def test_trace_runs_nothing_and_keeps_custom_ops_one_node(tiny):
    """make_fx traces over fake tensors: no launch, no counter bump; a
    torch.library custom op (the port's kernels) stays a single node."""
    from easydist_tpu_torch.ops.flash_attention import flash_decode_attention

    cfg, params = tiny
    step = easydist_compile(_decode_fn(cfg))
    cache = tg.init_kv_cache(cfg, 2, cfg.seq, device="cpu")
    before = flash_decode_attention.launches
    gm = step.get_compiled(cache, params, torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32)).graph_module
    assert flash_decode_attention.launches == before
    assert not cache["k"].any()  # tracing wrote nothing

    @torch.library.custom_op("test_torch_compile::double", mutates_args=())
    def double(x: torch.Tensor) -> torch.Tensor:
        return x * 2

    @double.register_fake
    def _(x):
        return torch.empty_like(x)

    g = easydist_compile(lambda x: double(x) + 1)
    r = g.get_compiled(torch.ones(2))
    targets = [str(n.target) for n in r.graph_module.graph.nodes
               if n.op == "call_function"]
    assert "test_torch_compile.double.default" in targets
    assert torch.equal(g(torch.ones(2)), torch.full((2,), 3.0))
    assert any("index_put" in str(n.target) for n in gm.graph.nodes)


@pytest.mark.parametrize("case", ["state_then_data", "scalar_ends_pairing",
                                  "bare_leaf_not_state", "shape_mismatch"])
def test_infer_state_io_matches_jax(case):
    """Same structures, built from numpy, through both packages."""
    z = np.zeros((2, 3), np.float32)
    w = np.zeros((4,), np.float32)
    if case == "state_then_data":
        args = ({"k": z, "v": z}, [w, w], z)
        out = ({"k": z, "v": z}, [w, w], w)
    elif case == "scalar_ends_pairing":
        args = ({"k": z}, z)
        out = ({"k": z}, np.float32(1.0))
    elif case == "bare_leaf_not_state":
        args = (z, {"k": z})
        out = (z, {"k": z})
    else:
        args = ({"k": z}, {"k": z})
        out = ({"k": w}, {"k": z})
    want = jax_infer_state_io(
        jax.tree.map(jnp.asarray, args), jax.tree.map(jnp.asarray, out))
    got = infer_state_io(
        jax.tree.map(torch.from_numpy, args),
        jax.tree.map(lambda a: torch.as_tensor(a), out))
    assert got == want
