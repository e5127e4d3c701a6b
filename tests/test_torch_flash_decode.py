"""Port decode/chunk attention (easydist_tpu_torch.ops.flash_attention)
against the JAX package: the plain versions against the JAX XLA twins and
the Pallas decode kernel (interpret mode), dispatch rules, and — on a
CUDA host — the CUDA kernel against the plain version.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: atol 1e-5 in float32 (the bar of
tests/test_ops/test_decode_attention.py)."""

import importlib

import numpy as np
import pytest
import torch

from easydist_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5
LENGTHS = [[5, 64], [1, 17], [64, 64], [33, 48]]


def _rand(b=2, h=4, T=64, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, h, d)).astype(np.float32),
            rs.standard_normal((b, h, T, d)).astype(np.float32),
            rs.standard_normal((b, h, T, d)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.fixture(scope="module")
def jax_ops():
    """(jax.numpy, the JAX package's ops/flash_attention module), imported
    here so the card's tests collect on a host without JAX.  The module
    is imported by name: `easydist_tpu.ops` exports a function called
    flash_attention that shadows it."""
    jnp = pytest.importorskip("jax.numpy")
    return jnp, importlib.import_module("easydist_tpu.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class TestDecodePlainVsJax:
    @pytest.mark.parametrize("lengths", LENGTHS)
    def test_matches_jax_xla_path(self, jax_ops, lengths):
        jnp, jfa = jax_ops
        q, k, v = _rand()
        scale = 1.0 / np.sqrt(q.shape[-1])
        L = np.asarray(lengths, np.int32)
        ref = jfa._decode_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(L), scale)
        out = tfa._decode_attention_xla(*_t(q, k, v, L), scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("lengths", LENGTHS)
    def test_matches_jax_pallas_kernel_interpret(self, jax_ops, lengths):
        jnp, jfa = jax_ops
        q, k, v = _rand()
        L = np.asarray(lengths, np.int32)
        ref = jfa.flash_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L),
            interpret=True, block_k=16)
        out = tfa._decode_attention_xla(*_t(q, k, v, L),
                                        1.0 / np.sqrt(q.shape[-1]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_length_zero_is_mean_of_v_like_jax_xla(self, jax_ops):
        jnp, jfa = jax_ops
        q, k, v = _rand()
        L = np.asarray([0, 3], np.int32)
        out = tfa._decode_attention_xla(*_t(q, k, v, L), 0.25)
        ref = jfa._decode_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(L), 0.25)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(out[0].numpy(), v[0].mean(axis=1),
                                   atol=ATOL)

    def test_bf16_output_dtype(self):
        q, k, v = (t.to(torch.bfloat16) for t in _t(*_rand()))
        out = tfa._decode_attention_xla(q, k, v, torch.tensor([3, 9]), 0.25)
        assert out.dtype == torch.bfloat16 and out.shape == q.shape


class TestChunkPlainVsJax:
    @pytest.mark.parametrize("starts", [[0, 0], [8, 24], [56, 3]])
    def test_matches_jax_xla_path(self, jax_ops, starts):
        jnp, jfa = jax_ops
        rs = np.random.RandomState(1)
        b, h, c, T, d = 2, 4, 8, 64, 16
        q = rs.standard_normal((b, h, c, d)).astype(np.float32)
        k = rs.standard_normal((b, h, T, d)).astype(np.float32)
        v = rs.standard_normal((b, h, T, d)).astype(np.float32)
        q_pos = (np.asarray(starts, np.int32)[:, None]
                 + np.arange(c, dtype=np.int32)[None])
        ref = jfa._chunk_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(q_pos),
                                       0.25)
        out = tfa.chunk_attention(*_t(q, k, v, q_pos), scale=0.25)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_unknown_backend_raises(self):
        q, k, v = _t(*_rand())
        with pytest.raises(ValueError, match="prefill attention backend"):
            tfa.chunk_attention(q[:, :, None], k, v,
                                torch.zeros(2, 1, dtype=torch.int32),
                                backend="flash")


class TestDispatch:
    def test_auto_on_cpu_runs_plain_version(self):
        q, k, v = _t(*_rand())
        L = torch.tensor([5, 64], dtype=torch.int32)
        before = tfa.flash_decode_attention.launches
        out = tfa.decode_attention(q, k, v, L)
        ref = tfa._decode_attention_xla(q, k, v, L, 0.25)
        assert torch.equal(out, ref)
        assert tfa.flash_decode_attention.launches == before

    def test_flash_on_cpu_tensor_raises(self):
        q, k, v = _t(*_rand())
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tfa.decode_attention(q, k, v, torch.tensor([5, 64]),
                                 backend="flash")
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tfa.flash_decode_attention(q, k, v, torch.tensor([5, 64]))

    def test_unknown_backend_raises(self):
        q, k, v = _t(*_rand())
        with pytest.raises(ValueError, match="decode attention backend"):
            tfa.decode_attention(q, k, v, torch.tensor([5, 64]),
                                 backend="ring")

    def test_paged_backend_degrades_to_auto(self, jax_ops):
        # as the JAX dispatcher does (ops/flash_attention.py:535-538): the
        # contiguous path has no table to chase
        jnp, jfa = jax_ops
        q, k, v = _rand()
        L = np.asarray([5, 64], np.int32)
        out = tfa.decode_attention(*_t(q, k, v, L), backend="paged")
        ref = jfa.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(L),
                                   backend="paged")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
        assert torch.equal(out, tfa.decode_attention(*_t(q, k, v, L)))

    def test_scalar_length_broadcasts(self):
        q, k, v = _t(*_rand())
        out = tfa.decode_attention(q, k, v, 7)
        ref = tfa._decode_attention_xla(q, k, v, torch.tensor([7, 7]), 0.25)
        assert torch.equal(out, ref)

    @pytest.mark.parametrize("block_k,t_k,d,itemsize,want", [
        (256, 1024, 64, 2, 256),    # serving shape, bf16: 64 KB K+V tile
        (256, 1000, 64, 2, 8),      # _pick_block halves to a divisor
        (256, 1024, 128, 4, 128),   # f32 d=128: halved to fit shared memory
        (16, 64, 16, 4, 16),
    ])
    def test_decode_tile(self, jax_ops, block_k, t_k, d, itemsize, want):
        assert tfa._decode_tile(block_k, t_k, d, itemsize) == want
        assert jax_ops[1]._pick_block(block_k, t_k) == \
            tfa._pick_block(block_k, t_k)


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("lengths", [[1] * 8, [1024] * 8,
                                         [1, 1024, 300, 77, 513, 256, 999,
                                          5]])
    def test_kernel_matches_plain(self, cuda_device, dtype, lengths):
        rs = np.random.RandomState(0)
        b, h, T, d = 8, 12, 1024, 64
        q, k, v = (torch.as_tensor(rs.standard_normal(s), dtype=dtype,
                                   device=cuda_device)
                   for s in ((b, h, d), (b, h, T, d), (b, h, T, d)))
        L = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
        before = tfa.flash_decode_attention.launches
        out = tfa.decode_attention(q, k, v, L)
        torch.cuda.synchronize()
        assert tfa.flash_decode_attention.launches == before + 1
        ref = tfa._decode_attention_xla(q.float(), k.float(), v.float(), L,
                                        1.0 / np.sqrt(d))
        # bf16, per element: half an output ulp (<= 2^-8 |x|) over f32
        # order noise
        tol = ATOL if dtype == torch.float32 else 2.0 ** -8 * ref.abs() + ATOL
        assert bool(((out.float() - ref).abs() <= tol).all())

    def test_plain_backend_on_cuda_tensor_raises(self, cuda_device):
        q, k, v = (t.to(cuda_device) for t in _t(*_rand(d=64)))
        L = torch.tensor([5, 64], dtype=torch.int32, device=cuda_device)
        before = tfa.flash_decode_attention.launches
        with pytest.raises(RuntimeError, match="CPU tensors only"):
            tfa.decode_attention(q, k, v, L, backend="xla")
        assert tfa.flash_decode_attention.launches == before
