"""Port decode/chunk attention (easydist_tpu_torch.ops.flash_attention)
against the JAX package: the plain versions against the JAX XLA twins and
the Pallas decode kernel (interpret mode), dispatch rules, a plain
emulation of the decode kernel's split-K merge against both, and — on a
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


def _split_k_merge(q, kf, vf, lengths, scale: float, chunk: int):
    """The decode kernels' split-K (B4 over a contiguous cache; B5 and B6
    over the cache gathered through the table) in plain torch over f32
    caches kf/vf [b, h, T, d]: each row's live keys in splits of `chunk`
    tokens, each split's max m, denominator l and output acc in f32, then
    the partials merged in split order with the 1e-30 clamp; a row of
    length 0 gives 0."""
    out = torch.zeros(q.shape)
    for bi, n in enumerate(lengths.tolist()):
        n = min(n, kf.shape[2])
        parts = []
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            s = torch.einsum("hd,hkd->hk", q[bi].float() * scale,
                             kf[bi, :, c0:c1])
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(dim=-1, keepdim=True),
                          torch.einsum("hk,hkd->hd", p, vf[bi, :, c0:c1])))
        if not parts:
            continue
        top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        den = torch.zeros_like(top)
        acc = torch.zeros(q.shape[1:])
        for m, l, a in parts:  # split order
            den = den + l * torch.exp(m - top)
            acc = acc + a * torch.exp(m - top)
        out[bi] = acc / den.clamp_min(1e-30)
    return out.to(q.dtype)


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



class TestSplitK:
    """B4 cuts each row's keys into splits of `_decode_split_tokens`
    tokens, one block each, and merges the splits' partials in split
    order.  Emulated, the merge equals the plain version and the JAX
    Pallas kernel (interpret mode) at the f32 bar on both sides of a split
    boundary, at a cache length that is not a multiple of the split, at
    head_dim 64 and 128, over f32 and bf16 caches; a row of length 0
    gives 0, as the TPU kernel does (the plain version gives mean(v))."""

    @pytest.mark.parametrize("dtype,d,block_k", [
        (torch.float32, 64, 256), (torch.bfloat16, 64, 256),
        (torch.float32, 128, 256), (torch.bfloat16, 128, 256),
        (torch.float32, 64, 100)])
    def test_merge_matches_plain_and_jax_kernel(self, jax_ops, dtype, d,
                                                block_k):
        jnp, jfa = jax_ops
        chunk = tfa._decode_split_tokens(block_k, d, dtype.itemsize)
        assert chunk == (128 if (dtype, d) == (torch.float32, 128)
                         else block_k)
        t_k = 2 * chunk + 88  # a partial last split
        lengths = [0, 1, chunk - 1, chunk, chunk + 1, t_k]
        q, k, v = (x.to(dtype).float()  # the values the kernel reads
                   for x in _t(*_rand(b=len(lengths), h=2, T=t_k, d=d,
                                      seed=3)))
        L = torch.tensor(lengths, dtype=torch.int32)
        scale = 1.0 / np.sqrt(d)
        got = _split_k_merge(q, k, v, L, scale, chunk)
        ref = tfa._decode_attention_xla(q, k, v, L, scale)
        pallas = jfa.flash_decode_attention(
            *(jnp.asarray(x.numpy()) for x in (q, k, v, L)), scale=scale,
            interpret=True, block_k=t_k // 2)
        for want in (ref.numpy(), np.asarray(pallas)):
            np.testing.assert_allclose(got[1:].numpy(), want[1:], atol=ATOL)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        np.testing.assert_allclose(np.asarray(pallas)[0], 0.0)
        # a bf16 q: the same f32 arithmetic, the output rounded once
        assert torch.equal(_split_k_merge(q.to(dtype), k, v, L, scale, chunk),
                           got.to(dtype))

    @pytest.mark.parametrize("block_k,d,itemsize,want", [
        (256, 64, 2, 256),     # serving shape, bf16: 64 KB of K + V
        (256, 128, 2, 256),
        (256, 64, 4, 256),
        (256, 128, 4, 128),    # f32 at head_dim 128: halved to fit
        (1000, 64, 2, 500),    # any block_k, halved to fit
        (100, 64, 2, 100),     # no divisor of the cache length needed
        (16, 64, 4, 16),
    ])
    def test_decode_split_tokens(self, block_k, d, itemsize, want):
        assert tfa._decode_split_tokens(block_k, d, itemsize) == want

    def test_decode_split_tokens_rejects_empty_split(self):
        with pytest.raises(ValueError, match="block_k"):
            tfa._decode_split_tokens(0, 64, 2)


def _card_inputs(dev, dtype, lengths, t_k=1024, h=12, d=64, seed=0):
    """q [b, h, d], k/v [b, h, t_k, d] in `dtype` and int32 lengths [b] on
    the card, from numpy."""
    rs = np.random.RandomState(seed)
    b = len(lengths)
    q, k, v = (torch.as_tensor(rs.standard_normal(s), dtype=dtype,
                               device=dev)
               for s in ((b, h, d), (b, h, t_k, d), (b, h, t_k, d)))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _b4_reference(q, k, v, lengths):
    """The plain B4 in f32 on the same inputs, with 0 on rows of length
    0."""
    ref = tfa._decode_attention_xla(q.float(), k.float(), v.float(),
                                    lengths, 1.0 / np.sqrt(q.shape[-1]))
    ref[lengths == 0] = 0.0
    return ref


def _b4_close(q, out, ref) -> bool:
    """Within atol 1e-5, plus half an ulp (2^-8 |ref|) of a bf16
    output."""
    tol = ATOL if q.dtype == torch.float32 else 2.0 ** -8 * ref.abs() + ATOL
    return bool(((out.float() - ref).abs() <= tol).all())


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

    @pytest.mark.parametrize("block_k", [None, 100])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [64, 128])
    def test_at_split_boundaries(self, cuda_device, dtype, d, block_k):
        # lengths on both sides of the split boundaries (256 tokens; 128
        # for f32 at head_dim 128; 100 at block_k 100), an empty row, and
        # a cache length that is no multiple of the split
        chunk = tfa._decode_split_tokens(block_k or 256, d, dtype.itemsize)
        t_k = 1000
        lengths = [1, 0, chunk - 1, chunk, chunk + 1, 2 * chunk + 1,
                   t_k - 1, t_k]
        q, k, v, L = _card_inputs(cuda_device, dtype, lengths, t_k=t_k,
                                  d=d)
        before = tfa.flash_decode_attention.launches
        out = tfa.flash_decode_attention(q, k, v, L, block_k=block_k)
        torch.cuda.synchronize()
        assert tfa.flash_decode_attention.launches == before + 1
        assert _b4_close(q, out, _b4_reference(q, k, v, L))

    @pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                         (torch.bfloat16, 64),
                                         (torch.float32, 128)])
    def test_is_deterministic_and_leaves_no_stale_counters(
            self, cuda_device, dtype, d):
        # split boundaries depend on the length alone and the merge order
        # is fixed: two launches are bitwise equal.  Each launch resets the
        # counters it used, so calls with other lengths stay right.
        lengths = [1024, 700, 257, 256, 0, 513, 1, 900]
        q, k, v, L = _card_inputs(cuda_device, dtype, lengths, d=d)
        first = tfa.flash_decode_attention(q, k, v, L)
        for lens in (lengths, [300, 1, 1024, 0, 64, 511, 129, 700],
                     [0] * 8, lengths):
            L2 = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
            out = tfa.flash_decode_attention(q, k, v, L2)
            torch.cuda.synchronize()
            assert _b4_close(q, out, _b4_reference(q, k, v, L2))
            assert all(int(c.abs().sum()) == 0
                       for c in tfa._SPLIT_COUNTERS.values())
        assert torch.equal(out, first)

    def test_plain_backend_on_cuda_tensor_raises(self, cuda_device):
        q, k, v = (t.to(cuda_device) for t in _t(*_rand(d=64)))
        L = torch.tensor([5, 64], dtype=torch.int32, device=cuda_device)
        before = tfa.flash_decode_attention.launches
        with pytest.raises(RuntimeError, match="CPU tensors only"):
            tfa.decode_attention(q, k, v, L, backend="xla")
        assert tfa.flash_decode_attention.launches == before


# head_dims beyond the exact body's 64 and 128 (the padded body)
SWEEP_DIMS = (1, 7, 8, 16, 32, 80, 96, 100, 129, 256)


@pytest.mark.cuda
class TestAllHeadDimsOnCard:
    """B4 on the padded body at every head_dim of the sweep, against its
    plain version at its split boundaries (the split's tokens at the
    padded width), f32 and bf16; two launches bitwise equal; the limit at
    256; a cache whose base is not 16-byte aligned."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", SWEEP_DIMS)
    def test_at_split_boundaries(self, cuda_device, dtype, d):
        chunk = tfa._decode_split_tokens(256, d, dtype.itemsize)
        t_k = 1000
        lengths = [1, 0, chunk - 1, chunk, chunk + 1, 2 * chunk + 1,
                   t_k - 1, t_k]
        q, k, v, L = _card_inputs(cuda_device, dtype, lengths, t_k=t_k,
                                  h=4, d=d, seed=d)
        before = tfa.flash_decode_attention.launches
        out = tfa.flash_decode_attention(q, k, v, L)
        torch.cuda.synchronize()
        assert tfa.flash_decode_attention.launches == before + 1
        assert _b4_close(q, out, _b4_reference(q, k, v, L))

    @pytest.mark.parametrize("d", [8, 80])
    def test_is_deterministic(self, cuda_device, d):
        lengths = [1000, 700, 257, 256, 0, 513, 1, 900]
        q, k, v, L = _card_inputs(cuda_device, torch.bfloat16, lengths,
                                  t_k=1000, h=4, d=d)
        first = tfa.flash_decode_attention(q, k, v, L)
        again = tfa.flash_decode_attention(q, k, v, L)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        assert all(int(c.abs().sum()) == 0
                   for c in tfa._SPLIT_COUNTERS.values())

    def test_unaligned_cache_reads_in_place(self, cuda_device):
        # rows of 7 bf16 elements (14 bytes) from a base 2 bytes past a
        # 16-byte boundary: the padded body copies 2 bytes at a time
        lengths = [5, 300, 0, 64]
        q, k, v, L = _card_inputs(cuda_device, torch.bfloat16, lengths,
                                  t_k=300, h=2, d=7)
        flat = torch.empty(k.numel() + 1, device=cuda_device,
                           dtype=k.dtype)
        k_off = flat[1:].view(k.shape)
        k_off.copy_(k)
        out = tfa.flash_decode_attention(q, k_off, v, L)
        torch.cuda.synchronize()
        assert _b4_close(q, out, _b4_reference(q, k, v, L))

    def test_head_dim_above_256_raises(self, cuda_device):
        q, k, v, L = _card_inputs(cuda_device, torch.float32, [3], t_k=8,
                                  h=1, d=257)
        with pytest.raises(ValueError, match="head_dim 1..256"):
            tfa.flash_decode_attention(q, k, v, L)
