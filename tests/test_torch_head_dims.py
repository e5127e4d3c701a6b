"""Every head_dim the TPU kernels take, on the CPU.

The six TPU kernels block over the sequence and keep the head_dim whole,
so they take any width; the port's kernels take every head_dim from 1 to
256 (B1-B3 on the tensor cores at padded widths up to 256; B4-B6 on the
decode body's exact width at 64 and 128, on its padded body elsewhere).
Here, where the wrappers run their plain versions: B1-B3 (forward and
both gradients), B4, B5 and B6 at head_dim 8 and 16 (the tiny configs
and the JAX tests), 80 (Cerebras-GPT-2.7B) and 100 (OpenLLaMA-3B)
against the JAX package's Pallas kernels in interpret mode; the split
sizing at the padded widths, with B4's split merge emulated against the
JAX kernel; `estimate_smem_bytes` (the counterpart of the JAX package's
`estimate_vmem_bytes`); and a 2-layer GPT session at Cerebras-GPT's
head_dim 80 against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX tests': forward rtol 1e-4 / atol 1e-5, backward
rtol 2e-4 / atol 2e-5 (tests/test_ops/test_flash_attention.py), decode
atol 1e-5 (tests/test_ops/test_paged_decode_attention.py)."""

import importlib
import math

import numpy as np
import pytest
import torch

from easydist_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_flash_attention import _rand
from tests.test_torch_flash_decode import _split_k_merge
from tests.test_torch_paged_ops import _paged, _t

DIMS = (8, 16, 80, 100)
FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)
ATOL = 1e-5
# n_blocks of B6's int8 pages at each head_dim: blocks of 4, 4, 16, 25
# dims (25 is no multiple of an int8 vector: one scale an element)
BLOCKS = {8: 2, 16: 4, 80: 5, 100: 4}
# shared memory of B1-B3's largest launch, as the card reported it
# (chip_smoke.py phase 3, `smem_phase`; NVIDIA H100 80GB HBM3)
CARD_SMEM = {(torch.float32, 64): 214088, (torch.float32, 128): 230568,
             (torch.bfloat16, 64): 82984, (torch.bfloat16, 128): 132136,
             (torch.float32, 80): 230720, (torch.bfloat16, 100): 132136,
             (torch.float32, 256): 230432, (torch.bfloat16, 8): 82984,
             (torch.bfloat16, 80): 132136, (torch.float32, 40): 214088,
             (torch.bfloat16, 40): 82984, (torch.float32, 96): 222256,
             (torch.bfloat16, 112): 132136, (torch.float32, 112): 230568,
             (torch.bfloat16, 256): 197672, (torch.bfloat16, 129): 197672}


@pytest.fixture(scope="module")
def jax_ops():
    """(jax, jax.numpy, the JAX package's ops/flash_attention module)."""
    jax = pytest.importorskip("jax")
    return (jax, jax.numpy,
            importlib.import_module("easydist_tpu.ops.flash_attention"))


class TestTrainingVsJax:
    @pytest.mark.parametrize("d", DIMS)
    @pytest.mark.parametrize("causal", [True, False])
    def test_forward_and_gradients_match_pallas(self, jax_ops, d, causal):
        # B1's (out, lse) and B2 / B3's gradients through the port's
        # autograd, against jax.vjp of the Pallas forward in interpret
        # mode, with cotangents on both outputs
        jax, jnp, jfa = jax_ops
        q, k, v, do = _rand(b=2, h=2, t=40, d=d, seed=d)
        g_lse = np.random.RandomState(d + 1).standard_normal(
            (4, 40)).astype(np.float32)
        (out_j, lse_j), vjp = jax.vjp(
            lambda a, b, c: jfa.flash_attention_lse(a, b, c, causal, None,
                                                    16, 16, True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
        qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
        out, lse = tfa.flash_attention_lse(qt, kt, vt, causal)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                                   **FWD)
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                                   **FWD)
        got = torch.autograd.grad((out, lse), (qt, kt, vt),
                                  _t(do, g_lse))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD)


    @pytest.mark.parametrize("causal", [True, False])
    def test_dq_at_256_matches_pallas(self, jax_ops, causal):
        # GPT-J's and Gemma's head_dim: the plain dQ, which the card holds
        # f32 B2 at the width 256 to, against the JAX package's Pallas
        # backward in interpret mode (cotangents on out and lse)
        jax, jnp, jfa = jax_ops
        q, k, v, do = _rand(b=1, h=2, t=64, d=256, seed=256)
        g_lse = np.random.RandomState(257).standard_normal(
            (2, 64)).astype(np.float32)
        _, vjp = jax.vjp(
            lambda a, b, c: jfa.flash_attention_lse(a, b, c, causal, None,
                                                    32, 32, True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp((jnp.asarray(do), jnp.asarray(g_lse)))[0]
        qt, kt, vt, dot, gt = _t(q, k, v, do, g_lse)
        scale = 1.0 / math.sqrt(256)
        out, lse = tfa._flash_forward_xla(qt, kt, vt, causal, scale)
        delta = tfa._flash_delta(out, dot, gt)
        dq = tfa._flash_bwd_dq_xla(qt, kt, vt, dot, lse, delta, causal,
                                   scale)
        np.testing.assert_allclose(dq.numpy(), np.asarray(want), **BWD)


class TestDecodeVsJax:
    @pytest.mark.parametrize("d", DIMS)
    def test_b4_matches_pallas(self, jax_ops, d):
        _, jnp, jfa = jax_ops
        q, k, v = _rand(b=3, h=2, t=48, d=d, seed=d, n=3)
        q = np.ascontiguousarray(q[:, :, 0])
        L = np.asarray([1, 17, 48], np.int32)
        ref = jfa.flash_decode_attention(
            *(jnp.asarray(x) for x in (q, k, v, L)), interpret=True,
            block_k=16)
        out = tfa.decode_attention(*_t(q, k, v, L))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("d", DIMS)
    def test_b5_matches_pallas_gqa(self, jax_ops, d):
        _, jnp, jfa = jax_ops
        q, k, v, table, L = _paged([29, 6, 32], h=4, kvh=2, d=d, seed=d)
        scale = 1.0 / math.sqrt(d)
        ref = jfa.flash_paged_decode_attention(
            *(jnp.asarray(x) for x in (q, k, v, table, L)), scale=scale,
            interpret=True)
        out = tfa.paged_decode_attention(*_t(q, k, v, table, L))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("d", DIMS)
    def test_b6_matches_pallas(self, jax_ops, d):
        _, jnp, jfa = jax_ops
        q, k, v, table, L = _paged([29, 6, 32], h=4, kvh=2, d=d,
                                   seed=d + 1)
        nb = BLOCKS[d]
        kq, ks = (x.numpy() for x in tfa.kv_quantize(torch.from_numpy(k), nb))
        vq, vs = (x.numpy() for x in tfa.kv_quantize(torch.from_numpy(v), nb))
        ref = jfa.flash_paged_decode_quant_attention(
            *(jnp.asarray(x) for x in (q, kq, vq, ks, vs, table, L)),
            interpret=True)
        out = tfa.paged_decode_attention(
            *_t(q, kq, vq, table, L), k_scale=torch.from_numpy(ks),
            v_scale=torch.from_numpy(vs))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


class TestPaddedWidths:
    @pytest.mark.parametrize("d,width", [(1, 64), (8, 64), (63, 64),
                                         (64, 64), (65, 128), (80, 128),
                                         (100, 128), (128, 128),
                                         (129, 256), (256, 256)])
    def test_decode_width(self, d, width):
        assert tfa._decode_width(d) == width

    @pytest.mark.parametrize("d,itemsize,want", [
        (80, 4, 128),    # f32 rows of 128: K + V of 256 keys is 256 KB
        (80, 2, 256), (8, 4, 256), (256, 2, 128), (256, 4, 64)])
    def test_b4_split_at_padded_width(self, d, itemsize, want):
        assert tfa._decode_split_tokens(256, d, itemsize) == want

    @pytest.mark.parametrize("d,nb,elem,want", [
        (80, 0, 4, 128), (80, 5, 1, 256), (100, 0, 2, 256),
        (256, 0, 4, 64), (256, 4, 1, 256)])
    def test_b5_b6_split_at_padded_width(self, d, nb, elem, want):
        assert tfa._split_tokens(64, d, nb, elem) == want

    @pytest.mark.parametrize("d", DIMS)
    def test_b4_split_merge_matches_pallas(self, jax_ops, d):
        # B4's splits at the padded width's chunk, merged in split order,
        # against the plain version and the Pallas kernel in interpret
        # mode on both sides of a split boundary; a row of length 0 gives
        # 0, as the TPU kernel does
        _, jnp, jfa = jax_ops
        chunk = tfa._decode_split_tokens(256, d, 4) // 4  # several splits
        t_k = 2 * chunk + 7
        lengths = [0, 1, chunk - 1, chunk, chunk + 1, t_k]
        q, k, v = _rand(b=len(lengths), h=2, t=t_k, d=d, seed=d + 2, n=3)
        q = np.ascontiguousarray(q[:, :, 0])
        L = np.asarray(lengths, np.int32)
        scale = 1.0 / math.sqrt(d)
        got = _split_k_merge(*_t(q, k, v), torch.from_numpy(L), scale, chunk)
        ref = tfa._decode_attention_xla(*_t(q, k, v, L), scale)
        pallas = jfa.flash_decode_attention(
            *(jnp.asarray(x) for x in (q, k, v, L)), scale=scale,
            interpret=True, block_k=chunk)
        for want in (ref.numpy(), np.asarray(pallas)):
            np.testing.assert_allclose(got[1:].numpy(), want[1:], atol=ATOL)
        assert torch.equal(got[0], torch.zeros_like(got[0]))

    @pytest.mark.parametrize("d", [0, 257, 1024])
    def test_head_dim_limit_raises(self, d):
        with pytest.raises(ValueError, match="head_dim 1..256"):
            tfa._check_head_dim("flash_fwd", d)


class TestSmemEstimate:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_independent_of_sequence_length(self, dtype):
        # the counterpart of tests/test_ops/test_flash_attention.py:163-164:
        # the same bytes at T = 256 and 32768, under the card's 232448
        # bytes a block, for every head_dim the kernels take
        for d in range(1, tfa._MAX_HEAD_DIM + 1):
            short = tfa.estimate_smem_bytes(256, 256, d, dtype)
            long = tfa.estimate_smem_bytes(32768, 32768, d, dtype)
            assert short == long < 232448, (d, dtype, short, long)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
    def test_every_launch_within_the_card(self, kernel, dtype):
        # each kernel's launch on its route, at every head_dim 1..256,
        # takes at most the card's 232448 bytes a block; f32 B1 and B3
        # take one tile shape across 129..256
        sizes = {d: tfa._route_smem(kernel, d, dtype)
                 for d in range(1, tfa._MAX_HEAD_DIM + 1)}
        assert max(sizes.values()) <= 232448, (kernel, dtype, sizes)
        assert len({sizes[d] for d in range(129, 257)}) == 1
        for d, n in sizes.items():
            assert tfa.estimate_smem_bytes(1, 1, d, dtype) >= n

    @pytest.mark.parametrize("key", sorted(CARD_SMEM, key=str))
    def test_equals_the_cards_launches(self, key):
        dtype, d = key
        assert tfa.estimate_smem_bytes(1024, 1024, d, dtype) == CARD_SMEM[key]

    @pytest.mark.parametrize("kernel,d,dtype,route,smem", [
        # B1 bf16 at 64: Q, two stages of K and V tiles, five barriers
        ("fwd", 64, torch.bfloat16, ("sm90", 64),
         1024 + 128 * 64 * 2 + 2 * 2 * 128 * 64 * 2 + 8 * 5),
        # Cerebras-GPT-2.7B's 80 in bf16: two 64-column panels a row
        ("fwd", 80, torch.bfloat16, ("sm90", 80),
         1024 + 128 * 256 + 2 * 2 * 64 * 256 + 8 * 5),
        ("dkv", 80, torch.bfloat16, ("sm90", 80),
         1024 + 2 * 128 * 256 + 2 * (2 * 32 * 256 + 2 * 32 * 4) + 8 * 5),
        # in f32, three 32-column panels a row; V^T (and Q^T, dO^T) as 80
        # rows of 32 slots; B1 with two consumer warpgroups (Q's halves
        # for 128 queries), B3 keeps two stages at 80
        ("fwd", 80, torch.float32, ("tf32", 80),
         1024 + 2 * 128 * 384 + 2 * 32 * 384
         + 2 * (2 * 32 * 384 + 2 * 80 * 128) + 16 * 3),
        ("dkv", 80, torch.float32, ("tf32", 80),
         1024 + 4 * 64 * 384 + 2 * (4 * 16 * 384 + 4 * 80 * 128 + 2 * 16 * 4)
         + 8 * 8),
        # 40 at the width 64: half of the last k16 step is zeros
        ("fwd", 40, torch.bfloat16, ("sm90", 64),
         1024 + 128 * 128 + 2 * 2 * 128 * 128 + 8 * 5),
        ("dkv", 40, torch.float32, ("tf32", 64),
         1024 + 4 * 64 * 256 + 2 * (4 * 32 * 256 + 4 * 64 * 128 + 2 * 32 * 4)
         + 8 * 8),
        # 96 in f32: one stage of B3 with 32-query tiles (two stages pass
        # the card's 227 KB at either tile)
        ("dkv", 96, torch.float32, ("tf32", 96),
         1024 + 4 * 64 * 384 + 4 * 32 * 384 + 4 * 96 * 128 + 2 * 32 * 4
         + 8 * 5),
        # B2 at the same widths: Q and dO of 128 queries, two stages of K
        # and V tiles of 64 keys; in f32 one consumer warpgroup above 64
        # (64 queries, Q's halves in registers below 128), dO's halves
        # resident and two stages of K, V (their halves) and K^T (80 or
        # 96 rows of 32 slots) at 80 and 96
        ("dq", 80, torch.bfloat16, ("sm90", 80),
         1024 + 2 * 128 * 256 + 2 * 2 * 64 * 256 + 8 * 5),
        ("dq", 80, torch.float32, ("tf32", 80),
         1024 + 2 * 64 * 384 + 2 * (4 * 32 * 384 + 2 * 80 * 128) + 24 * 2),
        ("dq", 96, torch.float32, ("tf32", 96),
         1024 + 2 * 64 * 384 + 2 * (4 * 32 * 384 + 2 * 96 * 128) + 24 * 2),
        ("dq", 40, torch.bfloat16, ("sm90", 64),
         1024 + 2 * 128 * 128 + 2 * 2 * 64 * 128 + 8 * 5),
        # rows no TMA map takes (bf16 100 is 200 bytes, bf16 6 12): the
        # producer fills the same tiles, so the same shared memory
        ("fwd", 100, torch.bfloat16, ("sm90", 128),
         1024 + 128 * 256 + 2 * 2 * 64 * 256 + 8 * 5),
        ("dkv", 100, torch.float32, ("tf32", 128), 230568),
        ("dq", 100, torch.bfloat16, ("sm90", 128),
         1024 + 2 * 128 * 256 + 2 * 2 * 64 * 256 + 8 * 5),
        ("dkv", 8, torch.bfloat16, ("sm90", 64),
         1024 + 2 * 128 * 128 + 2 * (2 * 64 * 128 + 2 * 64 * 4) + 8 * 5),
        ("dkv", 6, torch.bfloat16, ("sm90", 64),
         1024 + 2 * 128 * 128 + 2 * (2 * 64 * 128 + 2 * 64 * 4) + 8 * 5),
        # above 128 in bf16: the width 256, B1 with 32-key tiles, B3's two
        # warpgroups on 64 keys (a half of the columns each), 16-query
        # tiles, B2 with 32-key tiles
        ("fwd", 256, torch.bfloat16, ("sm90", 256),
         1024 + 128 * 512 + 2 * 2 * 32 * 512 + 8 * 5),
        ("dkv", 129, torch.bfloat16, ("sm90", 256),
         1024 + 2 * 64 * 512 + 2 * (2 * 16 * 512 + 2 * 16 * 4) + 8 * 5),
        ("dq", 256, torch.bfloat16, ("sm90", 256),
         1024 + 2 * 128 * 512 + 2 * 2 * 32 * 512 + 8 * 5),
        # f32 B2 at 256: Q and dO raw (64 queries), K's and V's halves
        # (16 keys), the dS tile, P handed over
        ("dq", 129, torch.float32, ("tf32", 256),
         1024 + 2 * 64 * 1024 + 4 * 16 * 1024 + 64 * 128 + 128 * 8 * 4),
        # f32 B1 at 256: Q's halves for 64 queries, one stage of 16 keys
        # (K_hi and K_lo stacked, V^T_hi and V^T_lo as 256 rows of 128
        # bytes), no raw stage, four barriers
        ("fwd", 256, torch.float32, ("tf32", 256),
         1024 + 2 * 64 * 1024 + 2 * 16 * 1024 + 2 * 256 * 128 + 8 * 4),
        ("fwd", 129, torch.float32, ("tf32", 256),
         1024 + 2 * 64 * 1024 + 2 * 16 * 1024 + 2 * 256 * 128 + 8 * 4),
        # f32 B3 at 256: K and V raw (64 keys), Q's and dO's halves (16
        # queries), the P^T and dS^T tiles, P^T handed over, lse / delta
        ("dkv", 129, torch.float32, ("tf32", 256),
         1024 + 2 * 64 * 1024 + 4 * 16 * 1024 + 2 * 64 * 128 + 128 * 8 * 4
         + 2 * 16 * 4),
        ("dkv", 256, torch.float32, ("tf32", 256),
         1024 + 2 * 64 * 1024 + 4 * 16 * 1024 + 2 * 64 * 128 + 128 * 8 * 4
         + 2 * 16 * 4),
        ("dq", 256, torch.float32, ("tf32", 256),
         1024 + 2 * 64 * 1024 + 4 * 16 * 1024 + 64 * 128 + 128 * 8 * 4),
    ])
    def test_routes(self, kernel, d, dtype, route, smem):
        # each kernel's route and width at (d, dtype), and the dynamic
        # shared memory its launch passes there
        assert tfa._train_route(d, dtype) == route
        assert tfa._route_smem(kernel, d, dtype) == smem

    @pytest.mark.parametrize("d,dtype,width,tma", [
        (64, torch.bfloat16, 64, True), (128, torch.float32, 128, True),
        (8, torch.bfloat16, 64, True), (4, torch.float32, 64, True),
        (40, torch.bfloat16, 64, True), (72, torch.bfloat16, 80, True),
        (68, torch.float32, 80, True), (80, torch.bfloat16, 80, True),
        (80, torch.float32, 80, True), (88, torch.bfloat16, 96, True),
        (96, torch.float32, 96, True), (112, torch.bfloat16, 128, True),
        (124, torch.float32, 128, True),
        # rows no TMA map takes: the producer's own copies
        (100, torch.bfloat16, 128, False), (4, torch.bfloat16, 64, False),
        (66, torch.float32, 80, False), (1, torch.float32, 64, False),
        (127, torch.bfloat16, 128, False),
        # above 128: the width 256
        (136, torch.bfloat16, 256, True), (129, torch.bfloat16, 256, False),
        (256, torch.bfloat16, 256, True), (256, torch.float32, 256, True),
        (129, torch.float32, 256, False), (136, torch.float32, 256, True),
        (192, torch.float32, 256, True), (255, torch.float32, 256, False)])
    def test_tensor_core_width(self, d, dtype, width, tma):
        # csrc/flash_attn_common.cuh `tensor_core_width`: B1-B3's padded
        # width in either dtype, the smallest of 64, 80, 96, 128, 256 that
        # holds d; rows of d * itemsize bytes a multiple of 16 go through
        # TMA maps (or f32 B1-B3's 16-byte loads at 256)
        assert tfa._tc_width(d) == width
        assert tfa._tma_rows(d, dtype) == tma
        route = "tf32" if dtype == torch.float32 else "sm90"
        assert tfa._train_route(d, dtype) == (route, width)
        assert tfa.train_kernel_symbol("fwd", d, dtype) == \
            f"flash_fwd_{route}_kernel"
        assert tfa.train_kernel_symbol("dq", d, dtype) == \
            f"flash_bwd_dq_{route}_kernel"
        assert tfa.train_kernel_symbol("dkv", d, dtype) == \
            f"flash_bwd_dkv_{route}_kernel"

    def test_rejects_other_dtypes_and_widths(self):
        with pytest.raises(TypeError):
            tfa.estimate_smem_bytes(8, 8, 64, torch.float16)
        with pytest.raises(ValueError, match="head_dim"):
            tfa.estimate_smem_bytes(8, 8, 300, torch.float32)


# ------------------------------------- a session at Cerebras-GPT's head_dim

CEREBRAS_KW = dict(vocab=256, seq=64, dim=160, heads=2, layers=2)
N_NEW = 6
PROMPTS = [[3, 14, 15, 9, 2], [11, 5], list(range(1, 20))]


@pytest.fixture(scope="module")
def gpt80():
    jax = pytest.importorskip("jax")
    from easydist_tpu.models import gpt as jg
    from easydist_tpu_torch.models import gpt as tg

    cfg_j = jg.GPTConfig(**CEREBRAS_KW)
    params_j = jg.gpt_init(cfg_j, jax.random.PRNGKey(80))
    params_t = tg.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return jg, cfg_j, params_j, tg, tg.GPTConfig(**CEREBRAS_KW), params_t


def _jax_uncached_greedy(jg, cfg, params, prompt):
    import jax
    import jax.numpy as jnp

    apply = jax.jit(lambda p, t: jg.gpt_apply(p, cfg, t))
    cur, out = list(prompt), []
    for _ in range(N_NEW):
        logits = apply(params, jnp.asarray([cur], jnp.int32))
        nxt = int(jnp.argmax(logits[0, len(cur) - 1]))
        out.append(nxt)
        cur.append(nxt)
    return out


@pytest.mark.parametrize("layout", ["bucketed", "paged"])
def test_session_head_dim_80_ids_equal_jax_reforward(gpt80, layout):
    from easydist_tpu_torch.serve import GenerationSession, ServeConfig

    jg, cfg_j, params_j, tg, cfg_t, params_t = gpt80
    assert cfg_t.dim // cfg_t.heads == 80
    ref = [_jax_uncached_greedy(jg, cfg_j, params_j, p) for p in PROMPTS]
    kw = dict(kv_layout="paged", prefill_chunk=8) if layout == "paged" \
        else {}
    sess = GenerationSession.for_gpt(
        params_t, cfg_t, device="cpu", compile_key=None,
        config=ServeConfig(decode_buckets=(cfg_t.seq,), max_decode_slots=2,
                           **kw))
    futs = [sess.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    sess.run_until_drained()
    assert [f.result(timeout=5)["ids"] for f in futs] == ref


def test_decode_step_head_dim_80_matches_jax(gpt80):
    import jax
    import jax.numpy as jnp

    jg, cfg_j, params_j, tg, cfg_t, params_t = gpt80
    rs = np.random.RandomState(81)
    shape = (cfg_j.layers, 2, cfg_j.heads, cfg_j.seq, 80)
    k, v = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    token = np.asarray([5, 77], np.int32)
    pos = np.asarray([0, 40], np.int32)
    ref_cache, ref_logits = jax.jit(
        lambda pr, c, t, q: jg.gpt_decode_step(pr, cfg_j, c, t, q))(
        params_j, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(token), jnp.asarray(pos))
    cache, logits = tg.gpt_decode_step(
        params_t, cfg_t, {"k": torch.from_numpy(k.copy()),
                          "v": torch.from_numpy(v.copy())},
        torch.from_numpy(token), torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               **FWD)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), **FWD)
