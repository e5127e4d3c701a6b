"""Port paged decode ops and KV bookkeeping against the JAX package:
`gather_pages` (sentinel clip, GQA repeat after the gather) and
`kv_quantize`/`kv_dequantize` bitwise; the plain paged versions against
the JAX Pallas kernels B5/B6 in interpret mode; dispatch rules; the
`PagePool`/`PageTable` copies and `audit_page_table` against the JAX
package's KV001 audit; a plain emulation of B5's and B6's split-K merge
(`_split_k_merge`, B4's, over the gathered cache) against the plain
versions; the grouped route's host plan (route, query heads a block,
split tokens, shared memory) at every head_dim and a numpy emulation of
its schedule (query-head chunks, ring tiles, per-split softmax,
fixed-order merge) against the JAX Pallas kernels; and — on a CUDA host —
the CUDA kernels against the plain versions.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: atol 1e-5 in float32 (the bar of
tests/test_ops/test_paged_decode_attention.py)."""

import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from easydist_tpu_torch.kv import PagePool, PageTable, audit_page_table
from easydist_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_flash_decode import _split_k_merge

ATOL = 1e-5
PT, MP, NP = 8, 4, 16   # page tokens, max pages per row, arena pages


@pytest.fixture(scope="module")
def jax_ops():
    """(jax.numpy, the JAX package's ops/flash_attention module), imported
    here so the card's tests collect on a host without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    return jnp, importlib.import_module("easydist_tpu.ops.flash_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _paged(lengths, h=4, kvh=4, d=16, seed=0, pt=PT, mp=MP, n_pages=NP,
           dead=()):
    """q [b, h, d], K/V arenas [n_pages, kvh, pt, d] and a table mapping
    each row's live windows to pages of a shuffled permutation (sentinel
    `n_pages` elsewhere, and on the `dead` rows), all numpy."""
    rs = np.random.RandomState(seed)
    b = len(lengths)
    perm = rs.permutation(n_pages)
    table = np.full((b, mp), n_pages, np.int32)
    for i, n in enumerate(lengths):
        if i not in dead:
            live = -(-n // pt)
            table[i, :live] = perm[i * mp:i * mp + live]
    q = rs.standard_normal((b, h, d)).astype(np.float32)
    k = rs.standard_normal((n_pages, kvh, pt, d)).astype(np.float32)
    v = rs.standard_normal((n_pages, kvh, pt, d)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


class TestGatherPages:
    @pytest.mark.parametrize("kvh,h", [(4, None), (2, 4), (1, 4)])
    def test_bitwise_vs_jax_with_sentinels(self, jax_ops, kvh, h):
        jnp, jfa = jax_ops
        _, k, _, table, _ = _paged([32, 17, 1], kvh=kvh, dead=(2,))
        got = tfa.gather_pages(*_t(k, table), n_heads=h)
        ref = jfa.gather_pages(jnp.asarray(k), jnp.asarray(table),
                               n_heads=h)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_sentinel_clips_to_last_page(self):
        _, k, _, table, _ = _paged([8])
        got = tfa.gather_pages(*_t(k, table))
        np.testing.assert_array_equal(got[0, :, PT:2 * PT].numpy(),
                                      k[NP - 1])

    def test_heads_not_multiple_of_kv_heads_raises(self):
        _, k, _, table, _ = _paged([8], kvh=3)
        with pytest.raises(ValueError, match="not a multiple of kv_heads"):
            tfa.gather_pages(*_t(k, table), n_heads=4)


class TestQuant:
    @pytest.mark.parametrize("nb", [1, 2, 4])
    def test_bitwise_vs_jax(self, jax_ops, nb):
        jnp, jfa = jax_ops
        rs = np.random.RandomState(nb)
        x = rs.standard_normal((3, 5, 16)).astype(np.float32)
        # exact half-integer multiples of a block's step: rint's ties
        x[0, 0] = np.arange(16, dtype=np.float32) - 7.5
        x[0, 1] = 0.0                                   # an all-zero row
        q, s = tfa.kv_quantize(torch.from_numpy(x), nb)
        jq, js = jfa.kv_quantize(jnp.asarray(x), nb)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(s.shape) == (3, 5, nb)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tfa.kv_dequantize(q, s).numpy(),
            np.asarray(jfa.kv_dequantize(jq, js)))
        # round trip within half a step per element; zero rows exact
        err = (tfa.kv_dequantize(q, s) - torch.from_numpy(x)).abs()
        assert bool((err <= s.repeat_interleave(16 // nb, -1) * 0.5
                     + 1e-6).all())
        assert bool((s[0, 1] == 1.0).all())

    def test_dequantize_dtype_and_bad_blocks(self):
        q, s = tfa.kv_quantize(torch.ones(2, 8), 2)
        assert tfa.kv_dequantize(q, s, torch.bfloat16).dtype == \
            torch.bfloat16
        with pytest.raises(ValueError, match="not a multiple"):
            tfa.kv_quantize(torch.zeros(2, 8), 3)


class TestPlainVsJaxKernels:
    @pytest.mark.parametrize("lengths,kvh", [([32, 17], 4), ([1, 8], 4),
                                             ([9, 25], 4), ([25, 10], 2),
                                             ([32, 1], 1)])
    def test_b5_plain_matches_pallas_interpret(self, jax_ops, lengths, kvh):
        jnp, jfa = jax_ops
        q, k, v, table, L = _paged(lengths, kvh=kvh)
        scale = 1.0 / np.sqrt(q.shape[-1])
        ref = jfa.flash_paged_decode_attention(
            *(jnp.asarray(x) for x in (q, k, v, table, L)), scale=scale,
            interpret=True)
        out = tfa._paged_decode_attention_xla(*_t(q, k, v, table, L), scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("nb,kvh", [(1, 4), (4, 4), (2, 2)])
    def test_b6_plain_matches_pallas_interpret(self, jax_ops, nb, kvh):
        jnp, jfa = jax_ops
        q, k, v, table, L = _paged([29, 6], kvh=kvh, seed=nb)
        kq, ks = (x.numpy() for x in tfa.kv_quantize(torch.from_numpy(k),
                                                     nb))
        vq, vs = (x.numpy() for x in tfa.kv_quantize(torch.from_numpy(v),
                                                     nb))
        ref = jfa.flash_paged_decode_quant_attention(
            *(jnp.asarray(x) for x in (q, kq, vq, ks, vs, table, L)),
            scale=0.25, interpret=True)
        out = tfa._paged_decode_attention_quant_xla(
            *_t(q, kq, vq, ks, vs, table, L), 0.25)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_b5_plain_matches_jax_xla(self, jax_ops):
        jnp, jfa = jax_ops
        q, k, v, table, L = _paged([32, 17, 1], kvh=2, dead=(2,))
        ref = jfa._paged_decode_attention_xla(
            *(jnp.asarray(x) for x in (q, k, v, table, L)), 0.25)
        out = tfa._paged_decode_attention_xla(*_t(q, k, v, table, L), 0.25)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    def test_garbage_pages_unobservable(self):
        q, k, v, table, L = _paged([17, 9])
        base = tfa._paged_decode_attention_xla(*_t(q, k, v, table, L), 0.25)
        mapped = {int(p) for p in table.ravel() if p < NP}
        for pid in set(range(NP)) - mapped:
            k[pid], v[pid] = 1e4, -1e4
        noisy = tfa._paged_decode_attention_xla(*_t(q, k, v, table, L),
                                                0.25)
        assert torch.equal(base, noisy)


def _split_k_emulated(q, kq, vq, ks, vs, table, lengths, scale: float,
                      chunk: int):
    """B6's split-K in plain torch: the int8 pages and their scales
    gathered and dequantized, then `_split_k_merge`."""
    h = q.shape[1]
    kf, vf = (tfa.kv_dequantize(tfa.gather_pages(x, table, n_heads=h),
                                tfa.gather_pages(sc, table, n_heads=h))
              for x, sc in ((kq, ks), (vq, vs)))
    return _split_k_merge(q, kf, vf, lengths, scale, chunk)


class TestSplitK:
    """B5 and B6 cut each row's keys into splits of `_split_tokens`
    tokens, one block each, and merge the splits' partials in split
    order.  Emulated at the serving page size, the merge equals the plain
    version at the f32 bar on both sides of a split boundary, on a dead
    all-sentinel row and under GQA, over int8 (B6) and f32 or bf16 (B5)
    pages; a row of length 0 gives 0, as the TPU kernels do (the plain
    version gives mean(v) there)."""

    @pytest.mark.parametrize("nb,h,kvh", [(1, 4, 4), (4, 4, 4), (1, 12, 4),
                                          (4, 12, 4)])
    def test_merge_matches_plain(self, nb, h, kvh):
        pt, mp = 64, 8
        chunk = tfa._split_tokens(pt, 64, nb)
        assert chunk == 256
        lengths = [0, 1, chunk - 1, chunk, chunk + 1, mp * pt, 1]
        q, k, v, table, L = _t(*_paged(lengths, h=h, kvh=kvh, d=64, pt=pt,
                                       mp=mp, n_pages=len(lengths) * mp,
                                       dead=(6,)))
        kq, ks = tfa.kv_quantize(k, nb)
        vq, vs = tfa.kv_quantize(v, nb)
        got = _split_k_emulated(q, kq, vq, ks, vs, table, L, 0.125, chunk)
        ref = tfa._paged_decode_attention_quant_xla(q, kq, vq, ks, vs, table,
                                                    L, 0.125)
        np.testing.assert_allclose(got[1:].numpy(), ref[1:].numpy(),
                                   atol=ATOL)
        assert torch.equal(got[0], torch.zeros_like(got[0]))

    @pytest.mark.parametrize("pt,d,nb,want", [
        (64, 64, 1, 256), (64, 128, 4, 256), (16, 64, 1, 256),
        (48, 64, 1, 240), (1024, 64, 1, 256), (64, 128, 128, 128)])
    def test_split_tokens(self, pt, d, nb, want):
        # whole pages up to 256 tokens; 256 of a longer page; halved until
        # a split fits the shared-memory budget
        assert tfa._split_tokens(pt, d, nb) == want

    @pytest.mark.parametrize("dtype,d,h,kvh", [
        (torch.float32, 64, 4, 4), (torch.bfloat16, 64, 12, 4),
        (torch.float32, 128, 12, 4), (torch.bfloat16, 128, 4, 4)])
    def test_exact_pages_merge_matches_plain(self, dtype, d, h, kvh):
        # B5: splits of 256 tokens, of 128 for f32 pages at head_dim 128
        pt, mp = 64, 8
        chunk = tfa._split_tokens(pt, d, 0, dtype.itemsize)
        assert chunk == (128 if (dtype, d) == (torch.float32, 128) else 256)
        lengths = [0, 1, chunk - 1, chunk, chunk + 1, mp * pt, 1]
        q, k, v, table, L = _t(*_paged(lengths, h=h, kvh=kvh, d=d, pt=pt,
                                       mp=mp, n_pages=len(lengths) * mp,
                                       dead=(6,)))
        k, v = k.to(dtype), v.to(dtype)
        scale = 1.0 / np.sqrt(d)
        kf, vf = (tfa.gather_pages(x.float(), table, n_heads=h)
                  for x in (k, v))
        got = _split_k_merge(q, kf, vf, L, scale, chunk)
        ref = tfa._paged_decode_attention_xla(q, k, v, table, L, scale)
        np.testing.assert_allclose(got[1:].numpy(), ref[1:].numpy(),
                                   atol=ATOL)
        assert torch.equal(got[0], torch.zeros_like(got[0]))

    @pytest.mark.parametrize("pt,d,elem,want", [
        (64, 64, 2, 256), (64, 128, 2, 256), (64, 64, 4, 256),
        (64, 128, 4, 128), (48, 128, 4, 96), (16, 128, 4, 128),
        (1024, 128, 4, 128)])
    def test_split_tokens_wide_elements(self, pt, d, elem, want):
        # B5's bf16 (2-byte) and f32 (4-byte) pages, no scales: f32 K + V
        # of 256 keys at head_dim 128 would take 256 KB, so 128
        assert tfa._split_tokens(pt, d, 0, elem) == want


# the card's limits a block: dynamic shared memory the launcher takes
# (decode_split.cuh's kSmemLimit), and a bound on the grouped body's
# static arrays (red_s, ml_s, last_s: at most 8 * 8 + 2 * 8 floats and
# an int)
SMEM_LIMIT = 227 * 1024 - 4 * 1024
GROUP_STATIC_BYTES = 4 * (8 * 8 + 2 * 8 + 1)
# shared memory of one SM of an H100, and what the card reserves a block
SM_SMEM_BYTES = 228 * 1024
SM_BLOCK_RESERVED = 1024
GROUPS = (1, 2, 3, 4, 7, 8, 16)
# (elem bytes of the pages, n_blocks): B5's f32 and bf16 pages (either q),
# B6's int8 pages at one scale a row and at 4
PAGE_KINDS = ((4, 0), (2, 0), (1, 1), (1, 4))


class TestGroupedRoute:
    """The grouped route's host plan (`_paged_route`, `_group_heads_tile`,
    `_group_split_tokens`, `_group_tile_keys`, `_group_smem_bytes`; the C
    side's `group_launch` mirrors them, on the constants that
    `test_constants_are_the_headers` holds equal) at every head_dim 1..256, every page kind and the groups of
    `GROUPS`: G = 1 keeps the split body and its chunk, G >= 2 takes the
    least of 2, 4, 8 query heads a block that holds the group (8 and
    several chunks past it), whole-page splits up to 256 tokens, a slot
    of at most `_GROUP_SLOT_BYTES`, and every launch under the card's
    limit."""

    @pytest.mark.parametrize("name,c_name", [
        ("_GROUP_STAGES", "kGroupStages"),
        ("_GROUP_SLOT_BYTES", "kGroupSlotBytes"),
        ("_GROUP_MAX_TILE", "kGroupMaxTile"),
        ("_GROUP_MIN_TILE", "kGroupMinTile"),
        ("_GROUP_THREADS", "kGThreads")])
    def test_constants_are_the_headers(self, name, c_name):
        header = (Path(tfa.__file__).parent / "csrc"
                  / "decode_group.cuh").read_text()
        m = re.search(rf"constexpr int {c_name} = ([0-9* ]+);", header)
        assert m, c_name
        assert getattr(tfa, name) == math.prod(
            int(x) for x in m.group(1).split("*"))

    @pytest.mark.parametrize("group", GROUPS)
    def test_plan_at_every_head_dim(self, group):
        kvh = 2
        heads = group * kvh
        route = tfa._paged_route(heads, kvh)
        assert route == ("split" if group == 1 else "group")
        assert tfa.paged_kernel_symbol(heads, kvh, False) == (
            "paged_decode_kernel" if group == 1
            else "paged_decode_group_kernel")
        assert tfa.paged_kernel_symbol(heads, kvh, True) == (
            "paged_decode_quant_kernel" if group == 1
            else "paged_decode_quant_group_kernel")
        gt = tfa._group_heads_tile(group)
        assert gt == min(g for g in (2, 4, 8) if g >= min(group, 8))
        chunks = -(-group // gt)
        assert gt * chunks - group < gt    # masked rows: fewer than a chunk
        for pt in (1, 8, 48, 64, 300):
            chunk = tfa._group_split_tokens(pt)
            assert chunk == (256 // pt * pt if pt <= 256 else 256)
            for d in range(1, 257):
                for elem, nb in PAGE_KINDS:
                    if nb and d % nb:
                        continue
                    want = tfa._split_tokens(pt, d, nb, elem)
                    got = tfa._paged_chunk(pt, d, nb, elem, heads, kvh)
                    assert got == (want if group == 1 else chunk)
                    tile = tfa._group_tile_keys(d, elem, nb)
                    per_key = tfa._decode_width(d) * elem + 4 * nb
                    assert 8 <= tile <= 256 and tile & (tile - 1) == 0
                    slot = tfa._GROUP_SLOT_BYTES
                    assert tile == 8 or tile * per_key <= slot
                    assert tile == 256 or 2 * tile * per_key > slot
                    smem = tfa._group_smem_bytes(d, elem, nb, group, chunk)
                    assert smem % 16 == 0
                    assert smem + GROUP_STATIC_BYTES < SMEM_LIMIT

    @pytest.mark.parametrize("heads,kvh,d,elem,nb,blocks_sm", [
        (32, 8, 128, 2, 0, 3), (32, 8, 128, 4, 0, 3), (32, 8, 128, 1, 1, 5),
        (28, 4, 128, 2, 0, 3), (64, 8, 128, 2, 0, 3), (8, 2, 80, 2, 0, 3)])
    def test_blocks_an_sm(self, heads, kvh, d, elem, nb, blocks_sm):
        # Llama-3-8B's shape (32 / 8, pages of 64 tokens) holds at least
        # two grouped blocks an SM, so one block's copies overlap another's
        # arithmetic; the split body held one (134 KB a bf16 split)
        chunk = tfa._paged_chunk(64, d, nb, elem, heads, kvh)
        assert chunk == 256
        per_block = (tfa._group_smem_bytes(d, elem, nb, heads // kvh, chunk)
                     + GROUP_STATIC_BYTES + SM_BLOCK_RESERVED)
        assert SM_SMEM_BYTES // per_block >= blocks_sm >= 2
        if (heads, kvh, d, elem) == (32, 8, 128, 2) and nb == 0:
            # the split body's bf16 split: arena rows, K, V and scores of
            # 256 keys (decode_split.cuh's `split_smem`)
            split = 8 * 256 + 2 * 256 * d * elem + 4 * 256
            assert SM_SMEM_BYTES // (split + SM_BLOCK_RESERVED) == 1


def _grouped_emulated(q, k, v, table, lengths, scale: float, ks=None,
                      vs=None):
    """The grouped route's schedule in numpy f32: for each row, KV head
    and chunk of `_group_heads_tile(G)` query heads (rows past G masked),
    the row's live keys in splits of `_group_split_tokens(pt)`; in a
    split, scores a ring tile (`_group_tile_keys`) at a time, the split's
    max, exp and sum once every tile is scored, P.V a tile at a time; then
    the splits merged in split order with the 1e-30 clamp; a row of length
    0 gives 0.  With int8 pages, `ks`/`vs` are their scales (each element
    dequantized by its block's scale)."""
    b, h, d = q.shape
    n_pages, kvh, pt, _ = k.shape
    group = h // kvh
    gt = tfa._group_heads_tile(group)
    chunk = tfa._group_split_tokens(pt)
    quant = ks is not None
    nb = ks.shape[3] if quant else 0
    tile = tfa._group_tile_keys(d, 1 if quant else k.dtype.itemsize, nb)

    def rows(x, sc, bi, kh, pos):
        page = np.clip(table[bi, pos // pt], 0, n_pages - 1)
        r = x[page, kh, pos % pt].astype(np.float32)        # [n, d]
        if quant:
            r = (r.reshape(len(pos), nb, d // nb)
                 * sc[page, kh, pos % pt][..., None]).reshape(len(pos), d)
        return r

    out = np.zeros((b, h, d), np.float32)
    for bi in range(b):
        n_len = max(0, min(int(lengths[bi]), table.shape[1] * pt))
        for kh in range(kvh):
            for c in range(-(-group // gt)):
                heads = [kh * group + c * gt + g for g in range(gt)
                         if c * gt + g < group]
                qs = q[bi, heads].astype(np.float32) * np.float32(scale)
                parts = []
                for c0 in range(0, n_len, chunk):
                    pos = np.arange(c0, min(c0 + chunk, n_len))
                    kr, vr = rows(k, ks, bi, kh, pos), rows(v, vs, bi, kh,
                                                            pos)
                    s = np.concatenate([kr[j:j + tile] @ qs.T
                                        for j in range(0, len(pos), tile)])
                    m = s.max(axis=0)
                    p = np.exp(s - m)
                    acc = np.zeros((len(heads), d), np.float32)
                    for j in range(0, len(pos), tile):     # tile order
                        acc += p[j:j + tile].T @ vr[j:j + tile]
                    parts.append((m, p.sum(axis=0), acc))
                if not parts:
                    continue
                top = np.max([m for m, _, _ in parts], axis=0)
                den = np.zeros(len(heads), np.float32)
                acc = np.zeros((len(heads), d), np.float32)
                for m, l, a in parts:                       # split order
                    w = np.exp(m - top)
                    den += l * w
                    acc += a * w[:, None]
                out[bi, heads] = acc / np.maximum(den, 1e-30)[:, None]
    return out


class TestGroupedSchedule:
    """The grouped route's schedule, emulated in numpy, against the JAX
    package's B5 and B6 run in interpret mode at 32 / 8 (d 128), 12 / 4,
    28 / 4 and 8 / 1 (d 80): rows of length 0, a dead all-sentinel row,
    a page boundary and both sides of the 256-token split, at the f32 bar
    (atol 1e-5, tests/test_ops/test_paged_decode_attention.py:132).  Row
    0 gives 0 in both."""

    CASES = [(32, 8, 128), (12, 4, 64), (28, 4, 128), (8, 1, 80)]

    @staticmethod
    def _inputs(h, kvh, d, seed):
        pt, mp = 64, 5
        chunk = tfa._group_split_tokens(pt)
        lengths = [0, 1, pt + 1, chunk, chunk + 1]
        return _paged(lengths, h=h, kvh=kvh, d=d, seed=seed, pt=pt, mp=mp,
                      n_pages=len(lengths) * mp, dead=(1,))

    @pytest.mark.parametrize("h,kvh,d", CASES)
    def test_b5_matches_pallas_interpret(self, jax_ops, h, kvh, d):
        jnp, jfa = jax_ops
        q, k, v, table, L = self._inputs(h, kvh, d, seed=h + d)
        scale = 1.0 / math.sqrt(d)
        ref = jfa.flash_paged_decode_attention(
            *(jnp.asarray(x) for x in (q, k, v, table, L)), scale=scale,
            interpret=True)
        got = _grouped_emulated(q, k, v, table, L, scale)
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
        assert not got[0].any()

    @pytest.mark.parametrize("h,kvh,d", CASES)
    def test_b6_matches_pallas_interpret(self, jax_ops, h, kvh, d):
        jnp, jfa = jax_ops
        q, k, v, table, L = self._inputs(h, kvh, d, seed=h + d + 1)
        nb = 4 if d % 4 == 0 else 1
        kq, ks = (x.numpy() for x in tfa.kv_quantize(torch.from_numpy(k),
                                                     nb))
        vq, vs = (x.numpy() for x in tfa.kv_quantize(torch.from_numpy(v),
                                                     nb))
        scale = 1.0 / math.sqrt(d)
        ref = jfa.flash_paged_decode_quant_attention(
            *(jnp.asarray(x) for x in (q, kq, vq, ks, vs, table, L)),
            scale=scale, interpret=True)
        got = _grouped_emulated(q, kq, vq, table, L, scale, ks=ks, vs=vs)
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
        assert not got[0].any()


class TestDispatch:
    def test_auto_on_cpu_runs_plain_version(self):
        q, k, v, table, L = _t(*_paged([32, 17]))
        before = tfa.flash_paged_decode_attention.launches
        out = tfa.paged_decode_attention(q, k, v, table, L)
        assert torch.equal(out, tfa._paged_decode_attention_xla(
            q, k, v, table, L, 0.25))
        assert tfa.flash_paged_decode_attention.launches == before

    def test_auto_quant_on_cpu_runs_plain_version(self):
        q, k, v, table, L = _t(*_paged([32, 17]))
        kq, ks = tfa.kv_quantize(k, 2)
        vq, vs = tfa.kv_quantize(v, 2)
        before = tfa.flash_paged_decode_quant_attention.launches
        out = tfa.paged_decode_attention(q, kq, vq, table, L, k_scale=ks,
                                         v_scale=vs, backend="xla")
        assert torch.equal(out, tfa._paged_decode_attention_quant_xla(
            q, kq, vq, ks, vs, table, L, 0.25))
        assert tfa.flash_paged_decode_quant_attention.launches == before

    @pytest.mark.parametrize("backend", ["paged", "flash"])
    def test_kernel_backends_on_cpu_tensor_raise(self, backend):
        q, k, v, table, L = _t(*_paged([32, 17]))
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tfa.paged_decode_attention(q, k, v, table, L, backend=backend)
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tfa.flash_paged_decode_quant_attention(q, k, v, k[..., :1],
                                                   v[..., :1], table, L)

    def test_custom_ops_on_cpu_tensors_run_plain_versions(self):
        q, k, v, table, L = _t(*_paged([32, 17]))
        kq, ks = tfa.kv_quantize(k, 1)
        vq, vs = tfa.kv_quantize(v, 1)
        before = (tfa.flash_paged_decode_attention.launches,
                  tfa.flash_paged_decode_quant_attention.launches)
        ops = torch.ops.easydist_tpu_torch
        assert torch.equal(ops.paged_decode(q, k, v, table, L, 0.25),
                           tfa._paged_decode_attention_xla(q, k, v, table,
                                                           L, 0.25))
        assert torch.equal(
            ops.paged_decode_quant(q, kq, vq, ks, vs, table, L, 0.25),
            tfa._paged_decode_attention_quant_xla(q, kq, vq, ks, vs, table,
                                                  L, 0.25))
        assert (tfa.flash_paged_decode_attention.launches,
                tfa.flash_paged_decode_quant_attention.launches) == before

    def test_scalar_length_broadcasts(self):
        q, k, v, table, _ = _t(*_paged([32, 32]))
        out = tfa.paged_decode_attention(q, k, v, table, 7)
        ref = tfa._paged_decode_attention_xla(q, k, v, table,
                                              torch.tensor([7, 7]), 0.25)
        assert torch.equal(out, ref)

    def test_argument_errors(self):
        q, k, v, table, L = _t(*_paged([32, 17]))
        with pytest.raises(ValueError, match="given together"):
            tfa.paged_decode_attention(q, k, v, table, L, k_scale=k)
        with pytest.raises(ValueError, match="paged decode attention "
                                             "backend"):
            tfa.paged_decode_attention(q, k, v, table, L, backend="ring")
        q3, k3, v3, t3, L3 = _t(*_paged([32, 17], kvh=3))
        with pytest.raises(ValueError, match="not a multiple of kv_heads"):
            tfa.flash_paged_decode_attention(q3, k3, v3, t3, L3)

    def test_contiguous_dispatcher_degrades_paged_to_auto(self, jax_ops):
        # the JAX package's rule (ops/flash_attention.py:535-538): there is
        # no table to chase, so "paged" means auto for contiguous callers
        rs = np.random.RandomState(0)
        q = torch.from_numpy(rs.standard_normal((2, 4, 16)).astype(
            np.float32))
        k, v = (torch.from_numpy(rs.standard_normal((2, 4, 32, 16)).astype(
            np.float32)) for _ in range(2))
        L = torch.tensor([5, 32])
        out = tfa.decode_attention(q, k, v, L, backend="paged")
        assert torch.equal(out, tfa.decode_attention(q, k, v, L,
                                                     backend="auto"))


class TestKvBookkeeping:
    def test_pool_alloc_share_release(self):
        pool = PagePool(4, 8, page_bytes=100)
        assert pool.sentinel == 4
        a, b = pool.alloc(), pool.alloc()
        assert (a, b) == (0, 1) and pool.in_use == 2
        assert pool.share(a) == 2 and pool.release(a) == 1
        assert pool.release(a) == 0 and pool.n_free == 3
        assert pool.alloc() == a                # LIFO reuse
        assert pool.ensure_exclusive(b) is None
        pool.share(b)
        fresh = pool.ensure_exclusive(b)
        assert fresh not in (a, b) and pool.refcount(b) == 1
        with pytest.raises(ValueError, match="use-after-free"):
            pool.release(3 if fresh != 3 else 2)
        assert pool.check_invariants() == []
        assert pool.stats()["peak_in_use"] == 3

    def test_pool_exhaustion_raises(self):
        pool = PagePool(1, 8)
        pool.alloc()
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.alloc()

    def test_table_map_unmap_and_holes(self):
        table = PageTable(2, 4, 8)
        table.map(0, 0, 5)
        table.map(0, 1, 6)
        with pytest.raises(ValueError, match="already maps"):
            table.map(0, 1, 7)
        assert table.mapped(0) == [5, 6] and table.n_mapped(0) == 2
        table.map(1, 2, 3)                      # a hole before window 2
        assert any("hole" in p for p in table.check_invariants())
        assert table.unmap_tail(1, 0) == [3]
        assert table.unmap_row(0) == [5, 6]
        assert table.check_invariants() == []

    @pytest.mark.parametrize("fault", ["clean", "under_counted", "freed",
                                       "leak"])
    def test_audit_matches_jax_kv001(self, fault):
        from easydist_tpu.analyze import kv_rules
        from easydist_tpu.kv import PagePool as JPool
        from easydist_tpu.kv import PageTable as JTable

        found = []
        for pool_cls, table_cls, audit in (
                (PagePool, PageTable, audit_page_table),
                (JPool, JTable, kv_rules.audit_page_table)):
            pool, table = pool_cls(6, 8, page_bytes=64), table_cls(3, 4, 6)
            for slot in range(2):
                for j in range(2):
                    table.map(slot, j, pool.alloc())
            if fault == "under_counted":
                table.map(2, 0, table.mapped(0)[0])  # shared, no share()
            elif fault == "freed":
                pool.release(table.mapped(1)[1])     # freed under slot 1
            elif fault == "leak":
                pool._refcount[5] = -1
            found.append(audit(pool, table))
        port, jax_findings = found
        assert len(port) == len(jax_findings)
        assert (port == []) == (fault == "clean")
        assert port == [f.message for f in jax_findings]


def _b6_reference(q, kq, vq, ks, vs, table, lengths):
    """The plain B6 in f32 on the same inputs, with 0 on rows of length
    0 (the kernel's and the TPU kernel's answer there)."""
    ref = tfa._paged_decode_attention_quant_xla(
        q.float(), kq, vq, ks, vs, table, lengths,
        1.0 / np.sqrt(q.shape[-1]))
    ref[lengths == 0] = 0.0
    return ref


def _b5_reference(q, k, v, table, lengths):
    """The plain B5 in f32 on the same inputs, with 0 on rows of length
    0."""
    ref = tfa._paged_decode_attention_xla(q.float(), k.float(), v.float(),
                                          table, lengths,
                                          1.0 / np.sqrt(q.shape[-1]))
    ref[lengths == 0] = 0.0
    return ref


def _b6_close(q, out, ref) -> bool:
    """Within atol 1e-5, plus half an ulp (2^-8 |ref|) of a bf16
    output."""
    tol = ATOL if q.dtype == torch.float32 else 2.0 ** -8 * ref.abs() + ATOL
    return bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                        (torch.bfloat16, torch.bfloat16),
                                        (torch.float32, torch.bfloat16)])
    @pytest.mark.parametrize("kvh,d", [(12, 64), (4, 64), (12, 128)])
    def test_b5_matches_plain(self, cuda_device, dtypes, kvh, d):
        q_dt, kv_dt = dtypes
        lengths = [1, 1, 63, 64, 65, 300, 700, 1024]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=12, kvh=kvh, d=d, pt=64, mp=16, n_pages=144,
            dead=(0,))))
        q, k, v = q.to(q_dt), k.to(kv_dt), v.to(kv_dt)
        before = tfa.flash_paged_decode_attention.launches
        out = tfa.paged_decode_attention(q, k, v, table, L)
        torch.cuda.synchronize()
        assert tfa.flash_paged_decode_attention.launches == before + 1
        ref = tfa._paged_decode_attention_xla(q.float(), k.float(),
                                              v.float(), table, L,
                                              1.0 / np.sqrt(d))
        tol = ATOL if q_dt == torch.float32 else \
            2.0 ** -8 * ref.abs() + ATOL
        assert bool(((out.float() - ref).abs() <= tol).all())

    @pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nb,kvh", [(1, 12), (4, 12), (4, 4)])
    def test_b6_matches_plain(self, cuda_device, q_dt, nb, kvh):
        # lengths on both sides of the 256-token split boundaries, and an
        # empty row
        lengths = [1, 0, 63, 64, 65, 255, 256, 257, 300, 511, 513, 700,
                   1024]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=12, kvh=kvh, d=64, pt=64, mp=16,
            n_pages=16 * len(lengths), dead=(0,))))
        kq, ks = tfa.kv_quantize(k, nb)
        vq, vs = tfa.kv_quantize(v, nb)
        q = q.to(q_dt)
        before = tfa.flash_paged_decode_quant_attention.launches
        out = tfa.paged_decode_attention(q, kq, vq, table, L, k_scale=ks,
                                         v_scale=vs)
        torch.cuda.synchronize()
        assert tfa.flash_paged_decode_quant_attention.launches == before + 1
        assert _b6_close(q, out, _b6_reference(q, kq, vq, ks, vs, table, L))

    def test_b6_is_deterministic_and_leaves_no_stale_counters(self,
                                                              cuda_device):
        # split boundaries depend on the length alone and the merge order
        # is fixed: two launches are bitwise equal.  Each launch resets the
        # counters it used, so calls with other lengths stay right.
        lengths = [1024, 700, 257, 256, 0, 513, 1, 900]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=12, kvh=12, d=64, pt=64, mp=16, n_pages=128)))
        kq, ks = tfa.kv_quantize(k, 1)
        vq, vs = tfa.kv_quantize(v, 1)
        first = tfa.flash_paged_decode_quant_attention(q, kq, vq, ks, vs,
                                                       table, L)
        for lens in (lengths, [300, 1, 1024, 0, 64, 511, 257, 700],
                     [0] * 8, lengths):
            L2 = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
            out = tfa.flash_paged_decode_quant_attention(q, kq, vq, ks, vs,
                                                         table, L2)
            torch.cuda.synchronize()
            assert _b6_close(q, out, _b6_reference(q, kq, vq, ks, vs,
                                                   table, L2))
            assert all(int(c.abs().sum()) == 0
                       for c in tfa._SPLIT_COUNTERS.values())
        assert torch.equal(out, first)

    @pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                        (torch.bfloat16, torch.bfloat16),
                                        (torch.float32, torch.bfloat16)])
    @pytest.mark.parametrize("d", [64, 128])
    def test_b5_at_split_boundaries(self, cuda_device, dtypes, d):
        # lengths on both sides of the 256- and 128-token split
        # boundaries, an empty row and a dead all-sentinel row, GQA 12/4
        q_dt, kv_dt = dtypes
        lengths = [1, 0, 127, 128, 129, 255, 256, 257, 511, 513, 1024]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=12, kvh=4, d=d, pt=64, mp=16,
            n_pages=16 * len(lengths), dead=(0,))))
        q, k, v = q.to(q_dt), k.to(kv_dt), v.to(kv_dt)
        out = tfa.flash_paged_decode_attention(q, k, v, table, L)
        torch.cuda.synchronize()
        assert _b6_close(q, out, _b5_reference(q, k, v, table, L))

    @pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                         (torch.bfloat16, 64),
                                         (torch.float32, 128)])
    def test_b5_is_deterministic_and_leaves_no_stale_counters(
            self, cuda_device, dtype, d):
        # as B6: bitwise equal launches, counters at 0 after each call,
        # calls with other lengths in between stay right
        lengths = [1024, 700, 257, 256, 0, 513, 1, 900]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=12, kvh=12, d=d, pt=64, mp=16, n_pages=128)))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        first = tfa.flash_paged_decode_attention(q, k, v, table, L)
        for lens in (lengths, [300, 1, 1024, 0, 64, 511, 129, 700],
                     [0] * 8, lengths):
            L2 = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
            out = tfa.flash_paged_decode_attention(q, k, v, table, L2)
            torch.cuda.synchronize()
            assert _b6_close(q, out, _b5_reference(q, k, v, table, L2))
            assert all(int(c.abs().sum()) == 0
                       for c in tfa._SPLIT_COUNTERS.values())
        assert torch.equal(out, first)

    def test_b4_b5_b6_interleaved_on_one_stream(self, cuda_device):
        # B4, B5 and B6 share one buffer of arrival counters a stream:
        # launched in turns with no sync between, on rows of several live
        # splits, each still equals its plain version, repeats are bitwise
        # equal, and every counter is 0 at the end
        lengths = [1024, 700, 257, 256, 0, 513, 1, 900]
        other = [300, 1, 257, 0, 0, 511, 1, 700]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=12, kvh=12, d=64, pt=64, mp=16, n_pages=128)))
        L2 = torch.tensor(other, dtype=torch.int32, device=cuda_device)
        kq, ks = tfa.kv_quantize(k, 1)
        vq, vs = tfa.kv_quantize(v, 1)
        # the same cache, contiguous [8, 12, 1024, 64], for B4
        kc, vc = (tfa.gather_pages(x, table).contiguous() for x in (k, v))
        calls = [
            (lambda: tfa.flash_decode_attention(q, kc, vc, L),
             _b5_reference(q, k, v, table, L)),
            (lambda: tfa.flash_paged_decode_attention(q, k, v, table, L2),
             _b5_reference(q, k, v, table, L2)),
            (lambda: tfa.flash_paged_decode_quant_attention(
                q, kq, vq, ks, vs, table, L),
             _b6_reference(q, kq, vq, ks, vs, table, L)),
            (lambda: tfa.flash_decode_attention(q, kc, vc, L2),
             _b5_reference(q, k, v, table, L2)),
        ]
        outs = [[call() for call, _ in calls] for _ in range(3)]
        torch.cuda.synchronize()
        for i, (_, ref) in enumerate(calls):
            assert _b6_close(q, outs[0][i], ref)
            assert all(torch.equal(o[i], outs[0][i]) for o in outs[1:])
        assert all(int(c.abs().sum()) == 0
                   for c in tfa._SPLIT_COUNTERS.values())

    def test_plain_backend_on_cuda_tensor_raises(self, cuda_device):
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged([8])))
        with pytest.raises(RuntimeError, match="CPU tensors only"):
            tfa.paged_decode_attention(q, k, v, table, L, backend="xla")


# head_dims beyond the exact body's 64 and 128 (the padded body), with
# B6's n_blocks at each (1, and one that divides d)
SWEEP_BLOCKS = {1: 1, 8: 2, 16: 4, 32: 4, 80: 5, 96: 3, 100: 4, 129: 3,
                256: 4}


@pytest.mark.cuda
class TestAllHeadDimsOnCard:
    """B5 and B6 on the padded body at every head_dim of the sweep,
    against their plain versions at their split boundaries with a dead
    all-sentinel row and an empty row, GQA 4:1 at 80 and 100, f32 and
    bf16 q (B5 also bf16 pages under an f32 q); the limit at 256."""

    @pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                        (torch.bfloat16, torch.bfloat16),
                                        (torch.float32, torch.bfloat16)])
    @pytest.mark.parametrize("d", sorted(SWEEP_BLOCKS))
    def test_b5_matches_plain(self, cuda_device, dtypes, d):
        q_dt, kv_dt = dtypes
        h, kvh = (8, 2) if d in (80, 100) else (4, 4)
        chunk = tfa._split_tokens(64, d, 0, kv_dt.itemsize)
        lengths = [1, 0, chunk - 1, chunk, chunk + 1, 700, 1024]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=h, kvh=kvh, d=d, pt=64, mp=16,
            n_pages=16 * len(lengths), dead=(0,), seed=d)))
        q, k, v = q.to(q_dt), k.to(kv_dt), v.to(kv_dt)
        before = tfa.flash_paged_decode_attention.launches
        out = tfa.paged_decode_attention(q, k, v, table, L)
        torch.cuda.synchronize()
        assert tfa.flash_paged_decode_attention.launches == before + 1
        assert _b6_close(q, out, _b5_reference(q, k, v, table, L))

    @pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", sorted(SWEEP_BLOCKS))
    @pytest.mark.parametrize("one_block", [True, False])
    def test_b6_matches_plain(self, cuda_device, q_dt, d, one_block):
        nb = 1 if one_block else SWEEP_BLOCKS[d]
        h, kvh = (8, 2) if d in (80, 100) else (4, 4)
        chunk = tfa._split_tokens(64, d, nb)
        lengths = [1, 0, chunk - 1, chunk, chunk + 1, 700, 1024]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=h, kvh=kvh, d=d, pt=64, mp=16,
            n_pages=16 * len(lengths), dead=(0,), seed=d + 1)))
        kq, ks = tfa.kv_quantize(k, nb)
        vq, vs = tfa.kv_quantize(v, nb)
        q = q.to(q_dt)
        before = tfa.flash_paged_decode_quant_attention.launches
        out = tfa.paged_decode_attention(q, kq, vq, table, L, k_scale=ks,
                                         v_scale=vs)
        torch.cuda.synchronize()
        assert tfa.flash_paged_decode_quant_attention.launches == before + 1
        assert _b6_close(q, out, _b6_reference(q, kq, vq, ks, vs, table, L))

    def test_head_dim_above_256_raises(self, cuda_device):
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            [3], d=300)))
        with pytest.raises(ValueError, match="head_dim 1..256"):
            tfa.flash_paged_decode_attention(q, k, v, table, L)


# query heads over KV heads of the grouped route's card cases at head_dim
# 128: ratios 2, 3, 4, 7, 8 and 16 (two head chunks), and Llama-3-70B's
# 64 / 8
GROUP_RATIOS = ((8, 4), (12, 4), (16, 4), (14, 2), (16, 2), (32, 2), (64, 8))
# and off 64 / 128 (rows read at their own width into the body's): 8 / 2
# at 80 and 100, with the widths 64 and 256 and each GT once more
GROUP_CASES = [r + (128,) for r in GROUP_RATIOS] + [
    (8, 2, 80), (8, 2, 100), (4, 2, 80), (16, 2, 100), (12, 4, 256),
    (16, 2, 8), (4, 2, 129)]
GROUP_LENGTHS = [1, 0, 63, 64, 65, 255, 256, 257, 511, 513, 700, 1024]


def _grouped_inputs(dev, h, kvh, d, seed, lengths=GROUP_LENGTHS):
    """q, K/V arenas, table and lengths on the card: 64-token pages, 16 a
    row, row 0 dead (all-sentinel, length 1), row 1 empty."""
    return [x.to(dev) for x in _t(*_paged(
        lengths, h=h, kvh=kvh, d=d, pt=64, mp=16,
        n_pages=16 * len(lengths), dead=(0,), seed=seed))]


@pytest.mark.cuda
class TestGroupedOnCard:
    """B5 and B6 under GQA on the grouped route (`paged_decode_group_kernel`,
    `paged_decode_quant_group_kernel`): against their plain versions at the
    ratios of `GROUP_RATIOS` (d 128), 8 / 2 at d 80 and 100 and the other
    `GROUP_CASES` off 64 / 128 (each GT at each width), every dtype pair,
    B6 at n_blocks 1 and 4 (1 and 3 at 129), lengths on both sides
    of the page and the 256-token split boundaries with an empty and a
    dead row; one launch a call; page sizes on and off the bulk copies
    path, and arenas off 16 bytes; a table of ten splits; two launches
    bitwise equal with every counter back at 0; interleaved with B4 and
    the split body on one stream."""

    @pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                        (torch.bfloat16, torch.bfloat16),
                                        (torch.float32, torch.bfloat16)])
    @pytest.mark.parametrize("h,kvh,d", GROUP_CASES)
    def test_b5_matches_plain(self, cuda_device, dtypes, h, kvh, d):
        q_dt, kv_dt = dtypes
        q, k, v, table, L = _grouped_inputs(cuda_device, h, kvh, d, h + d)
        q, k, v = q.to(q_dt), k.to(kv_dt), v.to(kv_dt)
        before = tfa.flash_paged_decode_attention.launches
        out = tfa.paged_decode_attention(q, k, v, table, L)
        torch.cuda.synchronize()
        assert tfa.flash_paged_decode_attention.launches == before + 1
        assert _b6_close(q, out, _b5_reference(q, k, v, table, L))

    @pytest.mark.parametrize("q_dt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("nb", [1, 4])
    @pytest.mark.parametrize("h,kvh,d", GROUP_CASES)
    def test_b6_matches_plain(self, cuda_device, q_dt, nb, h, kvh, d):
        nb = 3 if d % nb else nb
        q, k, v, table, L = _grouped_inputs(cuda_device, h, kvh, d,
                                            h + d + nb)
        kq, ks = tfa.kv_quantize(k, nb)
        vq, vs = tfa.kv_quantize(v, nb)
        q = q.to(q_dt)
        before = tfa.flash_paged_decode_quant_attention.launches
        out = tfa.paged_decode_attention(q, kq, vq, table, L, k_scale=ks,
                                         v_scale=vs)
        torch.cuda.synchronize()
        assert tfa.flash_paged_decode_quant_attention.launches == before + 1
        assert _b6_close(q, out, _b6_reference(q, kq, vq, ks, vs, table, L))

    @pytest.mark.parametrize("pt,d,offset", [
        (2, 128, 0), (8, 128, 0), (48, 128, 0), (128, 128, 0),
        (512, 128, 0), (64, 256, 1)])
    @pytest.mark.parametrize("kind", ["f32", "bf16", "int8 1", "int8 4"])
    def test_page_sizes_and_unaligned_arenas(self, cuda_device, pt, d,
                                             offset, kind):
        # the tiles go by one bulk copy a page where d is the body's width,
        # the arenas lie on 16 bytes and a tile holds whole pages (8, 128)
        # or lies inside one (512), else by the per-row copies: pages of 2
        # tokens (a page's int8 scales 8 bytes), 48 (tiles across pages),
        # arenas `offset` elements off 16 bytes; each against its plain
        # version, lengths on both sides of a page and a split
        mp = -(-1100 // pt)
        lengths = [1, 0, max(pt - 1, 1), pt + 1, 255, 257, 700, mp * pt]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=16, kvh=4, d=d, pt=pt, mp=mp,
            n_pages=mp * len(lengths), dead=(0,), seed=pt + d)))

        def off(x):  # x's values at `offset` elements into a buffer
            if not offset:
                return x
            buf = torch.empty(x.numel() + offset, dtype=x.dtype,
                              device=x.device)
            return buf[offset:].view(x.shape).copy_(x)

        if kind.startswith("int8"):
            q = q.to(torch.bfloat16)
            kq, ks = tfa.kv_quantize(k, int(kind[5:]))
            vq, vs = tfa.kv_quantize(v, int(kind[5:]))
            kq, vq, ks, vs = (off(x) for x in (kq, vq, ks, vs))
            out = tfa.flash_paged_decode_quant_attention(q, kq, vq, ks, vs,
                                                         table, L)
            ref = _b6_reference(q, kq, vq, ks, vs, table, L)
        else:
            dt = torch.float32 if kind == "f32" else torch.bfloat16
            q, k, v = q.to(dt), off(k.to(dt)), off(v.to(dt))
            out = tfa.flash_paged_decode_attention(q, k, v, table, L)
            ref = _b5_reference(q, k, v, table, L)
        torch.cuda.synchronize()
        assert _b6_close(q, out, ref)

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_long_table_merges_ten_splits(self, cuda_device, quant, dtype):
        # a table of 40 pages (2560 tokens, 10 splits of 256): the block
        # row's last block merges ten partials in split order; lengths on
        # both sides of the 8th and 9th splits
        lengths = [1, 0, 2048, 2049, 2303, 2560, 700, 2304]
        q, k, v, table, L = (x.to(cuda_device) for x in _t(*_paged(
            lengths, h=32, kvh=8, d=128, pt=64, mp=40,
            n_pages=40 * len(lengths), dead=(0,), seed=9)))
        q = q.to(dtype)
        if quant:
            kq, ks = tfa.kv_quantize(k, 1)
            vq, vs = tfa.kv_quantize(v, 1)
            out = tfa.flash_paged_decode_quant_attention(q, kq, vq, ks, vs,
                                                         table, L)
            ref = _b6_reference(q, kq, vq, ks, vs, table, L)
        else:
            k, v = k.to(dtype), v.to(dtype)
            out = tfa.flash_paged_decode_attention(q, k, v, table, L)
            ref = _b5_reference(q, k, v, table, L)
        torch.cuda.synchronize()
        assert _b6_close(q, out, ref)
        assert all(int(c.abs().sum()) == 0
                   for c in tfa._SPLIT_COUNTERS.values())

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                         (torch.bfloat16, 128),
                                         (torch.bfloat16, 80)])
    def test_deterministic_and_leaves_no_stale_counters(self, cuda_device,
                                                        quant, dtype, d):
        # split boundaries depend on the length alone and every sum runs in
        # a fixed order: two launches are bitwise equal; each launch resets
        # the counters it used, so calls with other lengths stay right
        lengths = [1024, 700, 257, 256, 0, 513, 1, 900]
        q, k, v, table, L = _grouped_inputs(cuda_device, 32, 8, d, d,
                                            lengths)
        q = q.to(dtype)
        if quant:
            kq, ks = tfa.kv_quantize(k, 1)
            vq, vs = tfa.kv_quantize(v, 1)

            def call(lens):
                return tfa.flash_paged_decode_quant_attention(
                    q, kq, vq, ks, vs, table, lens)

            def ref(lens):
                return _b6_reference(q, kq, vq, ks, vs, table, lens)
        else:
            k, v = k.to(dtype), v.to(dtype)

            def call(lens):
                return tfa.flash_paged_decode_attention(q, k, v, table, lens)

            def ref(lens):
                return _b5_reference(q, k, v, table, lens)

        first = call(L)
        for lens in (lengths, [300, 1, 1024, 0, 64, 511, 129, 700],
                     [0] * 8, lengths):
            L2 = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
            out = call(L2)
            torch.cuda.synchronize()
            assert _b6_close(q, out, ref(L2))
            assert all(int(c.abs().sum()) == 0
                       for c in tfa._SPLIT_COUNTERS.values())
        assert torch.equal(out, first)

    def test_interleaved_with_b4_and_split_body_on_one_stream(self,
                                                              cuda_device):
        # the grouped blocks count in on the same buffer of arrival
        # counters as B4 and the split body (one a stream): launched in
        # turns with no sync between, each equals its plain version,
        # repeats are bitwise equal, every counter is 0 at the end
        lengths = [1024, 700, 257, 256, 0, 513, 1, 900]
        other = [300, 1, 257, 0, 0, 511, 1, 700]
        q, k, v, table, L = _grouped_inputs(cuda_device, 32, 8, 128, 5,
                                            lengths)
        L2 = torch.tensor(other, dtype=torch.int32, device=cuda_device)
        kq, ks = tfa.kv_quantize(k, 1)
        vq, vs = tfa.kv_quantize(v, 1)
        q1, k1, v1, t1, _ = _grouped_inputs(cuda_device, 8, 8, 128, 6,
                                            lengths)
        # the GQA cache repeated to the query heads, contiguous, for B4
        kc, vc = (tfa.gather_pages(x, table, n_heads=32).contiguous()
                  for x in (k, v))
        calls = [
            (lambda: tfa.flash_paged_decode_attention(q, k, v, table, L),
             _b5_reference(q, k, v, table, L)),
            (lambda: tfa.flash_decode_attention(q, kc, vc, L2),
             _b5_reference(q, k, v, table, L2)),
            (lambda: tfa.flash_paged_decode_quant_attention(
                q, kq, vq, ks, vs, table, L2),
             _b6_reference(q, kq, vq, ks, vs, table, L2)),
            (lambda: tfa.flash_paged_decode_attention(q1, k1, v1, t1, L2),
             _b5_reference(q1, k1, v1, t1, L2)),
            (lambda: tfa.flash_paged_decode_attention(q, k, v, table, L2),
             _b5_reference(q, k, v, table, L2)),
        ]
        outs = [[call() for call, _ in calls] for _ in range(3)]
        torch.cuda.synchronize()
        for i, (_, ref) in enumerate(calls):
            assert _b6_close(q, outs[0][i], ref)
            assert all(torch.equal(o[i], outs[0][i]) for o in outs[1:])
        assert all(int(c.abs().sum()) == 0
                   for c in tfa._SPLIT_COUNTERS.values())
