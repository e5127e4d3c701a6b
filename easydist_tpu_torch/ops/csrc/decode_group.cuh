// The grouped decode body of B5 `paged_decode_group_kernel`
// (paged_decode_group.cu) and B6 `paged_decode_quant_group_kernel`
// (paged_decode_quant_group.cu), for Hopper (sm_90a): grouped-query
// attention, G = heads / kv_heads >= 2 query heads reading one KV head.
// G = 1 stays on the split body of decode_split.cuh (paged_decode.cu).
//
// It computes what that body computes (f32 softmax of q.k * scale over a
// row's live keys, each split's max, denominator and output merged in
// split order, the 1e-30 clamp, 0 for a row of length 0), for GT query
// heads of one KV head at once.
//
// What bounds it.  Memory: each KV head's live K and V rows (and B6's
// scales) once, over 3.35 TB/s.  The split body gives every query head
// its own block, so under G:1 the same K and V bytes leave device memory
// G times (Llama-3-8B's 32 heads over 8: 4x), and a split of 256 bf16
// keys at d 128 holds all its K and V (134 KB), one 128-thread block an
// SM whose copies overlap nothing.  Per key, GT queries do 4 * d flops
// each against K and V read once: about 2 flops a byte at GT 4 in bf16,
// 8 in int8, so the CUDA cores in f32 keep up and the tensor cores are
// not needed.
//
// What the design does about it.  The grid is (batch * kv_heads *
// ceil(G / GT), splits): one block of 256 threads takes GT query heads
// (the least of 2, 4, 8 that holds G; 8 and several head chunks past it;
// rows past G are masked) over one split of a row's keys (256 tokens of
// whole pages), and reads the KV head's rows of that split once for all
// of them.  The split streams through a ring of two slots in shared
// memory, `tile` keys a slot (up to 32 KB of K or V rows with their
// scales: 128 keys of bf16 or int8 at d 128): first every K tile of the
// split, then every V tile, one tile in flight while the other is
// computed.  Where the pages are bf16 or int8, d is the body's width,
// the arena lies on 16 bytes and a tile holds whole pages or lies inside
// one (Llama's shape: 128 keys, two 64-token pages), thread 0 copies each
// page's slab of the tile (its scales too) as one `cp.async.bulk` counted
// on the slot's mbarrier, reading the page from the table as it issues:
// no per-key row table, no barrier a tile.  Elsewhere (f32 pages, padded
// widths, other pages, unaligned arenas) every thread copies rows by
// decode_split.cuh's padded copies (`cp.async` of 16 bytes where a row's
// bytes and the arena's base align to 16, narrower copies otherwise),
// each key's arena row resolved through the table once.  One body
// serves every head_dim, at the width D = 64, 128 or 256 that holds it
// (zeros past d in shared memory).  Scores: a
// key's row is read by kL = min(32, D * GT / 32) lanes, each holding its
// dims of every query's q (32 floats a lane; 64 at D 256 / GT 8, whose
// kernels run one block an SM); each K element is loaded from shared
// memory once and used for all GT queries, and the GT partial dots are
// reduced across the key's lanes by a reduce-scatter (GT - 1 +
// log2(kL / GT) shuffles, not GT * log2(kL)).  int8 elements become f32
// by a byte permute and an add (a quarter of an int-to-float
// conversion's cost).
// The split's scores stay in shared memory ([chunk][GT] f32), so the
// softmax is the split body's: max, exp, sum once the last K tile is
// scored (no rescaling across tiles).  P.V: four output dims of one key
// group a thread for all GT queries, the groups summed through the ring
// at the end.  Partials and the merge are the split body's, per query
// row ([rows, splits, d + 2]): a block counts in on its block row's
// counter with one acquire-release atomic after a barrier (no fence a
// thread), and the last block merges with the loads of all its elements
// and four splits in flight together; the counter is back at 0 after
// every launch.  Split boundaries depend on the length and the chunk
// alone and every sum runs in a fixed order, so two launches on the same
// inputs are bitwise equal.
//
// What was measured (scripts/kernel_ab.py and chip_smoke.py phase 3 on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6).  Llama-3-8B's
// shape, bf16, by the profiler: B5 0.0697 -> ~0.0210 ms against SDPA
// enable_gqa's 0.0172 (unique-byte bound 0.0101), B6 0.0453 -> ~0.0209;
// the bulk copies took ~1.5 us off each (0.0227 / 0.0223 on the per-row
// copies in the same call), at 28 / 4 and 64 / 8 too.
// Neither the split length (128, 512), nor the ring's depth, nor the
// shared memory carveout moved the first version (4 x 16 KB, 128
// threads, 64 q floats a lane: 0.0245 / 0.0283); timing it with parts
// taken out showed a fixed ~4 us (launch, table, barriers), ~4 us of
// merge, and arithmetic
// that the copies did not hide (B6: ~11 us).  256 threads with 32 q
// floats a lane (two blocks, 16 warps an SM), the acquire-release count
// and two 32 KB slots (half the barriers) brought it to 0.0227 /
// 0.0223 before the bulk copies; merging a
// block row's splits through a thread-block cluster's shared memory
// instead was slower (0.034 / 0.038).

#pragma once

#include <type_traits>

#include "decode_split.cuh"

namespace {

constexpr int kGThreads = 256;              // threads a grouped block
constexpr int kQFloats = 32;                // q floats a lane holds
constexpr int kGWarps = kGThreads / 32;
constexpr int kGroupStages = 2;             // ring slots
constexpr int kGroupSlotBytes = 32 * 1024;  // a slot's rows + scales, at most
constexpr int kGroupMaxTile = 256;          // keys a slot, at most
constexpr int kGroupMinTile = 8;
// tiles of bf16 and int8 pages go as one bulk copy a page where they can
// (group_bulk); f32 pages keep the per-row copies, since the bulk path's
// state spilled the f32 bodies at GT 4, which use all 128 registers
template <typename TKV>
constexpr bool kBulkPages = sizeof(TKV) <= 2;

// Query heads a block takes for a group of G: 2, 4 or 8
__host__ __device__ inline int group_heads_tile(int group) {
  return group <= 2 ? 2 : group <= 4 ? 4 : 8;
}

// Keys a ring slot holds: the most (a power of two up to 256) whose rows
// of the body's width and scales fit kGroupSlotBytes, 8 at the least
inline int group_tile_keys(int width, int kv_bytes, int scale_blocks) {
  int tile = kGroupMaxTile;
  while (tile > kGroupMinTile &&
         tile * (width * kv_bytes + 4 * scale_blocks) > kGroupSlotBytes)
    tile /= 2;
  return tile;
}

// Dynamic shared memory of a grouped block, each region on a 16-byte
// boundary: arena rows of the split's keys, the ring (each slot K or V
// rows then their scales; it also holds the P.V groups' sums at the
// end), the split's scores [chunk][gt].
struct GroupSmem {
  size_t rows, ring, slot, scales, p, total;
};
__host__ __device__ inline GroupSmem group_smem(int chunk, int tile, int d,
                                                int kv_bytes,
                                                int scale_blocks, int gt) {
  GroupSmem s;
  const size_t c = static_cast<size_t>(chunk), t = static_cast<size_t>(tile);
  s.scales = round16(t * d * kv_bytes);
  s.slot = s.scales + round16(4 * t * scale_blocks);
  s.rows = 0;
  s.ring = round16(8 * c);
  const size_t ring = kGroupStages * s.slot;
  const size_t sums = static_cast<size_t>(kGThreads) * 4 * gt * 4;
  s.p = s.ring + (ring > sums ? ring : sums);
  s.total = s.p + round16(4 * c * gt);
  return s;
}

struct GroupArgs {
  SplitArgs s;
  int group;    // G = heads / kv_heads
  int chunks;   // head chunks a KV head: ceil(G / GT)
  int tile;     // keys a ring slot
  int bulk;     // tiles by one bulk copy a page (group_bulk)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this phase's one arrival, expecting `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; both addresses on 16 bytes) from device
// memory into shared memory as one bulk copy, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One 32-bit word of K/V elements (4 int8, 2 bf16 or 1 f32) as f32.  An
// int8 byte, biased by 128, becomes the low byte of 2^23's mantissa (a
// byte permute), and 2^23 + 128 subtracted gives it exactly: a permute
// and an add a byte, where an int-to-float conversion runs at a quarter
// of their rate
template <typename TKV>
__device__ __forceinline__ void unpack_word(uint32_t w,
                                            float* x) {
  if constexpr (sizeof(TKV) == 1) {
    const uint32_t b = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = __uint_as_float(__byte_perm(b, 0x4b000000u, 0x7440 + i)) -
             8388736.f;
  } else if constexpr (sizeof(TKV) == 2) {
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    x[0] = __uint_as_float(w);
  }
}

// U bytes (4, 8 or 16) of K/V elements from shared memory as f32
template <typename TKV, int U>
__device__ __forceinline__ void load_unit(const TKV* p,
                                          float (&x)[U / sizeof(TKV)]) {
  constexpr int kWords = U / 4, kPer = 4 / sizeof(TKV);
  uint32_t w[kWords];
  if constexpr (U == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (U == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    static_assert(U == 4, "4-, 8- or 16-byte loads");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) unpack_word<TKV>(w[i], x + kPer * i);
}

// The GT partial dots of a key's lanes summed across its lanes (lane
// offsets O, O / 2, ..., 1 within the key): halving steps first, each
// lane keeping half its sums and adding its partner's half, so after
// log2(GT) steps a lane holds one query's sum over its lane pair set,
// then plain butterfly steps.  Lane `sub` of the key ends with query
// sub / (kL / GT)'s whole dot in s[0].
template <int GT, int C, int O>
__device__ __forceinline__ void group_reduce(float (&s)[GT], int sub) {
  if constexpr (C > 1) {
    static_assert(O >= 1, "a key's lanes hold at least GT lanes");
    const bool hi = (sub & O) != 0;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float send = hi ? s[i] : s[i + C / 2];
      const float keep = hi ? s[i + C / 2] : s[i];
      s[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    group_reduce<GT, C / 2, O / 2>(s, sub);
  } else if constexpr (O >= 1) {
    s[0] += __shfl_xor_sync(0xffffffffu, s[0], O);
    group_reduce<GT, 1, O / 2>(s, sub);
  }
}

// GT floats of the scores row of one key
template <int GT>
__device__ __forceinline__ void load_p(const float* p, float (&x)[GT]) {
  if constexpr (GT == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    x[0] = w.x, x[1] = w.y;
  } else {
#pragma unroll
    for (int i = 0; i < GT; i += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + i);
      x[i] = w.x, x[i + 1] = w.y, x[i + 2] = w.z, x[i + 3] = w.w;
    }
  }
}

// One block: GT query heads of one KV head over one split of a row's
// keys.  kQuant: int8 K/V with f32 block scales (B6).  D: the body's
// width, the head_dim's at 64 and 128, else the next of 64, 128, 256;
// rows of a.head_dim <= D elements are read in place, zero-padded in
// shared memory (decode_split.cuh's padded copies: 16 bytes a copy where
// a row's bytes and the arena's base align to 16, so at 64 and 128).
template <typename TQ, typename TKV, bool kQuant, int D, int GT>
__device__ __forceinline__ void decode_group_body(const GroupArgs& ga) {
  const SplitArgs& a = ga.s;
  constexpr int kSize = sizeof(TKV);
  // lanes a key: kQFloats q floats a lane (GT * D / kL), at most a warp,
  // and at least 4 elements a lane (a 4-byte load of int8)
  constexpr int kL0 = D * GT / kQFloats;
  constexpr int kL = kL0 > 32 ? 32 : kL0 > D / 4 ? D / 4 : kL0;
  constexpr int kE = D / kL;                      // elements a lane, a key
  constexpr int kU = kE * kSize < 16 ? kE * kSize : 16;  // bytes a load
  constexpr int kUE = kU / kSize;                 // elements a load
  constexpr int kUL = kE / kUE;                   // loads a lane, a key
  constexpr int kKeysPass = kGThreads / kL;       // keys a pass
  constexpr int kColGroups = D / 4;               // four dims a thread (P.V)
  constexpr int kGroups = kGThreads / kColGroups; // key groups of P.V
  constexpr int kOuts = (GT * D + kGThreads - 1) / kGThreads;  // outputs
  static_assert(kL >= GT && kL <= 32 && (kL & (kL - 1)) == 0,
                "a key's lanes hold the group, inside one warp");
  static_assert(kU >= 4 && kUL * kUE == kE && kUL >= 1,
                "loads of 4, 8 or 16 bytes split a lane's share");
  static_assert(kGThreads % kColGroups == 0, "P.V groups split the block");

  const int d = a.head_dim;
  const int C = a.chunk;
  const int nb = kQuant ? a.n_blocks : 1;
  const int tile = ga.tile;
  const GroupSmem lay = group_smem(C, tile, D, kSize, kQuant ? nb : 0, GT);
  extern __shared__ __align__(16) unsigned char smem[];
  long long* row_s = reinterpret_cast<long long*>(smem + lay.rows);  // [C]
  unsigned char* ring = smem + lay.ring;
  float* p_s = reinterpret_cast<float*>(smem + lay.p);  // [C][GT]
  __shared__ float red_s[kGWarps][GT];
  __shared__ float ml_s[2][GT];  // the split's max and denominator a query
  __shared__ int last_s;

  const int G = ga.group;
  const int ci = blockIdx.x % ga.chunks;
  const int gk = blockIdx.x / ga.chunks;  // batch * kv_heads + kv head
  const int bi = gk / a.kv_heads, kh = gk % a.kv_heads;
  const int n_q = min(GT, G - ci * GT);   // query rows this block holds
  const int head0 = kh * G + ci * GT;     // its first query head
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pt = a.page_tokens;
  const int len = max(0, min(a.lengths[bi], a.tokens));
  const int c0 = split * C;
  auto row_of = [&](int g) {  // query g's row of q, out and the partials
    return static_cast<size_t>(bi) * a.heads + head0 + g;
  };
  if (len == 0) {  // no keys: 0, as the TPU kernel's 0 / max(0, 1e-30)
    if (split == 0)
      for (int i = tid; i < n_q * d; i += kGThreads)
        static_cast<TQ*>(a.out)[row_of(i / d) * d + i % d] = from_f32<TQ>(0.f);
    return;
  }
  if (c0 >= len) return;  // past the row's keys: no partial, no arrival
  const int n = min(C, len - c0);
  const int n_live = (len + C - 1) / C;  // splits holding live keys
  const int n_tiles = (n + tile - 1) / tile;
  const int total = 2 * n_tiles;  // K tiles, then V tiles

  // the arena row of each key (pages clipped into the arena, as the
  // TPU's index map clips).  On the bulk path thread 0 reads the table as
  // it issues, from the block's table row, its KV head's offset in a page
  // of the arena and its split's first token, kept in shared memory
  // rather than registers between the tiles it issues; the ring's slots
  // get a barrier each
  const int* tbl = a.table + static_cast<size_t>(bi) * a.max_pages;
  __shared__ __align__(8) uint64_t bar_s[kGroupStages];
  __shared__ const int* tbl_s;
  __shared__ int head_row_s, c0_s;
  const bool bulk = kBulkPages<TKV> && ga.bulk;
  if (bulk) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kGroupStages; ++i) mbar_init(&bar_s[i]);
      tbl_s = tbl, head_row_s = kh * pt, c0_s = c0;
    }
  } else {
    for (int r = tid; r < n; r += kGThreads) {
      const int p = c0 + r;
      const int page = min(max(tbl[p / pt], 0), a.n_pages - 1);
      row_s[r] = (static_cast<long long>(page) * a.kv_heads + kh) * pt + p % pt;
    }
  }
  __syncthreads();

  // tile t into ring slot t % kGroupStages: K rows (t < n_tiles) or V
  // rows of keys j0 .. j0 + nt - 1 of the split, then their scales.  The
  // bulk path: thread 0 copies each page's slab of the tile (to the
  // page's end, or the tile's: rows past the row's length are read, and
  // never used) as one copy, and its scales as another
  auto issue = [&](int t) {
    const bool is_v = t >= n_tiles;
    const int j0 = (is_v ? t - n_tiles : t) * tile;
    const int nt = min(tile, n - j0);
    unsigned char* slot =
        ring + static_cast<size_t>(t % kGroupStages) * lay.slot;
    if (bulk) {
      if (tid != 0) return;
      const int* tb = tbl_s;
      const int k0 = c0_s + j0, head_row = head_row_s;
      const int k1 = min(((k0 + nt + pt - 1) / pt) * pt, k0 + tile);
      uint64_t* bar = &bar_s[t % kGroupStages];
      const uint32_t row_bytes = d * kSize + (kQuant ? 4 * nb : 0);
      mbar_expect_tx(bar, static_cast<uint32_t>(k1 - k0) * row_bytes);
      const TKV* src = static_cast<const TKV*>(is_v ? a.v : a.k);
      for (int p = k0; p < k1;) {
        const int e = min((p / pt + 1) * pt, k1);
        const int page = min(max(tb[p / pt], 0), a.n_pages - 1);
        const long long row =
            static_cast<long long>(page) * a.kv_heads * pt + head_row + p % pt;
        bulk_copy(slot + static_cast<size_t>(p - k0) * d * kSize,
                  src + row * d, static_cast<uint32_t>(e - p) * d * kSize,
                  bar);
        if constexpr (kQuant)
          bulk_copy(slot + lay.scales + static_cast<size_t>(p - k0) * nb * 4,
                    (is_v ? a.v_scale : a.k_scale) + row * nb,
                    static_cast<uint32_t>(e - p) * nb * 4, bar);
        p = e;
      }
      return;
    }
    copy_padded<TKV, D, kGThreads>(reinterpret_cast<TKV*>(slot),
                        static_cast<const TKV*>(is_v ? a.v : a.k), nt, d,
                        [&](int j) { return row_s[j0 + j]; });
    if constexpr (kQuant) {
      float* sd = reinterpret_cast<float*>(slot + lay.scales);
      const float* ss = is_v ? a.v_scale : a.k_scale;
      for (int i = tid; i < nt * nb; i += kGThreads)
        cp_async4(sd + i, ss + row_s[j0 + i / nb] * nb + i % nb);
    }
  };
  // the next tile out, then tile t landed for every thread; its slot
  auto wait_tile = [&](int t) -> const unsigned char* {
    if (t + kGroupStages - 1 < total) issue(t + kGroupStages - 1);
    if (bulk) {
      mbar_wait(&bar_s[t % kGroupStages], (t / kGroupStages) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<kGroupStages - 1>();
      __syncthreads();
    }
    return ring + static_cast<size_t>(t % kGroupStages) * lay.slot;
  };
#pragma unroll
  for (int t = 0; t < kGroupStages - 1; ++t) {
    if (t < total) issue(t);
    cp_async_commit();
  }

  // this lane's share of every query's q (times the softmax scale; zeros
  // past d and on masked rows): loads m = 0 .. kUL - 1 of the key's row,
  // load m at unit sub + kL * ((m + rot) % kUL), rot spreading the keys
  // of a warp over the banks
  const int sub = tid % kL, key_of = tid / kL;
  const int rot = (lane / kL) % kUL;
  const int blk = d / nb;  // dims per scale block
  const bool unit_scale = blk % kUE == 0, quad_scale = blk % 4 == 0;
  // the scale block of each load of a lane's share, and of its P.V quad
  // (a padded dim's block clamps to the last: its element is zero)
  int unit_blk[kUL];
#pragma unroll
  for (int m = 0; m < kUL; ++m)
    unit_blk[m] = min((sub + kL * ((m + rot) % kUL)) * kUE / blk, nb - 1);
  float qr[GT][kUL][kUE];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const TQ* qg = static_cast<const TQ*>(a.q) + row_of(g < n_q ? g : 0) * d;
#pragma unroll
    for (int m = 0; m < kUL; ++m) {
      const int u = sub + kL * ((m + rot) % kUL);
#pragma unroll
      for (int e = 0; e < kUE; ++e) {
        const int i = u * kUE + e;
        qr[g][m][e] = g < n_q && i < d ? to_f32(qg[i]) * a.scale : 0.f;
      }
    }
  }

  // scores of the split's keys j0 .. j0 + nt - 1 (a K tile) into p_s
  auto scores = [&](const unsigned char* slot, int j0, int nt) {
    const TKV* k_t = reinterpret_cast<const TKV*>(slot);
    const float* ks_t = reinterpret_cast<const float*>(slot + lay.scales);
#pragma unroll 1
    for (int jb = 0; jb < nt; jb += kKeysPass) {
      const int j = jb + key_of;
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) s[g] = 0.f;
      if (j < nt) {
#pragma unroll
        for (int m = 0; m < kUL; ++m) {
          const int u = sub + kL * ((m + rot) % kUL);
          float x[kUE];
          load_unit<TKV, kU>(k_t + static_cast<size_t>(j) * D + u * kUE, x);
          if (!kQuant) {
#pragma unroll
            for (int g = 0; g < GT; ++g)
#pragma unroll
              for (int e = 0; e < kUE; ++e)
                s[g] = fmaf(qr[g][m][e], x[e], s[g]);
          } else if (unit_scale) {
            const float sc = ks_t[j * nb + unit_blk[m]];
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              float part = 0.f;
#pragma unroll
              for (int e = 0; e < kUE; ++e)
                part = fmaf(qr[g][m][e], x[e], part);
              s[g] = fmaf(part, sc, s[g]);
            }
          } else {  // blocks narrower than a load, or not aligned to one
#pragma unroll
            for (int e = 0; e < kUE; ++e) {
              const float xe =
                  x[e] * ks_t[j * nb + min((u * kUE + e) / blk, nb - 1)];
#pragma unroll
              for (int g = 0; g < GT; ++g)
                s[g] = fmaf(qr[g][m][e], xe, s[g]);
            }
          }
        }
      }
      group_reduce<GT, GT, kL / 2>(s, sub);
      if (j < nt && sub % (kL / GT) == 0)
        p_s[(j0 + j) * GT + sub / (kL / GT)] = s[0];
    }
  };

  for (int t = 0; t < n_tiles; ++t) {
    const unsigned char* slot = wait_tile(t);
    scores(slot, t * tile, min(tile, n - t * tile));
    __syncthreads();  // the slot is free, and the scores are written
  }

  // the split's softmax a query: a thread takes query tid % GT over keys
  // tid / GT, + kGThreads / GT, ...; the lanes of one query combine by
  // the shuffles at offsets 16 .. GT, the warps through red_s
  {
    const int g = tid % GT;
    float mx = kNegInf;
    for (int j = tid / GT; j < n; j += kGThreads / GT)
      mx = fmaxf(mx, p_s[j * GT + g]);
#pragma unroll
    for (int o = 16; o >= GT; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane < GT) red_s[warp][lane] = mx;
    __syncthreads();
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kGWarps; ++w) m = fmaxf(m, red_s[w][g]);
    float sum = 0.f;
    for (int j = tid / GT; j < n; j += kGThreads / GT) {
      const float p = expf(p_s[j * GT + g] - m);
      p_s[j * GT + g] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o >= GT; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncthreads();  // every thread has read the maxima
    if (lane < GT) red_s[warp][lane] = sum;
    __syncthreads();
    if (tid < GT) {  // g == tid here
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kGWarps; ++w) l += red_s[w][tid];
      ml_s[0][tid] = m, ml_s[1][tid] = l;
    }
  }

  // P.V: four output dims of one key group a thread, for every query
  const int cg = tid % kColGroups, grp = tid / kColGroups;
  const int quad_blk = min(4 * cg / blk, nb - 1);
  float acc[GT][4];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  for (int t = n_tiles; t < total; ++t) {
    const unsigned char* slot = wait_tile(t);
    const TKV* v_t = reinterpret_cast<const TKV*>(slot);
    const float* vs_t = reinterpret_cast<const float*>(slot + lay.scales);
    const int j0 = (t - n_tiles) * tile;
    const int nt = min(tile, n - j0);
    for (int j = grp; j < nt; j += kGroups) {
      float x[4];
      load_unit<TKV, 4 * kSize>(v_t + static_cast<size_t>(j) * D + 4 * cg, x);
      if constexpr (kQuant) {
        if (quad_scale) {
          const float w = vs_t[j * nb + quad_blk];
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] *= w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] *= vs_t[j * nb + min((4 * cg + e) / blk, nb - 1)];
        }
      }
      float p[GT];
      load_p<GT>(p_s + (j0 + j) * GT, p);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p[g], x[e], acc[g][e]);
    }
    __syncthreads();  // the slot is free
  }

  // the key groups' sums through the ring (no copy is in flight: the last
  // wait took every group), [kGroups][GT][D]
  float* acc_s = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < GT; ++g)
    *reinterpret_cast<float4*>(acc_s + (grp * GT + g) * D + 4 * cg) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  // this thread's outputs: element tid + r * kGThreads of [GT][D] (g =
  // GT past the last)
  float o[kOuts];
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    const int idx = tid + r * kGThreads, g = idx / D, i = idx % D;
    o[r] = 0.f;
    if (g < GT) {
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg)
        o[r] += acc_s[(gg * GT + g) * D + i];
    }
  }

  TQ* out = static_cast<TQ*>(a.out);
  if (n_live == 1) {  // the row's only split: the output itself
#pragma unroll
    for (int r = 0; r < kOuts; ++r) {
      const int idx = tid + r * kGThreads, g = idx / D, i = idx % D;
      if (g < n_q && i < d)
        out[row_of(g) * d + i] = from_f32<TQ>(o[r] / fmaxf(ml_s[1][g], 1e-30f));
    }
    return;
  }

  // partials of a row with several splits, one a query row; the block
  // row's last block merges them
  const size_t stride = d + 2;
  auto part = [&](int g, int s) {
    return a.work + (row_of(g) * gridDim.y + s) * stride;
  };
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    const int idx = tid + r * kGThreads, g = idx / D, i = idx % D;
    if (g < n_q && i < d) part(g, split)[i] = o[r];
  }
  if (tid < n_q) {
    float* pp = part(tid, split);
    pp[d] = ml_s[0][tid], pp[d + 1] = ml_s[1][tid];
  }
  // the block counts in once every thread's partial is written: thread
  // 0's release (after the barrier) publishes them, and the last block's
  // acquire, with the barrier after it, lets its threads see the others'
  __syncthreads();
  if (tid == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(a.counters + blockIdx.x)
                 : "memory");
    last_s = before == n_live - 1;
  }
  __syncthreads();
  if (!last_s) return;
  // this thread's elements of [GT][D] (those of o above), each merged over
  // the splits in split order (max, then rescaled sums); the loads of all
  // its elements and of four splits go out together, not one round trip
  // an element and a split
  float mm[kOuts], ll[kOuts], oo[kOuts];
#pragma unroll
  for (int r = 0; r < kOuts; ++r) mm[r] = kNegInf, ll[r] = 0.f, oo[r] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
#pragma unroll
    for (int r = 0; r < kOuts; ++r) {
      const int g = (tid + r * kGThreads) / D;
      if (g < n_q) mm[r] = fmaxf(mm[r], __ldcg(part(g, s) + d));
    }
  }
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {  // fixed split order
#pragma unroll
    for (int r = 0; r < kOuts; ++r) {
      const int idx = tid + r * kGThreads, g = idx / D, i = idx % D;
      if (g < n_q && i < d) {
        const float* ps = part(g, s);
        const float w = expf(__ldcg(ps + d) - mm[r]);
        ll[r] = fmaf(__ldcg(ps + d + 1), w, ll[r]);
        oo[r] = fmaf(__ldcg(ps + i), w, oo[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    const int idx = tid + r * kGThreads, g = idx / D, i = idx % D;
    if (g < n_q && i < d)
      out[row_of(g) * d + i] = from_f32<TQ>(oo[r] / fmaxf(ll[r], 1e-30f));
  }
  if (tid == 0) a.counters[blockIdx.x] = 0;  // ready for the next launch
}

// The body's width D of a head_dim: 64, 128 or 256
__host__ __device__ inline int group_width(int head_dim) {
  return head_dim <= 64 ? 64 : head_dim <= 128 ? 128 : 256;
}

// A grouped launch: the kernel's arguments, its grid and dynamic shared
// memory, and GT
struct GroupLaunch {
  GroupArgs args;
  int blocks, n_splits, gt;
  size_t smem;
};

// Whether the tiles of a launch go by bulk copies, one a page's slab
// (one thread issues them, reading the table itself; no per-key row
// table): for bf16 and int8 pages (kBulkPages), where d is the body's
// width (no padding), the arena's bases lie
// on 16 bytes, and tiles start on a multiple of the tile and hold whole
// pages or lie inside one, so that every slab starts on 16 bytes and
// holds a multiple of 16 (B6's scales too: page_tokens * n_blocks a
// multiple of 4)
inline bool group_bulk(const SplitArgs& a, int width, int kv_bytes, int nb,
                       int tile) {
  const int pt = a.page_tokens;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return kv_bytes <= 2 && a.head_dim == width &&
         a.chunk % tile == 0 &&
         (tile % pt == 0 || pt % tile == 0) && aligned(a.k) &&
         aligned(a.v) &&
         (nb == 0 || ((pt * nb) % 4 == 0 && aligned(a.k_scale) &&
                      aligned(a.v_scale)));
}

// The grouped launch of B5 (kv_bytes 2 or 4, n_blocks 0) or B6 (kv_bytes
// 1, n_blocks scales a row) over `batch` rows of `a`; false where the
// shape is out of range (or heads / kv_heads < 2: G = 1 runs the split
// body).
inline bool group_launch(const SplitArgs& a, int batch, int kv_bytes,
                         GroupLaunch* out) {
  int n_splits = 0;
  if (a.heads < 1 || a.kv_heads < 1 || a.heads % a.kv_heads ||
      a.n_pages < 1 || a.page_tokens < 1 || a.max_pages < 1 ||
      a.head_dim < 1 || a.head_dim > 256 || a.n_blocks < 1 ||
      a.head_dim % a.n_blocks ||
      !split_count(static_cast<long long>(a.max_pages) * a.page_tokens,
                   a.chunk, &n_splits))
    return false;
  const int group = a.heads / a.kv_heads;
  if (group < 2) return false;  // G = 1: the split body
  const int nb = kv_bytes == 1 ? a.n_blocks : 0;
  const int D = group_width(a.head_dim);
  out->gt = group_heads_tile(group);
  const int tile = group_tile_keys(D, kv_bytes, nb);
  out->args = GroupArgs{a, group, (group + out->gt - 1) / out->gt, tile,
                        group_bulk(a, D, kv_bytes, nb, tile)};
  out->blocks = batch * a.kv_heads * out->args.chunks;
  out->n_splits = n_splits;
  out->smem = group_smem(a.chunk, tile, D, kv_bytes, nb, out->gt).total;
  return out->blocks > 0;
}

// Launches `l` through `launch(width, gt)`, a callable given the body's
// width D and the launch's GT as std::integral_constant, which launches
// its kernel's <.., D, GT> instantiation and returns the launch's error
template <int D, typename Launch>
cudaError_t launch_group_gt(const GroupLaunch& l, Launch launch) {
  using W = std::integral_constant<int, D>;
  switch (l.gt) {
    case 2:
      return launch(W{}, std::integral_constant<int, 2>{});
    case 4:
      return launch(W{}, std::integral_constant<int, 4>{});
    default:
      return launch(W{}, std::integral_constant<int, 8>{});
  }
}

template <typename Launch>
cudaError_t launch_group(const GroupLaunch& l, Launch launch) {
  switch (group_width(l.args.s.head_dim)) {
    case 64:
      return launch_group_gt<64>(l, launch);
    case 128:
      return launch_group_gt<128>(l, launch);
    default:
      return launch_group_gt<256>(l, launch);
  }
}

}  // namespace
