// The split-K (flash-decoding) body the three decode kernels share, for
// Hopper (sm_90a): B4 `flash_decode_kernel` (flash_decode.cu) over a
// contiguous cache, B5 `paged_decode_kernel` and B6
// `paged_decode_quant_kernel` (paged_decode.cu) through a page table.
//
// One query per (batch, head) row attends the row's live keys: f32
// softmax (a per-split max, denominator and output, merged across
// splits), keys at or past the row's length take weight 0, the output is
// in q's dtype with the denominator clamped at 1e-30 (a row of length 0
// returns 0, as the TPU kernels do).
//
// What bounds the three.  Each row reads its live K and V once and does
// ~4*d flops per key, about one flop per byte: far below the card's ~295
// flops per byte, so the bound is memory, the live K/V bytes (plus
// scales for B6) over 3.35 TB/s.
//
// What the design does about it.  The TPU walks a row's keys along a
// sequential grid axis; one CUDA block per row would leave 96 rows (the
// serving shape, 8 x 12) on 132 SMs, each waiting on one tile at a time.
// So each row's keys are cut into splits of `chunk` tokens (the host picks
// it so a split fits shared memory: 256 tokens, 128 for f32 at head_dim
// 128), and the grid is (rows, ceil(tokens / chunk)), known on the host
// from the cache's (or table's) width: the lengths are never read on the
// host.  A block whose split starts at or past its row's length exits at
// once.  A live block issues every K row (with its scales, B6) and every
// V row (with its scales) as `cp.async` copies in two groups, so the
// whole split (K and V of 256 keys at d 64: 64 KB in bf16, 32 KB in int8)
// is in flight at once and the scores start when K has landed while V
// still streams.  Where a key lives is the body's template parameter:
// consecutive rows of the cache (B4: key p of row r is row r * T + p, so
// the copies go out at once), or the arena row its page-table entry names
// (B5, B6: resolved into shared memory first).  Scores take four lanes
// per key (a 16-byte vector each, q in registers, two shuffles), P.V one
// thread per four output dims and key group.  A row with one live split
// writes acc / l itself.  Otherwise each block writes (m, l, acc) to a
// workspace, fences, and counts itself in on the row's counter; the last
// block to arrive merges the row's partials in split order (max, then
// rescaled sums, the 1e-30 clamp) and resets the counter to 0, so the
// counters are zero again after every launch.  Split boundaries depend
// only on the length and the chunk and the merge order is fixed, so two
// launches are bitwise equal.
//
// Head dims.  The body is a template on its width D, a power of two from
// 64 to 256 (the score lanes read a row as four lanes of 16-byte vectors,
// 64 bytes of int8 at the least; P.V gives each thread four dims of a
// key group, so D / 4 must divide the block).  head_dim 64 and 128 run
// the exact body, D = head_dim (kPad false: each row whole 16-byte
// vectors, `cp.async` 16 bytes at a time).  Every other head_dim from 1
// to 256 runs the padded body (kPad true) at the next such D: each key's
// row is read in place from the cache or the arena at its own d, with
// the widest copy both its byte length and the base align to (16, 8 or 4
// bytes by `cp.async`; 2 or 1 by a plain load and store), into a shared
// row of D elements whose dims at or past d are zeroed; q's padded dims
// are zero too.  Zeros add nothing to q.k or p.v, so the result is
// exact.  B6's scale of a padded dim is clamped to the row's last block
// (its element is zero), and a vector spanning two scale blocks (d / nb
// not a multiple of the vector) takes one scale an element.  No cache is
// ever copied or padded outside the kernel.  64 and 128 keep the exact
// body because it is faster there: run at those widths, the padded body
// took 1-3% more device time for B4 and B6 and 6-7% more for B5 at
// head_dim 128 (chip_smoke.py's phase-3 profiler times on an NVIDIA H100
// 80GB HBM3 at 700 W; it computes row addresses at run time).
// Registers: q's share of a lane is D / 4 floats, so the padded body
// takes 40-96 registers a thread (D 64-256; ptxas, no spill).
//
// Known limits: a split of f32 keys at head_dim 128 takes up to 130 KB of
// shared memory, one block an SM; the merge waits on the row's slowest
// split.  The padded body computes on its zero dims (d 80 runs at D 128).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;
// shared memory a block may take on the card, less the split body's
// static arrays
constexpr size_t kSmemLimit = 227 * 1024 - 4 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

struct SplitArgs {
  const void* q;
  const void* k;         // B4: [rows, tokens, d]; B5/B6: pages
  const void* v;
  const float* k_scale;  // B6 only
  const float* v_scale;  // B6 only
  const int* table;      // B5/B6 only
  const int* lengths;
  void* out;
  float* work;           // [rows, n_splits, d + 2] partials
  int* counters;         // [rows] arrivals, 0 between launches
  int heads;
  int kv_heads;          // B5/B6; B4 has one kv head a head
  int n_pages;           // B5/B6 only
  int page_tokens;       // B5/B6 only
  int max_pages;         // B5/B6 only
  int tokens;    // keys a row holds: T (B4), max_pages * page_tokens
  int n_blocks;  // scale blocks per row (B6); 1 otherwise
  int chunk;     // tokens per split
  float scale;
  int head_dim;  // d: D (the exact body) or 1..D (the padded body)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// a W-byte copy global -> shared: `cp.async` for 4, 8 and 16 bytes, a
// plain load and store below that (ordered by the block's next barrier)
template <int W>
__device__ __forceinline__ void copy_bytes(void* dst, const void* src) {
  if constexpr (W == 16) {
    cp_async16(dst, src);
  } else if constexpr (W == 8 || W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(W)
                 : "memory");
  } else if constexpr (W == 2) {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  } else {
    *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
  }
}
template <int W>
__device__ __forceinline__ void zero_bytes(void* dst) {
  if constexpr (W == 16) *static_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  else if constexpr (W == 8) *static_cast<uint2*>(dst) = make_uint2(0, 0);
  else if constexpr (W == 4) *static_cast<uint32_t*>(dst) = 0u;
  else if constexpr (W == 2) *static_cast<uint16_t*>(dst) = 0;
  else *static_cast<uint8_t*>(dst) = 0;
}

// Rows j < n of a split of the padded body: key j's d elements from
// element row `row_of(j)` of `src` (rows of d elements), W bytes a copy,
// then zeros up to the shared row's D elements; kT threads share them
template <int W, typename TKV, int D, int kT = kThreads, typename RowOf>
__device__ __forceinline__ void copy_padded_rows(TKV* dst, const TKV* src,
                                                 int n, int d,
                                                 RowOf row_of) {
  constexpr int kUnits = D * static_cast<int>(sizeof(TKV)) / W;
  const int data = d * static_cast<int>(sizeof(TKV)) / W;
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(TKV);
  for (int i = threadIdx.x; i < n * kUnits; i += kT) {
    const int j = i / kUnits, u = i % kUnits;
    unsigned char* to = reinterpret_cast<unsigned char*>(dst) +
                        static_cast<size_t>(j) * D * sizeof(TKV) + u * W;
    if (u < data)
      copy_bytes<W>(to, reinterpret_cast<const unsigned char*>(src) +
                            static_cast<size_t>(row_of(j)) * row_bytes +
                            u * W);
    else
      zero_bytes<W>(to);
  }
}

// copy_padded_rows at the widest copy that a row's bytes and both bases
// align to
template <typename TKV, int D, int kT = kThreads, typename RowOf>
__device__ __forceinline__ void copy_padded(TKV* dst, const TKV* src,
                                            int n, int d, RowOf row_of) {
  const uintptr_t align = static_cast<uintptr_t>(d) * sizeof(TKV) |
                          reinterpret_cast<uintptr_t>(src);
  if (align % 16 == 0)
    copy_padded_rows<16, TKV, D, kT>(dst, src, n, d, row_of);
  else if (align % 8 == 0)
    copy_padded_rows<8, TKV, D, kT>(dst, src, n, d, row_of);
  else if (align % 4 == 0)
    copy_padded_rows<4, TKV, D, kT>(dst, src, n, d, row_of);
  else if constexpr (sizeof(TKV) <= 2) {
    if (align % 2 == 0)
      copy_padded_rows<2, TKV, D, kT>(dst, src, n, d, row_of);
    else if constexpr (sizeof(TKV) == 1)
      copy_padded_rows<1, TKV, D, kT>(dst, src, n, d, row_of);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 16-byte vector of K/V elements (int8, bf16 or f32) as f32
template <typename TKV>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&x)[16 / sizeof(TKV)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(TKV) == 1) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        x[4 * i + b] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
    } else if constexpr (sizeof(TKV) == 2) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      x[i] = __uint_as_float(w[i]);
    }
  }
}

// Four consecutive K/V elements from shared memory as f32
template <typename TKV>
__device__ __forceinline__ void load4(const TKV* p, float (&x)[4]) {
  if constexpr (sizeof(TKV) == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[b] = static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xffu));
  } else if constexpr (sizeof(TKV) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(w.x << 16), x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16), x[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
  }
}

// Dynamic shared memory of a split of `chunk` keys, each region on a
// 16-byte boundary: arena rows (paged only), K, V, K and V scales (B6),
// scores.
struct SplitSmem {
  size_t rows, k, v, ks, vs, p, total;
};
__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ inline SplitSmem split_smem(int chunk, int d,
                                                int kv_bytes,
                                                int scale_blocks,
                                                bool paged) {
  SplitSmem s;
  const size_t c = static_cast<size_t>(chunk);
  s.rows = 0;
  s.k = s.rows + (paged ? round16(8 * c) : 0);
  s.v = s.k + round16(c * d * kv_bytes);
  s.ks = s.v + round16(c * d * kv_bytes);
  s.vs = s.ks + round16(4 * c * scale_blocks);
  s.p = s.vs + round16(4 * c * scale_blocks);
  s.total = s.p + round16(4 * c);
  return s;
}

// One block's split of one row.  kPaged: keys through the page table
// (B5, B6); else consecutive rows of a contiguous cache (B4).  kQuant:
// int8 K/V with f32 block scales (B6).  D: the body's width; kPad: rows
// of a.head_dim < D elements (else exactly D).
template <typename TQ, typename TKV, bool kQuant, bool kPaged, int D,
          bool kPad>
__device__ __forceinline__ void decode_split_body(const SplitArgs& a) {
  constexpr int kElems = 16 / sizeof(TKV);       // elements a vector
  constexpr int kVecs = D / kElems;              // vectors a row
  constexpr int kLanes = 4;                      // lanes a key (scores)
  constexpr int kLaneVecs = kVecs / kLanes;      // vectors a lane
  constexpr int kKeysPass = kThreads / kLanes;   // keys a pass
  constexpr int kColGroups = D / 4;              // four dims a thread (P.V)
  constexpr int kGroups = kThreads / kColGroups; // key groups of P.V
  constexpr int kOuts = (D + kThreads - 1) / kThreads;  // dims a thread
  static_assert(kLaneVecs >= 1 && kVecs % kLanes == 0, "lanes split rows");
  static_assert(kGroups >= 1 && kThreads % kColGroups == 0,
                "P.V groups split the block");
  static_assert(kPaged || !kQuant, "scales ride the page table");

  const int d = kPad ? a.head_dim : D;  // the row's own elements
  const int C = a.chunk;
  const int nb = kQuant ? a.n_blocks : 1;
  const SplitSmem lay = split_smem(C, D, sizeof(TKV), kQuant ? nb : 0,
                                   kPaged);
  extern __shared__ __align__(16) unsigned char smem[];
  long long* row_s = reinterpret_cast<long long*>(smem + lay.rows);  // [C]
  TKV* k_s = reinterpret_cast<TKV*>(smem + lay.k);                   // [C, D]
  TKV* v_s = reinterpret_cast<TKV*>(smem + lay.v);                   // [C, D]
  float* ks_s = reinterpret_cast<float*>(smem + lay.ks);             // [C, nb]
  float* vs_s = reinterpret_cast<float*>(smem + lay.vs);             // [C, nb]
  float* p_s = reinterpret_cast<float*>(smem + lay.p);               // [C]
  __shared__ float q_s[D];
  __shared__ float max_s[kWarps], sum_s[kWarps];
  __shared__ float acc_s[kGroups * D];
  __shared__ int last_s;

  const int row = blockIdx.x;  // batch * heads + head
  const int split = blockIdx.y;
  const int bi = row / a.heads;
  const int kh = (row % a.heads) / (a.heads / a.kv_heads);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pt = a.page_tokens;
  const int len = max(0, min(a.lengths[bi], a.tokens));
  const int c0 = split * C;
  TQ* out = static_cast<TQ*>(a.out) + static_cast<size_t>(row) * d;
  if (len == 0) {  // no keys: 0, as the TPU kernel's 0 / max(0, 1e-30)
    if (split == 0)
      for (int i = tid; i < d; i += kThreads) out[i] = from_f32<TQ>(0.f);
    return;
  }
  if (c0 >= len) return;  // past the row's keys: no partial, no arrival
  const int n = min(C, len - c0);
  const int n_live = (len + C - 1) / C;  // splits holding live keys

  // every K row and its scales (group 0), then every V row and its
  // scales (group 1), all in flight at once; B4's split is the rows
  // first .. first + n - 1 of its cache
  const uint4* kp = static_cast<const uint4*>(a.k);
  const uint4* vp = static_cast<const uint4*>(a.v);
  const long long first = static_cast<long long>(row) * a.tokens + c0;
  auto key_row = [&](int j) -> long long {
    if constexpr (kPaged) return row_s[j];
    else return first + j;
  };
  auto issue_copies = [&]() {
    if constexpr (kPad)
      copy_padded<TKV, D>(k_s, static_cast<const TKV*>(a.k), n, d, key_row);
    else
      for (int i = tid; i < n * kVecs; i += kThreads)
        cp_async16(reinterpret_cast<uint4*>(k_s) + i,
                   kPaged ? kp + row_s[i / kVecs] * kVecs + i % kVecs
                          : kp + first * kVecs + i);
    if constexpr (kQuant)
      for (int i = tid; i < n * nb; i += kThreads)
        cp_async4(ks_s + i, a.k_scale + row_s[i / nb] * nb + i % nb);
    cp_async_commit();
    if constexpr (kPad)
      copy_padded<TKV, D>(v_s, static_cast<const TKV*>(a.v), n, d, key_row);
    else
      for (int i = tid; i < n * kVecs; i += kThreads)
        cp_async16(reinterpret_cast<uint4*>(v_s) + i,
                   kPaged ? vp + row_s[i / kVecs] * kVecs + i % kVecs
                          : vp + first * kVecs + i);
    if constexpr (kQuant)
      for (int i = tid; i < n * nb; i += kThreads)
        cp_async4(vs_s + i, a.v_scale + row_s[i / nb] * nb + i % nb);
    cp_async_commit();
  };

  if constexpr (kPaged) {
    // the arena row of each key (pages clipped into the arena, as the
    // TPU's index map clips)
    const int* tbl = a.table + static_cast<size_t>(bi) * a.max_pages;
    for (int r = tid; r < n; r += kThreads) {
      const int p = c0 + r;
      const int page = min(max(tbl[p / pt], 0), a.n_pages - 1);
      row_s[r] = (static_cast<long long>(page) * a.kv_heads + kh) * pt +
                 p % pt;
    }
  } else {
    issue_copies();  // nothing to resolve: the copies go out at once
  }
  // q times the softmax scale (zeros past d)
  const TQ* q = static_cast<const TQ*>(a.q) + static_cast<size_t>(row) * d;
  for (int i = tid; i < D; i += kThreads)
    q_s[i] = i < d ? to_f32(q[i]) * a.scale : 0.f;
  __syncthreads();
  if constexpr (kPaged) issue_copies();

  // this lane's share of q: vectors sub, sub + 4, ... of a row; an odd
  // key's lanes start one step (64 bytes) on, so the two keys of a
  // quarter-warp's 16-byte reads fall in different halves of the banks
  const int sub = tid % kLanes, key_of = tid / kLanes;
  const int rot = (key_of & 1) * kLanes;
  const int blk = d / nb;  // dims per scale block
  // one scale a vector (or a P.V quad) when no vector spans two blocks;
  // a padded dim's block clamps to the last (its element is zero)
  const bool vec_scale = blk % kElems == 0, quad_scale = blk % 4 == 0;
  float qr[kLaneVecs][kElems];
#pragma unroll
  for (int m = 0; m < kLaneVecs; ++m)
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      qr[m][e] = q_s[((sub + kLanes * m + rot) % kVecs) * kElems + e];

  cp_async_wait<1>();  // this thread's K copies have landed ...
  __syncthreads();     // ... and every thread's

  // scores s_j = (q * scale) . k_j, four lanes a key
  float mx = kNegInf;
  for (int j0 = 0; j0 < n; j0 += kKeysPass) {
    const int j = j0 + key_of;
    float s = 0.f;
    if (j < n) {
#pragma unroll
      for (int m = 0; m < kLaneVecs; ++m) {
        const int c = (sub + kLanes * m + rot) % kVecs;
        float x[kElems];
        unpack<TKV>(reinterpret_cast<const uint4*>(k_s + j * D)[c], x);
        if (!kQuant || vec_scale) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kElems; ++e) part = fmaf(qr[m][e], x[e], part);
          s += kQuant ? part * ks_s[j * nb + min(c * kElems / blk, nb - 1)]
                      : part;
        } else {  // blocks narrower than a vector, or not aligned to one
#pragma unroll
          for (int e = 0; e < kElems; ++e)
            s = fmaf(qr[m][e] * x[e],
                     ks_s[j * nb + min((c * kElems + e) / blk, nb - 1)], s);
        }
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (j < n) {
      if (sub == 0) p_s[j] = s;
      mx = fmaxf(mx, s);
    }
  }
  mx = warp_max(mx);
  if (lane == 0) max_s[warp] = mx;
  __syncthreads();
  float m = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, max_s[w]);

  // probabilities and their sum
  float psum = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float p = expf(p_s[j] - m);
    p_s[j] = p;
    psum += p;
  }
  psum = warp_sum(psum);
  if (lane == 0) sum_s[warp] = psum;
  cp_async_wait<0>();  // V has landed (this thread's copies) ...
  __syncthreads();     // ... every thread's, and P and the sums are written
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += sum_s[w];

  // P.V: four output dims of one key group a thread
  const int cg = tid % kColGroups, g = tid / kColGroups;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = g; j < n; j += kGroups) {
    float x[4];
    load4(v_s + j * D + 4 * cg, x);
    const float p = p_s[j];
    if (!kQuant || quad_scale) {
      const float w =
          kQuant ? p * vs_s[j * nb + min(4 * cg / blk, nb - 1)] : p;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(w, x[e], acc[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] = fmaf(p * vs_s[j * nb + min((4 * cg + e) / blk, nb - 1)],
                      x[e], acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc_s[g * D + 4 * cg + e] = acc[e];
  __syncthreads();
  // this thread's output dims tid, tid + kThreads, ... (below d)
  float o[kOuts];
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    const int i = tid + r * kThreads;
    o[r] = 0.f;
    if (i < d) {
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg) o[r] += acc_s[gg * D + i];
    }
  }

  if (n_live == 1) {  // the row's only split: the output itself
#pragma unroll
    for (int r = 0; r < kOuts; ++r) {
      const int i = tid + r * kThreads;
      if (i < d) out[i] = from_f32<TQ>(o[r] / fmaxf(l, 1e-30f));
    }
    return;
  }

  // a partial of a row with several splits; the row's last block merges
  const size_t stride = d + 2;
  float* part = a.work + (static_cast<size_t>(row) * gridDim.y + split) *
                             stride;
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    const int i = tid + r * kThreads;
    if (i < d) part[i] = o[r];
  }
  if (tid == 0) part[d] = m, part[d + 1] = l;
  __threadfence();  // this thread's partial is visible device-wide ...
  __syncthreads();  // ... and every thread's, before the block counts in
  if (tid == 0)
    last_s = atomicAdd(a.counters + row, 1) == n_live - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();  // the other blocks' partials, seen through the counter
  const float* base = a.work + static_cast<size_t>(row) * gridDim.y * stride;
#pragma unroll
  for (int r = 0; r < kOuts; ++r) {
    const int i = tid + r * kThreads;
    if (i >= d) continue;
    float mm = kNegInf;
    for (int s = 0; s < n_live; ++s) mm = fmaxf(mm, __ldcg(base + s * stride + d));
    float ll = 0.f, oo = 0.f;
    for (int s = 0; s < n_live; ++s) {  // fixed split order
      const float w = expf(__ldcg(base + s * stride + d) - mm);
      ll = fmaf(__ldcg(base + s * stride + d + 1), w, ll);
      oo = fmaf(__ldcg(base + s * stride + i), w, oo);
    }
    out[i] = from_f32<TQ>(oo / fmaxf(ll, 1e-30f));
  }
  if (tid == 0) a.counters[row] = 0;  // ready for the next launch
}

// The splits a row of `tokens` keys takes at `chunk` tokens a split (at
// least one, so a row of an empty cache still writes its 0), in
// `n_splits`; false when the grid cannot hold them.
inline bool split_count(long long tokens, int chunk, int* n_splits) {
  if (chunk < 1 || tokens < 0 || tokens > INT_MAX) return false;
  const long long n = tokens > 0 ? (tokens + chunk - 1) / chunk : 1;
  *n_splits = static_cast<int>(n);
  return n <= 65535;
}

// Launches `Kernel` (a decode_split_body instance, or decode_group.cuh's
// grouped body) over (rows, n_splits) blocks of kT threads with `smem`
// bytes of dynamic shared memory, raising the kernel's limit on the
// current device once (and again only if a launch asks for more).
template <auto Kernel, int kT = kThreads, typename Args>
cudaError_t launch_split(const Args& a, int rows, int n_splits, size_t smem,
                         cudaStream_t stream) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  void (*kernel)(Args) = Kernel;
  if (smem > 48 * 1024) {
    static std::atomic<size_t> raised[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (raised[dev].load(std::memory_order_relaxed) < smem) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      raised[dev].store(smem, std::memory_order_relaxed);
    }
  }
  kernel<<<dim3(rows, n_splits), kT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
