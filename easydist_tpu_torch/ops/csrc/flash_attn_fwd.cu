// Flash-attention forward (B1) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel`
// (easydist_tpu/ops/flash_attention.py:78, host `_flash_forward` :117,
// API `flash_attention_lse` :354).  For each (batch*head) row block and
// each query row, online-softmax attention over the keys:
//
//   q [bh, t_q, d], k/v [bh, t_k, d]  ->  out [bh, t_q, d] (q's dtype),
//                                         lse [bh, t_q] (f32)
//
// with s = (q . k) * scale, keys past the query filled with -1e30 when
// causal (positions aligned at 0), running max m and denominator l in
// f32, out = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)), as
// the TPU kernel computes them.  float32 and bfloat16, head_dim 64 and
// 128, any t_q and t_k (ragged tiles are masked here, not shrunk).
//
// What bounds it.  At the training shape (bh 96, t 1024, d 64, bf16,
// causal) the function moves 50.7 MB (q, k, v and out once, lse) and
// needs 12.9 GFLOP (two causal products); over 3.35 TB/s and the
// tensor cores' 989 TFLOP/s the bound is 15.1 us, set by bytes.
//
// bfloat16: `flash_fwd_sm90_kernel`, on the tensor cores.  One block per
// (row block, 128-query tile), issued longest first (the last query tile
// has the most key tiles under causal masking).  One warp of a producer
// warpgroup loads the Q tile once and keeps K/V tiles in flight through
// a two-stage TMA ring (full/empty mbarriers), so the next tile's load
// overlaps this tile's products; tiles above the diagonal are neither
// loaded nor computed (the TPU's `_kv_index_map` clamp).  The producer
// hands its registers to the consumers (`setmaxnreg`: 40 a thread
// against 232), so S, O and P's fragments fit without spilling.  Two
// consumer warpgroups
// own 64 query rows each: S = Q.K^T is one `wgmma` (A and B from shared
// memory) per 16 columns of d, scaled in f32 after the product; the mask
// touches only tiles that cross the diagonal or the ragged end; the
// online softmax stays in registers (exp2 with log2 e folded into the
// scale).  P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and
// O += P_hi.V + P_lo.V runs as two register-A `wgmma`s with V read
// through the transpose bit.  Why the split: bf16 products of bf16
// inputs are exact in f32, so the only rounding the tensor cores add is
// P's; one bf16 cast puts a 2^-9 relative error on every weight and
// lands about 140x over the f32 bar this kernel is held to, the split
// leaves an error below the output's own bf16 rounding.  It costs three
// products where the function has two.  Key tiles are 128 wide at
// head_dim 64 and 64 wide at 128, so S (64 or 32 registers), O (32 or
// 64) and P's split fragments fit the 232 (`ptxas -v` in the build's
// .log: no spills).  A third ring stage measured no faster.  The
// epilogue rounds out to bf16 once.
//
// float32: `flash_fwd_tf32_kernel`, on the tensor cores as well, held to
// the f32 bar (rtol 1e-4 / atol 1e-5 on out and lse; the f32 train step
// equals the uncompiled one) by splitting every operand: x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (`cvt.rna`), and a.b as the three
// TF32 products a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, each exact in f32 and
// summed in f32.  What is dropped (a_lo.b_lo and lo's own rounding) is
// about 2^-21 of the product, where one TF32 cast loses 2^-11
// (`TestSplitRounding` emulates both on the CPU).  Both S = Q.K^T and
// O = P.V run so, six products where the function has two; at 495
// TFLOP/s dense TF32 that is still under two f32 products on the CUDA
// cores (67 TFLOP/s).  The bound is the function's: 101.1 MB over 3.35
// TB/s, 30.2 us, against its two products at the TF32 rate, 26.1 us
// (bh 96, t 1024, d 64, causal).  The block is B1 bf16's: a producer
// warpgroup and consumer warpgroups of 64 query rows, issued longest
// first, tiles above the diagonal never loaded.  TF32 `wgmma` takes both
// operands K-major only (the transpose bit is for 16-bit types), so P.V
// needs V^T with the keys contiguous, which TMA cannot make.  So one
// warp of the producer warpgroup streams raw f32 K/V tiles by TMA into a
// ring of raw stages, and its three other warps split each landed tile
// into K_hi/K_lo (the same swizzled layout, element by element) and
// V^T_hi/V^T_lo (transposed, keys contiguous) in a ring of converted
// stages, then release the raw stage and arrive on the converted stage's
// full barrier (after a proxy fence: `wgmma` reads shared memory through
// the async proxy).  The TF32 A fragment is not the accumulator's layout
// (see flash_attn_sm90.cuh): rather than shuffle P, the converters store
// each 8-key group of V^T in the order 0 2 4 6 1 3 5 7, so a thread's
// accumulator pair (2c, 2c + 1) is its A fragment's columns (c, c + 4).
// The softmax is B1 bf16's, in f32 (scale after the product, exp2, the
// -1e30 fill, the 1e-30 clamp).  Key tiles are 32 wide.  head_dim 64:
// two consumer warpgroups (128 queries), Q's halves in registers as A
// fragments (64 a thread), two raw and four converted stages (160 KB),
// `setmaxnreg` 56 / 224.  (With 64-key tiles, S = Q.K^T as register-A
// m64n64k8 products of the Q fragments drifted to one-cast accuracy,
// ~1e-4, on every key tile after a block's first, while 32-key tiles, or
// Q from shared memory, held ~1e-6 of a float64 reference: so 32.)
// head_dim 128: Q's halves would take 128 registers, so they sit in
// shared memory (split by the consumers themselves), one consumer
// warpgroup of 64 queries, one raw and two converted stages (224 KB).
//
// Known limits: the bf16 kernel serialises, within a warpgroup, the
// softmax of one tile and the products of the next (no ping-pong between
// the two warpgroups, no overlap inside one), stores its output straight
// from registers rather than through shared memory and TMA, and holds
// one block per SM; it runs at about 1.5-1.8x SDPA's forward.  The f32
// kernel serialises the same way, and its converters add a shared-memory
// pass over every K/V tile.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace flash_train {
namespace {

// ------------------------------------------- bfloat16: tensor cores (sm90)

template <int D>
struct FwdSm90 {
  static constexpr int kBQ = 128;                 // two warpgroups of 64 rows
  static constexpr int kBK = D == 64 ? 128 : 64;  // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kPanels = D / sm90::kPanelCols;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;    // one K or V tile
  static constexpr int kThreads = 384;  // + a producer warpgroup
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(FwdSm90<D>::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int t_q, int t_k,
                          int causal, float scale_log2) {
  using C = FwdSm90<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align1024(smem_raw);
  uint8_t* k_s = q_s + C::kQBytes;        // [S] K tiles
  uint8_t* v_s = k_s + S * C::kKVBytes;   // [S] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + S * C::kKVBytes);
  uint64_t* kv_full = q_full + 1;         // [S]
  uint64_t* kv_empty = kv_full + S;       // [S]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  const int n_kt = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one warp loads, three idle
    sm90::regs_release<sm90::kProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      sm90::mbar_expect_tx(q_full, C::kQBytes);
      sm90::tma_load_tile(q_s, &map_q, q_full, C::kPanels, BQ, q0, bh);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % S;
        if (it >= S) sm90::mbar_wait(&kv_empty[s], (it / S - 1) & 1);
        sm90::mbar_expect_tx(&kv_full[s], 2 * C::kKVBytes);
        sm90::tma_load_tile(k_s + s * C::kKVBytes, &map_k, &kv_full[s],
                            C::kPanels, BK, it * BK, bh);
        sm90::tma_load_tile(v_s + s * C::kKVBytes, &map_v, &kv_full[s],
                            C::kPanels, BK, it * BK, bh);
      }
    }
    return;
  }

  sm90::regs_take<sm90::kConsumerRegs>();
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 64
  const int wg = warp / 4;
  const int row_a = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  const int c2 = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kMaskFill, m_b = kMaskFill, l_a = 0.f, l_b = 0.f;

  const uint32_t q_addr = sm90::smem_u32(q_s) + 64 * wg * sm90::kRowBytes;
  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % S;
    const int k0 = it * BK;
    const uint32_t k_addr = sm90::smem_u32(k_s + s * C::kKVBytes);
    const uint32_t v_addr = sm90::smem_u32(v_s + s * C::kKVBytes);
    sm90::mbar_wait(&kv_full[s], (it / S) & 1);

    float sc[BK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // bytes into the panel's rows
      sm90::wgmma_ss<0>(
          sc, sm90::desc_k_major(q_addr + (kk / 4) * BQ * 128 + col),
          sm90::desc_k_major(k_addr + (kk / 4) * BK * 128 + col), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);

    // scores in log2 units, masked where the tile crosses the diagonal
    // or the ragged end; the row max
    const bool edge =
        k0 + BK > t_k || (causal && k0 + BK - 1 > q0 + 64 * wg);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = sc[4 * j + e] * scale_log2;
        float xb = sc[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + c2 + e;
          if (col >= t_k) {
            xa = xb = -INFINITY;  // past the keys: weight exactly 0
          } else if (causal) {
            if (col > row_a) xa = kMaskFill;
            if (col > row_b) xb = kMaskFill;
          }
        }
        sc[4 * j + e] = xa;
        sc[4 * j + 2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    const float mn_a = fmaxf(m_a, sm90::quad_max(mx_a));
    const float mn_b = fmaxf(m_b, sm90::quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mn_a);  // now P
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn_b);
        ps_a += sc[4 * j + e];
        ps_b += sc[4 * j + 2 + e];
      }
    l_a = l_a * al_a + ps_a;  // this lane's columns; quad-summed at the end
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }

    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    sm90::split_frags(sc, p_hi, p_lo);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv =
          sm90::desc_mn_major(v_addr + kk * 16 * 128, BK * 128);
      sm90::wgmma_rs<1>(o, p_hi[kk], dv);
      sm90::wgmma_rs<1>(o, p_lo[kk], dv);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    sm90::fence_regs(p_hi);
    sm90::fence_regs(p_lo);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&kv_empty[s]);  // this warp is done
  }

  const float ls_a = fmaxf(sm90::quad_sum(l_a), 1e-30f);
  const float ls_b = fmaxf(sm90::quad_sum(l_b), 1e-30f);
  const size_t row0 = static_cast<size_t>(bh) * t_q;
  if (row_a < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      sm90::store_bf16x2(out + (row0 + row_a) * D + 8 * j + c2,
                         o[4 * j] / ls_a, o[4 * j + 1] / ls_a);
    if (c2 == 0) lse[row0 + row_a] = m_a * sm90::kLn2 + logf(ls_a);
  }
  if (row_b < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      sm90::store_bf16x2(out + (row0 + row_b) * D + 8 * j + c2,
                         o[4 * j + 2] / ls_b, o[4 * j + 3] / ls_b);
    if (c2 == 0) lse[row0 + row_b] = m_b * sm90::kLn2 + logf(ls_b);
  }
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        void* out, void* lse, int bh, int t_q, int t_k,
                        int causal, float scale, cudaStream_t stream) {
  using C = FwdSm90<D>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t e = sm90::make_tile_map(&map_q, q, bh, t_q, D, C::kBQ);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_k, k, bh, t_k, D, C::kBK);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_v, v, bh, t_k, D, C::kBK);
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_fwd_sm90_kernel<D>;
  e = allow_smem(kernel, C::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), t_q, t_k, causal, scale * sm90::kLog2e);
  return cudaGetLastError();
}

// ----------------------------------- float32: tensor cores, three TF32 products

template <int D>
struct FwdTf32 {
  static constexpr int kWG = D == 64 ? 2 : 1;        // consumer warpgroups
  static constexpr int kBQ = 64 * kWG;               // queries a block
  static constexpr int kBK = 32;                     // keys a tile
  static constexpr bool kQRegs = D == 64;            // Q's halves in registers
  static constexpr int kRaw = D == 64 ? 2 : 1;       // raw K/V stages
  static constexpr int kConv = D == 64 ? 4 : 2;      // converted stages
  static constexpr int kPanels = D / sm90::kPanelColsF32;
  static constexpr int kTileBytes = kBK * D * 4;     // one f32 K or V tile
  static constexpr int kRawBytes = 2 * kTileBytes;   // K, V
  static constexpr int kConvBytes = 4 * kTileBytes;  // K_hi, K_lo, V^T_hi, V^T_lo
  static constexpr int kQBytes = kQRegs ? 0 : 2 * kBQ * D * 4;  // Q_hi, Q_lo
  static constexpr int kConverters = 96;             // producer warps 1-3
  static constexpr int kThreads = 128 * (1 + kWG);
  // registers a thread after `setmaxnreg` (two consumer warpgroups only;
  // one consumer warpgroup keeps the 255 of a 256-thread block)
  static constexpr int kProducerRegs = 56, kConsumerRegs = 224;
  static_assert(kWG == 1 || 128 * (kProducerRegs + kWG * kConsumerRegs) <=
                                65536,
                "the SM's register file");
  static constexpr size_t kSmem = 1024 + kQBytes + kRaw * kRawBytes +
                                  kConv * kConvBytes + 16 * (kRaw + kConv);
  static_assert(kSmem <= 227 * 1024, "the shared memory a block may use");
};

// One landed raw stage (K then V, each [BK rows][D] f32 in 128-byte
// swizzled panels of 32 columns) into a converted stage: K_hi and K_lo in
// the same layout, and V^T_hi, V^T_lo as [D rows][BK keys] in swizzled
// panels of 32 keys, each 8-key group in the order 0 2 4 6 1 3 5 7.
// Thread `ct` of the 96 converters; a warp takes 32 neighbouring columns
// of V, so its reads and its transposed 16-byte writes are free of bank
// conflicts.
template <int D, int BK>
__device__ __forceinline__ void convert_tile(const uint8_t* raw, uint8_t* conv,
                                             int ct) {
  constexpr int T = BK * D * 4;
  constexpr int kConverters = FwdTf32<D>::kConverters;
  sm90::split_tile<T, kConverters>(raw, conv, conv + T, ct);
  sm90::split_transposed<BK, D, kConverters>(raw + T, conv + 2 * T,
                                             conv + 3 * T, ct);
}

template <int D>
__global__ void __launch_bounds__(FwdTf32<D>::kThreads, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const float* __restrict__ q,
                          float* __restrict__ out, float* __restrict__ lse,
                          int t_q, int t_k, int causal, float scale_log2) {
  using C = FwdTf32<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, R = C::kRaw, S = C::kConv;
  constexpr int T = C::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align1024(smem_raw);     // Q_hi, Q_lo (head_dim 128)
  uint8_t* raw_s = q_s + C::kQBytes;            // [R] raw K, V
  uint8_t* conv_s = raw_s + R * C::kRawBytes;   // [S] converted stages
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(conv_s + S * C::kConvBytes);
  uint64_t* raw_empty = raw_full + R;
  uint64_t* conv_full = raw_empty + R;
  uint64_t* conv_empty = conv_full + S;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  const int n_kt = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int r = 0; r < R; ++r) {
      sm90::mbar_init(&raw_full[r], 1);
      sm90::mbar_init(&raw_empty[r], C::kConverters);
    }
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&conv_full[s], C::kConverters);
      sm90::mbar_init(&conv_empty[s], 4 * C::kWG);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * C::kWG) {  // producer warpgroup: one warp loads, three split
    if constexpr (C::kWG > 1) sm90::regs_release<C::kProducerRegs>();
    if (warp == 4 * C::kWG) {
      if (lane == 0) {
        for (int it = 0; it < n_kt; ++it) {
          const int r = it % R;
          if (it >= R) sm90::mbar_wait(&raw_empty[r], (it / R - 1) & 1);
          sm90::mbar_expect_tx(&raw_full[r], C::kRawBytes);
          uint8_t* dst = raw_s + r * C::kRawBytes;
          sm90::tma_load_tile(dst, &map_k, &raw_full[r], C::kPanels, BK,
                              it * BK, bh, sm90::kPanelColsF32);
          sm90::tma_load_tile(dst + T, &map_v, &raw_full[r], C::kPanels, BK,
                              it * BK, bh, sm90::kPanelColsF32);
        }
      }
      return;
    }
    const int ct = threadIdx.x - 128 * C::kWG - 32;
    for (int it = 0; it < n_kt; ++it) {
      const int r = it % R, s = it % S;
      sm90::mbar_wait(&raw_full[r], (it / R) & 1);
      if (it >= S) sm90::mbar_wait(&conv_empty[s], (it / S - 1) & 1);
      convert_tile<D, BK>(raw_s + r * C::kRawBytes,
                          conv_s + s * C::kConvBytes, ct);
      sm90::fence_proxy_async();  // the stores, before the consumers' wgmma
      sm90::mbar_arrive(&raw_empty[r]);
      sm90::mbar_arrive(&conv_full[s]);
    }
    return;
  }

  if constexpr (C::kWG > 1) sm90::regs_take<C::kConsumerRegs>();
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 64
  const int wg = warp / 4;
  const int row_a = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  const int c = lane % 4, c2 = 2 * c;
  const float* qb = q + static_cast<size_t>(bh) * t_q * D;

  // Q's halves: A fragments (columns 8 kk + c and + 4 of rows a and b),
  // or this warpgroup's 64 rows in shared memory, swizzled K-major
  uint32_t q_hi[C::kQRegs ? D / 8 : 1][4], q_lo[C::kQRegs ? D / 8 : 1][4];
  const uint32_t q_addr = sm90::smem_u32(q_s) + 64 * wg * sm90::kRowBytes;
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i % 2 ? row_b : row_a;
        const int col = 8 * kk + c + 4 * (i / 2);
        const float x = row < t_q ? qb[static_cast<size_t>(row) * D + col]
                                  : 0.f;
        sm90::split_tf32(x, q_hi[kk][i], q_lo[kk][i]);
      }
  } else {
    for (int i = threadIdx.x % 128; i < 64 * D / 4; i += 128) {
      const int r = 64 * wg + i / (D / 4), col = 4 * (i % (D / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < t_q)
        x = *reinterpret_cast<const float4*>(
            qb + static_cast<size_t>(q0 + r) * D + col);
      const int off = (col / 32) * BQ * 128 + r * 128 +
                      ((((col % 32) / 4) ^ (r % 8)) * 16);
      uint4 hi, lo;
      sm90::split_tf32(x, hi, lo);
      *reinterpret_cast<uint4*>(q_s + off) = hi;
      *reinterpret_cast<uint4*>(q_s + BQ * D * 4 + off) = lo;
    }
    sm90::fence_proxy_async();
    sm90::named_sync(1 + wg, 128);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kMaskFill, m_b = kMaskFill, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int s = it % S;
    const int k0 = it * BK;
    const uint32_t k_hi = sm90::smem_u32(conv_s + s * C::kConvBytes);
    const uint32_t k_lo = k_hi + T, v_hi = k_hi + 2 * T, v_lo = k_hi + 3 * T;
    sm90::mbar_wait(&conv_full[s], (it / S) & 1);
    if (causal && k0 > q0 + 64 * wg + 63) {  // wholly above this warpgroup
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&conv_empty[s]);
      continue;
    }

    // S = Q_hi.K_hi + Q_hi.K_lo + Q_lo.K_hi, 8 columns of d a step
    float sc[BK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t kc = (kk / 4) * BK * 128 + (kk % 4) * 32;
      if constexpr (C::kQRegs) {
        const uint64_t dk_hi = sm90::desc_k_major(k_hi + kc);
        sm90::wgmma_tf32_rs(sc, q_hi[kk], dk_hi, kk > 0);
        sm90::wgmma_tf32_rs(sc, q_hi[kk], sm90::desc_k_major(k_lo + kc), 1);
        sm90::wgmma_tf32_rs(sc, q_lo[kk], dk_hi, 1);
      } else {
        const uint32_t qc = q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint64_t dq_hi = sm90::desc_k_major(qc);
        sm90::wgmma_tf32_ss(sc, dq_hi, sm90::desc_k_major(k_hi + kc), kk > 0);
        sm90::wgmma_tf32_ss(sc, dq_hi, sm90::desc_k_major(k_lo + kc), 1);
        sm90::wgmma_tf32_ss(sc, sm90::desc_k_major(qc + BQ * D * 4),
                            sm90::desc_k_major(k_hi + kc), 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);
    if constexpr (C::kQRegs) {
      sm90::fence_regs(q_hi);
      sm90::fence_regs(q_lo);
    }

    // scores in log2 units, masked where the tile crosses the diagonal
    // or the ragged end; the row max
    const bool edge =
        k0 + BK > t_k || (causal && k0 + BK - 1 > q0 + 64 * wg);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = sc[4 * j + e] * scale_log2;
        float xb = sc[4 * j + 2 + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + c2 + e;
          if (col >= t_k) {
            xa = xb = -INFINITY;  // past the keys: weight exactly 0
          } else if (causal) {
            if (col > row_a) xa = kMaskFill;
            if (col > row_b) xb = kMaskFill;
          }
        }
        sc[4 * j + e] = xa;
        sc[4 * j + 2 + e] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    const float mn_a = fmaxf(m_a, sm90::quad_max(mx_a));
    const float mn_b = fmaxf(m_b, sm90::quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - mn_a);  // now P
        sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mn_b);
        ps_a += sc[4 * j + e];
        ps_b += sc[4 * j + 2 + e];
      }
    l_a = l_a * al_a + ps_a;  // this lane's columns; quad-summed at the end
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }

    // P's halves as A fragments: keys 2c and 2c + 1 of each 8-key group
    // are the fragment's columns c and c + 4 (V^T stored to match)
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
    sm90::split_frags_tf32(sc, p_hi, p_lo);
    // O += P_hi.V_hi + P_hi.V_lo + P_lo.V_hi, 8 keys a step
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t vc = (kk / 4) * D * 128 + (kk % 4) * 32;
      const uint64_t dv_hi = sm90::desc_k_major(v_hi + vc);
      sm90::wgmma_tf32_rs(o, p_hi[kk], dv_hi, 1);
      sm90::wgmma_tf32_rs(o, p_hi[kk], sm90::desc_k_major(v_lo + vc), 1);
      sm90::wgmma_tf32_rs(o, p_lo[kk], dv_hi, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    sm90::fence_regs(p_hi);
    sm90::fence_regs(p_lo);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&conv_empty[s]);  // this warp is done
  }

  const float ls_a = fmaxf(sm90::quad_sum(l_a), 1e-30f);
  const float ls_b = fmaxf(sm90::quad_sum(l_b), 1e-30f);
  const size_t row0 = static_cast<size_t>(bh) * t_q;
  if (row_a < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + (row0 + row_a) * D + 8 * j + c2) =
          make_float2(o[4 * j] / ls_a, o[4 * j + 1] / ls_a);
    if (c == 0) lse[row0 + row_a] = m_a * sm90::kLn2 + logf(ls_a);
  }
  if (row_b < t_q) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + (row0 + row_b) * D + 8 * j + c2) =
          make_float2(o[4 * j + 2] / ls_b, o[4 * j + 3] / ls_b);
    if (c == 0) lse[row0 + row_b] = m_b * sm90::kLn2 + logf(ls_b);
  }
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* out, void* lse, int bh, int t_q, int t_k,
                        int causal, float scale, cudaStream_t stream) {
  using C = FwdTf32<D>;
  if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorInvalidValue;
  CUtensorMap map_k, map_v;
  cudaError_t e = sm90::make_tile_map(&map_k, k, bh, t_k, D, C::kBK, 4);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_v, v, bh, t_k, D, C::kBK, 4);
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_fwd_tf32_kernel<D>;
  e = allow_smem(kernel, C::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_k, map_v, static_cast<const float*>(q), static_cast<float*>(out),
      static_cast<float*>(lse), t_q, t_k, causal, scale * sm90::kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_train

// dtype: 0 float32 (the three-product TF32 kernel), 1 bfloat16; both on
// the tensor cores.  q [bh, t_q, head_dim], k/v [bh, t_k, head_dim], out like q,
// lse f32 [bh, t_q]; all contiguous on the current device, 16-byte
// aligned.  Returns cudaGetLastError() after the launch (or the error of
// the tensor maps' encoding).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int t_q, int t_k,
                              int head_dim, int causal, float scale,
                              int dtype, void* stream) {
  if (bh == 0 || t_q == 0) return cudaSuccess;
  if (t_k < 1 || (t_q + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flash_train::dispatch(dtype, head_dim, [&](auto t, auto d) {
    constexpr int D = decltype(d)::value;
    if constexpr (std::is_same_v<decltype(t), __nv_bfloat16>)
      return flash_train::launch_sm90<D>(q, k, v, out, lse, bh, t_q, t_k,
                                         causal, scale, s);
    else
      return flash_train::launch_tf32<D>(q, k, v, out, lse, bh, t_q, t_k,
                                         causal, scale, s);
  });
}

extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
