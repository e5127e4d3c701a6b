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
// float32: `flash_fwd_kernel`, the CUDA-core kernel, kept for the f32
// promise (the compiled f32 train step equals the uncompiled one and the
// JAX trajectory at rtol 1e-4; tensor-core TF32 would lose digits).  One
// block of 256 threads per (row block, 64-query tile) loops over the K
// tiles up to the diagonal with m, l and the accumulator in registers;
// the Q tile (pre-scaled) and each K tile are staged transposed in shared
// memory and V row-major, all as f32, so every step of a tile product is
// two 16-byte shared loads feeding 16 FMAs per thread.  Arithmetic is f32
// end to end: no rounding enters beyond the output's cast.
//
// Known limits: the bf16 kernel serialises, within a warpgroup, the
// softmax of one tile and the products of the next (no ping-pong between
// the two warpgroups, no overlap inside one), stores its output straight
// from registers rather than through shared memory and TMA, and holds
// one block per SM; it runs at about 1.9x SDPA's forward.  The f32
// kernel runs at the CUDA cores' f32 rate and stages synchronously.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace flash_train {
namespace {

// ------------------------------------------- float32: CUDA cores

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int t_q, int t_k, int causal,
                     float scale) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  constexpr int TM = BQ / 16, TN = BK / 16, G = D / 64;
  constexpr int LQ = BQ + 4, LK = BK + 4, LV = D + 4;

  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;            // [D][LQ]  Q tile * scale, transposed
  float* k_t = q_t + D * LQ;    // [D][LK]  K tile, transposed
  float* v_s = k_t + D * LK;    // [BK][LV] V tile
  float* p_t = v_s + BK * LV;   // [BK][LQ] probabilities, transposed

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_off = static_cast<size_t>(bh) * t_q * D;
  const size_t kv_off = static_cast<size_t>(bh) * t_k * D;

  stage<BQ, D>(q + q_off, q0, t_q, scale, nullptr, q_t);

  float m[TM], l[TM], o[G][TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[g][i][j] = 0.f;
  }

  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's readers are done
    stage<BK, D>(k + kv_off, k0, t_k, 1.f, nullptr, k_t);
    stage<BK, D>(v + kv_off, k0, t_k, 1.f, v_s, nullptr);
    __syncthreads();

    float s[TM][TN] = {};
    tile_product<TM, TN, D>(q_t + ty * TM, LQ, k_t + tx * TN, LK, s);

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty * TM + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx * TN + j;
        if (col >= t_k)
          s[i][j] = -INFINITY;  // past the keys: weight exactly 0
        else if (causal && col > row)
          s[i][j] = kMaskFill;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);  // now the probability
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[g][i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float col[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) col[i] = s[i][j];
      store_vec<TM>(p_t + (tx * TN + j) * LQ + ty * TM, col);
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g)
      tile_product<TM, 4, BK>(p_t + ty * TM, LQ, v_s + 64 * g + tx * 4, LV,
                              o[g]);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= t_q) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g)
      store4(out + q_off + static_cast<size_t>(row) * D + 64 * g + tx * 4,
             make_float4(o[g][i][0] / l_safe, o[g][i][1] / l_safe,
                         o[g][i][2] / l_safe, o[g][i][3] / l_safe));
    if (tx == 0) lse[static_cast<size_t>(bh) * t_q + row] = m[i] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int t_q, int t_k, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  const size_t smem = sizeof(float) * (D * (BQ + 4) + D * (BK + 4) +
                                       BK * (D + 4) + BK * (BQ + 4));
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

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

}  // namespace
}  // namespace flash_train

// dtype: 0 float32 (the CUDA-core kernel), 1 bfloat16 (the tensor-core
// kernel).  q [bh, t_q, head_dim], k/v [bh, t_k, head_dim], out like q,
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
      return flash_train::launch<D>(q, k, v, out, lse, bh, t_q, t_k, causal,
                                    scale, s);
  });
}

extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
