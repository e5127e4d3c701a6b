// Flash-attention backward (B2 and B3) for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` (B2,
// easydist_tpu/ops/flash_attention.py:164) and `_flash_bwd_dkv_kernel`
// (B3, :197), both launched by `_flash_backward` (:235): the
// FlashAttention-2 backward, which recomputes the probabilities from the
// forward's saved logsumexp instead of keeping any [t_q, t_k] residual:
//
//   s  = (q * scale) . k       (keys past the query masked when causal)
//   P  = exp(s - lse)          dP = dO . v
//   dS = P * (dP - delta)      delta = rowsum(dO * O) - g_lse (computed
//                              outside, in torch, as XLA does on the TPU)
//   B2: dQ = sum_k dS K * scale
//   B3: dK = sum_q dS^T Q * scale,  dV = sum_q P^T dO
//
// in f32, outputs in the inputs' dtype.  q/k/v/dO [bh, t, d] float32 or
// bfloat16, lse/delta f32 [bh, t_q], head_dim 64 and 128, causal or
// full, any t_q and t_k (ragged tiles are masked here).
//
// What bounds them.  At the training shape (bh 96, t 1024, d 64, bf16,
// causal): B2 moves 63.7 MB (q, k, v, dO, lse, delta, dQ) and needs
// 19.3 GFLOP (three causal products), bound 19.5 us by operations at the
// tensor cores' 989 TFLOP/s; B3 moves 76.3 MB and needs 25.8 GFLOP (four
// products), bound 26.1 us by operations.  These kernels do their
// products in f32 on the CUDA cores, so arithmetic is what they wait on
// (their own floor at 67 TFLOP/s is about 0.29 ms and 0.39 ms).
//
// What the design does about it.  The split is the TPU's own, and it
// needs no atomics, so both kernels are deterministic:
//   * dQ: one block of 256 threads per (row block, Q tile), looping over
//     the K tiles up to the diagonal (tiles above it are neither loaded
//     nor computed: the `_kv_index_map` clamp) and keeping dQ in
//     registers;
//   * dK/dV: one block per (row block, K tile), with K and V staged once
//     and looping over the Q tiles from the first one that reaches the
//     diagonal (the `_q_index_map` clamp), keeping dK and dV in
//     registers.
// Every operand is staged in shared memory as f32, transposed where a
// product contracts over its columns and row-major where it contracts
// over its rows, so each step of each tile product is two 16-byte shared
// loads feeding 16 FMAs per thread.  P and dS go through shared memory
// between the two halves of a step (scores, then gradients).  No
// rounding enters beyond the outputs' casts.
//
// Known limits: as for the forward, f32 CUDA-core products; the dK/dV
// block stages eight tiles (139 KB at head_dim 64), so one block fits an
// SM.  Tensor-core products and a cp.async ring are the later steps.

#include "flash_attn_common.cuh"

namespace flash_train {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int t_q, int t_k, int causal, float scale) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  constexpr int TM = BQ / 16, TN = BK / 16, G = D / 64;
  constexpr int LQ = BQ + 4, LK = BK + 4, LV = D + 4;

  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;            // [D][LQ]  Q tile * scale, transposed
  float* do_t = q_t + D * LQ;   // [D][LQ]  dO tile, transposed
  float* k_t = do_t + D * LQ;   // [D][LK]  K tile, transposed
  float* k_s = k_t + D * LK;    // [BK][LV] K tile
  float* v_t = k_s + BK * LV;   // [D][LK]  V tile, transposed
  float* ds_t = v_t + D * LK;   // [BK][LQ] dS, transposed

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_off = static_cast<size_t>(bh) * t_q * D;
  const size_t kv_off = static_cast<size_t>(bh) * t_k * D;

  stage<BQ, D>(q + q_off, q0, t_q, scale, nullptr, q_t);
  stage<BQ, D>(dout + q_off, q0, t_q, 1.f, nullptr, do_t);

  float row_lse[TM], row_delta[TM], acc[G][TM][4] = {};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    const bool live = row < t_q;
    row_lse[i] = live ? lse[static_cast<size_t>(bh) * t_q + row] : 0.f;
    row_delta[i] = live ? delta[static_cast<size_t>(bh) * t_q + row] : 0.f;
  }

  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's readers are done
    stage<BK, D>(k + kv_off, k0, t_k, 1.f, k_s, k_t);
    stage<BK, D>(v + kv_off, k0, t_k, 1.f, nullptr, v_t);
    __syncthreads();

    float s[TM][TN] = {}, dp[TM][TN] = {};
    tile_product<TM, TN, D>(q_t + ty * TM, LQ, k_t + tx * TN, LK, s);
    tile_product<TM, TN, D>(do_t + ty * TM, LQ, v_t + tx * TN, LK, dp);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = k0 + tx * TN + j;
      float ds[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = q0 + ty * TM + i;
        const bool live = row < t_q && col < t_k && !(causal && col > row);
        const float p = live ? expf(s[i][j] - row_lse[i]) : 0.f;
        ds[i] = p * (dp[i][j] - row_delta[i]);
      }
      store_vec<TM>(ds_t + (tx * TN + j) * LQ + ty * TM, ds);
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g)
      tile_product<TM, 4, BK>(ds_t + ty * TM, LQ, k_s + 64 * g + tx * 4, LV,
                              acc[g]);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= t_q) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
      store4(dq + q_off + static_cast<size_t>(row) * D + 64 * g + tx * 4,
             make_float4(acc[g][i][0] * scale, acc[g][i][1] * scale,
                         acc[g][i][2] * scale, acc[g][i][3] * scale));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int t_q,
                         int t_k, int causal, float scale) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  // this thread: key rows ty*TK.., query columns tx*TQ.. of S^T
  constexpr int TK = BK / 16, TQ = BQ / 16, G = D / 64;
  constexpr int LQ = BQ + 4, LK = BK + 4, LV = D + 4;

  extern __shared__ __align__(16) float smem[];
  float* k_t = smem;             // [D][LK]  K tile, transposed
  float* v_t = k_t + D * LK;     // [D][LK]  V tile, transposed
  float* q_t = v_t + D * LK;     // [D][LQ]  Q tile * scale, transposed
  float* q_s = q_t + D * LQ;     // [BQ][LV] Q tile * scale
  float* do_t = q_s + BQ * LV;   // [D][LQ]  dO tile, transposed
  float* do_s = do_t + D * LQ;   // [BQ][LV] dO tile
  float* p_s = do_s + BQ * LV;   // [BQ][LK] P  (query row, key column)
  float* ds_s = p_s + BQ * LK;   // [BQ][LK] dS (query row, key column)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // under causal masking tile 0 is longest
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_off = static_cast<size_t>(bh) * t_q * D;
  const size_t kv_off = static_cast<size_t>(bh) * t_k * D;

  stage<BK, D>(k + kv_off, k0, t_k, 1.f, nullptr, k_t);
  stage<BK, D>(v + kv_off, k0, t_k, 1.f, nullptr, v_t);

  float dk_acc[G][TK][4] = {}, dv_acc[G][TK][4] = {};

  // Q tiles strictly above this K tile's first row see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < t_q; q0 += BQ) {
    __syncthreads();  // the last tile's readers are done
    stage<BQ, D>(q + q_off, q0, t_q, scale, q_s, q_t);
    stage<BQ, D>(dout + q_off, q0, t_q, 1.f, do_s, do_t);
    __syncthreads();

    float st[TK][TQ] = {}, dpt[TK][TQ] = {};
    tile_product<TK, TQ, D>(k_t + ty * TK, LK, q_t + tx * TQ, LQ, st);
    tile_product<TK, TQ, D>(v_t + ty * TK, LK, do_t + tx * TQ, LQ, dpt);
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int row = q0 + tx * TQ + j;  // query
      const bool row_live = row < t_q;
      const float r_lse =
          row_live ? lse[static_cast<size_t>(bh) * t_q + row] : 0.f;
      const float r_delta =
          row_live ? delta[static_cast<size_t>(bh) * t_q + row] : 0.f;
      float p[TK], ds[TK];
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        const int col = k0 + ty * TK + i;  // key
        const bool live = row_live && col < t_k && !(causal && col > row);
        p[i] = live ? expf(st[i][j] - r_lse) : 0.f;
        ds[i] = p[i] * (dpt[i][j] - r_delta);
      }
      store_vec<TK>(p_s + (tx * TQ + j) * LK + ty * TK, p);
      store_vec<TK>(ds_s + (tx * TQ + j) * LK + ty * TK, ds);
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) {
      tile_product<TK, 4, BQ>(p_s + ty * TK, LK, do_s + 64 * g + tx * 4, LV,
                              dv_acc[g]);
      tile_product<TK, 4, BQ>(ds_s + ty * TK, LK, q_s + 64 * g + tx * 4, LV,
                              dk_acc[g]);
    }
  }

#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int row = k0 + ty * TK + i;
    if (row >= t_k) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t at = kv_off + static_cast<size_t>(row) * D + 64 * g + tx * 4;
      // Q was staged times scale, so dK needs no further factor
      store4(dk + at, make_float4(dk_acc[g][i][0], dk_acc[g][i][1],
                                  dk_acc[g][i][2], dk_acc[g][i][3]));
      store4(dv + at, make_float4(dv_acc[g][i][0], dv_acc[g][i][1],
                                  dv_acc[g][i][2], dv_acc[g][i][3]));
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t_q, int t_k, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  const size_t smem =
      sizeof(float) * (2 * D * (BQ + 4) + 2 * D * (BK + 4) + BK * (D + 4) +
                       BK * (BQ + 4));
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int t_q, int t_k,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  const size_t smem =
      sizeof(float) * (2 * D * (BK + 4) + 2 * D * (BQ + 4) +
                       2 * BQ * (D + 4) + 2 * BQ * (BK + 4));
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_k + BK - 1) / BK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_train

// dtype: 0 float32, 1 bfloat16.  q/dout [bh, t_q, head_dim], k/v [bh, t_k,
// head_dim], lse/delta f32 [bh, t_q], outputs like their inputs; all
// contiguous on the current device, 16-byte aligned.  Each returns
// cudaGetLastError() after its launch.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh,
                                 int t_q, int t_k, int head_dim, int causal,
                                 float scale, int dtype, void* stream) {
  if (bh == 0 || t_q == 0) return cudaSuccess;
  if (t_k < 1 || (t_q + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flash_train::dispatch(dtype, head_dim, [&](auto t, auto d) {
    using T = decltype(t);
    return flash_train::launch_dq<T, decltype(d)::value>(
        q, k, v, dout, lse, delta, dq, bh, t_q, t_k, causal, scale, s);
  });
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int bh, int t_q,
                                  int t_k, int head_dim, int causal,
                                  float scale, int dtype, void* stream) {
  if (bh == 0 || t_k == 0) return cudaSuccess;
  if ((t_k + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flash_train::dispatch(dtype, head_dim, [&](auto t, auto d) {
    using T = decltype(t);
    return flash_train::launch_dkv<T, decltype(d)::value>(
        q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k, causal, scale, s);
  });
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
