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
// with s = (q * scale) . k, keys past the query filled with -1e30 when
// causal (positions aligned at 0), running max m and denominator l in
// f32, out = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)), as
// the TPU kernel computes them.  float32 and bfloat16, head_dim 64 and
// 128, any t_q and t_k (ragged tiles are masked here, not shrunk).
//
// What bounds it.  At the training shape (bh 96, t 1024, d 64, bf16,
// causal) the function moves 50.7 MB (q, k, v and out once, lse) and
// needs 12.9 GFLOP (two causal products); over 3.35 TB/s and the
// tensor cores' 989 TFLOP/s the bound is 15.1 us, set by bytes.  This
// kernel does its products in f32 on the CUDA cores (67 TFLOP/s peak),
// so arithmetic, not memory, is what it waits on: its own floor is
// about 0.2 ms.
//
// What the design does about it.  The TPU carries m, l and the output
// accumulator across the sequential K axis of its grid in VMEM scratch;
// CUDA blocks run in no order, so one block of 256 threads owns one
// (row block, Q tile) and loops over the K tiles itself, keeping m, l
// and the accumulator in registers.  Under causal masking the loop
// stops at the diagonal: tiles above it are neither loaded nor computed
// (the TPU's `_kv_index_map` clamp).  The Q tile (pre-scaled) and each K
// tile are staged transposed in shared memory and V row-major, all as
// f32, so every step of a tile product is two 16-byte shared loads
// feeding 16 FMAs per thread (4 x 4 register tiles).  Blocks are issued
// longest first (the last Q tile has the most K tiles under causal
// masking), so the tail of the grid is short.  Arithmetic is f32 end to
// end: no rounding enters beyond the output's cast to its dtype.
//
// Known limits: f32 CUDA-core products reach at most 1/15 of the bf16
// tensor-core rate; mma.sync / wgmma with bf16 operands, and a cp.async
// ring to overlap the next tile's load with this tile's products, are
// the later steps.

#include "flash_attn_common.cuh"

namespace flash_train {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int t_q, int t_k, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  const size_t smem = sizeof(float) * (D * (BQ + 4) + D * (BK + 4) +
                                       BK * (D + 4) + BK * (BQ + 4));
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_train

// dtype: 0 float32, 1 bfloat16.  q [bh, t_q, head_dim], k/v [bh, t_k,
// head_dim], out like q, lse f32 [bh, t_q]; all contiguous on the current
// device, 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int bh, int t_q, int t_k,
                              int head_dim, int causal, float scale,
                              int dtype, void* stream) {
  if (bh == 0 || t_q == 0) return cudaSuccess;
  if (t_k < 1 || (t_q + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flash_train::dispatch(dtype, head_dim, [&](auto t, auto d) {
    using T = decltype(t);
    return flash_train::launch<T, decltype(d)::value>(
        q, k, v, out, lse, bh, t_q, t_k, causal, scale, s);
  });
}

extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
