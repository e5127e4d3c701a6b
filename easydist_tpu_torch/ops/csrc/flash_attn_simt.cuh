// B1 (forward), B2 (dQ) and B3 (dK, dV) at every head_dim from 1 to 256
// that the tensor-core routes do not take (they take 64 and 128), for
// Hopper (sm_90a): `flash_fwd_simt_kernel`, `flash_bwd_dq_simt_kernel`,
// `flash_bwd_dkv_simt_kernel`.
//
// Replace the same TPU kernels as the tensor-core routes
// (easydist_tpu/ops/flash_attention.py:78, :164, :197) over the rest of
// their domain: the TPU kernels block over the sequence and keep the
// head_dim whole, so they take any width.  The tensor-core routes cannot
// as they stand: a TMA tensor map needs a row stride that is a multiple
// of 16 bytes, and `wgmma` takes K in steps of 16 (bf16) or 8 (TF32).
// These kernels compute the same functions as the tensor-core routes
// (flash_attn_fwd.cu, flash_attn_bwd.cu), in f32 FMAs on the CUDA cores:
// the -1e30 causal fill, the 1e-30 denominator clamp, lse = m + log(l),
// dS = P * (dP - delta).  bfloat16 inputs are widened to f32 as they are
// loaded, P and dS are never rounded, and each output is rounded to the
// inputs' dtype once, so the f32 route holds the f32 bars without any
// hi/lo split.
//
// What bounds them.  The function's products: at Cerebras-GPT-2.7B's
// training shape (bh 32 a sequence, t 2048, d 80, causal) the forward
// moves 42 MB a sequence in bf16 and does 21.5 GFLOP (two causal
// products), 0.022 ms at the tensor cores' 989 TFLOP/s against 0.013 ms
// of bytes at 3.35 TB/s.  These kernels run on the CUDA cores (67
// TFLOP/s of f32 at best), which is what a first design that is right
// gives up; the tensor cores at these widths (K padded to 16 with zeros)
// are later work.
//
// Design.  Rows q (B1, B2) or keys (B3) are shared by teams of
// `DP / 8` lanes of one warp, each lane holding 8 of the row's dims
// (lane t: dims t, t + team, ..., so a team reads consecutive words of a
// shared tile and the teams of a warp read the same words: no bank
// conflicts).  `DP` is the head_dim padded to the next of 32, 64, 128,
// 256 (a template parameter, so four instantiations a kernel and dtype);
// every dim at or past d is zero in registers and in shared memory, and
// zeros add nothing to a product, so the result is exact.  q, k, v and dO
// are read at their own d with element loads (no alignment beyond the
// element's).  A block of 256 threads owns 256 / team rows and walks the
// other side in tiles of 32 rows staged in shared memory as f32 [32][DP]
// (64 KB for K and V at DP 256): scores are team sums (xor shuffles), the
// forward's softmax is online in f32 (a running max and sum a row),
// B2's and B3's probabilities come from the saved lse.  Under causal
// masking the forward and dQ stop at the block's last visible key, and
// B3 starts at the block's first visible query (the TPU's `_kv_index_map`
// clamp); query tiles are issued longest first.  No atomics: two launches
// are bitwise equal.
//
// Registers: each lane holds 8 dims of each of its row's vectors (q and
// O in B1; q, dO and dQ in B2; k, v, dK and dV in B3) whatever DP is,
// and B1 its tile's 32 scores; ptxas gives B1 103-105, B2 63 and B3 80
// registers a thread at every width, no spill (two blocks of 256
// threads an SM by registers).
//
// Known limits: the team sums take log2(team) shuffles a score, every
// product reads shared memory once a multiply-add, the padding to a
// power of two wastes up to half the work (d 80 runs at DP 128), and a
// block at DP 256 holds only 8 rows a tile.  At [2, 32, 2048, 80]
// (chip_smoke.py phase 3) they run slower than the plain version's
// cuBLAS products.

#pragma once

#include "flash_attn_common.cuh"

namespace flash_train {
namespace simt {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // keys (B1, B2) or queries (B3) a staged tile
constexpr int kSlice = 8;  // dims a lane

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

template <int kTeam>
__device__ __forceinline__ float team_sum(float x) {
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows r0 .. r0 + kTile - 1 of a [rows, d] slab (rows past `rows` and
// dims past d as zeros) into shared memory as f32 [kTile][DP]
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int r0,
                                           int rows, int d) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = r0 + i / DP, c = i % DP;
    dst[i] = (r < rows && c < d)
                 ? to_f32(src[static_cast<size_t>(r) * d + c])
                 : 0.f;
  }
}

// This lane's 8 dims of a row (dims past d as zeros), times `mul`
template <typename T, int kTeam>
__device__ __forceinline__ void load_slice(float (&x)[kSlice], const T* row,
                                           int t, int d, bool live,
                                           float mul = 1.f) {
#pragma unroll
  for (int m = 0; m < kSlice; ++m) {
    const int c = t + kTeam * m;
    x[m] = (live && c < d) ? to_f32(row[c]) * mul : 0.f;
  }
}

template <typename T, int kTeam>
__device__ __forceinline__ void store_slice(T* row, const float (&x)[kSlice],
                                            int t, int d, float mul) {
#pragma unroll
  for (int m = 0; m < kSlice; ++m) {
    const int c = t + kTeam * m;
    if (c < d) row[c] = from_f32<T>(x[m] * mul);
  }
}

template <int DP>
struct Cfg {
  static_assert(DP == 32 || DP == 64 || DP == 128 || DP == 256,
                "padded head_dim");
  static constexpr int kTeam = DP / kSlice;      // lanes a row
  static constexpr int kRows = kThreads / kTeam;  // rows a block
  // dynamic shared memory: two f32 tiles (K and V; Q and dO) and, for
  // B3, the query tile's lse and delta rows
  static constexpr size_t kSmemFwd = 2 * kTile * DP * 4;
  static constexpr size_t kSmemDq = kSmemFwd;
  static constexpr size_t kSmemDkv = kSmemFwd + 2 * kTile * 4;
};

// ------------------------------------------------------------------- B1

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          float* __restrict__ lse, int t_q, int t_k, int d,
                          int causal, float scale) {
  using C = Cfg<DP>;
  constexpr int kTeam = C::kTeam;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = smem + kTile * DP;
  const size_t bh = blockIdx.x;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * C::kRows;
  const int t = threadIdx.x % kTeam;
  const int qi = q0 + threadIdx.x / kTeam;
  const bool live = qi < t_q;
  const size_t row = bh * t_q + (live ? qi : 0);

  float qr[kSlice], o[kSlice];
  load_slice<T, kTeam>(qr, q + row * d, t, d, live, scale);
#pragma unroll
  for (int m = 0; m < kSlice; ++m) o[m] = 0.f;
  float m_run = -INFINITY, l = 0.f;
  const int n_keys = causal ? min(t_k, q0 + C::kRows) : t_k;
  const T* kb = k + bh * t_k * d;
  const T* vb = v + bh * t_k * d;
  for (int j0 = 0; j0 < n_keys; j0 += kTile) {
    __syncthreads();  // the last tile is consumed
    stage_tile<T, DP>(k_s, kb, j0, t_k, d);
    stage_tile<T, DP>(v_s, vb, j0, t_k, d);
    __syncthreads();
    const int n = min(kTile, t_k - j0);
    float s[kTile];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < kSlice; ++m)
        part = fmaf(qr[m], k_s[j * DP + t + kTeam * m], part);
      part = team_sum<kTeam>(part);
      if (causal && j0 + j > qi) part = kMaskFill;
      s[j] = part;
      if (j < n) mx = fmaxf(mx, part);
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l *= alpha;
#pragma unroll
    for (int m = 0; m < kSlice; ++m) o[m] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = j < n ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int m = 0; m < kSlice; ++m)
        o[m] = fmaf(p, v_s[j * DP + t + kTeam * m], o[m]);
    }
  }
  if (!live) return;
  const float ls = fmaxf(l, 1e-30f);
  store_slice<T, kTeam>(out + row * d, o, t, d, 1.f / ls);
  if (t == 0) lse[row] = m_run + logf(ls);
}

// ------------------------------------------------------------------- B2

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, int t_q, int t_k, int d,
                             int causal, float scale) {
  using C = Cfg<DP>;
  constexpr int kTeam = C::kTeam;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = smem + kTile * DP;
  const size_t bh = blockIdx.x;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * C::kRows;
  const int t = threadIdx.x % kTeam;
  const int qi = q0 + threadIdx.x / kTeam;
  const bool live = qi < t_q;
  const size_t row = bh * t_q + (live ? qi : 0);

  float qr[kSlice], dor[kSlice], acc[kSlice];
  load_slice<T, kTeam>(qr, q + row * d, t, d, live, scale);
  load_slice<T, kTeam>(dor, dout + row * d, t, d, live);
#pragma unroll
  for (int m = 0; m < kSlice; ++m) acc[m] = 0.f;
  const float lse_i = lse[row], delta_i = delta[row];
  const int n_keys = causal ? min(t_k, q0 + C::kRows) : t_k;
  const T* kb = k + bh * t_k * d;
  const T* vb = v + bh * t_k * d;
  for (int j0 = 0; j0 < n_keys; j0 += kTile) {
    __syncthreads();
    stage_tile<T, DP>(k_s, kb, j0, t_k, d);
    stage_tile<T, DP>(v_s, vb, j0, t_k, d);
    __syncthreads();
    const int n = min(kTile, t_k - j0);
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int m = 0; m < kSlice; ++m) {
        s = fmaf(qr[m], k_s[j * DP + t + kTeam * m], s);
        dp = fmaf(dor[m], v_s[j * DP + t + kTeam * m], dp);
      }
      s = team_sum<kTeam>(s);
      dp = team_sum<kTeam>(dp);
      if (causal && j0 + j > qi) s = kMaskFill;
      const float p = j < n ? expf(s - lse_i) : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int m = 0; m < kSlice; ++m)
        acc[m] = fmaf(ds, k_s[j * DP + t + kTeam * m], acc[m]);
    }
  }
  if (live) store_slice<T, kTeam>(dq + row * d, acc, t, d, scale);
}

// ------------------------------------------------------------------- B3

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_simt_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv,
                              int t_q, int t_k, int d, int causal,
                              float scale) {
  using C = Cfg<DP>;
  constexpr int kTeam = C::kTeam;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = smem + kTile * DP;
  float* lse_s = smem + 2 * kTile * DP;
  float* delta_s = lse_s + kTile;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * C::kRows;  // the first block has most queries
  const int t = threadIdx.x % kTeam;
  const int kj = k0 + threadIdx.x / kTeam;
  const bool live = kj < t_k;
  const size_t row = bh * t_k + (live ? kj : 0);

  float kr[kSlice], vr[kSlice], dk_acc[kSlice], dv_acc[kSlice];
  load_slice<T, kTeam>(kr, k + row * d, t, d, live, scale);
  load_slice<T, kTeam>(vr, v + row * d, t, d, live);
#pragma unroll
  for (int m = 0; m < kSlice; ++m) dk_acc[m] = dv_acc[m] = 0.f;
  // queries before the block's first key see none of its keys
  const int first = causal ? min(k0, t_q) / kTile * kTile : 0;
  const T* qb = q + bh * t_q * d;
  const T* dob = dout + bh * t_q * d;
  const float* lseb = lse + bh * t_q;
  const float* deltab = delta + bh * t_q;
  for (int i0 = first; i0 < t_q; i0 += kTile) {
    __syncthreads();
    stage_tile<T, DP>(q_s, qb, i0, t_q, d);
    stage_tile<T, DP>(do_s, dob, i0, t_q, d);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      lse_s[threadIdx.x] = i < t_q ? lseb[i] : 0.f;
      delta_s[threadIdx.x] = i < t_q ? deltab[i] : 0.f;
    }
    __syncthreads();
    const int n = min(kTile, t_q - i0);
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int m = 0; m < kSlice; ++m) {
        s = fmaf(kr[m], q_s[i * DP + t + kTeam * m], s);
        dp = fmaf(vr[m], do_s[i * DP + t + kTeam * m], dp);
      }
      s = team_sum<kTeam>(s);
      dp = team_sum<kTeam>(dp);
      if (causal && kj > i0 + i) s = kMaskFill;
      const float p = i < n ? expf(s - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int m = 0; m < kSlice; ++m) {
        dv_acc[m] = fmaf(p, do_s[i * DP + t + kTeam * m], dv_acc[m]);
        dk_acc[m] = fmaf(ds, q_s[i * DP + t + kTeam * m], dk_acc[m]);
      }
    }
  }
  if (!live) return;
  store_slice<T, kTeam>(dk + row * d, dk_acc, t, d, scale);
  store_slice<T, kTeam>(dv + row * d, dv_acc, t, d, 1.f);
}

// ------------------------------------------------------------- launches

// The padded width of a head_dim the SIMT kernels take (1..256 but 64
// and 128), or 0
inline int padded_dim(int head_dim) {
  if (head_dim < 1 || head_dim > 256) return 0;
  return head_dim <= 32 ? 32 : head_dim <= 64 ? 64 : head_dim <= 128 ? 128
                                                                     : 256;
}

// Calls f(T{}, std::integral_constant<int, DP>{}) for dtype (0 float32,
// 1 bfloat16) and head_dim's padded width; cudaErrorInvalidValue for a
// head_dim outside 1..256.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& f) {
  const int dp = padded_dim(head_dim);
  auto by_width = [&](auto t) -> cudaError_t {
    switch (dp) {
      case 32: return f(t, std::integral_constant<int, 32>{});
      case 64: return f(t, std::integral_constant<int, 64>{});
      case 128: return f(t, std::integral_constant<int, 128>{});
      case 256: return f(t, std::integral_constant<int, 256>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_width(float{});
  if (dtype == 1) return by_width(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// the grid of a launch over `rows` rows a head, or false when it cannot
// hold them
template <int DP>
bool row_grid(int bh, int rows, dim3* grid) {
  const int tiles = (rows + Cfg<DP>::kRows - 1) / Cfg<DP>::kRows;
  if (tiles > 65535) return false;
  *grid = dim3(bh, tiles);
  return true;
}

}  // namespace simt
}  // namespace flash_train
