// B2 (dQ) at the head_dims the tensor-core routes do not take, for
// Hopper (sm_90a): `flash_bwd_dq_simt_kernel`.  The tensor-core routes
// (flash_attn_common.cuh) take B1 and B3 at every head_dim up to 256 and
// B2 up to 128 (bfloat16: up to 256) at a padded width; so this kernel
// runs float32 B2 above 128.
//
// Replaces the same TPU kernel as the tensor-core route
// (easydist_tpu/ops/flash_attention.py:164) over the rest of its domain:
// the TPU kernel blocks over the sequence and keeps the head_dim whole,
// so it takes any width.  It computes the function of the tensor-core
// route (flash_attn_bwd.cu) in f32 FMAs on the CUDA cores: the -1e30
// causal fill, P from the saved lse, dS = P * (dP - delta); inputs are
// read as f32, P and dS are never rounded, and dQ is written once, so it
// holds the f32 bar without any hi/lo split.
//
// What bounds it.  The function's products, which this kernel runs on
// the CUDA cores (67 TFLOP/s of f32 at best): what a first design that
// is right gives up.
//
// Design.  Rows q are shared by teams of `DP / 8` lanes of one warp, each
// lane holding 8 of the row's dims (lane t: dims t, t + team, ..., so a
// team reads consecutive words of a shared tile and the teams of a warp
// read the same words: no bank conflicts).  `DP` is the head_dim padded
// to the next of 32, 64, 128, 256 (a template parameter; the route
// instantiates f32 at 256 only); every dim at or past d is zero in
// registers and in shared memory, and zeros add nothing to a product, so
// the result is exact.  q, k, v and dO are read at their own d with
// element loads (no alignment beyond the element's).  A block of 256
// threads owns 256 / team rows and walks the keys in tiles of 32 staged
// in shared memory as f32 [32][DP] (64 KB for K and V at DP 256): scores
// and dP are team sums (xor shuffles).  Under causal masking it stops at
// the block's last visible key (the TPU's `_kv_index_map` clamp); query
// tiles are issued longest first.  No atomics: two launches are bitwise
// equal.
//
// Registers: each lane holds 8 dims of q, dO and dQ whatever DP is;
// ptxas gives 63 registers a thread, no spill (two blocks of 256 threads
// an SM by registers).
//
// Known limits: the team sums take log2(team) shuffles a score, every
// product reads shared memory once a multiply-add, the padding to 256
// wastes up to half the work (at d 129), and a block at DP 256 holds only
// 8 rows a tile.  At [2, 16, 2048, 256] (chip_smoke.py phase 3) it runs
// slower than the plain version's cuBLAS products.

#pragma once

#include "flash_attn_common.cuh"

namespace flash_train {
namespace simt {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // keys a staged tile
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
  // dynamic shared memory: two f32 tiles (K and V)
  static constexpr size_t kSmemDq = 2 * kTile * DP * 4;
};

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

// ------------------------------------------------------------- launches

// The padded width of a head_dim the SIMT kernels take (1..256 but 64
// and 128), or 0
inline int padded_dim(int head_dim) {
  if (head_dim < 1 || head_dim > 256) return 0;
  return head_dim <= 32 ? 32 : head_dim <= 64 ? 64 : head_dim <= 128 ? 128
                                                                     : 256;
}

// Calls f(float{}, std::integral_constant<int, 256>{}) for a float32
// head_dim from 129 to 256: the only head_dims B2's route sends here
// (`tensor_core_width` takes every other one), so the only instantiation
// built; cudaErrorInvalidValue otherwise.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& f) {
  if (dtype != 0 || padded_dim(head_dim) != 256) return cudaErrorInvalidValue;
  return f(float{}, std::integral_constant<int, 256>{});
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
