// Shared pieces of the training attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): tile sizes, bf16/f32 loads and stores, staging of
// a tile into shared memory, the per-thread product of two staged tiles
// (the CUDA-core kernels: B2 and B3 on float32), and the launch-side
// helpers (all kernels; the tensor-core pieces are in
// flash_attn_sm90.cuh).
//
// Thread layout of the CUDA-core kernels: 256 threads as a 16 x 16 grid,
// tx = threadIdx.x % 16, ty = threadIdx.x / 16.  A [M, N] tile product
// gives thread (ty, tx) the rows ty*M/16 .. +M/16 and the columns
// tx*N/16 .. +N/16; a [M, D] product gives it the rows ty*M/16 .. and the
// columns tx*4 + 64*g (g < D/64), four at a time.  The 16 threads of a
// row of the grid are 16 neighbouring lanes of one warp, so a row-wise
// max or sum is four shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>
#include <type_traits>

namespace flash_train {

constexpr int kThreads = 256;
constexpr float kMaskFill = -1e30f;  // the TPU kernels' causal fill
constexpr int kMaxDevices = 64;

// Query and key rows per tile.  head_dim 128 takes 32-row tiles so the
// dK/dV kernel's eight staged tiles fit the 227 KB a block may use.
template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int kQ = 64, kK = 64;
};
template <>
struct Tiles<128> {
  static constexpr int kQ = 32, kK = 32;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  // round to nearest even, as torch's .to(torch.bfloat16)
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// N consecutive f32 from shared memory (N = 2 or 4, aligned to N).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  static_assert(N == 2 || N == 4, "vector of 2 or 4");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  static_assert(N == 2 || N == 4, "vector of 2 or 4");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// Stages rows [row0, row0 + R) of a row-major [n_rows, D] matrix into
// shared memory as f32 times `mul`: row-major into `nat` (row stride
// D + 4) and/or transposed into `tr` (row stride R + 4), either may be
// null.  Rows at or past n_rows become zeros.  Neighbouring threads take
// neighbouring rows, so the transposed stores hit 32 banks and the
// row-major 16-byte stores (stride D + 4) are free of conflicts too.
template <int R, int D, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int n_rows, float mul, float* nat,
                                      float* tr) {
  for (int i = threadIdx.x; i < R * (D / 4); i += kThreads) {
    const int r = i % R;
    const int c = (i / R) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      x = load4(src + static_cast<size_t>(row0 + r) * D + c);
      x.x *= mul, x.y *= mul, x.z *= mul, x.w *= mul;
    }
    if (nat) store4(nat + r * (D + 4) + c, x);
    if (tr) {
      tr[(c + 0) * (R + 4) + r] = x.x;
      tr[(c + 1) * (R + 4) + r] = x.y;
      tr[(c + 2) * (R + 4) + r] = x.z;
      tr[(c + 3) * (R + 4) + r] = x.w;
    }
  }
}

// acc[i][j] += sum_k a[k * lda + i] * b[k * ldb + j] over k < K: the
// thread's TM x TN corner of a product whose two operands lie in shared
// memory with the contracted index as their row (a and b already point
// at the thread's first row and column).  Each step is two vector loads
// and TM * TN fused multiply-adds in f32.
template <int TM, int TN, int K>
__device__ __forceinline__ void tile_product(const float* a, int lda,
                                             const float* b, int ldb,
                                             float (&acc)[TM][TN]) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
    load_vec<TM>(a + k * lda, av);
    load_vec<TN>(b + k * ldb, bv);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// max / sum over the 16 lanes of one row of the thread grid
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Raises a kernel's dynamic shared-memory limit on the current device
// once (and again only if a launch asks for more).  `raised` is the
// caller's per-instantiation record.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       std::atomic<size_t> (&raised)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
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
  return cudaSuccess;
}

// Calls f(T{}, std::integral_constant<int, D>{}) for dtype (0 float32,
// 1 bfloat16) and head_dim (64, 128); cudaErrorInvalidValue otherwise.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F&& f) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (dtype == 0 && head_dim == 64) return f(float{}, D64{});
  if (dtype == 0 && head_dim == 128) return f(float{}, D128{});
  if (dtype == 1 && head_dim == 64) return f(__nv_bfloat16{}, D64{});
  if (dtype == 1 && head_dim == 128) return f(__nv_bfloat16{}, D128{});
  return cudaErrorInvalidValue;
}

}  // namespace flash_train
