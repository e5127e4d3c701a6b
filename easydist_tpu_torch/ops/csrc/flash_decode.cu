// Single-query decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_decode_kernel`
// (easydist_tpu/ops/flash_attention.py:409, host `flash_decode_attention`
// :448).  One query per (batch, head) row attends that row's KV cache
// up to its live length:
//
//   q [b, h, d], k/v [b, h, t_k, d], lengths int32 [b]  ->  out [b, h, d]
//
// in f32 arithmetic (online softmax: running max, running denominator,
// running output), keys at positions >= length masked, output in q's
// dtype, denominator clamped at 1e-30 (a row of length 0 returns 0, as
// the TPU kernel does).  Takes float32 and bfloat16 with head_dim 64 or
// 128.
//
// What bounds it.  Each row reads its live K and V once and does ~4*d
// flops per key, about one flop per byte: far below the card's ~295
// flops per byte, so the bound is memory, bytes of K/V at the live
// lengths over 3.35 TB/s (8 x 12 rows at length 1024, d = 64, bf16:
// 25.2 MB, 7.5 us).
//
// What the design does about it.  One block of 128 threads per
// (batch, head) row walks the row's live keys in tiles.  A tile of K and
// its tile of V are copied into shared memory with 16-byte loads that
// neighbouring threads issue on neighbouring addresses, so every byte of
// a tile is in flight at once (a 256-key bf16 tile at d = 64 is 64 KB,
// above the 48 KB static limit, so shared memory is dynamic and the
// launcher raises the limit).  Tiles at or past the length are never
// fetched, and only the live keys of the last tile are.  Scores are one
// warp per key (lanes split d, a shuffle reduction), the P.V pass one
// thread per output dim and key group; the running statistics never
// leave registers.
//
// Known limit: at the serving shape there are only 96 rows for 132 SMs,
// and each block waits on its tile before computing (no double
// buffering).  Splitting a row's keys across blocks (split-K with a
// second combine pass) and a cp.async / TMA ring are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

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

// Copies n_bytes (a multiple of 16) from global to shared memory.
__device__ __forceinline__ void copy_tile(void* dst, const void* src,
                                          int n_bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n_bytes / 16; i += kThreads) d[i] = s[i];
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int heads, int t_k, int tile, float scale) {
  static_assert(kThreads % D == 0, "head_dim must divide the block");
  constexpr int kGroups = kThreads / D;  // key groups of the P.V pass

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // [tile, D]
  T* v_s = k_s + static_cast<size_t>(tile) * D;          // [tile, D]
  float* p_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(tile) * D);
  __shared__ float q_s[D];
  __shared__ float red_s[kWarps];
  __shared__ float acc_s[kThreads];

  const int row = blockIdx.x;  // batch * heads + head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = max(0, min(lengths[row / heads], t_k));
  const size_t kv_off = static_cast<size_t>(row) * t_k * D;

  for (int i = tid; i < D; i += kThreads)
    q_s[i] = to_f32(q[static_cast<size_t>(row) * D + i]) * scale;

  // running max and denominator: every thread holds the same values
  float m = kNegInf;
  float l = 0.f;
  const int d = tid % D;  // this thread's output dim ...
  const int g = tid / D;  // ... and key group
  float acc = 0.f;
  __syncthreads();

  for (int start = 0; start < len; start += tile) {
    const int n = min(tile, len - start);  // live keys of this tile
    copy_tile(k_s, k + kv_off + static_cast<size_t>(start) * D,
              n * D * static_cast<int>(sizeof(T)));
    copy_tile(v_s, v + kv_off + static_cast<size_t>(start) * D,
              n * D * static_cast<int>(sizeof(T)));
    __syncthreads();

    // scores s_j = (q * scale) . k_j: one warp per key
    float tmax = kNegInf;
    for (int j = warp; j < n; j += kWarps) {
      const T* kr = k_s + j * D;
      float s = 0.f;
#pragma unroll
      for (int i = lane; i < D; i += 32) s += q_s[i] * to_f32(kr[i]);
      s = warp_sum(s);  // every lane now holds the score
      if (lane == 0) p_s[j] = s;
      tmax = fmaxf(tmax, s);
    }
    if (lane == 0) red_s[warp] = tmax;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red_s[w]);
    const float alpha = expf(m - m_new);

    // probabilities and their sum
    float psum = 0.f;
    for (int j = tid; j < n; j += kThreads) {
      const float p = expf(p_s[j] - m_new);
      p_s[j] = p;
      psum += p;
    }
    psum = warp_sum(psum);
    __syncthreads();  // red_s (the maxima) is read by all before reuse
    if (lane == 0) red_s[warp] = psum;
    __syncthreads();
    float tsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tsum += red_s[w];
    l = l * alpha + tsum;
    m = m_new;

    // P.V over this thread's key group, for its output dim
    float pv = 0.f;
    for (int j = g; j < n; j += kGroups)
      pv += p_s[j] * to_f32(v_s[j * D + d]);
    acc = acc * alpha + pv;
    __syncthreads();  // the tile buffers and red_s are reused next tile
  }

  acc_s[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) o += acc_s[gg * D + tid];
    out[static_cast<size_t>(row) * D + tid] = from_f32<T>(o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int rows, int heads,
                   int t_k, int tile, float scale, cudaStream_t stream) {
  const size_t smem =
      2 * static_cast<size_t>(tile) * D * sizeof(T) + tile * sizeof(float);
  auto kernel = flash_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    // above the static limit: raise this instantiation's limit on this
    // device, once (and again only if a larger tile asks for more)
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
  kernel<<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), heads, t_k, tile, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, const void* lengths, void* out,
                       int rows, int heads, int t_k, int tile, float scale,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, rows, heads, t_k, tile,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, rows, heads, t_k, tile,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  All tensors contiguous on the
// current device; k/v 16-byte aligned.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int batch,
                            int heads, int t_k, int head_dim, int tile,
                            float scale, int dtype, void* stream) {
  const int rows = batch * heads;
  if (rows == 0) return cudaSuccess;
  if (tile < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dim<float>(head_dim, q, k, v, lengths, out, rows, heads,
                               t_k, tile, scale, s);
    case 1:
      return launch_dim<__nv_bfloat16>(head_dim, q, k, v, lengths, out, rows,
                                       heads, t_k, tile, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
