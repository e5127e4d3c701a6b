// Single-query decode attention through a page table, for Hopper (sm_90a).
//
// Replaces two TPU kernels of easydist_tpu/ops/flash_attention.py:
//   * B5 `_flash_paged_decode_kernel` (:644, host
//     `flash_paged_decode_attention` :687) -> `paged_decode_kernel`;
//   * B6 `_flash_paged_decode_quant_kernel` (:754, host
//     `flash_paged_decode_quant_attention` :809) -> `paged_decode_quant_kernel`.
//
// One query per (batch, head) row attends the row's live tokens, which
// sit in the arena's pages as the row's table names them:
//
//   q [b, h, d], k/v pages [n_pages, kv_h, pt, d], table int32 [b, mp],
//   lengths int32 [b]  ->  out [b, h, d]
//
// Token p of row bi lives in page clip(table[bi, p / pt], 0, n_pages - 1)
// at offset p % pt, in kv head head / (h / kv_h) (GQA).  Arithmetic is
// f32 (online softmax: running max, denominator and output), keys at or
// past the row's length take weight 0, the output is in q's dtype with
// the denominator clamped at 1e-30 (a row of length 0 returns 0, as the
// TPU kernel does).  B5 takes q and pages of float32 or bfloat16 (pages
// in q's dtype, or bfloat16 pages under a float32 q: widening is exact),
// head_dim 64 or 128, any page size.  B6 takes int8 pages with f32
// per-block scales [n_pages, kv_h, pt, n_blocks] riding the same table
// index (n_blocks divides head_dim) and dequantizes each element on
// chip (int8 * its block's scale) inside the loop: the int8 payload and
// the scales stream from device memory as stored, and no dequantized
// copy of the arena is ever written.  That is B6's whole point.
//
// What bounds them.  Each row reads its live K and V once and does ~4*d
// flops per key, about one flop per byte: far below the card's ~295
// flops per byte, so the bound is memory — the live K/V bytes (plus
// scales for B6) over 3.35 TB/s (8 x 12 rows at length 1024, d = 64:
// bf16 25.2 MB, 7.5 us; int8 with one scale per row 13.4 MB, 4.0 us).
//
// What the design does about it.  The TPU walks pages along a
// sequential grid axis, carrying m, l and the output in VMEM scratch
// and clamping dead windows in the BlockSpec index map.  CUDA blocks run
// in no order, so one block of 128 threads per (batch, head) row reads
// its own length and table row and walks only its live tokens in tiles
// of 64, the running statistics in registers (as the contiguous decode
// kernel, flash_decode.cu, does).  Per tile, each key's arena row is
// resolved once through the table into shared memory; then the tile's K
// and V rows are copied into shared memory with 16-byte loads, where
// neighbouring threads read neighbouring addresses (a page's rows for one
// kv head are contiguous).  Pages at or past the row's live count are
// neither loaded nor computed.  Scores are one warp per key (lanes split
// d, a shuffle reduction), the P.V pass one thread per output dim and key
// group.
//
// Known limit: at the serving shape there are 96 rows for 132 SMs and a
// block waits on each tile before computing.  A cp.async / TMA ring and
// splitting a row's pages across blocks (split-K with a combine pass)
// are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys staged per tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // B6 only
  const float* v_scale;  // B6 only
  const int* table;
  const int* lengths;
  void* out;
  int heads;
  int kv_heads;
  int n_pages;
  int page_tokens;
  int max_pages;
  int n_blocks;  // scale blocks per row (B6); 1 for B5
  float scale;
};

template <typename TQ, typename TKV, bool kQuant, int D>
__device__ __forceinline__ void paged_decode_body(const PagedArgs& a) {
  static_assert(kThreads % D == 0, "head_dim must divide the block");
  static_assert((D * sizeof(TKV)) % 16 == 0, "rows of 16-byte vectors");
  constexpr int kGroups = kThreads / D;                // key groups of P.V
  constexpr int kVecs = D * sizeof(TKV) / 16;          // vectors per row

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* k_s = reinterpret_cast<TKV*>(smem);                  // [kTile, D]
  TKV* v_s = k_s + kTile * D;                               // [kTile, D]
  float* p_s = reinterpret_cast<float*>(v_s + kTile * D);   // [kTile]
  float* ks_s = p_s + kTile;                                // [kTile, nb]
  float* vs_s = ks_s + (kQuant ? kTile * a.n_blocks : 0);   // [kTile, nb]
  __shared__ float q_s[D];
  __shared__ float red_s[kWarps];
  __shared__ float acc_s[kThreads];
  __shared__ long long row_s[kTile];  // arena row of each key of the tile

  const int row = blockIdx.x;  // batch * heads + head
  const int bi = row / a.heads;
  const int kh = (row % a.heads) / (a.heads / a.kv_heads);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = a.n_blocks;
  const int blk = kQuant ? D / nb : D;  // dims per scale block
  const int len =
      max(0, min(a.lengths[bi], a.max_pages * a.page_tokens));
  const int* tbl = a.table + static_cast<size_t>(bi) * a.max_pages;
  const TQ* q = static_cast<const TQ*>(a.q);
  const uint4* kp = static_cast<const uint4*>(a.k);
  const uint4* vp = static_cast<const uint4*>(a.v);

  for (int i = tid; i < D; i += kThreads)
    q_s[i] = to_f32(q[static_cast<size_t>(row) * D + i]) * a.scale;

  // running max and denominator: every thread holds the same values
  float m = kNegInf;
  float l = 0.f;
  const int d = tid % D;  // this thread's output dim ...
  const int g = tid / D;  // ... and key group
  float acc = 0.f;

  for (int start = 0; start < len; start += kTile) {
    const int n = min(kTile, len - start);  // live keys of this tile
    // each key's arena row: its page (clipped into the allocatable
    // pages, as the TPU's index map clips), kv head and offset
    for (int r = tid; r < n; r += kThreads) {
      const int p = start + r;
      const int page = min(max(tbl[p / a.page_tokens], 0), a.n_pages - 1);
      row_s[r] = (static_cast<long long>(page) * a.kv_heads + kh) *
                     a.page_tokens + p % a.page_tokens;
    }
    __syncthreads();  // also orders q_s before the first scores
    for (int i = tid; i < n * kVecs; i += kThreads) {
      const size_t src = static_cast<size_t>(row_s[i / kVecs]) * kVecs +
                         i % kVecs;
      reinterpret_cast<uint4*>(k_s)[i] = kp[src];
      reinterpret_cast<uint4*>(v_s)[i] = vp[src];
    }
    if constexpr (kQuant) {
      for (int i = tid; i < n * nb; i += kThreads) {
        const size_t src = static_cast<size_t>(row_s[i / nb]) * nb + i % nb;
        ks_s[i] = a.k_scale[src];
        vs_s[i] = a.v_scale[src];
      }
    }
    __syncthreads();

    // scores s_j = (q * scale) . k_j: one warp per key
    float tmax = kNegInf;
    for (int j = warp; j < n; j += kWarps) {
      const TKV* kr = k_s + j * D;
      float s = 0.f;
#pragma unroll
      for (int i = lane; i < D; i += 32) {
        float kv = to_f32(kr[i]);
        if constexpr (kQuant) kv *= ks_s[j * nb + i / blk];
        s += q_s[i] * kv;
      }
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
    for (int j = g; j < n; j += kGroups) {
      float vv = to_f32(v_s[j * D + d]);
      if constexpr (kQuant) vv *= vs_s[j * nb + d / blk];
      pv += p_s[j] * vv;
    }
    acc = acc * alpha + pv;
    __syncthreads();  // the tile buffers, row_s and red_s are reused
  }

  acc_s[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) o += acc_s[gg * D + tid];
    static_cast<TQ*>(a.out)[static_cast<size_t>(row) * D + tid] =
        from_f32<TQ>(o / fmaxf(l, 1e-30f));
  }
}

// B5: exact pages
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(PagedArgs a) {
  paged_decode_body<TQ, TKV, false, D>(a);
}

// B6: block-scaled int8 pages, dequantized on chip
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_quant_kernel(PagedArgs a) {
  paged_decode_body<TQ, int8_t, true, D>(a);
}

template <typename TQ, typename TKV, bool kQuant, int D>
cudaError_t launch(const PagedArgs& a, int rows, cudaStream_t stream) {
  const size_t smem =
      2 * static_cast<size_t>(kTile) * D * sizeof(TKV) +
      kTile * sizeof(float) +
      (kQuant ? 2 * static_cast<size_t>(kTile) * a.n_blocks * sizeof(float)
              : 0);
  void (*kernel)(PagedArgs);
  if constexpr (kQuant) {
    kernel = paged_decode_quant_kernel<TQ, D>;
  } else {
    kernel = paged_decode_kernel<TQ, TKV, D>;
  }
  if (smem > 48 * 1024) {
    // above the static limit: raise this instantiation's limit on this
    // device, once (and again only if more scale blocks ask for more)
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
  kernel<<<rows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool kQuant>
cudaError_t launch_dim(int head_dim, const PagedArgs& a, int rows,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<TQ, TKV, kQuant, 64>(a, rows, stream);
    case 128:
      return launch<TQ, TKV, kQuant, 128>(a, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid_shape(int heads, int kv_heads, int n_pages, int page_tokens,
                 int max_pages) {
  return heads >= 1 && kv_heads >= 1 && heads % kv_heads == 0 &&
         n_pages >= 1 && page_tokens >= 1 && max_pages >= 1;
}

}  // namespace

// B5.  dtype codes: 0 float32, 1 bfloat16; (q, pages) in {(0, 0),
// (1, 1), (0, 1)}.  All tensors contiguous on the current device; pages
// 16-byte aligned.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* table, const void* lengths,
                            void* out, int batch, int heads, int kv_heads,
                            int n_pages, int page_tokens, int max_pages,
                            int head_dim, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
  const int rows = batch * heads;
  if (rows == 0) return cudaSuccess;
  if (!valid_shape(heads, kv_heads, n_pages, page_tokens, max_pages))
    return cudaErrorInvalidValue;
  const PagedArgs a{q, k, v, nullptr, nullptr,
                    static_cast<const int*>(table),
                    static_cast<const int*>(lengths), out, heads, kv_heads,
                    n_pages, page_tokens, max_pages, 1, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_dim<float, float, false>(head_dim, a, rows, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_dim<__nv_bfloat16, __nv_bfloat16, false>(head_dim, a,
                                                           rows, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_dim<float, __nv_bfloat16, false>(head_dim, a, rows, s);
  return cudaErrorInvalidValue;
}

// B6.  q dtype code as above; pages int8, scales float32
// [n_pages, kv_heads, page_tokens, n_blocks] with n_blocks dividing
// head_dim.  Same contract as paged_decode.
extern "C" int paged_decode_quant(const void* q, const void* k,
                                  const void* v, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* lengths, void* out, int batch,
                                  int heads, int kv_heads, int n_pages,
                                  int page_tokens, int max_pages,
                                  int head_dim, int n_blocks, float scale,
                                  int q_dtype, void* stream) {
  const int rows = batch * heads;
  if (rows == 0) return cudaSuccess;
  if (!valid_shape(heads, kv_heads, n_pages, page_tokens, max_pages) ||
      n_blocks < 1 || head_dim % n_blocks != 0)
    return cudaErrorInvalidValue;
  const PagedArgs a{q, k, v, static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<const int*>(table),
                    static_cast<const int*>(lengths), out, heads, kv_heads,
                    n_pages, page_tokens, max_pages, n_blocks, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_dim<float, int8_t, true>(head_dim, a, rows, s);
    case 1:
      return launch_dim<__nv_bfloat16, int8_t, true>(head_dim, a, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
