// Single-query decode attention over a contiguous KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_flash_decode_kernel`
// (easydist_tpu/ops/flash_attention.py:409, host `flash_decode_attention`
// :448).  One query per (batch, head) row attends that row's KV cache
// up to its live length:
//
//   q [b, h, d], k/v [b, h, t_k, d], lengths int32 [b]  ->  out [b, h, d]
//
// in f32 arithmetic, keys at positions >= length masked, output in q's
// dtype, denominator clamped at 1e-30 (a row of length 0 returns 0, as
// the TPU kernel does).  Takes float32 and bfloat16 with any head_dim
// from 1 to 256: 64 and 128 on the exact body, every other one on the
// padded body at the next of 64, 128, 256 (decode_split.cuh, "Head
// dims"), reading the cache in place at its own width.
//
// What bounds it: memory, the live K/V bytes over 3.35 TB/s (8 x 12 rows
// at length 1024, d = 64, bf16: 25.2 MB, 7.5 us).  The design is the
// split-K body B5 and B6 share (`decode_split_body`, decode_split.cuh),
// with key p of row r read from row r * t_k + p of k and v: each row's
// keys in splits of `chunk` tokens, one block a split, every split's K
// and V in flight at once as `cp.async` copies, the partials merged in
// split order by the row's last block inside the same launch.

#include "decode_split.cuh"

namespace {

template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(SplitArgs a) {
  decode_split_body<T, T, false, false, D, kPad>(a);
}

template <typename T, int D, bool kPad>
cudaError_t launch(const SplitArgs& a, int rows, int n_splits,
                   cudaStream_t stream) {
  return launch_split<flash_decode_kernel<T, D, kPad>>(
      a, rows, n_splits, split_smem(a.chunk, D, sizeof(T), 0, false).total,
      stream);
}

// head_dim 64 and 128 on the exact body; 1..256 otherwise on the padded
// body at the next of 64, 128, 256
template <typename T>
cudaError_t launch_dim(int head_dim, const SplitArgs& a, int rows,
                       int n_splits, cudaStream_t stream) {
  if (head_dim == 64) return launch<T, 64, false>(a, rows, n_splits, stream);
  if (head_dim == 128)
    return launch<T, 128, false>(a, rows, n_splits, stream);
  if (head_dim < 1 || head_dim > 256) return cudaErrorInvalidValue;
  if (head_dim < 64) return launch<T, 64, true>(a, rows, n_splits, stream);
  if (head_dim < 128) return launch<T, 128, true>(a, rows, n_splits, stream);
  return launch<T, 256, true>(a, rows, n_splits, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  All tensors contiguous on the current
// device; k/v 16-byte aligned at head_dim 64 and 128.  `chunk` tokens per split; the grid has
// max(1, ceil(t_k / chunk)) splits a row.  `work` holds f32
// [batch * heads, n_splits, head_dim + 2]; `counters` int32
// [batch * heads], zero at the call and zero again after the launch.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* work,
                            void* counters, int batch, int heads, int t_k,
                            int head_dim, int chunk, float scale, int dtype,
                            void* stream) {
  const int rows = batch * heads;
  if (rows == 0) return cudaSuccess;
  int n_splits = 0;
  if (heads < 1 || !split_count(t_k, chunk, &n_splits))
    return cudaErrorInvalidValue;
  const SplitArgs a{q, k, v, nullptr, nullptr, nullptr,
                    static_cast<const int*>(lengths), out,
                    static_cast<float*>(work), static_cast<int*>(counters),
                    heads, heads, 0, 0, 0, t_k, 1, chunk, scale,
                    head_dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dim<float>(head_dim, a, rows, n_splits, s);
    case 1:
      return launch_dim<__nv_bfloat16>(head_dim, a, rows, n_splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
