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
// f32 (softmax with a running or per-split max, denominator and output),
// keys at or past the row's length take weight 0, the output is in q's
// dtype with the denominator clamped at 1e-30 (a row of length 0 returns
// 0, as the TPU kernel does).  B5 takes q and pages of float32 or
// bfloat16 (pages in q's dtype, or bfloat16 pages under a float32 q:
// widening is exact), head_dim 64 or 128, any page size.  B6 takes int8
// pages with f32 per-block scales [n_pages, kv_h, pt, n_blocks] riding
// the same table index (n_blocks divides head_dim) and dequantizes each
// element on chip (int8 * its block's scale): the int8 payload and the
// scales stream from device memory as stored, and no dequantized copy of
// the arena is ever written.  That is B6's whole point.
//
// What bounds them: memory, the live K/V bytes (plus scales for B6) over
// 3.35 TB/s (8 x 12 rows at length 1024, d = 64: bf16 25.2 MB, 7.5 us;
// int8 with one scale per row 13.4 MB, 4.0 us).  Both kernels are the
// split-K body B4 shares too (`decode_split_body`, decode_split.cuh),
// instantiated for exact pages (B5) and int8 pages (B6), with each key's
// arena row resolved through the table into shared memory before its
// copies go out.  Splits are whole pages (the host's `_split_tokens`:
// 256 tokens at 64-token pages, 128 for f32 pages at head_dim 128) and
// the grid is (rows, ceil(mp * pt / chunk)), known from the table's
// width.

#include "decode_split.cuh"

namespace {

// B5: exact pages (f32 or bf16)
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(SplitArgs a) {
  decode_split_body<TQ, TKV, false, true, D>(a);
}

// B6: block-scaled int8 pages, dequantized on chip
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_quant_kernel(SplitArgs a) {
  decode_split_body<TQ, int8_t, true, true, D>(a);
}

// B5 (kQuant false) or B6 (true) over `n_splits` splits a row
template <typename TQ, typename TKV, bool kQuant, int D>
cudaError_t launch(const SplitArgs& a, int rows, int n_splits,
                   cudaStream_t stream) {
  const size_t smem =
      split_smem(a.chunk, D, sizeof(TKV), kQuant ? a.n_blocks : 0, true)
          .total;
  if constexpr (kQuant)
    return launch_split<paged_decode_quant_kernel<TQ, D>>(a, rows, n_splits,
                                                          smem, stream);
  else
    return launch_split<paged_decode_kernel<TQ, TKV, D>>(a, rows, n_splits,
                                                         smem, stream);
}

template <typename TQ, typename TKV, bool kQuant>
cudaError_t launch_dim(int head_dim, const SplitArgs& a, int rows,
                       int n_splits, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<TQ, TKV, kQuant, 64>(a, rows, n_splits, stream);
    case 128:
      return launch<TQ, TKV, kQuant, 128>(a, rows, n_splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The shape checks both entries share; the splits a row (whole pages of
// `chunk` tokens over max_pages * page_tokens) in `n_splits`.
bool valid_split_shape(int heads, int kv_heads, int n_pages, int page_tokens,
                       int max_pages, int chunk, int* n_splits) {
  return heads >= 1 && kv_heads >= 1 && heads % kv_heads == 0 &&
         n_pages >= 1 && page_tokens >= 1 && max_pages >= 1 &&
         split_count(static_cast<long long>(max_pages) * page_tokens, chunk,
                     n_splits);
}

}  // namespace

// B5.  dtype codes: 0 float32, 1 bfloat16; (q, pages) in {(0, 0),
// (1, 1), (0, 1)}.  All tensors contiguous on the current device; pages
// 16-byte aligned.  `chunk` tokens per split; the grid has
// ceil(max_pages * page_tokens / chunk) splits a row.  `work` holds f32
// [batch * heads, n_splits, head_dim + 2]; `counters` int32
// [batch * heads], zero at the call and zero again after the launch.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* table, const void* lengths,
                            void* out, void* work, void* counters, int batch,
                            int heads, int kv_heads, int n_pages,
                            int page_tokens, int max_pages, int head_dim,
                            int chunk, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
  const int rows = batch * heads;
  if (rows == 0) return cudaSuccess;
  int n_splits = 0;
  if (!valid_split_shape(heads, kv_heads, n_pages, page_tokens, max_pages,
                         chunk, &n_splits))
    return cudaErrorInvalidValue;
  const SplitArgs a{q, k, v, nullptr, nullptr,
                    static_cast<const int*>(table),
                    static_cast<const int*>(lengths), out,
                    static_cast<float*>(work), static_cast<int*>(counters),
                    heads, kv_heads, n_pages, page_tokens, max_pages,
                    max_pages * page_tokens, 1, chunk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_dim<float, float, false>(head_dim, a, rows, n_splits, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_dim<__nv_bfloat16, __nv_bfloat16, false>(head_dim, a, rows,
                                                            n_splits, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_dim<float, __nv_bfloat16, false>(head_dim, a, rows,
                                                   n_splits, s);
  return cudaErrorInvalidValue;
}

// B6.  q dtype code as above; pages int8, scales float32
// [n_pages, kv_heads, page_tokens, n_blocks] with n_blocks dividing
// head_dim.  Same contract as paged_decode otherwise.
extern "C" int paged_decode_quant(const void* q, const void* k,
                                  const void* v, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* lengths, void* out, void* work,
                                  void* counters, int batch, int heads,
                                  int kv_heads, int n_pages,
                                  int page_tokens, int max_pages,
                                  int head_dim, int n_blocks, int chunk,
                                  float scale, int q_dtype, void* stream) {
  const int rows = batch * heads;
  if (rows == 0) return cudaSuccess;
  int n_splits = 0;
  if (!valid_split_shape(heads, kv_heads, n_pages, page_tokens, max_pages,
                         chunk, &n_splits) ||
      n_blocks < 1 || head_dim % n_blocks != 0)
    return cudaErrorInvalidValue;
  const SplitArgs a{q, k, v, static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<const int*>(table),
                    static_cast<const int*>(lengths), out,
                    static_cast<float*>(work), static_cast<int*>(counters),
                    heads, kv_heads, n_pages, page_tokens, max_pages,
                    max_pages * page_tokens, n_blocks, chunk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_dim<float, int8_t, true>(head_dim, a, rows, n_splits, s);
    case 1:
      return launch_dim<__nv_bfloat16, int8_t, true>(head_dim, a, rows,
                                                     n_splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
