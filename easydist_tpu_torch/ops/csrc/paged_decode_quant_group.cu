// B6 under grouped-query attention, for Hopper (sm_90a): single-query
// decode through a page table over block-scaled int8 pages, where
// heads / kv_heads >= 2 query heads share a KV head.
//
// Replaces, with paged_decode.cu's `paged_decode_quant_kernel` (G = 1),
// the TPU kernel B6 `_flash_paged_decode_quant_kernel` of
// easydist_tpu/ops/flash_attention.py (:754, `pallas_call` :862).  The
// same function, arguments and contract as `paged_decode_quant`
// (paged_decode.cu): each int8 element is dequantized on chip by its
// block's f32 scale, and no dequantized copy is written.  The body, what
// bounds it and what its design does about it are decode_group.cuh's
// (the scales ride each ring tile beside its rows).  A source of its own,
// so that its instantiations compile beside the other kernels' sources.

#include "decode_group.cuh"

namespace {

// two blocks an SM (128 registers a thread) where a lane's q is 32 floats;
// one at D 256 / GT 8, where it is 64
template <typename TQ, int D, int GT>
__global__ void __launch_bounds__(kGThreads, D * GT <= 1024 ? 2 : 1)
    paged_decode_quant_group_kernel(GroupArgs a) {
  decode_group_body<TQ, int8_t, true, D, GT>(a);
}

template <typename TQ>
cudaError_t launch(const GroupLaunch& l, cudaStream_t s) {
  return launch_group(l, [&](auto width, auto gt) {
    constexpr int D = decltype(width)::value, GT = decltype(gt)::value;
    return launch_split<paged_decode_quant_group_kernel<TQ, D, GT>, kGThreads>(
        l.args, l.blocks, l.n_splits, l.smem, s);
  });
}

}  // namespace

// B6 at heads / kv_heads >= 2.  The arguments of `paged_decode_quant`
// (paged_decode.cu): q dtype code 0 float32, 1 bfloat16; pages int8,
// scales float32 [n_pages, kv_heads, page_tokens, n_blocks] with n_blocks
// dividing head_dim; the contract of `paged_decode_group` otherwise.
extern "C" int paged_decode_quant_group(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, void* out,
    void* work, void* counters, int batch, int heads, int kv_heads,
    int n_pages, int page_tokens, int max_pages, int head_dim, int n_blocks,
    int chunk, float scale, int q_dtype, void* stream) {
  if (batch == 0) return cudaSuccess;
  const SplitArgs a{q, k, v, static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<const int*>(table),
                    static_cast<const int*>(lengths), out,
                    static_cast<float*>(work), static_cast<int*>(counters),
                    heads, kv_heads, n_pages, page_tokens, max_pages,
                    max_pages * page_tokens, n_blocks, chunk, scale,
                    head_dim};
  GroupLaunch l;
  if (!group_launch(a, batch, 1, &l)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch<float>(l, s);
    case 1:
      return launch<__nv_bfloat16>(l, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_decode_quant_group_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
