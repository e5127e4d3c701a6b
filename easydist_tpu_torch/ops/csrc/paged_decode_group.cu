// B5 under grouped-query attention, for Hopper (sm_90a): single-query
// decode through a page table where heads / kv_heads >= 2 query heads
// share a KV head.
//
// Replaces, with paged_decode.cu's `paged_decode_kernel` (G = 1), the TPU
// kernel B5 `_flash_paged_decode_kernel` of
// easydist_tpu/ops/flash_attention.py (:644, `pallas_call` :742), which
// maps query head hi to KV head hi // (heads // kv_heads) in its index
// maps and so reads a KV head's pages once per query head.  The same
// function, arguments and contract as `paged_decode` (paged_decode.cu);
// the body, what bounds it and what its design does about it are
// decode_group.cuh's: one block per (row, KV head, chunk of up to 8 query
// heads, split) reads the KV head's rows of its split once for all the
// chunk's query heads (the split body reads them once per query head: 4x
// at Llama-3-8B's 32 / 8).  A source of its own, so that its
// instantiations compile beside the other kernels' sources.

#include "decode_group.cuh"

namespace {

// two blocks an SM (128 registers a thread) where a lane's q is 32 floats;
// one at D 256 / GT 8, where it is 64
template <typename TQ, typename TKV, int D, int GT>
__global__ void __launch_bounds__(kGThreads, D * GT <= 1024 ? 2 : 1)
    paged_decode_group_kernel(GroupArgs a) {
  decode_group_body<TQ, TKV, false, D, GT>(a);
}

template <typename TQ, typename TKV>
cudaError_t launch(const GroupLaunch& l, cudaStream_t s) {
  return launch_group(l, [&](auto width, auto gt) {
    constexpr int D = decltype(width)::value, GT = decltype(gt)::value;
    return launch_split<paged_decode_group_kernel<TQ, TKV, D, GT>, kGThreads>(
        l.args, l.blocks, l.n_splits, l.smem, s);
  });
}

}  // namespace

// B5 at heads / kv_heads >= 2.  The arguments of `paged_decode`
// (paged_decode.cu): dtype codes 0 float32, 1 bfloat16, (q, pages) in
// {(0, 0), (1, 1), (0, 1)}; all tensors contiguous on the current device;
// `chunk` tokens a split, ceil(max_pages * page_tokens / chunk) splits a
// row; `work` f32 [batch * heads, n_splits, head_dim + 2]; `counters`
// int32 of at least batch * heads, zero at the call and zero again after
// the launch.  Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for a shape it does not take (G = 1
// among them).
extern "C" int paged_decode_group(const void* q, const void* k, const void* v,
                                  const void* table, const void* lengths,
                                  void* out, void* work, void* counters,
                                  int batch, int heads, int kv_heads,
                                  int n_pages, int page_tokens, int max_pages,
                                  int head_dim, int chunk, float scale,
                                  int q_dtype, int kv_dtype, void* stream) {
  if (batch == 0) return cudaSuccess;
  const SplitArgs a{q, k, v, nullptr, nullptr,
                    static_cast<const int*>(table),
                    static_cast<const int*>(lengths), out,
                    static_cast<float*>(work), static_cast<int*>(counters),
                    heads, kv_heads, n_pages, page_tokens, max_pages,
                    max_pages * page_tokens, 1, chunk, scale, head_dim};
  GroupLaunch l;
  if (!group_launch(a, batch, kv_dtype == 0 ? 4 : 2, &l))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float>(l, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(l, s);
  if (q_dtype == 0 && kv_dtype == 1) return launch<float, __nv_bfloat16>(l, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_group_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
