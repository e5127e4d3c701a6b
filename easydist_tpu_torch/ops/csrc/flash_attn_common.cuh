// Shared pieces of the training attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the causal fill, the routes' head_dims and the
// launch-side helpers (the tensor-core pieces are in flash_attn_sm90.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>
#include <type_traits>

namespace flash_train {

constexpr float kMaskFill = -1e30f;  // the TPU kernels' causal fill
constexpr int kMaxDevices = 64;

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

// The shared memory a launch of `kernel` takes: its static bytes
// (cudaFuncGetAttributes) and the dynamic bytes the launch passes.
template <typename Kernel>
cudaError_t report_smem(Kernel kernel, size_t dynamic, int* static_bytes,
                        int* dynamic_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *static_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_bytes = static_cast<int>(dynamic);
  return cudaSuccess;
}

// The head_dims the kernels take.  B1 (forward), B2 (dQ) and B3 (dK, dV)
// run on the tensor cores at every head_dim up to 256 in both dtypes,
// templated on a padded width DP (64, 80, 96, 128; 256 for 129..256)
// with the true d at run time; the tiles' columns past d are zeros (they
// add nothing to the products over d, which run every 32-byte step of
// the width), the products whose N is the head_dim take N = DP (at 256 in
// float32 B2 and B3 put the head_dim on the M side instead), and the
// epilogues store at stride d.  Rows a TMA map takes (d * itemsize a
// multiple of 16) are loaded by the maps, whose extent d zero-fills the
// padding; other rows (bf16 100) by the producer's own copies into the
// same swizzled tiles (flash_attn_sm90.cuh, `fill_tile`).  The float32
// kernels at 256 take no maps: their tiles of TF32 halves leave no room
// for a raw landing stage, so they load the rows themselves (flash_attn_
// fwd.cu, flash_attn_bwd.cu).  `tensor_core_width` gives DP, or 0 outside
// 1..256.
inline int tensor_core_width(int head_dim) {
  if (head_dim < 1 || head_dim > 256) return 0;
  return head_dim <= 64 ? 64 : head_dim <= 80 ? 80 : head_dim <= 96 ? 96
                                               : head_dim <= 128 ? 128 : 256;
}

// Calls f(T{}, std::integral_constant<int, DP>{}) for dtype (0 float32,
// 1 bfloat16) and a padded width DP (64, 80, 96, 128, 256);
// cudaErrorInvalidValue otherwise.
template <typename F>
cudaError_t dispatch_width(int dtype, int width, F&& f) {
  auto by_width = [&](auto t) -> cudaError_t {
    using T = decltype(t);
    switch (width) {
      case 64: return f(T{}, std::integral_constant<int, 64>{});
      case 80: return f(T{}, std::integral_constant<int, 80>{});
      case 96: return f(T{}, std::integral_constant<int, 96>{});
      case 128: return f(T{}, std::integral_constant<int, 128>{});
      case 256: return f(T{}, std::integral_constant<int, 256>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_width(float{});
  if (dtype == 1) return by_width(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace flash_train
