// Shared pieces of the training attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the causal fill and the launch-side helpers (the
// tensor-core pieces are in flash_attn_sm90.cuh).

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
