// Hopper (sm_90a) pieces shared by the tensor-core training attention
// kernels (flash_attn_fwd.cu, flash_attn_bwd.cu): mbarriers, TMA tile
// loads, shared-memory matrix descriptors for 128-byte swizzled tiles,
// `wgmma` products (f32 += bf16 x bf16, and f32 += tf32 x tf32 for the
// float32 kernels), the accumulator-to-A-fragment conversion with the
// hi/lo split, the converters' f32-tile-to-TF32-halves helpers, the quad
// reductions of the accumulator layout, and the host-side tensor-map
// encoder.
//
// Tile layout.  Every operand tile is `rows x d` bf16 (or f32), row-major
// in device memory, and lands in shared memory as panels of `rows x 128
// bytes` (64 bf16 or 32 f32 columns), each loaded by one TMA box with the
// 128-byte swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)).
// Panels start on 1024-byte boundaries, so 8-row groups are 1024 bytes
// apart.  A 32-byte step of the contracted index is 16 bf16 or 8 tf32
// values: one `k16` or `k8` product.
//   * A product that contracts over the 64 columns (S = Q.K^T: Q and K both
//     contract over d) reads the tile "K-major": the descriptor starts at
//     row r0 of the panel plus 32 bytes per 16-column step, stride 1024
//     between 8-row groups.
//   * A product that contracts over the rows (O += P.V: V contracts over
//     its keys) reads it "MN-major" with the transpose bit: the descriptor
//     starts at row 16 k of the panel for step k, 8-row groups 1024 bytes
//     apart, and the next 64 columns one panel further on.
//
// Accumulator layout of `wgmma.m64nNk16` (f32): warp w of the warpgroup
// holds rows 16 w + lane / 4 ("row a") and that + 8 ("row b"); register
// 4 j + e holds row a, column 8 j + 2 (lane % 4) + e, and 4 j + 2 + e holds
// row b at the same column (e = 0, 1).  The four lanes of a quad share a
// row, so a row's max or sum is two shuffles.  The A fragment of the
// register form (`wgmma ... {a0..a3}`) has the same row and column map
// for each 16-column step, so an accumulator becomes an A operand without
// moving between lanes.  At TF32 (`m64nNk8`) it does not: the A fragment
// holds columns c and c + 4 (c = lane % 4) of rows a and b, registers
// {a0, a1, a2, a3} = (a, c), (b, c), (a, c + 4), (b, c + 4), where the
// accumulator holds columns 2c and 2c + 1.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash_train {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPanelCols = 64;     // bf16 columns of one 128-byte swizzled row
constexpr int kPanelColsF32 = 32;  // f32 columns of one such row
constexpr int kRowBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after `p` (shared memory)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -------------------------------------------------------------------- TMA

// One box of a 3-D [bh][t][d] map into shared memory at `dst`, counted on
// `bar`.  Coordinates run innermost first: column, row, row block.  Rows
// past t are zero-filled (and still counted in the box's bytes).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int block) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(block)
      : "memory");
}

// all `panels` boxes (`cols` columns each) of a `rows`-row tile at
// (row, block)
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int panels,
                                              int rows, int row, int block,
                                              int cols = kPanelCols) {
  for (int p = 0; p < panels; ++p)
    tma_load(dst + p * rows * kRowBytes, map, bar, p * cols, row, block);
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads (`wgmma` operands) that a barrier hands them to.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over `threads` threads of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -------------------------------------------------------- matrix descriptors

__device__ __forceinline__ uint64_t desc_encode(uint32_t addr,
                                                uint32_t lead_bytes,
                                                uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead_bytes & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((stride_bytes & 0x3FFFF) >> 4) << 32 |
         1ull << 62;  // 128-byte swizzle
}

// contracted index along the panel's columns (the lead offset is unused)
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc_encode(addr, 16, 1024);
}

// contracted index along the rows; the next 64 columns `panel_bytes` on
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t panel_bytes) {
  return desc_encode(addr, panel_bytes, 1024);
}

// Register budget of a warpgroup (all four warps execute it): the producer
// warpgroup gives registers back, the consumers take them.  A block of
// three warpgroups starts at 168 a thread (65536 / 384); producer 40 and
// consumers 232 stay within the SM's 65536.
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// --------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous product writes (or reads) must not be touched
// by the compiler across the wait: each is redefined after it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x N] = A[64 x 16] . B[16 x N] (+ D when `accumulate`), A and B from
// shared memory (descriptors); TransB 1 reads B MN-major.  d has N / 2
// registers a thread.

template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransB));
}

// D[64 x N] += A[64 x 16] . B[16 x N], A from registers (a fragment of
// four bf16 pairs a thread), B from shared memory.

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TransB));
}

// D[64 x N] (+)= A[64 x 8] . B[8 x N] in TF32, both operands K-major
// (the only layout TF32 takes): A from shared memory or from registers (a
// fragment of four tf32 values a thread), B from shared memory.

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// x as hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
// ties away from zero (`cvt.rna`): hi + lo holds x to about 2^-22 of its
// size, so three TF32 products a_hi.b_hi + a_hi.b_lo + a_lo.b_hi keep an
// f32 product to about 2^-21 where one TF32 product rounds it to 2^-11.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split_tf32(float4 x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// ------------------------------------------------ f32 tiles -> TF32 halves
//
// The TF32 kernels' converters (warps of the producer warpgroup) turn an
// f32 tile that TMA landed in shared memory (`R` rows x D columns, panels
// of 32 columns and R rows, 128-byte swizzle) into the halves the
// products read.  Thread `t` of `N` converters.

// `B`: the items a converter loads before it splits and stores any, so
// their latencies overlap.  B = 1 is a plain loop.  A batch unrolls the
// loop whole (kept at run time it timed no faster than one item); that
// costs registers, which a kernel whose converters and consumers compile
// to one tight count cannot spare (it spills or slows): such a kernel
// takes B = 1.
template <int kItems, int N, int B, typename Load, typename Store>
__device__ __forceinline__ void convert_items(int t, Load load, Store store) {
  if constexpr (B == 1) {
    for (int i = t; i < kItems; i += N) store(i, load(i));
  } else {
    constexpr int kSteps = (kItems + N - 1) / N;
#pragma unroll
    for (int j0 = 0; j0 < kSteps; j0 += B) {
      float4 x[B];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int i = t + (j0 + j) * N;
        if (j0 + j < kSteps && i < kItems) x[j] = load(i);
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int i = t + (j0 + j) * N;
        if (j0 + j < kSteps && i < kItems) store(i, x[j]);
      }
    }
  }
}

// The tile at `src` as hi = tf32(x) into `hi` and lo = tf32(x - hi) into
// `lo`, both in its layout; `lo` may be `src` (in place: each thread
// reads and writes only its own 16-byte chunks).
template <int BYTES, int N, int B = 1>
__device__ __forceinline__ void split_tile(const uint8_t* src, uint8_t* hi,
                                           uint8_t* lo, int t) {
  convert_items<BYTES / 16, N, B>(
      t, [&](int i) { return reinterpret_cast<const float4*>(src)[i]; },
      [&](int i, float4 x) {
        uint4 h, l;
        split_tf32(x, h, l);
        reinterpret_cast<uint4*>(hi)[i] = h;
        reinterpret_cast<uint4*>(lo)[i] = l;
      });
}

// The landed tile's transpose, split: hi and lo as [D rows][slots], the
// slot of a value its row in the tile (keys or queries contiguous), in
// panels of 32 slots (D * 128 bytes each), 128-byte swizzle, each 8-slot
// group stored in the order 0 2 4 6 1 3 5 7 so that an accumulator pair
// (2c, 2c + 1) is a TF32 A fragment's columns (c, c + 4).  R is a multiple
// of 8; with R = 16 only the first half of each 128-byte row is written.
// Item i is column i % D at slots 4 (i / D) .. + 3; a warp takes 32
// neighbouring columns, so its reads and its 16-byte writes are free of
// bank conflicts.
template <int R, int D, int N, int B = 1>
__device__ __forceinline__ void split_transposed(const uint8_t* raw,
                                                 uint8_t* hi, uint8_t* lo,
                                                 int t) {
  convert_items<D * R / 4, N, B>(
      t,
      [&](int i) {
        const int d = i % D, quad = i / D;
        const int r0 = 8 * (quad / 2) + quad % 2;  // rows r0 + 2 e
        const uint8_t* col = raw + (d / 32) * R * 128 + (d % 4) * 4;
        float xs[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 2 * e;
          xs[e] = *reinterpret_cast<const float*>(
              col + r * 128 + ((((d % 32) / 4) ^ (r % 8)) * 16));
        }
        return make_float4(xs[0], xs[1], xs[2], xs[3]);
      },
      [&](int i, float4 x) {
        const int d = i % D, pos = 4 * (i / D);
        const int off = (pos / 32) * D * 128 + d * 128 +
                        ((((pos % 32) / 4) ^ (d % 8)) * 16);
        uint4 h, l;
        split_tf32(x, h, l);
        *reinterpret_cast<uint4*>(hi + off) = h;
        *reinterpret_cast<uint4*>(lo + off) = l;
      });
}

// An accumulator of a 64 x N TF32 product (N / 2 registers) as the N / 8
// A fragments of its hi and lo halves: step kk holds columns 8 kk + 2c
// and + 1 as the fragment's (c, c + 4), which the transposed operand's
// 0 2 4 6 1 3 5 7 order matches.
template <int R>
__device__ __forceinline__ void split_frags_tf32(const float (&acc)[R],
                                                 uint32_t (&hi)[R / 4][4],
                                                 uint32_t (&lo)[R / 4][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 4; ++kk) {
    split_tf32(acc[4 * kk], hi[kk][0], lo[kk][0]);
    split_tf32(acc[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split_tf32(acc[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split_tf32(acc[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// --------------------------------------------- accumulator -> A fragments

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo holds
// x to about 2^-16 of its size, so a product fed both halves keeps f32 P
// (and dS) where one bf16 cast would round them to 2^-8.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// An accumulator of N / 2 registers (64 x N) as N / 16 A fragments, each
// split hi/lo: step k holds columns 16 k .. 16 k + 15.
template <int R>
__device__ __forceinline__ void split_frags(const float (&acc)[R],
                                            uint32_t (&hi)[R / 8][4],
                                            uint32_t (&lo)[R / 8][4]) {
#pragma unroll
  for (int k = 0; k < R / 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16x2(acc[8 * k + 2 * i], acc[8 * k + 2 * i + 1], hi[k][i],
                   lo[k][i]);
}

// max / sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (x0, x1) rounded to bf16 and stored as one pair
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x0,
                                             float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime once (no -lcuda)
inline cudaError_t encode_tiled(EncodeTiled* out) {
  static std::atomic<EncodeTiled> cached{nullptr};
  EncodeTiled fn = cached.load(std::memory_order_acquire);
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || sym == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(sym);
    cached.store(fn, std::memory_order_release);
  }
  *out = fn;
  return cudaSuccess;
}

// The map of a contiguous bf16 (elem_bytes 2) or f32 (4) [bh][t][d]
// tensor, read in boxes of `rows` rows by 128 bytes (64 or 32 columns)
// with the 128-byte swizzle; rows past t read as zeros.  The base must be
// 16-byte aligned (d * elem_bytes and t * d * elem_bytes, the strides,
// always are multiples of 16 for d 64 and 128).
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, int bh,
                                 int t, int d, int rows, int elem_bytes = 2) {
  EncodeTiled encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * elem_bytes,
                                 static_cast<cuuint64_t>(t) * d * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kRowBytes / elem_bytes),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace flash_train
