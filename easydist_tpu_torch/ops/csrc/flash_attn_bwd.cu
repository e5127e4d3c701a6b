// Flash-attention backward (B2 and B3) for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` (B2,
// easydist_tpu/ops/flash_attention.py:164) and `_flash_bwd_dkv_kernel`
// (B3, :197), both launched by `_flash_backward` (:235): the
// FlashAttention-2 backward, which recomputes the probabilities from the
// forward's saved logsumexp instead of keeping any [t_q, t_k] residual:
//
//   s  = (q . k) * scale       (keys past the query masked when causal)
//   P  = exp(s - lse)          dP = dO . v
//   dS = P * (dP - delta)      delta = rowsum(dO * O) - g_lse (computed
//                              outside, in torch, as XLA does on the TPU)
//   B2: dQ = sum_k dS K * scale
//   B3: dK = sum_q dS^T Q * scale,  dV = sum_q P^T dO
//
// in f32, outputs in the inputs' dtype.  q/k/v/dO [bh, t, d] float32 or
// bfloat16, lse/delta f32 [bh, t_q], head_dim 64 and 128, causal or
// full, any t_q and t_k (ragged tiles are masked here).
//
// What bounds them.  At the training shape (bh 96, t 1024, d 64, bf16,
// causal): B2 moves 63.7 MB (q, k, v, dO, lse, delta, dQ) and needs
// 19.3 GFLOP (three causal products), bound 19.5 us by operations at the
// tensor cores' 989 TFLOP/s; B3 moves 76.3 MB and needs 25.8 GFLOP (four
// products), bound 26.1 us by operations.
//
// The split is the TPU's own, and it needs no atomics, so both kernels
// are deterministic: dQ has one block per (row block, Q tile) looping over
// the K tiles up to the diagonal (the `_kv_index_map` clamp); dK/dV one
// block per (row block, K tile) looping over the Q tiles from the first
// one that reaches the diagonal (the `_q_index_map` clamp).  Tiles above
// the diagonal are neither loaded nor computed.
//
// B3, bfloat16: `flash_bwd_dkv_sm90_kernel`, on the tensor cores.  A
// block owns 128 keys; one warp of a producer warpgroup loads K and V
// once by TMA and streams the Q and dO tiles through a two-stage TMA ring
// (full/empty mbarriers), writing each tile's lse (times log2 e) and
// delta rows into the same stage with plain loads; it hands its
// registers to the consumers (`setmaxnreg`, 40 against 232).  Two
// consumer warpgroups own 64 keys
// each and compute in the transposed orientation, keys as the M side of
// `wgmma`: S^T = K.Q^T and dP^T = V.dO^T (A and B from shared memory),
// P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - delta),
// then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
// operands and dO and Q read through the transpose bit; `scale` enters dK
// once, when it is written.  P^T and dS^T never leave the registers (the
// f32 kernel's shared-memory round trip for them is gone).  Both are
// split into bf16 hi + lo halves before their products, for the reason
// the forward splits P (flash_attn_fwd.cu): bf16 products of bf16 inputs
// are exact in f32, one bf16 cast of P or dS would put a 2^-9 error on
// every term, about 90-140x over the f32 bar, and the split keeps the
// error below the outputs' own rounding at six products where the
// function has four.  Query tiles are 64 wide at head_dim 64 and 32 at 128,
// so dK, dV, S^T, dP^T and the split fragments fit the 232 registers
// (`ptxas -v` in the build's .log: no spills).
//
// B2, bfloat16: `flash_bwd_dq_sm90_kernel`, on the tensor cores, B1's
// skeleton with B3's dS arithmetic.  A block owns 128 queries; one warp
// of a producer warpgroup loads the Q and dO tiles once by TMA and
// streams the K and V tiles (64 keys) through a two-stage TMA ring from
// key 0 up to the block's diagonal, then hands its registers to the
// consumers.  Two consumer warpgroups own 64 queries each and keep the lse
// (times log2 e) and delta of their two rows a thread in registers for
// the whole block.  Per key tile: S = Q.K^T and dP = dO.V^T (A and B from
// shared memory), P = exp2(S scale log2 e - lse log2 e) masked per
// element where the tile crosses the diagonal or a ragged end,
// dS = P (dP - delta), then dQ += dS_hi.K + dS_lo.K with dS as a register
// A operand and K read MN-major through the transpose bit, as B1 reads V.
// dS is split for B3's reason: one bf16 cast misses the f32 bar.  A
// warpgroup whose rows all lie above a tile's keys (the block's last
// tile under causal masking, for the first warpgroup) or past t_q only
// releases the stage.  `scale` enters dQ once, when it is written.  Four
// products where the function has three; S, dP, dQ and dS's halves fit
// the 232 registers (`ptxas -v`: no spills).
//
// B2 and B3, float32: CUDA-core kernels.  Every operand is staged in
// shared memory as f32, transposed where a product contracts over its
// columns and row-major where it contracts over its rows, so each step of
// each tile product is two 16-byte shared loads feeding 16 FMAs per
// thread; P and dS go through shared memory between the two halves of a
// step.  No rounding enters beyond the outputs' casts.  They keep the f32
// promise of the train step (see the forward's note).
//
// Known limits: the bf16 kernels serialise each warpgroup's exponentials
// and products and hold one block per SM; the f32 dK/dV block stages
// eight tiles (139 KB at head_dim 64), so one block fits an SM, and the
// f32 kernels stage synchronously.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace flash_train {
namespace {

// B2, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int t_q, int t_k, int causal,
                        float scale) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  constexpr int TM = BQ / 16, TN = BK / 16, G = D / 64;
  constexpr int LQ = BQ + 4, LK = BK + 4, LV = D + 4;

  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;            // [D][LQ]  Q tile * scale, transposed
  float* do_t = q_t + D * LQ;   // [D][LQ]  dO tile, transposed
  float* k_t = do_t + D * LQ;   // [D][LK]  K tile, transposed
  float* k_s = k_t + D * LK;    // [BK][LV] K tile
  float* v_t = k_s + BK * LV;   // [D][LK]  V tile, transposed
  float* ds_t = v_t + D * LK;   // [BK][LQ] dS, transposed

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_off = static_cast<size_t>(bh) * t_q * D;
  const size_t kv_off = static_cast<size_t>(bh) * t_k * D;

  stage<BQ, D>(q + q_off, q0, t_q, scale, nullptr, q_t);
  stage<BQ, D>(dout + q_off, q0, t_q, 1.f, nullptr, do_t);

  float row_lse[TM], row_delta[TM], acc[G][TM][4] = {};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    const bool live = row < t_q;
    row_lse[i] = live ? lse[static_cast<size_t>(bh) * t_q + row] : 0.f;
    row_delta[i] = live ? delta[static_cast<size_t>(bh) * t_q + row] : 0.f;
  }

  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's readers are done
    stage<BK, D>(k + kv_off, k0, t_k, 1.f, k_s, k_t);
    stage<BK, D>(v + kv_off, k0, t_k, 1.f, nullptr, v_t);
    __syncthreads();

    float s[TM][TN] = {}, dp[TM][TN] = {};
    tile_product<TM, TN, D>(q_t + ty * TM, LQ, k_t + tx * TN, LK, s);
    tile_product<TM, TN, D>(do_t + ty * TM, LQ, v_t + tx * TN, LK, dp);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = k0 + tx * TN + j;
      float ds[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = q0 + ty * TM + i;
        const bool live = row < t_q && col < t_k && !(causal && col > row);
        const float p = live ? expf(s[i][j] - row_lse[i]) : 0.f;
        ds[i] = p * (dp[i][j] - row_delta[i]);
      }
      store_vec<TM>(ds_t + (tx * TN + j) * LQ + ty * TM, ds);
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g)
      tile_product<TM, 4, BK>(ds_t + ty * TM, LQ, k_s + 64 * g + tx * 4, LV,
                              acc[g]);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= t_q) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
      store4(dq + q_off + static_cast<size_t>(row) * D + 64 * g + tx * 4,
             make_float4(acc[g][i][0] * scale, acc[g][i][1] * scale,
                         acc[g][i][2] * scale, acc[g][i][3] * scale));
  }
}

// B3, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int t_q, int t_k, int causal, float scale) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  // this thread: key rows ty*TK.., query columns tx*TQ.. of S^T
  constexpr int TK = BK / 16, TQ = BQ / 16, G = D / 64;
  constexpr int LQ = BQ + 4, LK = BK + 4, LV = D + 4;

  extern __shared__ __align__(16) float smem[];
  float* k_t = smem;             // [D][LK]  K tile, transposed
  float* v_t = k_t + D * LK;     // [D][LK]  V tile, transposed
  float* q_t = v_t + D * LK;     // [D][LQ]  Q tile * scale, transposed
  float* q_s = q_t + D * LQ;     // [BQ][LV] Q tile * scale
  float* do_t = q_s + BQ * LV;   // [D][LQ]  dO tile, transposed
  float* do_s = do_t + D * LQ;   // [BQ][LV] dO tile
  float* p_s = do_s + BQ * LV;   // [BQ][LK] P  (query row, key column)
  float* ds_s = p_s + BQ * LK;   // [BQ][LK] dS (query row, key column)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // under causal masking tile 0 is longest
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_off = static_cast<size_t>(bh) * t_q * D;
  const size_t kv_off = static_cast<size_t>(bh) * t_k * D;

  stage<BK, D>(k + kv_off, k0, t_k, 1.f, nullptr, k_t);
  stage<BK, D>(v + kv_off, k0, t_k, 1.f, nullptr, v_t);

  float dk_acc[G][TK][4] = {}, dv_acc[G][TK][4] = {};

  // Q tiles strictly above this K tile's first row see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < t_q; q0 += BQ) {
    __syncthreads();  // the last tile's readers are done
    stage<BQ, D>(q + q_off, q0, t_q, scale, q_s, q_t);
    stage<BQ, D>(dout + q_off, q0, t_q, 1.f, do_s, do_t);
    __syncthreads();

    float st[TK][TQ] = {}, dpt[TK][TQ] = {};
    tile_product<TK, TQ, D>(k_t + ty * TK, LK, q_t + tx * TQ, LQ, st);
    tile_product<TK, TQ, D>(v_t + ty * TK, LK, do_t + tx * TQ, LQ, dpt);
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int row = q0 + tx * TQ + j;  // query
      const bool row_live = row < t_q;
      const float r_lse =
          row_live ? lse[static_cast<size_t>(bh) * t_q + row] : 0.f;
      const float r_delta =
          row_live ? delta[static_cast<size_t>(bh) * t_q + row] : 0.f;
      float p[TK], ds[TK];
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        const int col = k0 + ty * TK + i;  // key
        const bool live = row_live && col < t_k && !(causal && col > row);
        p[i] = live ? expf(st[i][j] - r_lse) : 0.f;
        ds[i] = p[i] * (dpt[i][j] - r_delta);
      }
      store_vec<TK>(p_s + (tx * TQ + j) * LK + ty * TK, p);
      store_vec<TK>(ds_s + (tx * TQ + j) * LK + ty * TK, ds);
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) {
      tile_product<TK, 4, BQ>(p_s + ty * TK, LK, do_s + 64 * g + tx * 4, LV,
                              dv_acc[g]);
      tile_product<TK, 4, BQ>(ds_s + ty * TK, LK, q_s + 64 * g + tx * 4, LV,
                              dk_acc[g]);
    }
  }

#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int row = k0 + ty * TK + i;
    if (row >= t_k) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t at = kv_off + static_cast<size_t>(row) * D + 64 * g + tx * 4;
      // Q was staged times scale, so dK needs no further factor
      store4(dk + at, make_float4(dk_acc[g][i][0], dk_acc[g][i][1],
                                  dk_acc[g][i][2], dk_acc[g][i][3]));
      store4(dv + at, make_float4(dv_acc[g][i][0], dv_acc[g][i][1],
                                  dv_acc[g][i][2], dv_acc[g][i][3]));
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t_q, int t_k, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  const size_t smem =
      sizeof(float) * (2 * D * (BQ + 4) + 2 * D * (BK + 4) + BK * (D + 4) +
                       BK * (BQ + 4));
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int t_q, int t_k,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::kQ, BK = Tiles<D>::kK;
  const size_t smem =
      sizeof(float) * (2 * D * (BK + 4) + 2 * D * (BQ + 4) +
                       2 * BQ * (D + 4) + 2 * BQ * (BK + 4));
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dkv_kernel<D>;
  cudaError_t e = allow_smem(kernel, smem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_k + BK - 1) / BK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), t_q, t_k, causal,
      scale);
  return cudaGetLastError();
}

// ------------------------------------ B3, bfloat16: tensor cores (sm90)

template <int D>
struct DkvSm90 {
  static constexpr int kBK = 128;                // two warpgroups of 64 keys
  static constexpr int kBQ = D == 64 ? 64 : 32;  // queries a tile
  static constexpr int kStages = 2;
  static constexpr int kPanels = D / sm90::kPanelCols;
  static constexpr int kKVBytes = kBK * D * 2;   // the K or the V tile
  static constexpr int kQBytes = kBQ * D * 2;    // one Q or dO tile
  static constexpr int kLseBytes = 2 * kBQ * 4;  // a tile's lse and delta
  static constexpr int kThreads = 384;  // + a producer warpgroup
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes +
                                  kStages * (2 * kQBytes + kLseBytes) +
                                  8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(DkvSm90<D>::kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int t_q,
                              int t_k, int causal, float scale) {
  using C = DkvSm90<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = sm90::align1024(smem_raw);
  uint8_t* v_s = k_s + C::kKVBytes;
  uint8_t* q_s = v_s + C::kKVBytes;      // [S] Q tiles
  uint8_t* do_s = q_s + S * C::kQBytes;  // [S] dO tiles
  float* rows_s = reinterpret_cast<float*>(do_s + S * C::kQBytes);
  // rows_s[s]: BQ values of lse * log2 e, then BQ of delta
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(rows_s + S * 2 * BQ);
  uint64_t* full = kv_full + 1;   // [S]
  uint64_t* empty = full + S;     // [S]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // under causal masking tile 0 is longest
  // Q tiles strictly above this K tile's first row see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_qt = q_begin < t_q ? (t_q - q_begin + BQ - 1) / BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(bh) * t_q;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one warp loads, three idle
    sm90::regs_release<sm90::kProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      sm90::mbar_expect_tx(kv_full, 2 * C::kKVBytes);
      sm90::tma_load_tile(k_s, &map_k, kv_full, C::kPanels, BK, k0, bh);
      sm90::tma_load_tile(v_s, &map_v, kv_full, C::kPanels, BK, k0, bh);
    }
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % S;
      const int q0 = q_begin + it * BQ;
      if (it >= S) sm90::mbar_wait(&empty[s], (it / S - 1) & 1);
      float* rows = rows_s + s * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const bool live = q0 + r < t_q;
        rows[r] = live ? lse[row0 + q0 + r] * sm90::kLog2e : 0.f;
        rows[BQ + r] = live ? delta[row0 + q0 + r] : 0.f;
      }
      __syncwarp();  // the rows are written before lane 0 arrives
      if (lane == 0) {
        sm90::mbar_expect_tx(&full[s], 2 * C::kQBytes);
        sm90::tma_load_tile(q_s + s * C::kQBytes, &map_q, &full[s],
                            C::kPanels, BQ, q0, bh);
        sm90::tma_load_tile(do_s + s * C::kQBytes, &map_do, &full[s],
                            C::kPanels, BQ, q0, bh);
      }
    }
    return;
  }

  sm90::regs_take<sm90::kConsumerRegs>();
  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 64
  const int wg = warp / 4;
  const int key_a = k0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int key_b = key_a + 8;
  const int c2 = 2 * (lane % 4);
  const float scale_log2 = scale * sm90::kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const uint32_t k_addr = sm90::smem_u32(k_s) + 64 * wg * sm90::kRowBytes;
  const uint32_t v_addr = sm90::smem_u32(v_s) + 64 * wg * sm90::kRowBytes;
  sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int s = it % S;
    const int q0 = q_begin + it * BQ;
    const uint32_t q_addr = sm90::smem_u32(q_s + s * C::kQBytes);
    const uint32_t do_addr = sm90::smem_u32(do_s + s * C::kQBytes);
    const float* rows = rows_s + s * 2 * BQ;
    sm90::mbar_wait(&full[s], (it / S) & 1);

    float st[BQ / 2], dpt[BQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // bytes into the panel's rows
      sm90::wgmma_ss<0>(
          st, sm90::desc_k_major(k_addr + (kk / 4) * BK * 128 + col),
          sm90::desc_k_major(q_addr + (kk / 4) * BQ * 128 + col), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      sm90::wgmma_ss<0>(
          dpt, sm90::desc_k_major(v_addr + (kk / 4) * BK * 128 + col),
          sm90::desc_k_major(do_addr + (kk / 4) * BQ * 128 + col), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // P^T and dS^T in place: row = key, column = query
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + c2 + e;
        const int q = q0 + ql;
        const float l2 = rows[ql], dl = rows[BQ + ql];
        const bool live_q = q < t_q;
        const bool live_a = live_q && key_a < t_k && !(causal && key_a > q);
        const bool live_b = live_q && key_b < t_k && !(causal && key_b > q);
        const float pa =
            live_a ? exp2f(fmaf(st[4 * j + e], scale_log2, -l2)) : 0.f;
        const float pb =
            live_b ? exp2f(fmaf(st[4 * j + 2 + e], scale_log2, -l2)) : 0.f;
        st[4 * j + e] = pa;
        st[4 * j + 2 + e] = pb;
        dpt[4 * j + e] = pa * (dpt[4 * j + e] - dl);
        dpt[4 * j + 2 + e] = pb * (dpt[4 * j + 2 + e] - dl);
      }

    uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4];
    uint32_t ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
    sm90::split_frags(st, p_hi, p_lo);
    sm90::split_frags(dpt, ds_hi, ds_lo);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t d_do =
          sm90::desc_mn_major(do_addr + kk * 16 * 128, BQ * 128);
      const uint64_t d_q =
          sm90::desc_mn_major(q_addr + kk * 16 * 128, BQ * 128);
      sm90::wgmma_rs<1>(dv_acc, p_hi[kk], d_do);
      sm90::wgmma_rs<1>(dv_acc, p_lo[kk], d_do);
      sm90::wgmma_rs<1>(dk_acc, ds_hi[kk], d_q);
      sm90::wgmma_rs<1>(dk_acc, ds_lo[kk], d_q);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(p_hi);
    sm90::fence_regs(p_lo);
    sm90::fence_regs(ds_hi);
    sm90::fence_regs(ds_lo);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);  // this warp is done
  }

  const size_t key0 = static_cast<size_t>(bh) * t_k;
  if (key_a < t_k) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (key0 + key_a) * D + 8 * j + c2;
      sm90::store_bf16x2(dk + at, dk_acc[4 * j] * scale,
                         dk_acc[4 * j + 1] * scale);
      sm90::store_bf16x2(dv + at, dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
  }
  if (key_b < t_k) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (key0 + key_b) * D + 8 * j + c2;
      sm90::store_bf16x2(dk + at, dk_acc[4 * j + 2] * scale,
                         dk_acc[4 * j + 3] * scale);
      sm90::store_bf16x2(dv + at, dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int t_q, int t_k, int causal, float scale,
                            cudaStream_t stream) {
  using C = DkvSm90<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t e = sm90::make_tile_map(&map_q, q, bh, t_q, D, C::kBQ);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_do, dout, bh, t_q, D, C::kBQ);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_k, k, bh, t_k, D, C::kBK);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_v, v, bh, t_k, D, C::kBK);
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  e = allow_smem(kernel, C::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_k + C::kBK - 1) / C::kBK);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------ B2, bfloat16: tensor cores (sm90)

template <int D>
struct DqSm90 {
  static constexpr int kBQ = 128;  // two warpgroups of 64 queries
  static constexpr int kBK = 64;   // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kPanels = D / sm90::kPanelCols;
  static constexpr int kQBytes = kBQ * D * 2;    // the Q or the dO tile
  static constexpr int kKVBytes = kBK * D * 2;   // one K or V tile
  static constexpr int kThreads = 384;  // + a producer warpgroup
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(DqSm90<D>::kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int t_q,
                             int t_k, int causal, float scale) {
  using C = DqSm90<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align1024(smem_raw);
  uint8_t* do_s = q_s + C::kQBytes;
  uint8_t* k_s = do_s + C::kQBytes;       // [S] K tiles
  uint8_t* v_s = k_s + S * C::kKVBytes;   // [S] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + S * C::kKVBytes);
  uint64_t* kv_full = q_full + 1;         // [S]
  uint64_t* kv_empty = kv_full + S;       // [S]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  const int n_kt = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one warp loads, three idle
    sm90::regs_release<sm90::kProducerRegs>();
    if (warp > 8 || lane != 0) return;
    sm90::mbar_expect_tx(q_full, 2 * C::kQBytes);
    sm90::tma_load_tile(q_s, &map_q, q_full, C::kPanels, BQ, q0, bh);
    sm90::tma_load_tile(do_s, &map_do, q_full, C::kPanels, BQ, q0, bh);
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % S;
      if (it >= S) sm90::mbar_wait(&kv_empty[s], (it / S - 1) & 1);
      sm90::mbar_expect_tx(&kv_full[s], 2 * C::kKVBytes);
      sm90::tma_load_tile(k_s + s * C::kKVBytes, &map_k, &kv_full[s],
                          C::kPanels, BK, it * BK, bh);
      sm90::tma_load_tile(v_s + s * C::kKVBytes, &map_v, &kv_full[s],
                          C::kPanels, BK, it * BK, bh);
    }
    return;
  }

  sm90::regs_take<sm90::kConsumerRegs>();
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 64
  const int wg = warp / 4;
  const int wg_row0 = q0 + 64 * wg;
  const int row_a = wg_row0 + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  const int c2 = 2 * (lane % 4);
  const float scale_log2 = scale * sm90::kLog2e;
  // this thread's two rows: lse in log2 units and delta (0 past t_q,
  // where the rows are masked and never stored)
  const size_t row0 = static_cast<size_t>(bh) * t_q;
  const bool live_a = row_a < t_q, live_b = row_b < t_q;
  const float l2_a = live_a ? lse[row0 + row_a] * sm90::kLog2e : 0.f;
  const float l2_b = live_b ? lse[row0 + row_b] * sm90::kLog2e : 0.f;
  const float dl_a = live_a ? delta[row0 + row_a] : 0.f;
  const float dl_b = live_b ? delta[row0 + row_b] : 0.f;
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  const uint32_t q_addr = sm90::smem_u32(q_s) + 64 * wg * sm90::kRowBytes;
  const uint32_t do_addr = sm90::smem_u32(do_s) + 64 * wg * sm90::kRowBytes;
  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % S;
    const int k0 = it * BK;
    const uint32_t k_addr = sm90::smem_u32(k_s + s * C::kKVBytes);
    const uint32_t v_addr = sm90::smem_u32(v_s + s * C::kKVBytes);
    sm90::mbar_wait(&kv_full[s], (it / S) & 1);

    // a tile wholly above this warpgroup's rows, or rows all past t_q,
    // contributes nothing
    if (wg_row0 < t_q && !(causal && k0 > wg_row0 + 63)) {
      float sc[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the panel's rows
        sm90::wgmma_ss<0>(
            sc, sm90::desc_k_major(q_addr + (kk / 4) * BQ * 128 + col),
            sm90::desc_k_major(k_addr + (kk / 4) * BK * 128 + col), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        sm90::wgmma_ss<0>(
            dp, sm90::desc_k_major(do_addr + (kk / 4) * BQ * 128 + col),
            sm90::desc_k_major(v_addr + (kk / 4) * BK * 128 + col), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // P, then dS in place of dP; masked only where the tile crosses
      // the diagonal or a ragged end
      const bool edge = k0 + BK > t_k || wg_row0 + 64 > t_q ||
                        (causal && k0 + BK - 1 > wg_row0);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pa = exp2f(fmaf(sc[4 * j + e], scale_log2, -l2_a));
          float pb = exp2f(fmaf(sc[4 * j + 2 + e], scale_log2, -l2_b));
          if (edge) {
            const int col = k0 + 8 * j + c2 + e;
            if (!live_a || col >= t_k || (causal && col > row_a)) pa = 0.f;
            if (!live_b || col >= t_k || (causal && col > row_b)) pb = 0.f;
          }
          dp[4 * j + e] = pa * (dp[4 * j + e] - dl_a);
          dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl_b);
        }

      uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
      sm90::split_frags(dp, ds_hi, ds_lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t d_k =
            sm90::desc_mn_major(k_addr + kk * 16 * 128, BK * 128);
        sm90::wgmma_rs<1>(dq_acc, ds_hi[kk], d_k);
        sm90::wgmma_rs<1>(dq_acc, ds_lo[kk], d_k);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(dq_acc);
      sm90::fence_regs(ds_hi);
      sm90::fence_regs(ds_lo);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&kv_empty[s]);  // this warp is done
  }

  if (live_a) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      sm90::store_bf16x2(dq + (row0 + row_a) * D + 8 * j + c2,
                         dq_acc[4 * j] * scale, dq_acc[4 * j + 1] * scale);
  }
  if (live_b) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      sm90::store_bf16x2(dq + (row0 + row_b) * D + 8 * j + c2,
                         dq_acc[4 * j + 2] * scale,
                         dq_acc[4 * j + 3] * scale);
  }
}

template <int D>
cudaError_t launch_dq_sm90(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int t_q,
                           int t_k, int causal, float scale,
                           cudaStream_t stream) {
  using C = DqSm90<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t e = sm90::make_tile_map(&map_q, q, bh, t_q, D, C::kBQ);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_do, dout, bh, t_q, D, C::kBQ);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_k, k, bh, t_k, D, C::kBK);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_v, v, bh, t_k, D, C::kBK);
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  e = allow_smem(kernel, C::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), t_q,
      t_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_train

// dtype: 0 float32 (the CUDA-core kernels), 1 bfloat16 (the tensor-core
// kernels).  q/dout [bh, t_q, head_dim], k/v [bh, t_k, head_dim],
// lse/delta f32 [bh, t_q], outputs like their inputs; all contiguous on
// the current device, 16-byte aligned.  Each returns cudaGetLastError()
// after its launch (or the error of the tensor maps' encoding).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh,
                                 int t_q, int t_k, int head_dim, int causal,
                                 float scale, int dtype, void* stream) {
  if (bh == 0 || t_q == 0) return cudaSuccess;
  if (t_k < 1 || (t_q + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flash_train::dispatch(dtype, head_dim, [&](auto t, auto d) {
    constexpr int D = decltype(d)::value;
    if constexpr (std::is_same_v<decltype(t), __nv_bfloat16>)
      return flash_train::launch_dq_sm90<D>(q, k, v, dout, lse, delta, dq,
                                            bh, t_q, t_k, causal, scale, s);
    else
      return flash_train::launch_dq<D>(q, k, v, dout, lse, delta, dq, bh,
                                       t_q, t_k, causal, scale, s);
  });
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int bh, int t_q,
                                  int t_k, int head_dim, int causal,
                                  float scale, int dtype, void* stream) {
  if (bh == 0 || t_k == 0) return cudaSuccess;
  if ((t_k + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flash_train::dispatch(dtype, head_dim, [&](auto t, auto d) {
    constexpr int D = decltype(d)::value;
    if constexpr (std::is_same_v<decltype(t), __nv_bfloat16>)
      return flash_train::launch_dkv_sm90<D>(q, k, v, dout, lse, delta, dk,
                                             dv, bh, t_q, t_k, causal, scale,
                                             s);
    else
      return flash_train::launch_dkv<D>(q, k, v, dout, lse, delta, dk, dv, bh,
                                        t_q, t_k, causal, scale, s);
  });
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
