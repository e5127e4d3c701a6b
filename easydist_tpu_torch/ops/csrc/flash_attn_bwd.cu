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
// products), bound 26.1 us by operations.  In float32 the bytes double
// and the products run at the TF32 rate (495 TFLOP/s): B2 39.1 us and B3
// 52.1 us, both by operations.
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
// B2 and B3, float32: `flash_bwd_dq_tf32_kernel` and
// `flash_bwd_dkv_tf32_kernel`, on the tensor cores as the f32 forward
// runs (flash_attn_fwd.cu): every operand split x = hi + lo with hi =
// tf32(x) and lo = tf32(x - hi) (`cvt.rna`), each product of the function
// as the three TF32 products a_hi.b_hi + a_hi.b_lo + a_lo.b_hi summed in
// f32; P (P^T) and dS (dS^T) are made in registers in f32 and split the
// same way before their products.  No f32 value enters a product through
// one TF32 cast (which lands 24-39x over the f32 bar where the split
// stays at 0.02 of it: `TestSplitRounding`).  TF32 `wgmma` reads both
// operands K-major only, so a product that contracts over a tile's rows
// needs the tile transposed in shared memory, which TMA cannot make: one
// warp of the producer warpgroup lands each raw f32 tile by TMA in the
// lo slot of a converted stage, and its three other warps write the
// transposed halves from it, then (after a barrier of their own) split
// the tile into hi and lo in place, and hand the stage over behind a
// proxy fence.  Transposed tiles store each 8-row group in the order
// 0 2 4 6 1 3 5 7, so dS, P^T and dS^T go from accumulator to A fragment
// without a shuffle.
//   B2: a block owns 128 queries (two consumer warpgroups) at head_dim
//   64, 64 at 128 (one).  The K/V tiles (32 keys) stream through the
//   converted stages as K_hi, K_lo, V_hi, V_lo and K^T_hi, K^T_lo;
//   S = Q.K^T and dP = dO.V^T take K and V as they are, dQ += dS.K takes
//   K^T.  Q's halves are register A fragments at head_dim 64 (m64n32k8
//   products, which stay exact across key tiles where m64n64k8 ones of
//   resident fragments drifted in the f32 forward), in shared memory at
//   128; dO's halves are in shared memory, split by the consumers
//   themselves.  Nine products where the function has three.  Stages:
//   three (208 KB) at head_dim 64, one (224 KB) at 128.
//   B3: a block owns 64 keys in the transposed orientation of the bf16
//   B3: K's and V's halves stay in shared memory as A operands, and the
//   Q/dO tiles (32 queries; 16 at head_dim 128) stream through the
//   converted stages as Q, dO, Q^T and dO^T halves with their lse (times
//   log2 e) and delta rows, for one consumer warpgroup.  The converters'
//   work, not the products, bounds it (a second consumer warpgroup on
//   alternate tiles timed no faster), so at head_dim 64 seven warps
//   convert.  S^T = K.Q^T and
//   dP^T = V.dO^T take Q and dO as they are, dV += P^T.dO takes dO^T and
//   dK += dS^T.Q takes Q^T.  Twelve products where the function has four.
//   Two stages (192 KB) at head_dim 64; one (224 KB) at 128, where a
//   transposed tile keeps its 128-byte rows (32 slots, 16 used).
// No atomics: two launches are bitwise equal.  `ptxas -v`: no spills.
//
// Known limits: the bf16 kernels serialise each warpgroup's exponentials
// and products and hold one block per SM; the f32 kernels too, and at
// head_dim 128 their single stage serialises conversion and products.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace flash_train {
namespace {

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

// ------------------------ float32: tensor cores, three TF32 products

constexpr int kConvBarrier = 3;  // converters' named barrier (consumers 1, 2)

// B2, float32
template <int D>
struct DqTf32 {
  static constexpr int kWG = D == 64 ? 2 : 1;       // consumer warpgroups
  static constexpr int kBQ = 64 * kWG;              // queries a block
  static constexpr int kBK = 32;                    // keys a tile
  static constexpr bool kQRegs = D == 64;           // Q's halves in registers
  static constexpr int kStages = D == 64 ? 3 : 1;
  static constexpr int kPanels = D / sm90::kPanelColsF32;
  static constexpr int kTile = kBK * D * 4;         // one f32 K, V or K^T tile
  // K_hi, K_lo, V_hi, V_lo, K^T_hi, K^T_lo; TMA lands K in K_lo, V in V_lo
  static constexpr int kStageBytes = 6 * kTile;
  static constexpr int kHalfBytes = kBQ * D * 4;    // one half of dO (or Q)
  static constexpr int kResBytes = (kQRegs ? 2 : 4) * kHalfBytes;
  static constexpr int kConverters = 96;            // producer warps 1-3
  static constexpr int kThreads = 128 * (1 + kWG);
  // registers a thread after `setmaxnreg` (two consumer warpgroups only)
  static constexpr int kProducerRegs = 56, kConsumerRegs = 224;
  static_assert(kWG == 1 || 128 * (kProducerRegs + kWG * kConsumerRegs) <=
                                65536,
                "the SM's register file");
  static constexpr size_t kSmem =
      1024 + kResBytes + kStages * kStageBytes + 24 * kStages;
  static_assert(kSmem <= 227 * 1024, "the shared memory a block may use");
};

template <int D>
__global__ void __launch_bounds__(DqTf32<D>::kThreads, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const float* __restrict__ q,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int t_q, int t_k,
                             int causal, float scale) {
  using C = DqTf32<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages, T = C::kTile;
  constexpr int H = C::kHalfBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res_s = sm90::align1024(smem_raw);  // dO_hi, dO_lo (, Q_hi, Q_lo)
  uint8_t* stage_s = res_s + C::kResBytes;     // [S] converted stages
  uint64_t* raw_full =
      reinterpret_cast<uint64_t*>(stage_s + S * C::kStageBytes);
  uint64_t* conv_full = raw_full + S;
  uint64_t* conv_empty = conv_full + S;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  const int n_kt = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&raw_full[s], 1);
      sm90::mbar_init(&conv_full[s], C::kConverters);
      sm90::mbar_init(&conv_empty[s], 4 * C::kWG);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * C::kWG) {  // producer warpgroup: one warp loads, three split
    if constexpr (C::kWG > 1) sm90::regs_release<C::kProducerRegs>();
    if (warp == 4 * C::kWG) {
      if (lane == 0) {
        for (int it = 0; it < n_kt; ++it) {
          const int s = it % S;
          if (it >= S) sm90::mbar_wait(&conv_empty[s], (it / S - 1) & 1);
          uint8_t* st = stage_s + s * C::kStageBytes;
          sm90::mbar_expect_tx(&raw_full[s], 2 * T);
          sm90::tma_load_tile(st + T, &map_k, &raw_full[s], C::kPanels, BK,
                              it * BK, bh, sm90::kPanelColsF32);
          sm90::tma_load_tile(st + 3 * T, &map_v, &raw_full[s], C::kPanels,
                              BK, it * BK, bh, sm90::kPanelColsF32);
        }
      }
      return;
    }
    const int ct = threadIdx.x - 128 * C::kWG - 32;
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % S;
      uint8_t* st = stage_s + s * C::kStageBytes;
      sm90::mbar_wait(&raw_full[s], (it / S) & 1);
      sm90::split_transposed<BK, D, C::kConverters>(st + T, st + 4 * T,
                                                 st + 5 * T, ct);
      sm90::named_sync(kConvBarrier, C::kConverters);  // raw K read by all
      sm90::split_tile<T, C::kConverters>(st + T, st, st + T, ct);
      sm90::split_tile<T, C::kConverters>(st + 3 * T, st + 2 * T, st + 3 * T,
                                          ct);
      sm90::fence_proxy_async();  // the stores, before the consumers' wgmma
      sm90::mbar_arrive(&conv_full[s]);
    }
    return;
  }

  if constexpr (C::kWG > 1) sm90::regs_take<C::kConsumerRegs>();
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 64
  const int wg = warp / 4;
  const int wg_row0 = q0 + 64 * wg;
  const int row_a = wg_row0 + 16 * (warp % 4) + lane / 4;
  const int row_b = row_a + 8;
  const int c = lane % 4, c2 = 2 * c;
  const float scale_log2 = scale * sm90::kLog2e;
  // this thread's two rows: lse in log2 units and delta (0 past t_q,
  // where the rows are masked and never stored)
  const size_t row0 = static_cast<size_t>(bh) * t_q;
  const bool live_a = row_a < t_q, live_b = row_b < t_q;
  const float l2_a = live_a ? lse[row0 + row_a] * sm90::kLog2e : 0.f;
  const float l2_b = live_b ? lse[row0 + row_b] * sm90::kLog2e : 0.f;
  const float dl_a = live_a ? delta[row0 + row_a] : 0.f;
  const float dl_b = live_b ? delta[row0 + row_b] : 0.f;
  const float* qb = q + row0 * D;
  const float* dob = dout + row0 * D;

  // Q's halves as A fragments (columns 8 kk + c and + 4 of rows a and
  // b); dO's halves, and at head_dim 128 Q's, as this warpgroup's 64 rows
  // in shared memory, swizzled K-major
  uint32_t q_hi[C::kQRegs ? D / 8 : 1][4], q_lo[C::kQRegs ? D / 8 : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i % 2 ? row_b : row_a;
        const int col = 8 * kk + c + 4 * (i / 2);
        const float x = row < t_q ? qb[static_cast<size_t>(row) * D + col]
                                  : 0.f;
        sm90::split_tf32(x, q_hi[kk][i], q_lo[kk][i]);
      }
  }
  for (int i = threadIdx.x % 128; i < 64 * D / 4; i += 128) {
    const int r = 64 * wg + i / (D / 4), col = 4 * (i % (D / 4));
    const bool live = q0 + r < t_q;
    const size_t at = static_cast<size_t>(q0 + r) * D + col;
    const int off = (col / 32) * BQ * 128 + r * 128 +
                    ((((col % 32) / 4) ^ (r % 8)) * 16);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 hi, lo;
    sm90::split_tf32(live ? *reinterpret_cast<const float4*>(dob + at) : zero,
                     hi, lo);
    *reinterpret_cast<uint4*>(res_s + off) = hi;
    *reinterpret_cast<uint4*>(res_s + H + off) = lo;
    if constexpr (!C::kQRegs) {
      sm90::split_tf32(live ? *reinterpret_cast<const float4*>(qb + at)
                            : zero,
                       hi, lo);
      *reinterpret_cast<uint4*>(res_s + 2 * H + off) = hi;
      *reinterpret_cast<uint4*>(res_s + 3 * H + off) = lo;
    }
  }
  sm90::fence_proxy_async();
  sm90::named_sync(1 + wg, 128);

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t do_addr = sm90::smem_u32(res_s) + 64 * wg * sm90::kRowBytes;
  const uint32_t q_addr = do_addr + 2 * H;

  for (int it = 0; it < n_kt; ++it) {
    const int s = it % S;
    const int k0 = it * BK;
    const uint32_t k_hi = sm90::smem_u32(stage_s + s * C::kStageBytes);
    const uint32_t k_lo = k_hi + T, v_hi = k_hi + 2 * T, v_lo = k_hi + 3 * T;
    const uint32_t kt_hi = k_hi + 4 * T, kt_lo = k_hi + 5 * T;
    sm90::mbar_wait(&conv_full[s], (it / S) & 1);

    // a tile wholly above this warpgroup's rows, or rows all past t_q,
    // contributes nothing
    if (wg_row0 < t_q && !(causal && k0 > wg_row0 + 63)) {
      // S = Q.K^T and dP = dO.V^T, each as hi.hi + hi.lo + lo.hi, 8
      // columns of d a step
      float sc[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t kc = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint64_t dk_hi = sm90::desc_k_major(k_hi + kc);
        if constexpr (C::kQRegs) {
          sm90::wgmma_tf32_rs(sc, q_hi[kk], dk_hi, kk > 0);
          sm90::wgmma_tf32_rs(sc, q_hi[kk], sm90::desc_k_major(k_lo + kc), 1);
          sm90::wgmma_tf32_rs(sc, q_lo[kk], dk_hi, 1);
        } else {
          const uint32_t qc = q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32;
          const uint64_t dq_hi = sm90::desc_k_major(qc);
          sm90::wgmma_tf32_ss(sc, dq_hi, dk_hi, kk > 0);
          sm90::wgmma_tf32_ss(sc, dq_hi, sm90::desc_k_major(k_lo + kc), 1);
          sm90::wgmma_tf32_ss(sc, sm90::desc_k_major(qc + H), dk_hi, 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t kc = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t oc = do_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint64_t ddo_hi = sm90::desc_k_major(oc);
        const uint64_t dv_hi = sm90::desc_k_major(v_hi + kc);
        sm90::wgmma_tf32_ss(dp, ddo_hi, dv_hi, kk > 0);
        sm90::wgmma_tf32_ss(dp, ddo_hi, sm90::desc_k_major(v_lo + kc), 1);
        sm90::wgmma_tf32_ss(dp, sm90::desc_k_major(oc + H), dv_hi, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      if constexpr (C::kQRegs) {
        sm90::fence_regs(q_hi);
        sm90::fence_regs(q_lo);
      }

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

      // dQ += dS_hi.K^T_hi + dS_hi.K^T_lo + dS_lo.K^T_hi, 8 keys a step
      uint32_t ds_hi[BK / 8][4], ds_lo[BK / 8][4];
      sm90::split_frags_tf32(dp, ds_hi, ds_lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t tc = (kk / 4) * D * 128 + (kk % 4) * 32;
        const uint64_t dt_hi = sm90::desc_k_major(kt_hi + tc);
        sm90::wgmma_tf32_rs(dq_acc, ds_hi[kk], dt_hi, 1);
        sm90::wgmma_tf32_rs(dq_acc, ds_hi[kk], sm90::desc_k_major(kt_lo + tc),
                            1);
        sm90::wgmma_tf32_rs(dq_acc, ds_lo[kk], dt_hi, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(dq_acc);
      sm90::fence_regs(ds_hi);
      sm90::fence_regs(ds_lo);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&conv_empty[s]);  // this warp is done
  }

  if (live_a) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dq + (row0 + row_a) * D + 8 * j + c2) =
          make_float2(dq_acc[4 * j] * scale, dq_acc[4 * j + 1] * scale);
  }
  if (live_b) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dq + (row0 + row_b) * D + 8 * j + c2) =
          make_float2(dq_acc[4 * j + 2] * scale, dq_acc[4 * j + 3] * scale);
  }
}

template <int D>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int t_q,
                           int t_k, int causal, float scale,
                           cudaStream_t stream) {
  using C = DqTf32<D>;
  if (reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(dout) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_k, map_v;
  cudaError_t e = sm90::make_tile_map(&map_k, k, bh, t_k, D, C::kBK, 4);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_v, v, bh, t_k, D, C::kBK, 4);
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dq_tf32_kernel<D>;
  e = allow_smem(kernel, C::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_q + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_k, map_v, static_cast<const float*>(q),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), t_q, t_k,
      causal, scale);
  return cudaGetLastError();
}

// B3, float32
template <int D>
struct DkvTf32 {
  static constexpr int kBK = 64;                   // keys a block
  static constexpr int kBQ = D == 64 ? 32 : 16;    // queries a tile
  static constexpr int kStages = D == 64 ? 2 : 1;
  static constexpr int kPanels = D / sm90::kPanelColsF32;
  static constexpr int kKVBytes = kBK * D * 4;     // one half of K or V
  static constexpr int kTile = kBQ * D * 4;        // one half of a Q or dO tile
  static constexpr int kTrBytes = D * 128;         // a transposed half
  // Q_hi, Q_lo, dO_hi, dO_lo, Q^T_hi, Q^T_lo, dO^T_hi, dO^T_lo; TMA lands
  // Q in Q_lo, dO in dO_lo
  static constexpr int kStageBytes = 4 * kTile + 4 * kTrBytes;
  // One consumer warpgroup, a loading warp and the converters: their
  // work bounds the kernel (its products wait on them), so head_dim 64
  // takes seven warps (the kernel's 154 registers fit 384 threads' 168);
  // head_dim 128 needs ~190, more than 384 threads allow, so three.
  static constexpr int kConverters = D == 64 ? 224 : 96;
  static constexpr int kConvBatch = 6;  // items a converter loads at once
                                        // (sm90::convert_items)
  static constexpr int kThreads = 160 + kConverters;
  static constexpr size_t kSmem = 1024 + 4 * kKVBytes +
                                  kStages * (kStageBytes + 2 * kBQ * 4) +
                                  8 * (2 + 3 * kStages);
  static_assert(kSmem <= 227 * 1024, "the shared memory a block may use");
};

template <int D>
__global__ void __launch_bounds__(DkvTf32<D>::kThreads, 1)
    flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int t_q, int t_k, int causal, float scale) {
  using C = DkvTf32<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages, T = C::kTile;
  constexpr int TR = C::kTrBytes, KV = C::kKVBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* res_s = sm90::align1024(smem_raw);  // K_hi, K_lo, V_hi, V_lo
  uint8_t* stage_s = res_s + 4 * KV;           // [S] converted stages
  // rows_s[s]: BQ values of lse * log2 e, then BQ of delta
  float* rows_s = reinterpret_cast<float*>(stage_s + S * C::kStageBytes);
  uint64_t* kv_raw = reinterpret_cast<uint64_t*>(rows_s + S * 2 * BQ);
  uint64_t* kv_full = kv_raw + 1;
  uint64_t* raw_full = kv_full + 1;  // [S]
  uint64_t* conv_full = raw_full + S;
  uint64_t* conv_empty = conv_full + S;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // under causal masking block 0 is longest
  // queries before this block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < t_q ? (t_q - q_begin + BQ - 1) / BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = static_cast<size_t>(bh) * t_q;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_raw, 1);
    sm90::mbar_init(kv_full, C::kConverters);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&raw_full[s], 1);
      sm90::mbar_init(&conv_full[s], C::kConverters);
      sm90::mbar_init(&conv_empty[s], 4);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4) {  // producer warps: one loads, the others split
    if (warp == 4) {
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_raw, 2 * KV);
        sm90::tma_load_tile(res_s + KV, &map_k, kv_raw, C::kPanels, BK, k0,
                            bh, sm90::kPanelColsF32);
        sm90::tma_load_tile(res_s + 3 * KV, &map_v, kv_raw, C::kPanels, BK,
                            k0, bh, sm90::kPanelColsF32);
        for (int it = 0; it < n_qt; ++it) {
          const int s = it % S;
          const int q0 = q_begin + it * BQ;
          if (it >= S) sm90::mbar_wait(&conv_empty[s], (it / S - 1) & 1);
          uint8_t* st = stage_s + s * C::kStageBytes;
          sm90::mbar_expect_tx(&raw_full[s], 2 * T);
          sm90::tma_load_tile(st + T, &map_q, &raw_full[s], C::kPanels, BQ,
                              q0, bh, sm90::kPanelColsF32);
          sm90::tma_load_tile(st + 3 * T, &map_do, &raw_full[s], C::kPanels,
                              BQ, q0, bh, sm90::kPanelColsF32);
        }
      }
      return;
    }
    constexpr int N = C::kConverters, B = C::kConvBatch;
    const int ct = threadIdx.x - 160;
    sm90::mbar_wait(kv_raw, 0);
    sm90::split_tile<KV, N, B>(res_s + KV, res_s, res_s + KV, ct);
    sm90::split_tile<KV, N, B>(res_s + 3 * KV, res_s + 2 * KV, res_s + 3 * KV,
                               ct);
    sm90::fence_proxy_async();
    sm90::mbar_arrive(kv_full);
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % S;
      const int q0 = q_begin + it * BQ;
      uint8_t* st = stage_s + s * C::kStageBytes;
      sm90::mbar_wait(&raw_full[s], (it / S) & 1);
      sm90::split_transposed<BQ, D, N, B>(st + T, st + 4 * T,
                                          st + 4 * T + TR, ct);
      sm90::split_transposed<BQ, D, N, B>(st + 3 * T, st + 4 * T + 2 * TR,
                                          st + 4 * T + 3 * TR, ct);
      float* rows = rows_s + s * 2 * BQ;
      for (int r = ct; r < BQ; r += N) {
        const bool live = q0 + r < t_q;
        rows[r] = live ? lse[row0 + q0 + r] * sm90::kLog2e : 0.f;
        rows[BQ + r] = live ? delta[row0 + q0 + r] : 0.f;
      }
      sm90::named_sync(kConvBarrier, N);  // raw Q, dO read by all
      sm90::split_tile<T, N, B>(st + T, st, st + T, ct);
      sm90::split_tile<T, N, B>(st + 3 * T, st + 2 * T, st + 3 * T, ct);
      sm90::fence_proxy_async();  // the stores, before the consumers' wgmma
      sm90::mbar_arrive(&conv_full[s]);
    }
    return;
  }

  // consumers: one warpgroup owns keys k0 .. k0 + 63; rows = key,
  // columns = query
  const int key_a = k0 + 16 * warp + lane / 4;
  const int key_b = key_a + 8;
  const int c2 = 2 * (lane % 4);
  const float scale_log2 = scale * sm90::kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_hi = sm90::smem_u32(res_s), k_lo = k_hi + KV;
  const uint32_t v_hi = k_hi + 2 * KV, v_lo = k_hi + 3 * KV;
  sm90::mbar_wait(kv_full, 0);

  for (int it = 0; it < n_qt; ++it) {
    const int s = it % S;
    const int q0 = q_begin + it * BQ;
    const uint32_t q_hi = sm90::smem_u32(stage_s + s * C::kStageBytes);
    const uint32_t q_lo = q_hi + T, do_hi = q_hi + 2 * T, do_lo = q_hi + 3 * T;
    const uint32_t qt_hi = q_hi + 4 * T, qt_lo = qt_hi + TR;
    const uint32_t dot_hi = qt_hi + 2 * TR, dot_lo = qt_hi + 3 * TR;
    const float* rows = rows_s + s * 2 * BQ;
    sm90::mbar_wait(&conv_full[s], (it / S) & 1);

    // S^T = K.Q^T and dP^T = V.dO^T, each as hi.hi + hi.lo + lo.hi, 8
    // columns of d a step
    float st[BQ / 2], dpt[BQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ac = (kk / 4) * BK * 128 + (kk % 4) * 32;
      const uint32_t bc = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint64_t da = sm90::desc_k_major(k_hi + ac);
      const uint64_t db = sm90::desc_k_major(q_hi + bc);
      sm90::wgmma_tf32_ss(st, da, db, kk > 0);
      sm90::wgmma_tf32_ss(st, da, sm90::desc_k_major(q_lo + bc), 1);
      sm90::wgmma_tf32_ss(st, sm90::desc_k_major(k_lo + ac), db, 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ac = (kk / 4) * BK * 128 + (kk % 4) * 32;
      const uint32_t bc = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint64_t da = sm90::desc_k_major(v_hi + ac);
      const uint64_t db = sm90::desc_k_major(do_hi + bc);
      sm90::wgmma_tf32_ss(dpt, da, db, kk > 0);
      sm90::wgmma_tf32_ss(dpt, da, sm90::desc_k_major(do_lo + bc), 1);
      sm90::wgmma_tf32_ss(dpt, sm90::desc_k_major(v_lo + ac), db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // P^T and dS^T in place
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + c2 + e;
        const int qq = q0 + ql;
        const float l2 = rows[ql], dl = rows[BQ + ql];
        const bool live_q = qq < t_q;
        const bool live_a = live_q && key_a < t_k && !(causal && key_a > qq);
        const bool live_b = live_q && key_b < t_k && !(causal && key_b > qq);
        const float pa =
            live_a ? exp2f(fmaf(st[4 * j + e], scale_log2, -l2)) : 0.f;
        const float pb =
            live_b ? exp2f(fmaf(st[4 * j + 2 + e], scale_log2, -l2)) : 0.f;
        st[4 * j + e] = pa;
        st[4 * j + 2 + e] = pb;
        dpt[4 * j + e] = pa * (dpt[4 * j + e] - dl);
        dpt[4 * j + 2 + e] = pb * (dpt[4 * j + 2 + e] - dl);
      }

    // dV += P^T.dO and dK += dS^T.Q over the transposed tiles, each as
    // hi.hi + hi.lo + lo.hi, 8 queries a step
    uint32_t p_hi[BQ / 8][4], p_lo[BQ / 8][4];
    uint32_t ds_hi[BQ / 8][4], ds_lo[BQ / 8][4];
    sm90::split_frags_tf32(st, p_hi, p_lo);
    sm90::split_frags_tf32(dpt, ds_hi, ds_lo);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) {
      const uint32_t tc = kk * 32;  // one panel of 32 query slots
      const uint64_t d_do = sm90::desc_k_major(dot_hi + tc);
      const uint64_t d_q = sm90::desc_k_major(qt_hi + tc);
      sm90::wgmma_tf32_rs(dv_acc, p_hi[kk], d_do, 1);
      sm90::wgmma_tf32_rs(dv_acc, p_hi[kk], sm90::desc_k_major(dot_lo + tc), 1);
      sm90::wgmma_tf32_rs(dv_acc, p_lo[kk], d_do, 1);
      sm90::wgmma_tf32_rs(dk_acc, ds_hi[kk], d_q, 1);
      sm90::wgmma_tf32_rs(dk_acc, ds_hi[kk], sm90::desc_k_major(qt_lo + tc), 1);
      sm90::wgmma_tf32_rs(dk_acc, ds_lo[kk], d_q, 1);
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
    if (lane == 0) sm90::mbar_arrive(&conv_empty[s]);  // this warp is done
  }

  const size_t key0 = static_cast<size_t>(bh) * t_k;
  if (key_a < t_k) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (key0 + key_a) * D + 8 * j + c2;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
  }
  if (key_b < t_k) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (key0 + key_b) * D + 8 * j + c2;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int t_q, int t_k, int causal, float scale,
                            cudaStream_t stream) {
  using C = DkvTf32<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t e = sm90::make_tile_map(&map_q, q, bh, t_q, D, C::kBQ, 4);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_do, dout, bh, t_q, D, C::kBQ, 4);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_k, k, bh, t_k, D, C::kBK, 4);
  if (e == cudaSuccess)
    e = sm90::make_tile_map(&map_v, v, bh, t_k, D, C::kBK, 4);
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[kMaxDevices];
  auto kernel = flash_bwd_dkv_tf32_kernel<D>;
  e = allow_smem(kernel, C::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid(bh, (t_k + C::kBK - 1) / C::kBK);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace flash_train

// dtype: 0 float32 (the three-product TF32 kernels), 1 bfloat16; all on
// the tensor cores.  q/dout [bh, t_q, head_dim], k/v [bh, t_k, head_dim],
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
      return flash_train::launch_dq_tf32<D>(q, k, v, dout, lse, delta, dq,
                                            bh, t_q, t_k, causal, scale, s);
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
      return flash_train::launch_dkv_tf32<D>(q, k, v, dout, lse, delta, dk,
                                             dv, bh, t_q, t_k, causal, scale,
                                             s);
  });
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
