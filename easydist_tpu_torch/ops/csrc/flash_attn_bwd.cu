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
// bfloat16, lse/delta f32 [bh, t_q], causal or full, any t_q and t_k
// (ragged tiles are masked here).  On the kernels below: B2 and B3 at
// every head_dim up to 256 in both dtypes, templated on a padded width DP
// as B1 is (flash_attn_fwd.cu, "Head dims": TMA maps or the producer's
// own copies fill the tiles, S, dP (S^T, dP^T) over every k16 / k8 step
// of the width, dQ += dS.K, dV += P^T.dO and dK += dS^T.Q with N = DP,
// the epilogue and the f32 flush at stride d; in f32 the transposed K^T,
// Q^T and dO^T tiles hold DP rows; in bf16 at 256 B2 takes 32-key tiles,
// and one warpgroup's dK and dV would take 256 registers a thread, so
// B3's two warpgroups share the block's 64 keys, both compute S^T and
// dP^T, and each accumulates half of the columns; B2 and B3 f32 at 256
// are blocks of their own shape, `dq_tf32_wide` and `dkv_tf32_wide`).
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
// A operand and K read MN-major through the transpose bit, as B1 reads V
// (N = DP: at 80 across 1.25 panels).  dS is split for B3's reason: one
// bf16 cast misses the f32 bar.  A warpgroup whose rows all lie above a
// tile's keys (the block's last tile under causal masking, for the first
// warpgroup) or past t_q only releases the stage.  `scale` enters dQ
// once, when it is written.  Four products where the function has three;
// S, dP, dQ and dS's halves fit the 232 registers (`ptxas -v`: no
// spills).  At 256 the key tiles are 32 wide: 193 KB of shared memory,
// dQ in 128 registers a thread beside S and dP's 16 each.
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
//   B2 up to DP 128: a block owns 128 queries (two consumer warpgroups)
//   at DP 64, 64 above (one: a stage's tiles and 128 queries' halves pass
//   227 KB there).  The K/V tiles (32 keys) stream through the converted stages
//   as K_hi, K_lo, V_hi, V_lo and K^T_hi, K^T_lo (DP rows); S = Q.K^T
//   and dP = dO.V^T take K and V as they are, dQ += dS.K takes K^T.  Q's
//   halves are register A fragments up to DP 96 (m64n32k8 products, which
//   stay exact across key tiles where m64n64k8 ones of resident fragments
//   drifted in the f32 forward; a one-warpgroup block keeps 255 registers
//   a thread), in shared memory at 128; dO's halves are in shared memory,
//   split by the consumers themselves.  Nine products where the function
//   has three.  Stages: three (209 KB) at DP 64, two at 80 and 96 (185 /
//   193 KB), one (225 KB) at 128.
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
//   B3 f32 moves its dK / dV accumulators to device memory every 1024
//   queries (added there on the CUDA cores) and restarts them at 0: a
//   tensor-core f32 accumulator that sums the products of 32768 queries
//   drifts toward zero (sum((kernel - plain) sign(plain)) / sum |plain|
//   -2.4e-4 on dK, 1.9x the f32 bar on its worst element; -8.2e-6 with
//   the flush, chip_smoke.py's long-context run).  A block of at most
//   1024 queries never flushes.  B1 and B2 f32 drift alike (-2.0e-4 on
//   out and dQ at 32768 keys) and stay inside the bar there.
//   B3 f32 at 256 (`dkv_tf32_wide`): no producer and no transposed
//   copies.  K and V stay raw in A-fragment order and are split in
//   registers a k8 step at a time; two consumer warpgroups compute S^T
//   and dP^T one each and trade P^T through shared memory, then dV^T and
//   dK^T accumulate with the head_dim as the M side (A fragments read
//   from the natural Q / dO halves, B the P^T / dS^T tiles), 128 d rows a
//   warpgroup; 16-query tiles, one stage (213 KB).
//   B2 f32 at 256 (`dq_tf32_wide`): the same shape with queries and keys
//   trading places: Q and dO raw in A-fragment order, S and dP one a
//   warpgroup over 16-key tiles of stacked K / V halves, dQ^T with the
//   head_dim as the M side (A fragments read from the K halves, B the dS
//   tile), flushed every 1024 keys; one stage (205 KB).
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

template <int DP>
struct DkvSm90 {
  // Above 128 columns one warpgroup's dK and dV for 64 keys would take
  // DP registers a thread: the two warpgroups then share the block's 64
  // keys (both compute S^T and dP^T) and each accumulates its half of the
  // columns (kCols)
  static constexpr bool kSplit = DP > 128;
  static constexpr int kCols = kSplit ? DP / 2 : DP;  // dK / dV columns
  static constexpr int kBK = kSplit ? 64 : 128;  // keys a block
  static constexpr int kBQ = DP == 64 ? 64 : DP <= 128 ? 32 : 16;  // queries
  static constexpr int kStages = 2;
  static constexpr int kPanels = (DP + sm90::kPanelCols - 1) / sm90::kPanelCols;
  static constexpr int kKVBytes = kBK * kPanels * sm90::kRowBytes;  // K or V
  static constexpr int kQBytes = kBQ * kPanels * sm90::kRowBytes;   // Q or dO
  static constexpr int kLseBytes = 2 * kBQ * 4;  // a tile's lse and delta
  static constexpr int kThreads = 384;  // + a producer warpgroup
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes +
                                  kStages * (2 * kQBytes + kLseBytes) +
                                  8 * (1 + 2 * kStages);
};

template <int DP, bool kFill>
__global__ void __launch_bounds__(DkvSm90<DP>::kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const sm90::Fill fill,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int t_q,
                              int t_k, int d, int causal, float scale) {
  using C = DkvSm90<DP>;
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
    const uint32_t loads = kFill ? 128 : 1;  // arrivals a full phase
    sm90::mbar_init(kv_full, loads);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], loads);
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one warp loads, three idle
    sm90::regs_release<sm90::kProducerRegs>();
    if constexpr (kFill) {  // rows no map takes: the four warps fill
      const int rb = d * 2, tid = threadIdx.x - 256;
      const size_t q_slab = static_cast<size_t>(bh) * t_q * rb;
      const size_t kv_slab = static_cast<size_t>(bh) * t_k * rb;
      sm90::by_copy_width(fill.width, [&](auto w) {
        constexpr int W = decltype(w)::value;
        sm90::fill_tile<W, BK, C::kPanels>(sm90::smem_u32(k_s),
                                           fill.src[1] + kv_slab, k0, t_k, rb,
                                           tid, 128);
        sm90::fill_tile<W, BK, C::kPanels>(sm90::smem_u32(v_s),
                                           fill.src[2] + kv_slab, k0, t_k, rb,
                                           tid, 128);
        sm90::fill_commit();
        sm90::mbar_arrive(kv_full);
        for (int it = 0; it < n_qt; ++it) {
          const int s = it % S;
          const int q0 = q_begin + it * BQ;
          if (it >= S) sm90::mbar_wait(&empty[s], (it / S - 1) & 1);
          for (int r = tid; r < BQ; r += 128) {
            const bool live = q0 + r < t_q;
            rows_s[s * 2 * BQ + r] =
                live ? lse[row0 + q0 + r] * sm90::kLog2e : 0.f;
            rows_s[s * 2 * BQ + BQ + r] = live ? delta[row0 + q0 + r] : 0.f;
          }
          const uint32_t at = sm90::smem_u32(q_s) + s * C::kQBytes;
          sm90::fill_tile<W, BQ, C::kPanels>(at, fill.src[0] + q_slab, q0,
                                             t_q, rb, tid, 128);
          sm90::fill_tile<W, BQ, C::kPanels>(at + S * C::kQBytes,
                                             fill.src[3] + q_slab, q0, t_q,
                                             rb, tid, 128);
          sm90::fill_commit();
          sm90::mbar_arrive(&full[s]);
        }
      });
      return;
    }
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
  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 64 (with kSplit,
  // keys k0 .. + 64 and columns kCols wg .. + kCols)
  const int wg = warp / 4;
  const int key_wg = C::kSplit ? 0 : 64 * wg;
  const int col0 = C::kSplit ? C::kCols * wg : 0;
  const int key_a = k0 + key_wg + 16 * (warp % 4) + lane / 4;
  const int key_b = key_a + 8;
  const int c2 = 2 * (lane % 4);
  // every k16 step of S^T and dP^T at the width (as B1's S)
  constexpr int kSteps = (DP + 15) / 16;
  const float scale_log2 = scale * sm90::kLog2e;
  float dk_acc[C::kCols / 2], dv_acc[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const uint32_t k_addr = sm90::smem_u32(k_s) + key_wg * sm90::kRowBytes;
  const uint32_t v_addr = sm90::smem_u32(v_s) + key_wg * sm90::kRowBytes;
  // the first panel of this warpgroup's columns in a Q or dO tile
  const uint32_t col_panel = (col0 / sm90::kPanelCols) * BQ * 128;
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
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // bytes into the panel's rows
      sm90::wgmma_ss<0>(
          st, sm90::desc_k_major(k_addr + (kk / 4) * BK * 128 + col),
          sm90::desc_k_major(q_addr + (kk / 4) * BQ * 128 + col), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      sm90::wgmma_ss<0>(
          dpt, sm90::desc_k_major(v_addr + (kk / 4) * BK * 128 + col),
          sm90::desc_k_major(do_addr + (kk / 4) * BQ * 128 + col),
          kk > 0);
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
          sm90::desc_mn_major(do_addr + col_panel + kk * 16 * 128, BQ * 128);
      const uint64_t d_q =
          sm90::desc_mn_major(q_addr + col_panel + kk * 16 * 128, BQ * 128);
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

  // columns at or past d are the padding of Q and dO: not stored
  const size_t key0 = static_cast<size_t>(bh) * t_k;
  if (key_a < t_k) {
#pragma unroll
    for (int j = 0; j < C::kCols / 8; ++j) {
      const size_t at = (key0 + key_a) * d;
      const int col = col0 + 8 * j + c2;
      sm90::store_pair<!kFill>(dk + at, col, d, dk_acc[4 * j] * scale,
                               dk_acc[4 * j + 1] * scale);
      sm90::store_pair<!kFill>(dv + at, col, d, dv_acc[4 * j],
                               dv_acc[4 * j + 1]);
    }
  }
  if (key_b < t_k) {
#pragma unroll
    for (int j = 0; j < C::kCols / 8; ++j) {
      const size_t at = (key0 + key_b) * d;
      const int col = col0 + 8 * j + c2;
      sm90::store_pair<!kFill>(dk + at, col, d, dk_acc[4 * j + 2] * scale,
                               dk_acc[4 * j + 3] * scale);
      sm90::store_pair<!kFill>(dv + at, col, d, dv_acc[4 * j + 2],
                               dv_acc[4 * j + 3]);
    }
  }
}

template <int DP>
cudaError_t launch_dkv_sm90(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int t_q, int t_k, int d, int causal, float scale,
                            cudaStream_t stream) {
  using C = DkvSm90<DP>;
  CUtensorMap map_q{}, map_k{}, map_v{}, map_do{};
  sm90::Fill fill = sm90::fill_of(q, k, v, dout, d * 2);
  cudaError_t e = cudaSuccess;
  if (!fill.width) {
    e = sm90::make_tile_map(&map_q, q, bh, t_q, d, C::kBQ);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_do, dout, bh, t_q, d, C::kBQ);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_k, k, bh, t_k, d, C::kBK);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_v, v, bh, t_k, d, C::kBK);
  }
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[2][kMaxDevices];
  const dim3 grid(bh, (t_k + C::kBK - 1) / C::kBK);
  auto go = [&](auto kernel, std::atomic<size_t>(&up)[kMaxDevices]) {
    cudaError_t err = allow_smem(kernel, C::kSmem, up);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
        map_q, map_k, map_v, map_do, fill, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), t_q, t_k, d, causal, scale);
    return cudaGetLastError();
  };
  return fill.width ? go(flash_bwd_dkv_sm90_kernel<DP, true>, raised[1])
                    : go(flash_bwd_dkv_sm90_kernel<DP, false>, raised[0]);
}

// ------------------------------------ B2, bfloat16: tensor cores (sm90)

template <int DP>
struct DqSm90 {
  static constexpr int kBQ = 128;  // two warpgroups of 64 queries
  // keys a tile: at 256, 32 keeps two stages of K and V beside Q and dO
  // within 227 KB and S, dP and dS's halves small beside dQ's 128
  // registers (`scripts/kernel_ab.py` timed it 23% faster than the two
  // warpgroups sharing 64 queries and splitting dQ's columns)
  static constexpr int kBK = DP == 256 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int kPanels = (DP + sm90::kPanelCols - 1) / sm90::kPanelCols;
  static constexpr int kQBytes = kBQ * kPanels * sm90::kRowBytes;   // Q or dO
  static constexpr int kKVBytes = kBK * kPanels * sm90::kRowBytes;  // K or V
  static constexpr int kThreads = 384;  // + a producer warpgroup
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 227 * 1024, "the shared memory a block may use");
};

template <int DP, bool kFill>
__global__ void __launch_bounds__(DqSm90<DP>::kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const sm90::Fill fill,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int t_q,
                             int t_k, int d, int causal, float scale) {
  using C = DqSm90<DP>;
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
    const uint32_t loads = kFill ? 128 : 1;  // arrivals a full phase
    sm90::mbar_init(q_full, loads);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], loads);
      sm90::mbar_init(&kv_empty[s], 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one warp loads, three idle
    sm90::regs_release<sm90::kProducerRegs>();
    if constexpr (kFill) {  // rows no map takes: the four warps fill
      const int rb = d * 2, tid = threadIdx.x - 256;
      const size_t q_slab = static_cast<size_t>(bh) * t_q * rb;
      const size_t kv_slab = static_cast<size_t>(bh) * t_k * rb;
      sm90::by_copy_width(fill.width, [&](auto w) {
        constexpr int W = decltype(w)::value;
        sm90::fill_tile<W, BQ, C::kPanels>(sm90::smem_u32(q_s),
                                           fill.src[0] + q_slab, q0, t_q, rb,
                                           tid, 128);
        sm90::fill_tile<W, BQ, C::kPanels>(sm90::smem_u32(do_s),
                                           fill.src[3] + q_slab, q0, t_q, rb,
                                           tid, 128);
        sm90::fill_commit();
        sm90::mbar_arrive(q_full);
        for (int it = 0; it < n_kt; ++it) {
          const int s = it % S;
          if (it >= S) sm90::mbar_wait(&kv_empty[s], (it / S - 1) & 1);
          const uint32_t at = sm90::smem_u32(k_s) + s * C::kKVBytes;
          sm90::fill_tile<W, BK, C::kPanels>(at, fill.src[1] + kv_slab,
                                             it * BK, t_k, rb, tid, 128);
          sm90::fill_tile<W, BK, C::kPanels>(at + S * C::kKVBytes,
                                             fill.src[2] + kv_slab, it * BK,
                                             t_k, rb, tid, 128);
          sm90::fill_commit();
          sm90::mbar_arrive(&kv_full[s]);
        }
      });
      return;
    }
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
  // every k16 step of S and dP at the width, zeros past d included (a
  // test of d between the `wgmma`s makes ptxas serialize them all)
  constexpr int kSteps = (DP + 15) / 16;
  const float scale_log2 = scale * sm90::kLog2e;
  // this thread's two rows: lse in log2 units and delta (0 past t_q,
  // where the rows are masked and never stored)
  const size_t row0 = static_cast<size_t>(bh) * t_q;
  const bool live_a = row_a < t_q, live_b = row_b < t_q;
  const float l2_a = live_a ? lse[row0 + row_a] * sm90::kLog2e : 0.f;
  const float l2_b = live_b ? lse[row0 + row_b] * sm90::kLog2e : 0.f;
  const float dl_a = live_a ? delta[row0 + row_a] : 0.f;
  const float dl_b = live_b ? delta[row0 + row_b] : 0.f;
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

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
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the panel's rows
        sm90::wgmma_ss<0>(
            sc, sm90::desc_k_major(q_addr + (kk / 4) * BQ * 128 + col),
            sm90::desc_k_major(k_addr + (kk / 4) * BK * 128 + col), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
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

      // dQ += dS_hi.K + dS_lo.K with N = DP: K read MN-major through the
      // transpose bit across ceil(DP / 64) panels (B1 reads V so)
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

  // columns at or past d are K's padding: not stored
  if (live_a) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      sm90::store_pair<!kFill>(dq + (row0 + row_a) * d, 8 * j + c2, d,
                               dq_acc[4 * j] * scale,
                               dq_acc[4 * j + 1] * scale);
  }
  if (live_b) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      sm90::store_pair<!kFill>(dq + (row0 + row_b) * d, 8 * j + c2, d,
                               dq_acc[4 * j + 2] * scale,
                               dq_acc[4 * j + 3] * scale);
  }
}

template <int DP>
cudaError_t launch_dq_sm90(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int t_q,
                           int t_k, int d, int causal, float scale,
                           cudaStream_t stream) {
  using C = DqSm90<DP>;
  CUtensorMap map_q{}, map_k{}, map_v{}, map_do{};
  sm90::Fill fill = sm90::fill_of(q, k, v, dout, d * 2);
  cudaError_t e = cudaSuccess;
  if (!fill.width) {
    e = sm90::make_tile_map(&map_q, q, bh, t_q, d, C::kBQ);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_do, dout, bh, t_q, d, C::kBQ);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_k, k, bh, t_k, d, C::kBK);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_v, v, bh, t_k, d, C::kBK);
  }
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[2][kMaxDevices];
  const dim3 grid(bh, (t_q + C::kBQ - 1) / C::kBQ);
  auto go = [&](auto kernel, std::atomic<size_t>(&up)[kMaxDevices]) {
    cudaError_t err = allow_smem(kernel, C::kSmem, up);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
        map_q, map_k, map_v, map_do, fill, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
        t_q, t_k, d, causal, scale);
    return cudaGetLastError();
  };
  return fill.width ? go(flash_bwd_dq_sm90_kernel<DP, true>, raised[1])
                    : go(flash_bwd_dq_sm90_kernel<DP, false>, raised[0]);
}

// ------------------------ float32: tensor cores, three TF32 products

constexpr int kConvBarrier = 3;  // converters' named barrier (consumers 1, 2)

// B2, float32
template <int DP>
struct DqTf32 {
  // DP 256: `dq_tf32_wide` (its own layout, below)
  static constexpr bool kWide = DP > 128;
  // consumer warpgroups: two (128 queries) at 64; one (64 queries) above,
  // where a stage's tiles and the halves of 128 queries' dO (and Q) pass
  // the shared memory a block may use (at 256 two, sharing 64 queries)
  static constexpr int kWG = DP == 64 || kWide ? 2 : 1;
  static constexpr int kBQ = kWide ? 64 : 64 * kWG;   // queries a block
  static constexpr int kBK = kWide ? 16 : 32;         // keys a tile
  // Q's halves as A fragments up to 96 (DP registers a thread: one
  // consumer warpgroup keeps the 255 of a 256-thread block; 1.5x faster
  // at 80 and 96 than both halves in shared memory with one stage,
  // `scripts/kernel_ab.py`), in shared memory at 128
  static constexpr bool kQRegs = DP < 128;
  static constexpr int kPanels =
      (DP + sm90::kPanelColsF32 - 1) / sm90::kPanelColsF32;
  static constexpr int kRowPad = kPanels * sm90::kPanelColsF32;  // f32 a row
  static constexpr int kTile = kBK * kPanels * sm90::kRowBytes;  // K or V
  static constexpr int kTrBytes = DP * sm90::kRowBytes;  // K^T_hi or K^T_lo
  // K_hi, K_lo, V_hi, V_lo, K^T_hi, K^T_lo; TMA lands K in K_lo, V in V_lo
  static constexpr int kStageBytes = 4 * kTile + 2 * kTrBytes;
  static constexpr int kHalfBytes = kBQ * kPanels * sm90::kRowBytes;  // dO_hi
  static constexpr int kResBytes = (kQRegs ? 2 : 4) * kHalfBytes;
  static constexpr int kStages = DP == 64 ? 3 : DP < 128 ? 2 : 1;
  static constexpr int kConverters = 96;              // producer warps 1-3
  static constexpr int kThreads = kWide ? 256 : 128 * (1 + kWG);
  // registers a thread after `setmaxnreg` (two consumer warpgroups only)
  static constexpr int kProducerRegs = 56, kConsumerRegs = 224;
  static_assert(kWG == 1 || kWide ||
                    128 * (kProducerRegs + kWG * kConsumerRegs) <= 65536,
                "the SM's register file");
  // DP 256: key tiles between two flushes of dQ (1024 keys)
  static constexpr int kFlushTiles = 1024 / kBK;
  // DP 256: Q and dO raw in fragment order, K and V as stacked halves,
  // the dS tile (64 queries x 32 slots: hi, then lo) and the P hand-over
  // (8 values a thread of the first warpgroup); no barriers in shared
  // memory
  static constexpr size_t kWideSmem =
      1024 + 2 * kHalfBytes + 4 * kTile + kBQ * 128 + 128 * (kBK / 2) * 4;
  static constexpr size_t kSmem =
      kWide ? kWideSmem
            : 1024 + kResBytes + kStages * kStageBytes + 24 * kStages;
  static_assert(kSmem <= 227 * 1024, "the shared memory a block may use");
};

template <int DP, bool kFill>
__device__ __forceinline__ void dq_tf32_body(
    const CUtensorMap& map_k, const CUtensorMap& map_v,
    const sm90::Fill fill, const float* __restrict__ q,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int t_q,
    int t_k, int d, int causal, float scale) {
  using C = DqTf32<DP>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kStages, T = C::kTile;
  constexpr int TR = C::kTrBytes, H = C::kHalfBytes;
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
      sm90::mbar_init(&raw_full[s], kFill ? 32 : 1);
      sm90::mbar_init(&conv_full[s], C::kConverters);
      sm90::mbar_init(&conv_empty[s], 4 * C::kWG);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * C::kWG) {  // producer warpgroup: one warp loads, three split
    if constexpr (C::kWG > 1) sm90::regs_release<C::kProducerRegs>();
    if (warp == 4 * C::kWG) {
      if constexpr (kFill) {  // rows no map takes: the warp fills them
        const int rb = d * 4;
        const size_t kv_slab = static_cast<size_t>(bh) * t_k * rb;
        sm90::by_copy_width(fill.width, [&](auto w) {
          constexpr int W = decltype(w)::value;
          for (int it = 0; it < n_kt; ++it) {
            const int s = it % S;
            if (it >= S) sm90::mbar_wait(&conv_empty[s], (it / S - 1) & 1);
            const uint32_t at = sm90::smem_u32(stage_s) + s * C::kStageBytes;
            sm90::fill_tile<W, BK, C::kPanels>(at + T, fill.src[1] + kv_slab,
                                               it * BK, t_k, rb, lane, 32);
            sm90::fill_tile<W, BK, C::kPanels>(at + 3 * T,
                                               fill.src[2] + kv_slab, it * BK,
                                               t_k, rb, lane, 32);
            sm90::fill_commit();
            sm90::mbar_arrive(&raw_full[s]);
          }
        });
      } else if (lane == 0) {  // TMA
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
      sm90::split_transposed<BK, DP, C::kConverters>(st + T, st + 4 * T,
                                                     st + 4 * T + TR, ct);
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
  const float* qb = q + row0 * d;
  const float* dob = dout + row0 * d;

  // Q's halves as A fragments (columns 8 kk + c and + 4 of rows a and
  // b); dO's halves, and at 128 Q's, as this warpgroup's 64 rows in
  // shared memory, swizzled K-major; columns past d as zeros (a k8 step
  // may straddle d)
  uint32_t q_hi[C::kQRegs ? DP / 8 : 1][4], q_lo[C::kQRegs ? DP / 8 : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i % 2 ? row_b : row_a;
        const int col = 8 * kk + c + 4 * (i / 2);
        const float x = row < t_q && col < d
                            ? qb[static_cast<size_t>(row) * d + col]
                            : 0.f;
        sm90::split_tf32(x, q_hi[kk][i], q_lo[kk][i]);
      }
  }
  // the float4 at `src` (16-byte rows: the launch checks the bases), or
  // element by element where no map takes the rows (kFill), zeros past d
  auto load4 = [&](const float* src, int col) {
    float4 x;
    if (!kFill) {
      x = *reinterpret_cast<const float4*>(src);
    } else {
      x = make_float4(src[0], 0.f, 0.f, 0.f);
      if (col + 1 < d) x.y = src[1];
      if (col + 2 < d) x.z = src[2];
      if (col + 3 < d) x.w = src[3];
    }
    return x;
  };
  constexpr int kVecs = C::kRowPad / 4;  // float4s a padded row
  for (int i = threadIdx.x % 128; i < 64 * kVecs; i += 128) {
    const int r = 64 * wg + i / kVecs, col = 4 * (i % kVecs);
    const bool live = q0 + r < t_q && col < d;
    const size_t at = static_cast<size_t>(q0 + r) * d + col;
    const int off = (col / 32) * BQ * 128 + r * 128 +
                    ((((col % 32) / 4) ^ (r % 8)) * 16);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 hi, lo;
    sm90::split_tf32(live ? load4(dob + at, col) : zero, hi, lo);
    *reinterpret_cast<uint4*>(res_s + off) = hi;
    *reinterpret_cast<uint4*>(res_s + H + off) = lo;
    if constexpr (!C::kQRegs) {
      sm90::split_tf32(live ? load4(qb + at, col) : zero, hi, lo);
      *reinterpret_cast<uint4*>(res_s + 2 * H + off) = hi;
      *reinterpret_cast<uint4*>(res_s + 3 * H + off) = lo;
    }
  }
  sm90::fence_proxy_async();
  sm90::named_sync(1 + wg, 128);

  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t do_addr = sm90::smem_u32(res_s) + 64 * wg * sm90::kRowBytes;
  const uint32_t q_addr = do_addr + 2 * H;

  for (int it = 0; it < n_kt; ++it) {
    const int s = it % S;
    const int k0 = it * BK;
    const uint32_t k_hi = sm90::smem_u32(stage_s + s * C::kStageBytes);
    const uint32_t k_lo = k_hi + T, v_hi = k_hi + 2 * T, v_lo = k_hi + 3 * T;
    const uint32_t kt_hi = k_hi + 4 * T, kt_lo = kt_hi + TR;
    sm90::mbar_wait(&conv_full[s], (it / S) & 1);

    // a tile wholly above this warpgroup's rows, or rows all past t_q,
    // contributes nothing
    if (wg_row0 < t_q && !(causal && k0 > wg_row0 + 63)) {
      // S = Q.K^T and dP = dO.V^T, each as hi.hi + hi.lo + lo.hi, 8
      // columns of the width a step (zeros past d included)
      float sc[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
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
      for (int kk = 0; kk < DP / 8; ++kk) {
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

      // dQ += dS_hi.K^T_hi + dS_hi.K^T_lo + dS_lo.K^T_hi with N = DP, 8
      // keys a step
      uint32_t ds_hi[BK / 8][4], ds_lo[BK / 8][4];
      sm90::split_frags_tf32(dp, ds_hi, ds_lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t tc = (kk / 4) * DP * 128 + (kk % 4) * 32;
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

  // columns at or past d are K's padding: not stored
  if (live_a) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      sm90::store_pair<!kFill>(dq + (row0 + row_a) * d, 8 * j + c2, d,
                               dq_acc[4 * j] * scale,
                               dq_acc[4 * j + 1] * scale);
  }
  if (live_b) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      sm90::store_pair<!kFill>(dq + (row0 + row_b) * d, 8 * j + c2, d,
                               dq_acc[4 * j + 2] * scale,
                               dq_acc[4 * j + 3] * scale);
  }
}

// B2, float32 at DP 256 (head_dims 129-256).  Q's and dO's TF32 halves
// for 64 queries would take 256 KB and one warpgroup's dQ 128 registers
// a thread, so the block takes the shape of B3 at this width
// (`dkv_tf32_wide`) with queries and keys trading places.  Two consumer
// warpgroups (256 threads, no producer) share the block's 64 queries:
//   * Q and dO stay raw (64 KB each) in A-fragment order, so a thread
//     reads its fragment of a k8 step with one 16-byte load and splits it
//     into hi / lo in registers just before its products;
//   * per 16-key tile, warpgroup 0 computes S = Q.K^T and warpgroup 1
//     dP = dO.V^T, each as A_hi.[B_hi; B_lo] (one m64n32k8: the tile
//     stacks each panel's lo rows under its hi rows) + A_lo.B_hi (an
//     m64n16k8), the small terms in accumulators of their own, two k8
//     steps a commit group, one group's fragments in flight while the
//     next one's are split (one step a group timed 4% slower, four
//     spilled);
//   * warpgroup 0 makes P and hands it over in shared memory, warpgroup 1
//     makes dS = P (dP - delta) and writes its hi / lo halves as a K-major
//     B operand (64 queries x 32 slots);
//   * dQ accumulates transposed, the head_dim as the M side: dQ^T +=
//     K^T.dS^T as three products (m64n64k8), A fragments read from the
//     stacked K halves element by element (no transposed copy of K
//     exists), B the dS tile; warpgroup w owns d rows 128 w .. 128 w +
//     127: dQ^T takes 64 registers a thread;
//   * the next tile's K and V rows load into registers while this
//     tile's dQ^T products run (`kPrefetch`; 6% faster than loading
//     after them; held across the S / dP products as well they spilled
//     with two steps a group), and are split into the stage once every
//     warpgroup is done with it.
// dQ^T moves to dQ in device memory every 1024 keys (added there on the
// CUDA cores) and restarts at 0, as B3 f32 flushes dK / dV; a block of
// at most 1024 keys never flushes.  The store is transposed back at
// stride d.  Bound: at [2,16,2048,256] causal the function's three
// products at the TF32 rate, 0.208 ms; this runs 2.97 ms on an H100
// (0.50x SDPA's whole backward; `PERF.md` §6): the warpgroups meet at a
// barrier four times a 16-key tile, and the S / dP products are
// m64n32k8 / m64n16k8.
template <int DP, bool kFill>
__device__ __forceinline__ void dq_tf32_wide(
    const sm90::Fill fill, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int t_q,
    int t_k, int d, int causal, float scale) {
  using C = DqTf32<DP>;
  constexpr int BQ = C::kBQ, BK = C::kBK, QD = C::kHalfBytes, T = C::kTile;
  constexpr int kSteps = DP / 8;  // k8 steps of S and dP
  constexpr int kMT = DP / 128;   // 64-row d tiles a warpgroup
  constexpr int kVecs = DP / 4;   // float4s a padded row
  constexpr int kItems = 2 * BK * kVecs / 256;  // a thread's K / V float4s
  constexpr int G = 2;  // k8 steps of S or dP a commit group
  // the next tile's K / V rows load into registers while this tile's dQ
  // products run; the copy variant's element loads spill when held so
  constexpr bool kPrefetch = !kFill;
  static_assert(kItems * 256 == 2 * BK * kVecs && BQ == 64 && BK == 16 &&
                    C::kThreads == 256 && kSteps % G == 0,
                "the tile shapes below");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qd_s = sm90::align1024(smem_raw);  // Q, dO in fragment order
  uint8_t* kv_s = qd_s + 2 * QD;              // K, V stacked halves
  uint8_t* ds_s = kv_s + 4 * T;               // the dS tile
  float* xch = reinterpret_cast<float*>(ds_s + BQ * 128);  // P

  const float* q = reinterpret_cast<const float*>(fill.src[0]);
  const float* k = reinterpret_cast<const float*>(fill.src[1]);
  const float* v = reinterpret_cast<const float*>(fill.src[2]);
  const float* dout = reinterpret_cast<const float*>(fill.src[3]);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int q_end = min(q0 + BQ, t_q);
  const int k_end = causal ? min(t_k, q_end) : t_k;
  const int n_kt = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, c = lane % 4, c2 = 2 * c;
  const size_t row0 = static_cast<size_t>(bh) * t_q;
  const size_t key0 = static_cast<size_t>(bh) * t_k;
  auto elem = [&](const float* src, int row, int rows, int col) {
    return row < rows && col < d ? src[static_cast<size_t>(row) * d + col]
                                 : 0.f;
  };

  // Q and dO: item (kk, t) is thread t's A fragment of k8 step kk,
  // queries a and a + 8 (a = 16 (t / 32) + (t % 32) / 4) at columns
  // 8 kk + t % 4 and + 4, as {a0, a1, a2, a3} (eight items' loads in
  // flight at once)
#pragma unroll 8
  for (int i = threadIdx.x; i < 2 * kSteps * 128; i += 256) {
    const int which = i / (kSteps * 128), kk = (i / 128) % kSteps;
    const int t = i % 128;
    const float* src = (which ? dout : q) + row0 * d;
    const int qa = q0 + 16 * (t / 32) + (t % 32) / 4, col = 8 * kk + t % 4;
    reinterpret_cast<float4*>(qd_s + which * QD)[kk * 128 + t] =
        make_float4(elem(src, qa, t_q, col), elem(src, qa + 8, t_q, col),
                    elem(src, qa, t_q, col + 4),
                    elem(src, qa + 8, t_q, col + 4));
  }
  // this thread's rows of S or dP (queries ra, ra + 8): lse in log2 units
  // (warpgroup 0) or delta (1); 0 past t_q, where P is 0
  const int ra = 16 * warp + lane / 4;
  const int row_a = q0 + ra, row_b = row_a + 8;
  const float* rows = wg ? delta : lse;
  const float mul = wg ? 1.f : sm90::kLog2e;
  const float r_a = row_a < t_q ? rows[row0 + row_a] * mul : 0.f;
  const float r_b = row_b < t_q ? rows[row0 + row_b] * mul : 0.f;

  // a K / V tile: loaded into registers, then split into the stage (K's
  // panel p holds K_hi's 16 rows then K_lo's, then V's the same)
  const float* kb = k + key0 * d;
  const float* vb = v + key0 * d;
  float4 pre[kItems];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = threadIdx.x + 256 * j, which = i / (BK * kVecs);
      const int w = i % (BK * kVecs), row = k0 + w / kVecs;
      const int col = 4 * (w % kVecs);
      const float* src = which ? vb : kb;
      if (!kFill && row < t_k && col < d) {
        pre[j] = *reinterpret_cast<const float4*>(
            src + static_cast<size_t>(row) * d + col);
      } else {
        pre[j] = make_float4(elem(src, row, t_k, col),
                             elem(src, row, t_k, col + 1),
                             elem(src, row, t_k, col + 2),
                             elem(src, row, t_k, col + 3));
      }
    }
  };
  auto store_tile = [&]() {
    uint8_t* kv = kv_s + sm90::pinned(0);  // addresses made here
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = threadIdx.x + 256 * j, which = i / (BK * kVecs);
      const int w = i % (BK * kVecs), r = w / kVecs, col = 4 * (w % kVecs);
      const int off = which * 2 * T + (col / 32) * 2 * BK * 128 + r * 128 +
                      ((((col % 32) / 4) ^ (r % 8)) * 16);
      uint4 hi, lo;
      sm90::split_tf32(pre[j], hi, lo);
      *reinterpret_cast<uint4*>(kv + off) = hi;
      *reinterpret_cast<uint4*>(kv + off + BK * 128) = lo;
    }
    sm90::fence_proxy_async();  // the stores, before the wgmma reads
  };
  // dS's hi / lo halves at (query, slots 8 j + c2, + 1) of the dS tile
  // (row = local query, 128 bytes: slots 0-15 hi, 16-31 lo; swizzled)
  auto write_ds = [&](const float (&x)[BK / 2]) {
    uint8_t* tile = ds_s + sm90::pinned(0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ra + 8 * h, slot = 8 * j + c2;
        uint32_t h0, l0, h1, l1;
        sm90::split_tf32(x[4 * j + 2 * h], h0, l0);
        sm90::split_tf32(x[4 * j + 2 * h + 1], h1, l1);
        const int at = row * 128 + (slot % 4) * 4;
        *reinterpret_cast<uint2*>(tile + at +
                                  (((slot / 4) ^ (row % 8)) * 16)) =
            make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(tile + at +
                                  ((((slot + 16) / 4) ^ (row % 8)) * 16)) =
            make_uint2(l0, l1);
      }
  };

  float dqt[kMT][32];  // dQ^T: d rows x 64 queries
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqt[m][i] = 0.f;
  // f(index into dQ, dQ^T element) for each element this thread holds
  // inside [t_q, d)
  auto visit = [&](auto f) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 128 * wg + 64 * m + ra + 8 * h;
            const int qq = q0 + 8 * j + c2 + e;
            if (col < d && qq < t_q)
              f((row0 + qq) * d + col, dqt[m][4 * j + 2 * h + e]);
          }
  };
  // the accumulator against its partial sums in dq, unscaled: `to_memory`
  // stores partial + accumulator (the partial is 0 at the first flush,
  // `first`) and restarts the accumulator at 0; else the accumulator
  // takes partial + accumulator (the epilogue's last step)
  auto flush = [&](bool first, bool to_memory) {
    visit([&](size_t at, float& x) {
      const float sum = (first ? 0.f : dq[at]) + x;
      if (to_memory) {
        dq[at] = sum;
        x = 0.f;
      } else {
        x = sum;
      }
    });
  };

  const float scale_log2 = scale * sm90::kLog2e;
  const uint8_t* a_src = qd_s + wg * QD + tid * 16;  // Q (wg 0) or dO (wg 1)
  const uint32_t b_base = sm90::smem_u32(kv_s + wg * 2 * T);  // K or V
  const uint32_t ds_tile = sm90::smem_u32(ds_s);
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK;
    // every kFlushTiles tiles (1024 keys) dQ^T moves to dQ in device
    // memory (each thread owns its elements: no race); products summed
    // into one tensor-core accumulator drift from a rounded sum as their
    // count grows
    if (it > 0 && it % C::kFlushTiles == 0) flush(it == C::kFlushTiles, true);
    // S (warpgroup 0) or dP (1): A_hi.[B_hi; B_lo] + A_lo.B_hi, the small
    // terms in accumulators of their own (summed in f32 after)
    float s2[BK], s1[BK / 2];
    uint32_t f[2][2 * G][4];  // [buffer][step's hi, lo] fragments
    float4 xs[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      xs[g] = *reinterpret_cast<const float4*>(a_src + g * 128 * 16);
#pragma unroll
    for (int g0 = 0; g0 < kSteps; g0 += G) {
      const int b = (g0 / G) & 1;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sm90::split_tf32(xs[g].x, f[b][2 * g][0], f[b][2 * g + 1][0]);
        sm90::split_tf32(xs[g].y, f[b][2 * g][1], f[b][2 * g + 1][1]);
        sm90::split_tf32(xs[g].z, f[b][2 * g][2], f[b][2 * g + 1][2]);
        sm90::split_tf32(xs[g].w, f[b][2 * g][3], f[b][2 * g + 1][3]);
      }
      if (g0 + G < kSteps) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          xs[g] = *reinterpret_cast<const float4*>(
              a_src + (g0 + G + g) * 128 * 16);
      }
      sm90::wgmma_fence();
      const uint32_t bb = sm90::pinned(b_base);  // descriptors made here
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int kk = g0 + g;
        const uint64_t db = sm90::desc_k_major(bb + (kk / 4) * 2 * BK * 128 +
                                               (kk % 4) * 32);
        sm90::wgmma_tf32_rs(s2, f[b][2 * g], db, kk > 0);
        sm90::wgmma_tf32_rs(s1, f[b][2 * g + 1], db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the group before this one is done
      if (g0 > 0) sm90::fence_regs(f[b ^ 1]);  // its fragments live to here
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s2);
    sm90::fence_regs(s1);
    sm90::fence_regs(f[0]);
    sm90::fence_regs(f[1]);
    float st[BK / 2];  // columns 8 j + c2 + e of rows ra, ra + 8
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) st[i] = s2[i] + s2[i + BK / 2] + s1[i];

    // P (warpgroup 0), handed over; dS = P (dP - delta) (1)
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + c2 + e;
          const bool live_k = key < t_k;
          const bool live_a = live_k && row_a < t_q && !(causal && key > row_a);
          const bool live_b = live_k && row_b < t_q && !(causal && key > row_b);
          st[4 * j + e] =
              live_a ? exp2f(fmaf(st[4 * j + e], scale_log2, -r_a)) : 0.f;
          st[4 * j + 2 + e] =
              live_b ? exp2f(fmaf(st[4 * j + 2 + e], scale_log2, -r_b)) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4)
        *reinterpret_cast<float4*>(xch + tid * (BK / 2) + i) =
            make_float4(st[i], st[i + 1], st[i + 2], st[i + 3]);
    }
    __syncthreads();  // P handed over
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        st[i] = xch[tid * (BK / 2) + i] * (st[i] - (i % 4 < 2 ? r_a : r_b));
      write_ds(st);
    }
    sm90::fence_proxy_async();  // the tile, before the wgmma reads
    __syncthreads();
    if (kPrefetch && it + 1 < n_kt) load_tile(k0 + BK);

    // dQ^T += K^T.dS^T, one (d tile, 8 keys) group of three products at a
    // time
    uint32_t af[2][2][4];  // K_hi, K_lo fragments
#pragma unroll
    for (int gi = 0; gi < kMT * (BK / 8); ++gi) {
      const int m = gi / (BK / 8), kk = gi % (BK / 8), b = gi & 1;
      const int col = 128 * wg + 64 * m + ra;  // d rows col, col + 8
      const uint8_t* kt = kv_s + sm90::pinned(0);  // addresses made here
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // K_hi, K_lo
        const uint8_t* tile = kt + x * BK * 128;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kr = 8 * kk + c + 4 * (i / 2), dc = col + 8 * (i % 2);
          af[b][x][i] = *reinterpret_cast<const uint32_t*>(
              tile + (dc / 32) * 2 * BK * 128 + kr * 128 +
              ((((dc % 32) / 4) ^ (kr % 8)) * 16) + (dc % 4) * 4);
        }
      }
      sm90::wgmma_fence();
      const uint32_t ds_at = sm90::pinned(ds_tile);
      const uint64_t s_hi = sm90::desc_k_major(ds_at + kk * 32);
      const uint64_t s_lo = sm90::desc_k_major(ds_at + 64 + kk * 32);
      sm90::wgmma_tf32_rs(dqt[m], af[b][0], s_hi, 1);
      sm90::wgmma_tf32_rs(dqt[m], af[b][0], s_lo, 1);
      sm90::wgmma_tf32_rs(dqt[m], af[b][1], s_hi, 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (gi > 0) sm90::fence_regs(af[b ^ 1]);
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < kMT; ++m) sm90::fence_regs(dqt[m]);
    sm90::fence_regs(af[0]);
    sm90::fence_regs(af[1]);
    __syncthreads();  // every read of the stage and the dS tile is done
    if (it + 1 < n_kt) {
      if (!kPrefetch) load_tile(k0 + BK);
      store_tile();
      __syncthreads();
    }
  }

  if (n_kt > C::kFlushTiles) flush(false, false);
  // columns at or past d are K's padding: not stored
  visit([&](size_t at, float& x) { dq[at] = x * scale; });
}

template <int DP, bool kFill>
__global__ void __launch_bounds__(DqTf32<DP>::kThreads, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const sm90::Fill fill,
                             const float* __restrict__ q,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int t_q, int t_k, int d,
                             int causal, float scale) {
  if constexpr (DqTf32<DP>::kWide)
    dq_tf32_wide<DP, kFill>(fill, lse, delta, dq, t_q, t_k, d, causal,
                            scale);
  else
    dq_tf32_body<DP, kFill>(map_k, map_v, fill, q, dout, lse, delta, dq, t_q,
                            t_k, d, causal, scale);
}

template <int DP>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int t_q,
                           int t_k, int d, int causal, float scale,
                           cudaStream_t stream) {
  using C = DqTf32<DP>;
  CUtensorMap map_k{}, map_v{};
  sm90::Fill fill = sm90::fill_of(q, k, v, dout, d * 4);
  cudaError_t e = cudaSuccess;
  if (!fill.width) {  // 16-byte loads of q's, dout's (at 256 all) rows
    if (reinterpret_cast<uintptr_t>(q) % 16 ||
        reinterpret_cast<uintptr_t>(dout) % 16)
      return cudaErrorInvalidValue;
    if constexpr (C::kWide) {
      if (reinterpret_cast<uintptr_t>(k) % 16 ||
          reinterpret_cast<uintptr_t>(v) % 16)
        return cudaErrorInvalidValue;
    } else {
      e = sm90::make_tile_map(&map_k, k, bh, t_k, d, C::kBK, 4);
      if (e == cudaSuccess)
        e = sm90::make_tile_map(&map_v, v, bh, t_k, d, C::kBK, 4);
    }
  }
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[2][kMaxDevices];
  const dim3 grid(bh, (t_q + C::kBQ - 1) / C::kBQ);
  auto go = [&](auto kernel, std::atomic<size_t>(&up)[kMaxDevices]) {
    cudaError_t err = allow_smem(kernel, C::kSmem, up);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
        map_k, map_v, fill, static_cast<const float*>(q),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq), t_q, t_k,
        d, causal, scale);
    return cudaGetLastError();
  };
  return fill.width ? go(flash_bwd_dq_tf32_kernel<DP, true>, raised[1])
                    : go(flash_bwd_dq_tf32_kernel<DP, false>, raised[0]);
}

// B3, float32
template <int DP, bool kFill = false>
struct DkvTf32 {
  // DP 256: `dkv_tf32_wide` (its own layout, below)
  static constexpr bool kWide = DP > 128;
  static constexpr int kBK = 64;                    // keys a block
  // queries a tile: 32 halves the small S^T and dP^T products a query
  // against 16; at DP 80, 16 keeps two stages (32 would leave one), and
  // at 128 and 256 32 does not fit (`scripts/kernel_ab.py` times the
  // choices)
  static constexpr int kBQ = DP == 80 || DP >= 128 ? 16 : 32;
  static constexpr int kPanels =
      (DP + sm90::kPanelColsF32 - 1) / sm90::kPanelColsF32;
  static constexpr int kKVBytes = kBK * kPanels * sm90::kRowBytes;  // a half
  // one half of a Q or dO tile
  static constexpr int kTile = kBQ * kPanels * sm90::kRowBytes;
  static constexpr int kTrBytes = DP * 128;         // a transposed half
  // Q_hi, Q_lo, dO_hi, dO_lo, Q^T_hi, Q^T_lo, dO^T_hi, dO^T_lo; TMA lands
  // Q in Q_lo, dO in dO_lo
  static constexpr int kStageBytes = 4 * kTile + 4 * kTrBytes;
  // One consumer warpgroup, a loading warp and the converters: their
  // work bounds the kernel at 64 (its products wait on them), so seven
  // warps convert there and at 80 (the kernel's registers fit 384
  // threads' 168: 154 at 64); at 96 and 128 the accumulators and tiles
  // need more than 384 threads allow, so three, and so does the copy
  // variant (kFill), whose loading warp's copies spilled at 64 with
  // seven.
  static constexpr int kConverters = DP <= 80 && !kFill ? 224 : 96;
  static constexpr int kConvBatch = 6;  // items a converter loads at once
                                        // (sm90::convert_items)
  static constexpr int kThreads = kWide ? 256 : 160 + kConverters;
  // query tiles between two flushes of the accumulators (1024 queries)
  static constexpr int kFlushTiles = 1024 / kBQ;
  // shared memory with one stage, and what each further stage adds; two
  // stages where they fit (DP 64 and 80), else one (96 and 128)
  static constexpr size_t kSmem1 =
      1024 + 4 * kKVBytes + kStageBytes + 2 * kBQ * 4 + 8 * 5;
  static constexpr size_t kStageSmem = kStageBytes + 2 * kBQ * 4 + 8 * 3;
  static constexpr int kStages = kSmem1 + kStageSmem <= 227 * 1024 ? 2 : 1;
  // DP 256: K and V in fragment order (raw f32), Q and dO as stacked
  // halves, the P^T and dS^T tiles (64 keys x 32 slots: hi, then lo),
  // the P^T hand-over (8 values a thread of the first warpgroup) and the
  // tile's lse / delta rows; no barriers in shared memory
  static constexpr size_t kWideSmem = 1024 + 2 * kKVBytes + 4 * kTile +
                                      2 * kBK * 128 + 128 * (kBQ / 2) * 4 +
                                      2 * kBQ * 4;
  static constexpr size_t kSmem =
      kWide ? kWideSmem : kSmem1 + (kStages - 1) * kStageSmem;
  static_assert(kSmem <= 227 * 1024, "the shared memory a block may use");
};

// A consumer thread's dK / dV accumulators (the rows key_a, key_b of its
// fragment layout) against their partial sums in dk / dv, unscaled:
// `to_memory` stores partial + accumulator there (the partial is 0 at
// the first flush, `first`) and restarts the accumulator at 0; else the
// accumulator takes partial + accumulator (the epilogue's last step).
template <int DP>
__device__ __forceinline__ void flush_dkv(float* dk, float* dv,
                                          float (&dk_acc)[DP / 2],
                                          float (&dv_acc)[DP / 2],
                                          size_t key0, int key_a, int key_b,
                                          int t_k, int d, int c2, bool first,
                                          bool to_memory) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_b : key_a;
    if (key >= t_k) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c2 + e;
        if (col >= d) continue;  // the padding's columns
        const size_t at = (key0 + key) * d + col;
        const int i = 4 * j + 2 * half + e;
        const float k_sum = (first ? 0.f : dk[at]) + dk_acc[i];
        const float v_sum = (first ? 0.f : dv[at]) + dv_acc[i];
        if (to_memory) {
          dk[at] = k_sum;
          dv[at] = v_sum;
          dk_acc[i] = dv_acc[i] = 0.f;
        } else {
          dk_acc[i] = k_sum;
          dv_acc[i] = v_sum;
        }
      }
  }
}

template <int DP, bool kFill>
__device__ __forceinline__ void dkv_tf32_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap& map_do,
    const sm90::Fill fill, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int t_q, int t_k, int d, int causal,
    float scale) {
  using C = DkvTf32<DP, kFill>;
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
    const uint32_t loads = kFill ? 32 : 1;  // arrivals a raw phase
    sm90::mbar_init(kv_raw, loads);
    sm90::mbar_init(kv_full, C::kConverters);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&raw_full[s], loads);
      sm90::mbar_init(&conv_full[s], C::kConverters);
      sm90::mbar_init(&conv_empty[s], 4);  // one per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4) {  // producer warps: one loads, the others split
    if constexpr (kFill) {  // rows no map takes: the loading warp fills
      if (warp == 4) {
        const int rb = d * 4;
        const size_t q_slab = static_cast<size_t>(bh) * t_q * rb;
        const size_t kv_slab = static_cast<size_t>(bh) * t_k * rb;
        sm90::by_copy_width(fill.width, [&](auto w) {
          constexpr int W = decltype(w)::value;
          const uint32_t res = sm90::smem_u32(res_s);
          sm90::fill_tile<W, BK, C::kPanels>(res + KV, fill.src[1] + kv_slab,
                                             k0, t_k, rb, lane, 32);
          sm90::fill_tile<W, BK, C::kPanels>(res + 3 * KV,
                                             fill.src[2] + kv_slab, k0, t_k, rb,
                                             lane, 32);
          sm90::fill_commit();
          sm90::mbar_arrive(kv_raw);
          for (int it = 0; it < n_qt; ++it) {
            const int s = it % S;
            const int q0 = q_begin + it * BQ;
            if (it >= S) sm90::mbar_wait(&conv_empty[s], (it / S - 1) & 1);
            const uint32_t at = sm90::smem_u32(stage_s) + s * C::kStageBytes;
            sm90::fill_tile<W, BQ, C::kPanels>(at + T, fill.src[0] + q_slab, q0,
                                               t_q, rb, lane, 32);
            sm90::fill_tile<W, BQ, C::kPanels>(at + 3 * T,
                                               fill.src[3] + q_slab, q0, t_q,
                                               rb, lane, 32);
            sm90::fill_commit();
            sm90::mbar_arrive(&raw_full[s]);
          }
        });
        return;
      }
    }
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
      sm90::split_transposed<BQ, DP, N, B>(st + T, st + 4 * T,
                                           st + 4 * T + TR, ct);
      sm90::split_transposed<BQ, DP, N, B>(st + 3 * T, st + 4 * T + 2 * TR,
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
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_hi = sm90::smem_u32(res_s), k_lo = k_hi + KV;
  const uint32_t v_hi = k_hi + 2 * KV, v_lo = k_hi + 3 * KV;
  const size_t key0 = static_cast<size_t>(bh) * t_k;
  bool flushed = false;  // dK / dV in device memory hold partial sums
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
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t ac = (kk / 4) * BK * 128 + (kk % 4) * 32;
      const uint32_t bc = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint64_t da = sm90::desc_k_major(k_hi + ac);
      const uint64_t db = sm90::desc_k_major(q_hi + bc);
      sm90::wgmma_tf32_ss(st, da, db, kk > 0);
      sm90::wgmma_tf32_ss(st, da, sm90::desc_k_major(q_lo + bc), 1);
      sm90::wgmma_tf32_ss(st, sm90::desc_k_major(k_lo + ac), db, 1);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
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
    // Every kFlushTiles tiles (1024 queries) the accumulators move to dK
    // and dV in device memory, added there on the CUDA cores (each
    // thread owns its elements: no race), and restart at 0.  Products
    // summed into one tensor-core accumulator drift from a rounded sum
    // as their count grows (at 32768 queries 1.9x the f32 bar on dK);
    // a block of at most 1024 queries never flushes, so its output is
    // what it was before the flush existed.
    if ((it + 1) % C::kFlushTiles == 0 && it + 1 < n_qt) {
      flush_dkv<DP>(dk, dv, dk_acc, dv_acc, key0, key_a, key_b, t_k, d, c2,
                    !flushed, true);
      flushed = true;
    }
  }

  if (flushed)  // the sums so far join the accumulators' last part
    flush_dkv<DP>(dk, dv, dk_acc, dv_acc, key0, key_a, key_b, t_k, d, c2,
                  false, false);
  // columns at or past d are the padding of Q and dO: not stored
  if (key_a < t_k) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const size_t at = (key0 + key_a) * d;
      sm90::store_pair<!kFill>(dk + at, 8 * j + c2, d,
                               dk_acc[4 * j] * scale,
                               dk_acc[4 * j + 1] * scale);
      sm90::store_pair<!kFill>(dv + at, 8 * j + c2, d, dv_acc[4 * j],
                               dv_acc[4 * j + 1]);
    }
  }
  if (key_b < t_k) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const size_t at = (key0 + key_b) * d;
      sm90::store_pair<!kFill>(dk + at, 8 * j + c2, d,
                               dk_acc[4 * j + 2] * scale,
                               dk_acc[4 * j + 3] * scale);
      sm90::store_pair<!kFill>(dv + at, 8 * j + c2, d, dv_acc[4 * j + 2],
                               dv_acc[4 * j + 3]);
    }
  }
}

// B3, float32 at DP 256 (head_dims 129-256).  K's and V's TF32 halves for
// the block's 64 keys would take 256 KB and one warpgroup's dK and dV
// 256 registers a thread, so the block changes shape.  Two consumer
// warpgroups (256 threads, no producer) share the 64 keys:
//   * K and V stay raw (64 KB each) in A-fragment order, so a thread
//     reads its fragment of a k8 step with one 16-byte load and splits it
//     into hi / lo in registers just before its products;
//   * per 16-query tile, warpgroup 0 computes S^T = K.Q^T and warpgroup
//     1 dP^T = V.dO^T, each as A_hi.[B_hi; B_lo] (one m64n32k8: the tile
//     stacks each panel's lo rows under its hi rows) + A_lo.B_hi (an
//     m64n16k8), one k8 step's fragments in flight while the next one's
//     are split (`wgmma_wait<1>`); the small terms keep accumulators
//     of their own (with one accumulator for all three the worst error
//     rose from 0.2 to 0.55 of the bar: the tensor cores' f32 sums drop
//     low bits of small addends);
//   * warpgroup 0 makes P^T and hands it over in shared memory, warpgroup
//     1 makes dS^T; each writes its tile's hi / lo halves as a K-major B
//     operand (64 keys x 32 slots);
//   * dV and dK accumulate transposed, the head_dim as the M side:
//     dV^T += dO^T.P and dK^T += Q^T.dS, three products each
//     (m64n64k8), A fragments read from the stacked Q / dO halves
//     element by element (no transposed copy of Q or dO exists), B the
//     P^T / dS^T tiles; warpgroup w owns d rows 128 w .. 128 w + 127:
//     dK^T and dV^T take 64 + 64 registers a thread;
//   * the next tile's Q and dO rows load (mostly from L2: every key block
//     of a row reads them) once every warpgroup is done with the stage,
//     and are split into it.
// The accumulators flush every 1024 queries, as at the other widths.
// Stores and flushes are transposed back at stride d.  Bound: at
// [2,16,2048,256] causal the function's four products at the TF32 rate,
// 0.278 ms; this runs 3.44 ms on an H100 (0.58x SDPA's whole backward;
// `PERF.md` §6): the two warpgroups meet at a barrier four times a
// 16-query tile, and the S^T / dP^T products are m64n32k8 / m64n16k8.
template <int DP, bool kFill>
__device__ __forceinline__ void dkv_tf32_wide(
    const sm90::Fill fill, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int t_q, int t_k, int d, int causal,
    float scale) {
  using C = DkvTf32<DP, kFill>;
  constexpr int BQ = C::kBQ, BK = C::kBK, KV = C::kKVBytes, T = C::kTile;
  constexpr int kSteps = DP / 8;  // k8 steps of S^T and dP^T
  constexpr int kMT = DP / 128;   // 64-row d tiles a warpgroup
  // k8 steps a commit group: at 2 their fragments spilled
  constexpr int G = 1;
  constexpr int kVecs = DP / 4;   // float4s a padded row
  constexpr int kItems = 2 * BQ * kVecs / 256;  // a thread's Q / dO float4s
  static_assert(kItems * 256 == 2 * BQ * kVecs && BQ == 16 && BK == 64,
                "the tile shapes below");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kv_s = sm90::align1024(smem_raw);  // K, V in fragment order
  uint8_t* qd_s = kv_s + 2 * KV;              // Q, dO stacked halves
  uint8_t* pds_s = qd_s + 4 * T;              // P^T tile, dS^T tile
  float* xch = reinterpret_cast<float*>(pds_s + 2 * BK * 128);  // P^T
  float* rows_s = xch + 128 * (BQ / 2);  // lse * log2 e, then delta

  const float* q = reinterpret_cast<const float*>(fill.src[0]);
  const float* k = reinterpret_cast<const float*>(fill.src[1]);
  const float* v = reinterpret_cast<const float*>(fill.src[2]);
  const float* dout = reinterpret_cast<const float*>(fill.src[3]);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // under causal masking block 0 is longest
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < t_q ? (t_q - q_begin + BQ - 1) / BQ : 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, c = lane % 4, c2 = 2 * c;
  const size_t row0 = static_cast<size_t>(bh) * t_q;
  const size_t key0 = static_cast<size_t>(bh) * t_k;
  auto elem = [&](const float* src, int row, int rows, int col) {
    return row < rows && col < d ? src[static_cast<size_t>(row) * d + col]
                                 : 0.f;
  };

  // K and V: item (kk, t) is thread t's A fragment of k8 step kk, keys
  // a and a + 8 (a = 16 (t / 32) + (t % 32) / 4) at columns 8 kk + t % 4
  // and + 4, as {a0, a1, a2, a3} (eight items' loads in flight at once)
#pragma unroll 8
  for (int i = threadIdx.x; i < 2 * kSteps * 128; i += 256) {
    const int which = i / (kSteps * 128), kk = (i / 128) % kSteps;
    const int t = i % 128;
    const float* src = (which ? v : k) + key0 * d;
    const int ka = k0 + 16 * (t / 32) + (t % 32) / 4, col = 8 * kk + t % 4;
    reinterpret_cast<float4*>(kv_s + which * KV)[kk * 128 + t] =
        make_float4(elem(src, ka, t_k, col), elem(src, ka + 8, t_k, col),
                    elem(src, ka, t_k, col + 4),
                    elem(src, ka + 8, t_k, col + 4));
  }

  // a Q / dO tile: loaded into registers, then split into the stage (Q's
  // panel p holds Q_hi's 16 rows then Q_lo's, then dO's the same), with
  // the tile's lse (times log2 e) and delta rows
  const float* qb = q + row0 * d;
  const float* dob = dout + row0 * d;
  float4 pre[kItems];
  float pre_row = 0.f;
  auto load_tile = [&](int q0) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = threadIdx.x + 256 * j, which = i / (BQ * kVecs);
      const int w = i % (BQ * kVecs), row = q0 + w / kVecs;
      const int col = 4 * (w % kVecs);
      const float* src = which ? dob : qb;
      if (!kFill && row < t_q && col < d) {
        pre[j] = *reinterpret_cast<const float4*>(
            src + static_cast<size_t>(row) * d + col);
      } else {
        pre[j] = make_float4(elem(src, row, t_q, col),
                             elem(src, row, t_q, col + 1),
                             elem(src, row, t_q, col + 2),
                             elem(src, row, t_q, col + 3));
      }
    }
    if (threadIdx.x < 2 * BQ) {
      const int qq = q0 + threadIdx.x % BQ;
      pre_row = qq >= t_q ? 0.f
                : threadIdx.x < BQ ? lse[row0 + qq] * sm90::kLog2e
                                   : delta[row0 + qq];
    }
  };
  auto store_tile = [&]() {
    uint8_t* qd = qd_s + sm90::pinned(0);  // addresses made here
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = threadIdx.x + 256 * j, which = i / (BQ * kVecs);
      const int w = i % (BQ * kVecs), r = w / kVecs, col = 4 * (w % kVecs);
      const int off = which * 2 * T + (col / 32) * 2 * BQ * 128 + r * 128 +
                      ((((col % 32) / 4) ^ (r % 8)) * 16);
      uint4 hi, lo;
      sm90::split_tf32(pre[j], hi, lo);
      *reinterpret_cast<uint4*>(qd + off) = hi;
      *reinterpret_cast<uint4*>(qd + off + BQ * 128) = lo;
    }
    if (threadIdx.x < 2 * BQ) rows_s[threadIdx.x] = pre_row;
    sm90::fence_proxy_async();  // the stores, before the wgmma reads
  };
  // x's hi / lo halves at (key, slots 8 j + c2, + 1) of a P^T / dS^T tile
  // (row = local key, 128 bytes: slots 0-15 hi, 16-31 lo; swizzled)
  const int key_a = 16 * warp + lane / 4;
  auto write_tile = [&](uint8_t* base, const float (&x)[BQ / 2]) {
    uint8_t* tile = base + sm90::pinned(0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key_a + 8 * h, slot = 8 * j + c2;
        uint32_t h0, l0, h1, l1;
        sm90::split_tf32(x[4 * j + 2 * h], h0, l0);
        sm90::split_tf32(x[4 * j + 2 * h + 1], h1, l1);
        const int at = key * 128 + (slot % 4) * 4;
        *reinterpret_cast<uint2*>(tile + at +
                                  (((slot / 4) ^ (key % 8)) * 16)) =
            make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(tile + at +
                                  ((((slot + 16) / 4) ^ (key % 8)) * 16)) =
            make_uint2(l0, l1);
      }
  };

  float dkt[kMT][32], dvt[kMT][32];  // dK^T, dV^T: d rows x 64 keys
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) dkt[m][i] = dvt[m][i] = 0.f;
  // f(index into dK / dV, dK^T element, dV^T element) for each element
  // this thread holds inside [t_k, d)
  auto visit = [&](auto f) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 128 * wg + 64 * m + key_a + 8 * h;
            const int key = k0 + 8 * j + c2 + e;
            if (col < d && key < t_k)
              f((key0 + key) * d + col, dkt[m][4 * j + 2 * h + e],
                dvt[m][4 * j + 2 * h + e]);
          }
  };
  // the accumulators against their partial sums in dk / dv, unscaled
  // (`flush_dkv`'s arithmetic)
  auto flush = [&](bool first, bool to_memory) {
    visit([&](size_t at, float& ka, float& va) {
      const float k_sum = (first ? 0.f : dk[at]) + ka;
      const float v_sum = (first ? 0.f : dv[at]) + va;
      if (to_memory) {
        dk[at] = k_sum;
        dv[at] = v_sum;
        ka = va = 0.f;
      } else {
        ka = k_sum;
        va = v_sum;
      }
    });
  };

  const float scale_log2 = scale * sm90::kLog2e;
  const uint8_t* a_src = kv_s + wg * KV + tid * 16;  // K (wg 0) or V (wg 1)
  const uint32_t b_base = sm90::smem_u32(qd_s + wg * 2 * T);  // Q or dO
  const uint32_t p_tile = sm90::smem_u32(pds_s);  // then the dS^T tile
  // Query tiles in runs of kFlushTiles (1024 queries); between two runs
  // the accumulators move to dK / dV in device memory (added there on the
  // CUDA cores) and restart at 0, as `flush_dkv` does at the other
  // widths.
  for (int r0 = 0; r0 < n_qt; r0 += C::kFlushTiles) {
    const int r1 = min(n_qt, r0 + C::kFlushTiles);
    if (r0 > 0) flush(r0 == C::kFlushTiles, true);
    load_tile(q_begin + r0 * BQ);
    store_tile();
    __syncthreads();
    for (int it = r0; it < r1; ++it) {
      const int q0 = q_begin + it * BQ;
      // S^T (warpgroup 0) or dP^T (1): A_hi.[B_hi; B_lo] + A_lo.B_hi, the
      // small terms in accumulators of their own (summed in f32 after)
      float s2[BQ], s1[BQ / 2];
      uint32_t fh[2][G][4], fl[2][G][4];
      float4 xs[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        xs[g] = *reinterpret_cast<const float4*>(a_src + g * 128 * 16);
#pragma unroll
      for (int g0 = 0; g0 < kSteps; g0 += G) {
        const int b = (g0 / G) & 1;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          sm90::split_tf32(xs[g].x, fh[b][g][0], fl[b][g][0]);
          sm90::split_tf32(xs[g].y, fh[b][g][1], fl[b][g][1]);
          sm90::split_tf32(xs[g].z, fh[b][g][2], fl[b][g][2]);
          sm90::split_tf32(xs[g].w, fh[b][g][3], fl[b][g][3]);
        }
        if (g0 + G < kSteps) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            xs[g] = *reinterpret_cast<const float4*>(
                a_src + (g0 + G + g) * 128 * 16);
        }
        sm90::wgmma_fence();
        const uint32_t bb = sm90::pinned(b_base);  // descriptors made here
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int kk = g0 + g;
          const uint64_t db = sm90::desc_k_major(
              bb + (kk / 4) * 2 * BQ * 128 + (kk % 4) * 32);
          sm90::wgmma_tf32_rs(s2, fh[b][g], db, kk > 0);
          sm90::wgmma_tf32_rs(s1, fl[b][g], db, kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the group before this one is done
        if (g0 > 0) {           // its fragments stay live until here
          sm90::fence_regs(fh[b ^ 1]);
          sm90::fence_regs(fl[b ^ 1]);
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s2);
      sm90::fence_regs(s1);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        sm90::fence_regs(fh[b]);
        sm90::fence_regs(fl[b]);
      }
      float st[BQ / 2];  // columns 8 j + c2 + e of rows key_a, key_a + 8
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        st[i] = s2[i] + s2[i + BQ / 2] + s1[i];

      // P^T (warpgroup 0), handed over; dS^T = P^T (dP^T - delta) (1)
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ql = 8 * j + c2 + e, qq = q0 + ql;
            const float l2 = rows_s[ql];
            const int ka = k0 + key_a, kb = ka + 8;
            const bool live_q = qq < t_q;
            const bool live_a = live_q && ka < t_k && !(causal && ka > qq);
            const bool live_b = live_q && kb < t_k && !(causal && kb > qq);
            st[4 * j + e] =
                live_a ? exp2f(fmaf(st[4 * j + e], scale_log2, -l2)) : 0.f;
            st[4 * j + 2 + e] =
                live_b ? exp2f(fmaf(st[4 * j + 2 + e], scale_log2, -l2)) : 0.f;
          }
#pragma unroll
        for (int i = 0; i < BQ / 2; i += 4)
          *reinterpret_cast<float4*>(xch + tid * (BQ / 2) + i) =
              make_float4(st[i], st[i + 1], st[i + 2], st[i + 3]);
        write_tile(pds_s, st);
      }
      __syncthreads();  // P^T handed over
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const float dl = rows_s[BQ + 8 * (i / 4) + c2 + i % 2];
          st[i] = xch[tid * (BQ / 2) + i] * (st[i] - dl);
        }
        write_tile(pds_s + BK * 128, st);
      }
      sm90::fence_proxy_async();  // the tiles, before the wgmma reads
      __syncthreads();

      // dV^T += dO^T.P and dK^T += Q^T.dS, one (d tile, 8 queries) group
      // of six products at a time
      uint32_t af[2][4][4];  // Q_hi, Q_lo, dO_hi, dO_lo fragments
#pragma unroll
      for (int gi = 0; gi < kMT * (BQ / 8); ++gi) {
        const int m = gi / (BQ / 8), kq = gi % (BQ / 8), b = gi & 1;
        const int col = 128 * wg + 64 * m + key_a;  // d rows col, col + 8
        const uint8_t* qd = qd_s + sm90::pinned(0);  // addresses made here
#pragma unroll
        for (int x = 0; x < 4; ++x) {  // Q_hi, Q_lo, dO_hi, dO_lo
          const uint8_t* tile = qd + (x / 2) * 2 * T + (x % 2) * BQ * 128;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qr = 8 * kq + c + 4 * (i / 2), dc = col + 8 * (i % 2);
            af[b][x][i] = *reinterpret_cast<const uint32_t*>(
                tile + (dc / 32) * 2 * BQ * 128 + qr * 128 +
                ((((dc % 32) / 4) ^ (qr % 8)) * 16) + (dc % 4) * 4);
          }
        }
        sm90::wgmma_fence();
        const uint32_t p_at = sm90::pinned(p_tile), ds_at = p_at + BK * 128;
        const uint64_t p_hi = sm90::desc_k_major(p_at + kq * 32);
        const uint64_t p_lo = sm90::desc_k_major(p_at + 64 + kq * 32);
        const uint64_t s_hi = sm90::desc_k_major(ds_at + kq * 32);
        const uint64_t s_lo = sm90::desc_k_major(ds_at + 64 + kq * 32);
        sm90::wgmma_tf32_rs(dvt[m], af[b][2], p_hi, 1);
        sm90::wgmma_tf32_rs(dvt[m], af[b][2], p_lo, 1);
        sm90::wgmma_tf32_rs(dvt[m], af[b][3], p_hi, 1);
        sm90::wgmma_tf32_rs(dkt[m], af[b][0], s_hi, 1);
        sm90::wgmma_tf32_rs(dkt[m], af[b][0], s_lo, 1);
        sm90::wgmma_tf32_rs(dkt[m], af[b][1], s_hi, 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (gi > 0) sm90::fence_regs(af[b ^ 1]);
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        sm90::fence_regs(dkt[m]);
        sm90::fence_regs(dvt[m]);
      }
      sm90::fence_regs(af[0]);
      sm90::fence_regs(af[1]);
      __syncthreads();  // every read of the stage and the tiles is done
      if (it + 1 < r1) {  // the next tile (rows held in registers across
                          // the products spilled, and timed slower)
        load_tile(q0 + BQ);
        store_tile();
        __syncthreads();
      }
    }
  }

  if (n_qt > C::kFlushTiles) flush(false, false);
  // columns at or past d are the padding of Q and dO: not stored
  visit([&](size_t at, float& ka, float& va) {
    dk[at] = ka * scale;
    dv[at] = va;
  });
}

template <int DP, bool kFill>
__global__ void __launch_bounds__(DkvTf32<DP, kFill>::kThreads, 1)
    flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const sm90::Fill fill,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int t_q, int t_k, int d, int causal,
                              float scale) {
  if constexpr (DkvTf32<DP, kFill>::kWide)
    dkv_tf32_wide<DP, kFill>(fill, lse, delta, dk, dv, t_q, t_k, d, causal,
                             scale);
  else
    dkv_tf32_body<DP, kFill>(map_q, map_k, map_v, map_do, fill, lse, delta,
                             dk, dv, t_q, t_k, d, causal, scale);
}

template <int DP>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int t_q, int t_k, int d, int causal, float scale,
                            cudaStream_t stream) {
  using C = DkvTf32<DP>;
  CUtensorMap map_q{}, map_k{}, map_v{}, map_do{};
  sm90::Fill fill = sm90::fill_of(q, k, v, dout, d * 4);
  cudaError_t e = cudaSuccess;
  if constexpr (C::kWide) {  // no maps: 16-byte loads of Q's, dO's rows
    if (!fill.width && (reinterpret_cast<uintptr_t>(q) % 16 ||
                        reinterpret_cast<uintptr_t>(dout) % 16))
      return cudaErrorInvalidValue;
  } else if (!fill.width) {
    e = sm90::make_tile_map(&map_q, q, bh, t_q, d, C::kBQ, 4);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_do, dout, bh, t_q, d, C::kBQ, 4);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_k, k, bh, t_k, d, C::kBK, 4);
    if (e == cudaSuccess)
      e = sm90::make_tile_map(&map_v, v, bh, t_k, d, C::kBK, 4);
  }
  if (e != cudaSuccess) return e;
  static std::atomic<size_t> raised[2][kMaxDevices];
  const dim3 grid(bh, (t_k + C::kBK - 1) / C::kBK);
  // both variants take C::kSmem (the converters hold no shared memory)
  auto go = [&](auto kernel, std::atomic<size_t>(&up)[kMaxDevices],
                int threads) {
    cudaError_t err = allow_smem(kernel, C::kSmem, up);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, C::kSmem, stream>>>(
        map_q, map_k, map_v, map_do, fill, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk),
        static_cast<float*>(dv), t_q, t_k, d, causal, scale);
    return cudaGetLastError();
  };
  return fill.width ? go(flash_bwd_dkv_tf32_kernel<DP, true>, raised[1],
                         DkvTf32<DP, true>::kThreads)
                    : go(flash_bwd_dkv_tf32_kernel<DP, false>, raised[0],
                         C::kThreads);
}

}  // namespace
}  // namespace flash_train

// dtype: 0 float32, 1 bfloat16.  B2 (dQ) and B3 (dK, dV) take the tensor
// cores at every head_dim up to 256, at its padded width
// (`tensor_core_width`: bfloat16 directly, float32 as three TF32
// products).
// q/dout [bh, t_q, head_dim], k/v [bh, t_k, head_dim], lse/delta f32
// [bh, t_q], outputs like their inputs; all contiguous on the current
// device, 16-byte aligned where a TMA map takes the rows.  Each returns
// cudaGetLastError() after its launch (or the error of the tensor maps'
// encoding).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh,
                                 int t_q, int t_k, int head_dim, int causal,
                                 float scale, int dtype, void* stream) {
  if (bh == 0 || t_q == 0) return cudaSuccess;
  if (t_k < 1 || (t_q + 31) / 32 > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = flash_train::tensor_core_width(head_dim);
  return flash_train::dispatch_width(dtype, width, [&](auto t, auto w) {
    constexpr int DP = decltype(w)::value;
    if constexpr (std::is_same_v<decltype(t), __nv_bfloat16>)
      return flash_train::launch_dq_sm90<DP>(q, k, v, dout, lse, delta, dq,
                                             bh, t_q, t_k, head_dim, causal,
                                             scale, s);
    else
      return flash_train::launch_dq_tf32<DP>(q, k, v, dout, lse, delta, dq,
                                             bh, t_q, t_k, head_dim, causal,
                                             scale, s);
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
  const int width = flash_train::tensor_core_width(head_dim);
  return flash_train::dispatch_width(dtype, width, [&](auto t, auto w) {
    constexpr int DP = decltype(w)::value;
    if constexpr (std::is_same_v<decltype(t), __nv_bfloat16>)
      return flash_train::launch_dkv_sm90<DP>(q, k, v, dout, lse, delta, dk,
                                              dv, bh, t_q, t_k, head_dim,
                                              causal, scale, s);
    else
      return flash_train::launch_dkv_tf32<DP>(q, k, v, dout, lse, delta, dk,
                                              dv, bh, t_q, t_k, head_dim,
                                              causal, scale, s);
  });
}

// The shared memory a launch of B2 (kernel 0) or B3 (kernel 1) at
// (head_dim, dtype) takes, on the route the entries above pick: the
// kernel's static bytes and the dynamic bytes its launch passes.
// Returns a cudaError_t.
extern "C" int flash_attn_bwd_smem(int kernel, int head_dim, int dtype,
                                   int* static_bytes, int* dynamic_bytes) {
  using namespace flash_train;
  const int width = tensor_core_width(head_dim);
  if (kernel == 0) {
    return dispatch_width(dtype, width, [&](auto t, auto w) {
      constexpr int DP = decltype(w)::value;
      if constexpr (std::is_same_v<decltype(t), __nv_bfloat16>)
        return report_smem(flash_bwd_dq_sm90_kernel<DP, false>,
                           DqSm90<DP>::kSmem, static_bytes, dynamic_bytes);
      else
        return report_smem(flash_bwd_dq_tf32_kernel<DP, false>,
                           DqTf32<DP>::kSmem, static_bytes, dynamic_bytes);
    });
  }
  if (kernel != 1) return cudaErrorInvalidValue;
  return dispatch_width(dtype, width, [&](auto t, auto w) {
    constexpr int DP = decltype(w)::value;
    if constexpr (std::is_same_v<decltype(t), __nv_bfloat16>)
      return report_smem(flash_bwd_dkv_sm90_kernel<DP, false>,
                         DkvSm90<DP>::kSmem,
                         static_bytes, dynamic_bytes);
    else
      return report_smem(flash_bwd_dkv_tf32_kernel<DP, false>,
                         DkvTf32<DP>::kSmem,
                         static_bytes, dynamic_bytes);
  });
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
