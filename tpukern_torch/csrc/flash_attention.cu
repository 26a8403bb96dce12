// FlashAttention-2 forward, split-Q: a block owns one (batch, q head,
// q tile) and walks the KV tiles up to the causal frontier with an online
// softmax (running max m and sum l in f32). Query head h reads KV head
// h / (Hq / Hkv) (GQA). Keys at or past Skv are masked with NEG_BIG, and a
// row whose sum stays 0 outputs 0.
//
// Replaces tpukern/ops/attention.py:62 `_fa_kernel` and its transposed-
// layout twin `_fa_tpv_kernel` (:656, chosen there at D <= 64 for the
// TPU's MXU width; one kernel covers both here). The LSE instance of
// either tier also writes each row's f32 log-sum-exp of the scaled scores
// in natural log (m + ln l), as the JAX kernel's return_stats does
// (attention.py:346-350): the training backward recomputes P from it.
// It is a template flag, so the serving path's instance compiles as it
// did without the output.
//
// The FEAT instances add the masks of the featured training path, as
// runtime arguments (struct AttnMask, common.cuh): a sliding window (key c visible to
// query r iff r - window + 1 <= c <= r) with attention sinks (c < sinks
// also visible), a logit softcap applied to the f32 score after the
// sm_scale multiply and before masking (s = cap * tanh(s / cap), with the
// accurate tanhf, then log2(e) in the bf16 tier; attention.py:207-214),
// and segment ids (a mismatching pair is masked; a row whose running max
// stays NEG_BIG sees no key and outputs 0, attention.py:338-343). The
// KV loop of a window starts at the tile holding max(0, q0 - window + 1),
// as the TPU kernel's should_run/in_band and KV-index pinning do
// (attention.py:124-137, :557-564), so work scales with S * window; the
// tiles below `sinks` run first. The serving path's instance (FEAT off)
// compiles as before.
//
// bf16 tier (fa_fwd_wgmma_kernel): the FlashAttention-2-on-Hopper design
// (PAPERS.md, arXiv 2312.11918) on csrc/hopper.cuh's TMA, mbarrier and
// wgmma blocks. A block is NC consumer warpgroups of 64 query rows each
// and a producer (a warp beside one consumer warpgroup; a warpgroup
// beside two, which gives its registers to the consumers by setmaxnreg):
// - the producer's one elected thread loads the block's Q once and then
//   the K and V tiles of the walk into a ring of STAGES stages (each K
//   and V tile its own `full` mbarrier, so S = Q K^T starts before V
//   lands), as far ahead as the consumers' `empty` arrivals let it;
// - Q, K and V load through 3-D tensor maps over (D, S, B * H), so a box
//   never reaches into the next head's rows and rows past S arrive as
//   zeros; a row of D = 128 (256 bytes) is two 64-column boxes of the
//   128-byte swizzle, and D = 32 loads as one 64-column box whose columns
//   past 32 arrive as zeros (the products run at width 64). Rows are D * 2
//   bytes, a multiple of 16 for every D taken, and the wrapper aligns the
//   bases to 16 bytes, so TMA takes every operand: there is no copy path;
// - each consumer warpgroup computes its 64 x BK scores with wgmma
//   m64n{BK}k16 (Q and K both from shared memory, K-major), masks them
//   (the FEAT masks, caps and scales too) and runs the online softmax in
//   registers, on wgmma's accumulator layout, where a row lives in one
//   quad of lanes: exp2 of the scores in log2 units (one FMA a score from
//   the raw score and the raw max), l summed from the f32 p, P rounded to
//   bf16 as the mma.sync kernel before it did;
// - O += P V runs wgmma m64n{D}k16 with A from registers: the f32 scores
//   of keys 16kk.. sit exactly where the A fragment of k16 step kk needs
//   them (hopper.cuh), so P goes from the softmax into the product with
//   one bf16 pack and no trip through shared memory, which would cost a
//   store, a fence and a barrier a tile; V is MN-major (its keys are the
//   contraction, read with the transpose-B bit);
// - the tensor cores and the softmax overlap inside a warpgroup: each
//   pass issues tile i's S and tile i - 1's P V together, runs tile i's
//   softmax while P V is in flight, then waits for it, releases its stage
//   and rescales O. The first tile is peeled off, the last P V follows
//   the loop, and every branch around a wgmma is on warp-uniform values
//   (the warp index is broadcast from lane 0): where the paths to a
//   wgmma differ, ptxas serialises every product of the kernel (C7520),
//   which cost 30% at S 4096 (PERF.md, #6 findings);
// - under causal, q tiles launch heaviest first (the last tile walks the
//   most keys), and a warpgroup only releases the KV tiles wholly past
//   its rows. A tile wholly visible to a warp skips the per-element mask.
// Tile shapes (launch_bf16): where the blocks of 64 query rows fit in one
// wave of the SMs (the serving prefill: 128 blocks at S 512), a block is
// 64 rows walking 128-key tiles, the shortest critical path; else 128
// rows (two consumer warpgroups, one's softmax under the other's
// products) walking 64-key tiles. The other shapes the harness times
// (`config`; 64 rows and 64 keys, 128 rows and 128 keys, the two heads of
// a GQA pair on one K/V stream) are built for D = 128 without LSE or FEAT
// only. Issuing the two warpgroups' products in turns (named barriers,
// FA3's ping-pong) gained nothing over the overlap and was dropped.
//
// What bounds it: each (query, key) pair costs 4 D flops, and K/V are
// read once per q tile. At the serving prefill (B 1, H 16/8, S 512,
// D 128, causal) the function moves 6.3 MB of q, k, v and o against
// 1.1 GFLOP, so the bytes bound it (1.9 us at 3.35 TB/s); from S 2048 on
// the flops do (69.5 us at S 4096 against 989 TFLOP/s). At the serving
// shape latency keeps the kernel from either bound: the longest block
// walks 4 serial 128-key tiles, each a product, a softmax and a product,
// under which the ring keeps the next tiles' loads in flight; at S 4096
// the issue of the softmax between the products does.
//
// Registers (`-Xptxas -v`, nvcc 12.9, sm_90a; chip_smoke.py prints them
// from the build's nvcc.log) and dynamic shared memory (Q, then STAGES
// stages of K and V; FaShape) of the instances the rule launches:
//   64 rows, 128 keys   D 128: 189 registers (198 with FEAT), no spills;
//                       214,016 B (3 stages), one block an SM; D 32/64:
//                       155 (164-166 with FEAT); 107,520 B (3), two
//   128 rows, 64 keys   168 registers before the split (40 for the
//                       producer, 232 for the consumers), no spills;
//                       D 128: 164,864 B (4 stages); D 32/64: 82,944 B (4)
// The harness's 128-key shapes of two warpgroups spill 200-208 bytes and
// are still serialised by ptxas (C7520).
//
// f32 tier: csrc/flash_attention_tf32.cu, split-TF32 products on the same
// tensor cores (launch_dlf hands it every f32 call).
//
// Softmax: the bf16 kernel runs in log2 space (scores scaled by
// sm_scale * log2(e), exp2), the f32 kernel in natural log space with exp,
// as the two tiers of the TPU kernel do. The scale is applied in f32 to
// the scores; the TPU kernel folds it into q and rounds q back to bf16.
#include <type_traits>

#include "hopper.cuh"

namespace tk {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------ bf16 TMA + wgmma
constexpr int FA_QW = 64;  // query rows of a consumer warpgroup
// registers a thread after setmaxnreg (two consumer warpgroups): the
// producer warpgroup's 40, the consumers' 232, of the 168 a thread of a
// 384-thread block starts with
constexpr int FA_P_REGS = 40, FA_C_REGS = 232;
static_assert(128 * (168 - FA_P_REGS) >= 256 * (FA_C_REGS - 168), "budget");

// The shape of an instance: D head dim, BK keys a KV tile, NC consumer
// warpgroups, PAIR: the two warpgroups take two query heads of one GQA
// group (the same 64 rows) instead of 64 rows each of one head.
template <int D, int BK, int NC, bool PAIR>
struct FaShape {
  static_assert(!PAIR || NC == 2, "a pair is two warpgroups");
  static constexpr int DP = D < 64 ? 64 : D;  // shared row width (zeros past D)
  static constexpr int NB = DP / 64;          // 128-byte boxes a row
  // + the producer: a warp beside one consumer warpgroup; a warpgroup
  // beside two, whose setmaxnreg gives its registers to the consumers (a
  // block of 9 warps is held to 168 registers a thread, as one of 12)
  static constexpr int THREADS = NC * 128 + (NC == 2 ? 128 : 32);
  static constexpr int BQ = PAIR ? FA_QW : FA_QW * NC;  // query rows a block
  static constexpr int QWG = FA_QW * DP * 2;  // Q of a warpgroup
  static constexpr int KV = BK * DP * 2;      // K (or V) of a tile
  static constexpr int STAGE = 2 * KV;
  // one consumer warpgroup whose Q and two stages leave room for a second
  // block on the SM: a budget that keeps it; else one block an SM (3
  // stages of 128-key tiles at D 128 fit). 2 to 4 stages, + 1 KiB for the
  // alignment
  static constexpr bool TWO = NC == 1 && 1024 + QWG + 2 * STAGE <= 112 * 1024;
  static constexpr int BUDGET = (TWO ? 110 : 226) * 1024;
  static constexpr int FIT = (BUDGET - 1024 - NC * QWG) / STAGE;
  static constexpr int STAGES = FIT < 2 ? 2 : FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = 1024 + NC * QWG + STAGES * STAGE;
  static constexpr int MIN_BLOCKS = TWO ? 2 : 1;
};

// d += A . B for the scores (A, B K-major from shared memory) and for
// O (A from registers, B MN-major), at the width of d
template <int NR>
__device__ __forceinline__ void fa_mma_ss(float (&d)[NR], uint64_t da,
                                          uint64_t db) {
  static_assert(NR == 32 || NR == 64, "64 or 128 keys a tile");
  if constexpr (NR == 32) wgmma_m64n64k16_bf16<0, 0>(d, da, db);
  else wgmma_m64n128k16_bf16<0, 0>(d, da, db);
}
template <int NR>
__device__ __forceinline__ void fa_mma_rs(float (&d)[NR],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  static_assert(NR == 32 || NR == 64, "64 or 128 columns of O");
  if constexpr (NR == 32) wgmma_m64n64k16_bf16_rs<1>(d, a, db);
  else wgmma_m64n128k16_bf16_rs<1>(d, a, db);
}

// issue O += P V: V's k16 step kk is 16 rows (2048 bytes) on from vs, its
// next 64 columns a box (BK rows) on
template <int BK, int NR>
__device__ __forceinline__ void fa_pv(float (&acc)[NR],
                                      const uint32_t (&pf)[BK / 16][4],
                                      uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    fa_mma_rs(acc, pf[kk], wgmma_desc(vs + kk * 2048, BK * 128, 1024));
}

// P's registers held until the P V that reads them asynchronously is
// done (the compiler reuses no register of pf before this point)
template <int K>
__device__ __forceinline__ void fa_fence_p(uint32_t (&pf)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pf[kk][i])::"memory");
}

// a consumer warp is done with a stage: its lane 0 arrives on `empty`
__device__ __forceinline__ void fa_release(uint32_t empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// 2^x on the special-function unit, subnormal results flushed to 0 (a p
// below 2^-126 adds nothing a bf16 P or an f32 sum of p keeps)
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int BK, int NC, bool PAIR, bool LSE, bool FEAT>
__global__ void __launch_bounds__(FaShape<D, BK, NC, PAIR>::THREADS,
                                  FaShape<D, BK, NC, PAIR>::MIN_BLOCKS)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    bf16* __restrict__ o, float* __restrict__ lse, int B,
                    int Hq, int Hkv, int Sq, int Skv, float scale_log2,
                    AttnMask f) {
  using S = FaShape<D, BK, NC, PAIR>;
  extern __shared__ unsigned char fa_smem[];
  // full K, full V and empty of each stage, then Q's
  __shared__ __align__(8) uint64_t fa_bar[3 * S::STAGES + 1];
  const uint32_t q_s = (smem_u32(fa_smem) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + NC * S::QWG;  // stage s: K, then V
  const uint32_t full_k = smem_u32(fa_bar), full_v = full_k + 8 * S::STAGES;
  const uint32_t empty = full_v + 8 * S::STAGES, bar_q = empty + 8 * S::STAGES;

  // the block's (q tile, head block, batch): under causal the q tiles in
  // decreasing order, so that the longest walks start first
  const int n_qt = (Sq + S::BQ - 1) / S::BQ, n_hb = PAIR ? Hq / 2 : Hq;
  const int per = n_hb * B, rank = blockIdx.x / per;
  const int hb = blockIdx.x % per % n_hb, b = blockIdx.x % per / n_hb;
  const int q0 = (f.causal ? n_qt - 1 - rank : rank) * S::BQ;
  const int h0 = PAIR ? 2 * hb : hb, hk = h0 / (Hq / Hkv);
  const int kv_end = f.causal ? min(Skv, q0 + S::BQ) : Skv;
  const KvRange<BK> kr(f, q0, FEAT);

  // warp broadcast from lane 0: the compiler then knows every value of
  // it is warp-uniform
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NC);  // lane 0 of each consumer warp
    }
    mbar_init(bar_q, 1);
  }
  __syncthreads();

  if (warp >= 4 * NC) {  // the producer: its first thread issues every load
    if constexpr (NC == 2) warpgroup_regs_dec<FA_P_REGS>();
    if (tid != 128 * NC) return;
    mbar_arrive_tx(bar_q, NC * S::QWG);
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int bx = 0; bx < S::NB; ++bx)
        tma_load_3d(q_s + c * S::QWG + bx * FA_QW * 128, &map_q, bar_q,
                    64 * bx, PAIR ? q0 : q0 + FA_QW * c,
                    b * Hq + h0 + (PAIR ? c : 0));
    const int z = b * Hkv + hk;
    for (int k0 = kr.first(), s = 0, ph = 0; k0 < kv_end; k0 = kr.next(k0)) {
      mbar_wait(empty + 8 * s, ph ^ 1);  // the first round passes
      const uint32_t ks = kv_s + s * S::STAGE, vs = ks + S::KV;
      mbar_arrive_tx(full_k + 8 * s, S::KV);
#pragma unroll
      for (int bx = 0; bx < S::NB; ++bx)
        tma_load_3d(ks + bx * BK * 128, &map_k, full_k + 8 * s, 64 * bx, k0,
                    z);
      mbar_arrive_tx(full_v + 8 * s, S::KV);
#pragma unroll
      for (int bx = 0; bx < S::NB; ++bx)
        tma_load_3d(vs + bx * BK * 128, &map_v, full_v + 8 * s, 64 * bx, k0,
                    z);
      if (++s == S::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: rows qw0.. of head h; this thread's rows r0 and
  // r1 = r0 + 8, its columns of a tile 8j + 2qd (+1)
  if constexpr (NC == 2) warpgroup_regs_inc<FA_C_REGS>();
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, qd = lane & 3;
  const int h = h0 + (PAIR ? wg : 0);
  const int qw0 = PAIR ? q0 : q0 + FA_QW * wg;
  const int r0 = qw0 + 16 * w + g, r1 = r0 + 8;
  const int wg_end = f.causal ? min(kv_end, qw0 + FA_QW) : kv_end;
  const bool segs = FEAT && f.qseg;
  const int qs0 = segs && r0 < Sq ? f.qseg[(int64_t)b * Sq + r0] : -1;
  const int qs1 = segs && r1 < Sq ? f.qseg[(int64_t)b * Sq + r1] : -1;
  const uint32_t qa = q_s + wg * S::QWG;
  // FEAT scores are scaled (and capped) to log2 units one by one; the
  // others stay raw, their max too, and exp2 takes s * sl - m * sl in one
  // FMA (sm_scale > 0, so the raw max is the scaled one's)
  const float sl = FEAT ? 1.f : scale_log2;

  float acc[S::DP / 2];
#pragma unroll
  for (int i = 0; i < S::DP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
  // P of the last tile computed, waiting for its P V, and that tile's
  // stage
  uint32_t pf[BK / 16][4];
  int s_p = 0;
  mbar_wait(bar_q, 0);

  // Each tile after the first: issue its S = Q K^T, then the previous
  // tile's O += P V; the softmax of this tile runs while P V is on the
  // tensor cores; after it, wait for P V, release its stage, rescale O. A
  // stage is refilled once its P V is done, so the ring runs STAGES - 1
  // tiles ahead of the softmax. The tiles a warpgroup computes are a
  // prefix of the walk (those before wg_end; at least one: the walk
  // starts at or below the block's first row), the rest it only releases.
  // The first tile is peeled off and the last P V follows the loop, so
  // every pass issues the same products and waits as deep: where the
  // paths to a wgmma differ, ptxas serialises the products.
  auto softmax = [&](float (&sc)[BK / 2], int k0, float& a0, float& a1) {
    // mask; a tile every key of which this warp's rows see needs none
    const bool whole = !FEAT && k0 + BK <= Skv &&
                       (!f.causal || k0 + BK - 1 <= qw0 + 16 * w);
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int col = k0 + 8 * j + 2 * qd + c2;
        if constexpr (FEAT) {
          const int ksg = segs && col < Skv ? f.kseg[(int64_t)b * Skv + col]
                                            : 0;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& x = sc[4 * j + 2 * hh + c2];
            float t;
            const bool ok =
                col < Skv && mask_visible(f, hh ? r1 : r0, col,
                                          hh ? qs1 : qs0, ksg);
            x = ok ? soft_cap(f, x * f.scale, t) * LOG2E : NEG_BIG;
          }
        } else if (!whole) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& x = sc[4 * j + 2 * hh + c2];
            const bool ok = col < Skv && (!f.causal || col <= (hh ? r1 : r0));
            x = ok ? x : NEG_BIG;
          }
        }
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = fa_exp2((m0 - mn0) * sl);
    a1 = fa_exp2((m1 - mn1) * sl);
    const float o0 = -mn0 * sl, o1 = -mn1 * sl;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = fa_exp2(fmaf(sc[4 * j], sl, o0));
      sc[4 * j + 1] = fa_exp2(fmaf(sc[4 * j + 1], sl, o0));
      sc[4 * j + 2] = fa_exp2(fmaf(sc[4 * j + 2], sl, o1));
      sc[4 * j + 3] = fa_exp2(fmaf(sc[4 * j + 3], sl, o1));
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
  };
  // S = Q K^T of the tile in stage s (zeroed first): k16 step kk reads 32
  // bytes into the rows of box kk / 4
  auto issue_s = [&](float (&sc)[BK / 2], int s) {
    const uint32_t ks = kv_s + s * S::STAGE;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) sc[c] = 0.f;
    wgmma_fence_acc(sc);
    wgmma_fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      fa_mma_ss(sc,
                wgmma_desc(qa + (kk >> 2) * FA_QW * 128 + (kk & 3) * 32, 16,
                           1024),
                wgmma_desc(ks + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16,
                           1024));
    wgmma_commit();
  };
  // P in bf16 as the A fragments of the k16 steps of P V
  auto pack = [&](const float (&sc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pf[kk][c] = pack_f32(sc[8 * kk + 2 * c], sc[8 * kk + 2 * c + 1]);
  };
  auto next = [&](int& k0, int& s, int& ph) {
    k0 = kr.next(k0);
    if (++s == S::STAGES) {
      s = 0;
      ph ^= 1;
    }
  };

  int k0 = kr.first(), s = 0, ph = 0;
  if (Skv > 0) {  // else no tile: every row sees no key
    {  // the first tile: no P V before it, O is still 0
      float sc[BK / 2], a0, a1;
      mbar_wait(full_k + 8 * s, ph);
      issue_s(sc, s);
      wgmma_wait<0>();
      wgmma_fence_acc(sc);
      softmax(sc, k0, a0, a1);
      pack(sc);
      mbar_wait(full_v + 8 * s, ph);
      s_p = s;
      next(k0, s, ph);
    }
    while (k0 < wg_end) {
      float sc[BK / 2], a0, a1;
      mbar_wait(full_k + 8 * s, ph);
      issue_s(sc, s);
      fa_pv<BK>(acc, pf, kv_s + s_p * S::STAGE + S::KV);
      wgmma_commit();
      wgmma_wait<1>();  // S is done; P V runs on
      wgmma_fence_acc(sc);
      softmax(sc, k0, a0, a1);
      wgmma_wait<0>();  // the previous tile's P V is done: its stage is free
      wgmma_fence_acc(acc);
      fa_fence_p(pf);
      fa_release(empty + 8 * s_p);
#pragma unroll
      for (int j = 0; j < S::DP / 8; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
      }
      pack(sc);
      mbar_wait(full_v + 8 * s, ph);  // V lands while the next S runs
      s_p = s;
      next(k0, s, ph);
    }
    for (; k0 < kv_end; next(k0, s, ph)) {  // tiles past this warpgroup's rows
      mbar_wait(full_k + 8 * s, ph);
      mbar_wait(full_v + 8 * s, ph);
      fa_release(empty + 8 * s);
    }
    // the last tile's P V
    wgmma_fence_acc(acc);
    wgmma_fence();
    fa_pv<BK>(acc, pf, kv_s + s_p * S::STAGE + S::KV);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(acc);
    fa_fence_p(pf);
    fa_release(empty + 8 * s_p);
  }

  // m to log2 units (a raw max times sl)
  m0 *= sl;
  m1 *= sl;

  // a row that saw no key (segments) keeps m == NEG_BIG: output 0
  const float inv0 = l0 == 0.f || (segs && m0 <= 0.5f * NEG_BIG) ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f || (segs && m1 <= 0.5f * NEG_BIG) ? 0.f : 1.f / l1;
  if (LSE && qd == 0) {  // m is in log2 units here
    float* lb = lse + (int64_t)(b * Hq + h) * Sq;
    if (r0 < Sq) lb[r0] = LN2 * m0 + logf(fmaxf(l0, 1e-37f));
    if (r1 < Sq) lb[r1] = LN2 * m1 + logf(fmaxf(l1, 1e-37f));
  }
  bf16* ob = o + (int64_t)(b * Hq + h) * Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * qd;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r1 * D + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

// The bf16 launch of one instance: the three tensor maps (boxes of 64
// columns by 64 query rows, or by BK keys, one head deep) and a 1-D grid
// of q tiles x head blocks x batch.
template <int D, int BK, int NC, bool PAIR, bool LSE, bool FEAT>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                         const AttnMask& f, cudaStream_t stream) {
  using S = FaShape<D, BK, NC, PAIR>;
  if (PAIR && (Hq / Hkv) % 2) return cudaErrorInvalidValue;
  CUtensorMap mq{}, mk{}, mv{};
  cudaError_t e = tma_map_bf16(&mq, q, D, Sq, 2 * D, 64, FA_QW,
                               (uint64_t)B * Hq);
  // no keys: the walk loads nothing, but the maps must still encode
  const bool none = Skv == 0;
  if (e == cudaSuccess)
    e = tma_map_bf16(&mk, none ? q : k, D, none ? Sq : Skv, 2 * D, 64, BK,
                     (uint64_t)B * (none ? Hq : Hkv));
  if (e == cudaSuccess)
    e = tma_map_bf16(&mv, none ? q : v, D, none ? Sq : Skv, 2 * D, 64, BK,
                     (uint64_t)B * (none ? Hq : Hkv));
  if (e != cudaSuccess) return e;
  auto kernel = fa_fwd_wgmma_kernel<D, BK, NC, PAIR, LSE, FEAT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::SMEM);
  if (e != cudaSuccess) return e;
  const int64_t blocks =
      (int64_t)((Sq + S::BQ - 1) / S::BQ) * (PAIR ? Hq / 2 : Hq) * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, S::THREADS, S::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, B, Hq, Hkv, Sq, Skv,
      f.scale * LOG2E, f);
  return cudaGetLastError();
}

// The SMs of the current device (read once)
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

// The bf16 tile shapes, by `config`: 0 the rule's (below); 1 + (BK == 128)
// + 2 * mode, mode 0 for 64 query rows a block, 1 for 128, 2 for a GQA
// pair: the timing harness's options, built for D = 128 without LSE or
// FEAT only. The rule (ops/attention.py fwd_tiles mirrors it): where the
// blocks of 64 query rows fit in one wave of the SMs (the serving
// prefill: 128 of them at S 512), blocks of 64 rows walking 128-key tiles,
// the shortest critical path; else blocks of 128 rows (two consumer
// warpgroups, one's softmax under the other's products) walking 64-key
// tiles, the best use of an SM (PERF.md, #6 findings).
template <int D, bool LSE, bool FEAT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                        const AttnMask& f, int config, cudaStream_t stream) {
#define TK_FA(BK, NC, PAIR)                                             \
  launch_wgmma<D, BK, NC, PAIR, LSE, FEAT>(q, k, v, o, lse, B, Hq, Hkv, \
                                           Sq, Skv, f, stream)
  if (config == 0)
    return (int64_t)((Sq + 63) / 64) * Hq * B <= sm_count()
               ? TK_FA(128, 1, false)
               : TK_FA(64, 2, false);
  if constexpr (D == 128 && !LSE && !FEAT) {
    switch (config) {
      case 1: return TK_FA(64, 1, false);
      case 2: return TK_FA(128, 1, false);
      case 3: return TK_FA(64, 2, false);
      case 4: return TK_FA(128, 2, false);
      case 5: return TK_FA(64, 2, true);
      case 6: return TK_FA(128, 2, true);
    }
  }
#undef TK_FA
  return cudaErrorInvalidValue;
}

template <int D, bool LSE, bool FEAT>
cudaError_t launch_dlf(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       const AttnMask& f, int dtype, int config,
                       cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_bf16<D, LSE, FEAT>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f,
                                     config, stream);
  if (config != 0) return cudaErrorInvalidValue;
  return flash_attention_tf32_launch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, B, Hq, Hkv,
      Sq, Skv, D, f, stream);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                     const AttnMask& f, int dtype, int config,
                     cudaStream_t stream) {
  const bool feat = f.window > 0 || f.softcap > 0.f || f.qseg;
  auto go = [&](auto lse_flag, auto feat_flag) {
    return launch_dlf<D, decltype(lse_flag)::value,
                      decltype(feat_flag)::value>(
        q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, config, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (lse) return feat ? go(T{}, T{}) : go(T{}, F{});
  return feat ? go(F{}, T{}) : go(F{}, F{});
}

}  // namespace

cudaError_t flash_attention_launch(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* q_seg,
                                   const int* kv_seg, int B, int Hq, int Hkv,
                                   int Sq, int Skv, int D, float sm_scale,
                                   int causal, int window, int sinks,
                                   float softcap, int dtype, int config,
                                   cudaStream_t stream) {
  if (B < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq < 0 || Skv < 0)
    return cudaErrorInvalidValue;
  if (causal && Sq != Skv) return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  // TMA reads the operands: 16-byte aligned bases
  if (!(aligned16(q) && aligned16(k) && aligned16(v)))
    return cudaErrorInvalidValue;
  AttnMask f;
  if (!make_mask(q_seg, kv_seg, causal, window, sinks, softcap, sm_scale, &f))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  switch (D) {
    case 32: return launch_d<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, config, stream);
    case 64: return launch_d<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, config, stream);
    case 128: return launch_d<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, config, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tk
