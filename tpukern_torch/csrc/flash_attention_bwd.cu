// The fused FlashAttention-2 backward (#8): split-TF32 products on the
// tensor cores, GQA inside the kernel. It replaces
// tpukern/ops/attention_bwd.py:339 `_bwd_fused_kernel` for f32 inputs;
// flash_attention_bwd_launch hands bf16 ones to the bf16 wgmma kernel of
// csrc/flash_attention_bwd_bf16.cu.
//
// A block owns (batch, KV head, a tile of TB_BKV keys): it keeps the
// tile's K and V in shared memory and walks the Q tiles (TB_BQ rows) of
// every query head of the KV head's group, each from the causal frontier
// on. For each it recomputes, rows = queries:
//   S  = Q K^T,  dP = dO V^T                       (64 x 32)
//   P  = exp(scale S - lse),  dS = P (dP - di) scale
//   dQ += dS K        (added to a zeroed f32 dq by 16-byte atomics)
//   dV += P^T dO,  dK += dS^T Q   (in registers, as dV^T and dK^T)
// so dK and dV, summed over the group's heads in registers, are written
// once, and K and V are read once: no copy of them for GQA. dQ is the
// FA-2 design's: a separate dQ pass would recompute P and dP (two more of
// the five D-deep products) where the atomics cost one 16-byte reduction
// per four (q, d) per KV tile; its summation order varies from run to run,
// so the tests compare dq with the plain version at a tolerance, never
// two kernel runs bit for bit (dk and dv are bit-stable).
//
// The products. Each f32 operand x is split into hi = x rounded to TF32
// and lo = x - hi, and a product is A_lo B_hi + A_hi B_lo + A_hi B_hi on
// wgmma .tf32 (csrc/hopper.cuh), which reads shared-memory operands
// K-major only and has no transpose bit, and whose A may come from
// registers. So:
// - the B operands live as hi and lo planes: K and V ([key][d]) for S and
//   dP, K^T ([d][key], keys in tf_perm order) for dQ, and each step's P^T
//   and dS^T ([key][q]) for dV^T and dK^T, written there by the threads
//   from their accumulators;
// - the A operands come from registers, split there: Q and dO for S and
//   dP, and Q^T and dO^T for dK^T and dV^T, read from one copy of Q and of
//   dO that TMA loads as they lie (f32, [q][d]) into shared memory; and dS
//   for dQ straight from its accumulator (tf_frag: hence K^T's key order).
// Q and dO of the next step load while this step's last products run.
// wgmma's M is 64: dV^T and dK^T take D rows in blocks of 64 (D 32: one
// block, its rows 32-63 zeros).
//
// The sums. wgmma rounds its accumulator after every k8 product, and not
// to nearest (PERF.md §6): every product takes a fresh accumulator
// each 32 values of its contraction (its 8 small products first), two in
// turns, added in f32 into the step's sums; dV^T and dK^T add each step's
// into registers. A model of these roundings on the CPU put dq, dk and dv
// at 0.8x, 0.6x and 0.4x the plain f32 version's error against f64, where
// one accumulator over each D-deep product gave up to 1.9x (the gate is
// 2x, ops/split_tf32.py SPLIT_GATE); on an H100, 0.24-0.90x (PERF.md
// §6).
//
// Masks, as the TPU kernel's: causal keeps key <= query; keys at or past
// Skv and queries at or past Sq load as zeros (TMA), and P and dS are
// selected to 0 there, since lse and di of a padded query are undefined.
//
// The block is two warpgroups that split each step: warpgroup 0 computes
// S, P and dV^T, warpgroup 1 dP, dS and dK^T, and dQ is shared at D 128
// (P passes through shared memory as it lies in the accumulators, dS as
// dS^T's planes); each writes the output it summed. K, V, K^T and a step's operands take 208 KiB of shared memory
// at D 128, so a block has the SM alone, and two warps share each
// scheduler.
//
// What bounds it: 5 D-deep products a visible pair, 10 D flops, as 3 TF32
// products each: at (B 2, Hq 16, S 1024, D 128, causal) 21.5 GFLOP, 130 µs
// at 495 TFLOP/s (321 µs on the CUDA cores' FMAs). Before those, the
// threads' own work: every A fragment split from f32 as it is read (256
// values a thread a step), and P and dS split into their planes.
#include "hopper.cuh"

namespace tk {
namespace {

constexpr int TB_BKV = 32;   // keys a block
constexpr int TB_BQ = 64;    // query rows a step
constexpr int TB_THREADS = 256;  // two warpgroups

// K's, V's and K^T's planes, Q and dO as loaded, P^T's and dS^T's
// planes, and P as it lies in warpgroup 0's accumulators
template <int D>
struct TbShape {
  static constexpr int KP = TB_BKV * D * 4;    // a plane of K, V or K^T
  static constexpr int QR = TB_BQ * D * 4;     // Q (or dO) as loaded
  static constexpr int PP = TB_BKV * TB_BQ * 4;  // a plane of P^T or dS^T
  static constexpr int K_HI = 0, V_HI = 2 * KP, KT_HI = 4 * KP;
  static constexpr int Q_RAW = 6 * KP, DO_RAW = Q_RAW + QR;
  static constexpr int PT_HI = DO_RAW + QR, DST_HI = PT_HI + 2 * PP;
  static constexpr int P_X = DST_HI + 2 * PP;  // two: steps in turns
  static constexpr int SMEM = 1024 + P_X + 2 * PP;
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// acc = dS K over the block's 32 keys at NQ columns of dQ: A (dS) as the
// k8 fragments h, l (keys in tf_frag's order), B K^T's rows from kt
// (its hi plane; lo TbShape::KP on), the small products first
template <int NQ, int KP>
__device__ __forceinline__ void tb_dq_mma(float (&acc)[NQ / 2],
                                          uint32_t (&h)[TB_BKV / 8][4],
                                          uint32_t (&l)[TB_BKV / 8][4],
                                          uint32_t kt, int kt_rows) {
  wgmma_fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TB_BKV / 8; ++kk) {
    tb_mma<NQ>(acc, l[kk], tf_desc(kt, kt_rows, kk), kk > 0);
    tb_mma<NQ>(acc, h[kk], tf_desc(kt + KP, kt_rows, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < TB_BKV / 8; ++kk)
    tb_mma<NQ>(acc, h[kk], tf_desc(kt, kt_rows, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_acc(acc);
  tf_fence_frag(h);
  tf_fence_frag(l);
}

// acc (a 64 x NQ tile of dQ, rows q0 + 16w + g (+8)) added to dq (rows
// of D floats from dqh, its first column there): lanes qd and qd ^ 1
// trade halves, so the even one adds columns c..c+3 of row r0 and the odd
// one those of row r1, one 16-byte reduction each
template <int NQ>
__device__ __forceinline__ void tb_dq_add(const float (&acc)[NQ / 2],
                                          float* dqh, int Sq, int D, int r0,
                                          int r1, int qd) {
  const bool odd = qd & 1;
  const int r = odd ? r1 : r0;
  float* dqr = dqh + (int64_t)r * D + 2 * (qd & 2);
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    const float give0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float give1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
    const float got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
    const float4 add =
        odd ? make_float4(got0, got1, acc[4 * j + 2], acc[4 * j + 3])
            : make_float4(acc[4 * j], acc[4 * j + 1], got0, got1);
    if (r < Sq) atomicAdd(reinterpret_cast<float4*>(dqr + 8 * j), add);
  }
}

template <int D>
__global__ void __launch_bounds__(TB_THREADS, 1)
fa_bwd_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dq,
                   float* __restrict__ dk, float* __restrict__ dv, int B,
                   int Hq, int Hkv, int Sq, int Skv, float scale,
                   int causal) {
  using S = TbShape<D>;
  constexpr int MB = D < 64 ? 1 : D / 64;  // blocks of 64 rows of dK^T, dV^T
  constexpr int NB = TB_BKV / 2;           // their accumulators a block
  extern __shared__ unsigned char tb_smem[];
  __shared__ __align__(8) uint64_t tb_bar[3];  // K and V; Q; dO
  const uint32_t raw0 = smem_u32(tb_smem);
  const uint32_t sb0 = (raw0 + 1023) & ~1023u;
  unsigned char* const base = tb_smem + (sb0 - raw0);
  const uint32_t bar_kv = smem_u32(tb_bar), bar_q = bar_kv + 8,
                 bar_do = bar_kv + 16;

  // the block's (KV tile, KV head, batch): the tiles nearest the start
  // first, the longest causal walks
  const int per = Hkv * B, t = blockIdx.x / per;
  const int hk = blockIdx.x % per % Hkv, b = blockIdx.x % per / Hkv;
  const int kv0 = t * TB_BKV, group = Hq / Hkv;
  const int q_first = causal ? kv0 / TB_BQ * TB_BQ : 0;
  const int n_qt = (Sq - q_first + TB_BQ - 1) / TB_BQ;
  const int steps = group * n_qt;

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, qd = lane & 3;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_q, 1);
    mbar_init(bar_do, 1);
  }
  __syncthreads();
  // step i's (query head, first row)
  auto step_at = [&](int i, int& h, int& q0) {
    h = hk * group + i / n_qt;
    q0 = q_first + i % n_qt * TB_BQ;
  };
  // Q (or dO) of step i by TMA
  auto load = [&](const CUtensorMap* map, uint32_t bar, int off, int i) {
    int h, q0;
    step_at(i, h, q0);
    mbar_arrive_tx(bar, S::QR);
#pragma unroll
    for (int bx = 0; bx < D / 32; ++bx)
      tma_load_3d(sb0 + off + bx * TB_BQ * 128, map, bar, 32 * bx, q0,
                  b * Hq + h);
  };
  if (tid == 0) {
    mbar_arrive_tx(bar_kv, 2 * TB_BKV * D * 4);
#pragma unroll
    for (int bx = 0; bx < D / 32; ++bx) {
      tma_load_3d(sb0 + S::K_HI + bx * TB_BKV * 128, &map_k, bar_kv, 32 * bx,
                  kv0, b * Hkv + hk);
      tma_load_3d(sb0 + S::V_HI + bx * TB_BKV * 128, &map_v, bar_kv, 32 * bx,
                  kv0, b * Hkv + hk);
    }
    if (steps > 0) {
      load(&map_q, bar_q, S::Q_RAW, 0);
      load(&map_do, bar_do, S::DO_RAW, 0);
    }
  }
  // K and V split in place (lo in the next plane), K^T written beside
  mbar_wait(bar_kv, 0);
  for (int u = tid; u < TB_BKV * D / 4; u += TB_THREADS) {
    const int key = u % TB_BKV, c = 4 * (u / TB_BKV);
    const int off = tf_off(TB_BKV, key, c);
    const float4 x = *reinterpret_cast<const float4*>(base + S::K_HI + off);
    tf_split4(base + S::K_HI + off, base + S::K_HI + S::KP + off);
    tf_split4(base + S::V_HI + off, base + S::V_HI + S::KP + off);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float hi, lo;
      split_tf32_finite(xs[e], hi, lo);
      const int o2 = tf_off(D, c + e, tf_perm(key));
      *reinterpret_cast<float*>(base + S::KT_HI + o2) = hi;
      *reinterpret_cast<float*>(base + S::KT_HI + S::KP + o2) = lo;
    }
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t k_hi = sb0 + S::K_HI, v_hi = sb0 + S::V_HI,
                 kt_hi = sb0 + S::KT_HI, pt_hi = sb0 + S::PT_HI,
                 dst_hi = sb0 + S::DST_HI;
  const unsigned char* const q_raw = base + S::Q_RAW;
  const unsigned char* const do_raw = base + S::DO_RAW;
  float* const p_xs = reinterpret_cast<float*>(base + S::P_X);
  auto rows_at = [](int r, int c) { return tf_off(TB_BQ, r, c); };
  auto cols_at = [](int r, int c) { return tf_off(TB_BQ, c, r); };
  // this warpgroup's dK^T (warpgroup 1) or dV^T (0): rows d = 64 mb +
  // 16 w + g (+8), columns key 8j + 2qd (+1)
  float acc_t[MB][NB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < NB; ++i) acc_t[mb][i] = 0.f;

  // The two warpgroups split each step: warpgroup 0 takes S, P (to
  // shared memory: P^T's planes, and P as it lies for warpgroup 1) and
  // dV^T += dO^T P; warpgroup 1 takes dP, dS (dS^T's planes), dK^T +=
  // Q^T dS and dQ += dS K. They meet once a step, where P is written
  // (barrier 1). Each loads the next step's operand it read last: dO
  // after dV^T (warpgroup 1 read it before barrier 1), Q after dK^T (0
  // read it before), so no warpgroup waits for the other's last product.
  // P goes through two buffers in turns: warpgroup 0 writes step i + 2's
  // only after barrier 1 of step i + 1, which warpgroup 1 reaches after
  // reading step i's.
  const int rl0 = 16 * w + g, rl1 = rl0 + 8;  // this thread's query rows
  for (int i = 0; i < steps; ++i) {
    int h, q0;
    step_at(i, h, q0);
    const int64_t bh = (int64_t)b * Hq + h;
    const int r0 = q0 + rl0, r1 = q0 + rl1;
    // row r's statistic (lse for warpgroup 0, di for 1), 0 past Sq
    const float* stat = (wg == 0 ? lse : di) + bh * Sq;
    const float st0 = r0 < Sq ? stat[r0] : 0.f;
    const float st1 = r1 < Sq ? stat[r1] : 0.f;
    mbar_wait(wg == 0 ? bar_q : bar_do, i & 1);
    float* const p_x = p_xs + (i & 1) * (S::PP / 4);

    // S = Q K^T (0) or dP = dO V^T (1): A from Q's or dO's rows
    float s[NB];
    const unsigned char* const a_rows = wg == 0 ? q_raw : do_raw;
    tb_product<TB_BKV, D>(
        s, true,
        [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
          tb_frag(a_rows, rows_at, rl0, 8 * kk + qd, true, hh, ll);
        },
        wg == 0 ? k_hi : v_hi, (wg == 0 ? k_hi : v_hi) + S::KP, TB_BKV);
    // P, and dS = P (dP - di) scale, zero where a pair is masked; their
    // transposes' planes ([key][q]) to shared memory
    const uint32_t t_hi = wg == 0 ? pt_hi : dst_hi;
    unsigned char* const tp = base + (t_hi - sb0);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < TB_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * qd + (e & 1);
          const int qi = q0 + (e < 2 ? rl0 : rl1), kvi = kv0 + key;
          const bool ok = kvi < Skv && qi < Sq && (!causal || kvi <= qi);
          const float p = expf(s[4 * j + e] * scale - (e < 2 ? st0 : st1));
          s[4 * j + e] = ok ? p : 0.f;
          p_x[(4 * j + e) * 128 + tid] = s[4 * j + e];
        }
    }
    named_barrier_sync(1, TB_THREADS);  // P is in shared memory
    if (wg == 1) {
#pragma unroll
      for (int i2 = 0; i2 < NB; ++i2)
        s[i2] = p_x[i2 * 128 + tid - 128] *
                (s[i2] - (i2 % 4 < 2 ? st0 : st1)) * scale;
    }
#pragma unroll
    for (int j = 0; j < TB_BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = tf_off(TB_BKV, 8 * j + 2 * qd + (e & 1),
                               e < 2 ? rl0 : rl1);
        float hi, lo;
        split_tf32_finite(s[4 * j + e], hi, lo);
        *reinterpret_cast<float*>(tp + off) = hi;
        *reinterpret_cast<float*>(tp + S::PP + off) = lo;
      }
    fence_proxy_async();
    named_barrier_sync(2 + wg, 128);  // this warpgroup's planes are in
    if constexpr (D == 128)  // warpgroup 0 reads dS^T's for its dQ
      if (wg == 1) named_barrier_arrive(5, TB_THREADS);

    // dV^T += dO^T P (0) or dK^T += Q^T dS (1): A from dO's or Q's
    // columns, B the planes just written
    const unsigned char* const a_cols = wg == 0 ? do_raw : q_raw;
    mbar_wait(wg == 0 ? bar_do : bar_q, i & 1);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int d0 = 64 * mb + rl0;
      tb_product<TB_BKV, TB_BQ>(
          acc_t[mb], false,
          [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
            tb_frag(a_cols, cols_at, d0, 8 * kk + qd, d0 < D, hh, ll);
          },
          t_hi, t_hi + S::PP, TB_BKV);
    }
    named_barrier_sync(2 + wg, 128);  // this warpgroup's last read
    if (i + 1 < steps) {
      if (tid == 0) load(&map_do, bar_do, S::DO_RAW, i + 1);
      if (tid == 128) load(&map_q, bar_q, S::Q_RAW, i + 1);
    }
    // dQ += dS K (one slab of 32 keys), added to dq: at D 128 warpgroup 0
    // takes columns 0-63 with dS read from dS^T's planes (split there),
    // warpgroup 1 columns 64-127 with dS from its registers; else 1 all
    float* const dqh = dq + bh * Sq * D;
    if (wg == 0) {
      if constexpr (D == 128) {
        named_barrier_sync(5, TB_THREADS);  // dS^T's planes are in
        uint32_t ah[TB_BKV / 8][4], al[TB_BKV / 8][4];
#pragma unroll
        for (int kk = 0; kk < TB_BKV / 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // A's (row, column) as tf_frag's
            const int off = tf_off(TB_BKV, 8 * kk + 2 * qd + (e >> 1),
                                   rl0 + 8 * (e & 1));
            ah[kk][e] = *reinterpret_cast<const uint32_t*>(
                base + S::DST_HI + off);
            al[kk][e] = *reinterpret_cast<const uint32_t*>(
                base + S::DST_HI + S::PP + off);
          }
        float acc[32];
        tb_dq_mma<64, S::KP>(acc, ah, al, kt_hi, D);
        tb_dq_add<64>(acc, dqh, Sq, D, r0, r1, qd);
      }
      continue;
    }
    constexpr int NQ = D == 128 ? 64 : D;  // warpgroup 1's columns of dQ
    uint32_t dsh[TB_BKV / 8][4], dsl[TB_BKV / 8][4];
    tf_frag(s, dsh, dsl);
    float acc[NQ / 2];
    tb_dq_mma<NQ, S::KP>(acc, dsh, dsl, kt_hi + (D - NQ) * 128, D);
    tb_dq_add<NQ>(acc, dqh + (D - NQ), Sq, D, r0, r1, qd);
  }

  // dV (warpgroup 0) and dK (1): each row d of the transposes a column
  float* const out = (wg == 0 ? dv : dk) + ((int64_t)b * Hkv + hk) * Skv * D;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < TB_BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * mb + rl0 + 8 * (e >> 1);
        const int kvi = kv0 + 8 * j + 2 * qd + (e & 1);
        if (d < D && kvi < Skv)
          out[(int64_t)(kv0 + 8 * j + 2 * qd + (e & 1)) * D + d] =
              acc_t[mb][4 * j + e];
      }
}

template <int D>
cudaError_t launch_bwd_tf32(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* di, float* dq, float* dk, float* dv,
                            int B, int Hq, int Hkv, int Sq, int Skv,
                            float scale, int causal, cudaStream_t stream) {
  using S = TbShape<D>;
  CUtensorMap mq{}, mk{}, mv{}, mdo{};
  // no queries: nothing loads Q or dO, but the maps must still encode
  const bool none = Sq == 0;
  const uint64_t qz = (uint64_t)B * (none ? Hkv : Hq);
  const int qn = none ? Skv : Sq;
  cudaError_t e = tma_map_f32(&mq, none ? k : q, D, qn, 4 * D, 32, TB_BQ, qz);
  if (e == cudaSuccess)
    e = tma_map_f32(&mdo, none ? k : dout, D, qn, 4 * D, 32, TB_BQ, qz);
  if (e == cudaSuccess)
    e = tma_map_f32(&mk, k, D, Skv, 4 * D, 32, TB_BKV, (uint64_t)B * Hkv);
  if (e == cudaSuccess)
    e = tma_map_f32(&mv, v, D, Skv, 4 * D, 32, TB_BKV, (uint64_t)B * Hkv);
  if (e != cudaSuccess) return e;
  auto kernel = fa_bwd_tf32_kernel<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::SMEM);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)((Skv + TB_BKV - 1) / TB_BKV) * Hkv * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, TB_THREADS, S::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, di, dq, dk, dv, B, Hq, Hkv, Sq, Skv, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

cudaError_t flash_attention_bwd_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* di,
                                       float* dq, void* dk, void* dv, int B,
                                       int Hq, int Hkv, int Sq, int Skv, int D,
                                       float sm_scale, int causal, int dtype,
                                       cudaStream_t stream) {
  if (B < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq < 0 || Skv < 0)
    return cudaErrorInvalidValue;
  if (causal && Sq != Skv) return cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (B == 0 || Skv == 0) return cudaSuccess;
  // TMA reads the operands: 16-byte aligned bases
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return cudaErrorInvalidValue;
  if (dtype == kBF16)  // csrc/flash_attention_bwd_bf16.cu
    return flash_attention_bwd_bf16_launch(q, k, v, dout, lse, di, dq, dk, dv,
                                           B, Hq, Hkv, Sq, Skv, D, sm_scale,
                                           causal, stream);
  const float *q32 = static_cast<const float*>(q),
              *k32 = static_cast<const float*>(k),
              *v32 = static_cast<const float*>(v),
              *do32 = static_cast<const float*>(dout);
  float *dk32 = static_cast<float*>(dk), *dv32 = static_cast<float*>(dv);
  switch (D) {
    case 32: return launch_bwd_tf32<32>(q32, k32, v32, do32, lse, di, dq, dk32, dv32, B, Hq, Hkv, Sq, Skv, sm_scale, causal, stream);
    case 64: return launch_bwd_tf32<64>(q32, k32, v32, do32, lse, di, dq, dk32, dv32, B, Hq, Hkv, Sq, Skv, sm_scale, causal, stream);
    case 128: return launch_bwd_tf32<128>(q32, k32, v32, do32, lse, di, dq, dk32, dv32, B, Hq, Hkv, Sq, Skv, sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tk
