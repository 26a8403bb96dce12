// The featured two-kernel backward for f32 inputs: #9 (dQ) and #10 (dK,
// dV) on split-TF32 products on the tensor cores, GQA inside both.
// fa_dq_tf32_kernel replaces tpukern/ops/attention_bwd.py:31 `_dq_kernel`
// (and, in the port, its transposed-layout twin `_dq_t_kernel`, :188),
// fa_dkv_tf32_kernel :110 `_dkv_kernel` (and `_dkv_t_kernel`, :261);
// csrc/flash_attention_featured_bwd.cu routes f32 here. Each output has
// one owner, so dQ, dK and dV are written once, without atomics, and the
// same bits come from run to run.
//
// Both recompute, for each visible (query, key) pair of a tile,
//   S  = Q K^T,  dP = dO V^T                                 (64 x 32)
//   s  = cap tanh(scale S / cap) = cap t          (scale S without a cap)
//   P  = exp(s - lse),  dS = P (1 - t^2) (dP - di) scale  (t = 0 uncapped)
// - #9: a block owns (batch, query head h, 64 query rows) and walks the
//   tiles of 32 keys of KV head h / group that meet its band, from the
//   tile holding max(0, q0 - window + 1) to the causal frontier
//   (attention_bwd.py:45-49), summing dQ^T += K^T dS^T in registers.
// - #10: a block owns (batch, KV head, 32 keys), keeps their K and V, and
//   walks the tiles of 64 rows of every query head of the group, from the
//   causal frontier to the last query whose window reaches the block's
//   last key, kv0 + 31 + window - 1 (attention_bwd.py:125-128), summing
//   dV^T += dO^T P and dK^T += Q^T dS in registers.
//
// The products are csrc/hopper.cuh's split-TF32 ones (tb_product): each
// f32 operand x is split into hi = x rounded to TF32 and lo, and a product
// is A_lo B_hi + A_hi B_lo + A_hi B_hi on wgmma .tf32, which reads B from
// shared memory K-major only and A from registers or shared memory:
// - S and dP take A from Q's and dO's rows, f32 copies that TMA loads as
//   they lie, split as they are read, and B from K's and V's hi and lo
//   planes, which TMA loads as f32 and the threads split in place (hi
//   where TMA wrote, lo in the next plane);
// - #9 sums dQ transposed, dQ^T = K^T dS^T, so that its A comes from K's
//   planes as they lie (read across, already split) and its B from dS's
//   planes ([q][key]): no K^T planes;
// - #10's dV^T and dK^T take A from dO's and Q's columns (split as read)
//   and B from P^T's and dS^T's planes ([key][q]), in turns in one buffer.
// Every product takes a fresh accumulator each 32 values of its
// contraction, its 8 small products first, added in f32.
//
// The two warpgroups of a block take the tiles (#9) or steps (#10) in
// turns, each the whole chain of its own: its own K and V stage (#9) or
// Q and dO buffers (#10), its own planes, and its own partial sums, added
// at the end, the second warpgroup's to the first's. So no barrier joins
// the two inside the walk, and one's products run while the other splits,
// waits for its loads, or computes P and dS. Each operand of its next
// tile or step loads by TMA as soon as it has been read for the last time
// (V, dO after dP or dV^T; K, Q at the end), and a tile or step starts
// with dP, so that K's or Q's load runs under that product. 224 KiB of
// shared memory at D 128: a block has the SM alone.
//
// Masks, as the TPU kernels' (common.cuh mask_visible, soft_cap): causal
// keeps key <= query, the window key >= query - window + 1, segments equal
// ids; keys past Skv and queries past Sq load as zeros (TMA). Each is a
// select after the arithmetic, never a multiply: a row that sees no key
// (a padding segment) has an lse near NEG_BIG, and exp(s - lse) is inf
// there.
//
// What bounds them: 3 (#9) and 4 (#10) D-deep products a visible pair, as
// 3 TF32 products each: at (B 2, Hq 16, S 1024, D 128, window 512) 9.67
// and 12.9 GFLOP, 58.6 and 78.1 µs at 495 TFLOP/s (144.3 and 192.4 on the
// CUDA cores' FMAs). Before those, the threads' own work: K and V split,
// the A fragments split as read, the softcap's tanhf and the exp.
#include "hopper.cuh"

namespace tk {
namespace {

constexpr int FT_ROWS = 64;      // query rows: #9's block, #10's step
constexpr int FT_KEYS = 32;      // keys: #9's tile, #10's block
constexpr int FT_THREADS = 256;  // two warpgroups
// the slab of S's and dP's products (tb_product's SK): 32 values at D
// 128, 8 below, where f32's own sums over D are short and its error
// small against the roundings of a longer wgmma chain
template <int D>
constexpr int FT_SLAB = D == 128 ? 32 : 8;

// P and dS of one pair from S and dP, 0 where the pair is masked (ok
// false): the scores' chain above, the selects after the arithmetic
__device__ __forceinline__ float2 ft_p_ds(const AttnMask& m, float s,
                                          float dp, float lse, float di,
                                          bool ok) {
  float t;
  const float p = expf(soft_cap(m, s * m.scale, t) - lse);
  const float pc = m.softcap > 0.f ? p * (1.f - t * t) : p;
  return make_float2(ok ? p : 0.f, ok ? pc * (dp - di) * m.scale : 0.f);
}

// x split into its planes' element at byte offset off (hi at p, lo lo
// bytes on)
__device__ __forceinline__ void ft_put(unsigned char* p, int lo, int off,
                                       float x) {
  float hi, l;
  split_tf32_finite(x, hi, l);
  *reinterpret_cast<float*>(p + off) = hi;
  *reinterpret_cast<float*>(p + lo + off) = l;
}

// the n f32 values of a tile TMA loaded at p split in place: hi there, lo
// lo bytes on; by the 128 threads of a warpgroup (wt its thread)
template <int R, int D>
__device__ __forceinline__ void ft_split(unsigned char* p, int lo, int wt) {
  for (int u = wt; u < R * D / 4; u += 128) {
    const int off = tf_off(R, u % R, 4 * (u / R));
    tf_split4(p + off, p + lo + off);
  }
}

// D / 32 boxes of 32 columns x rows of a 3-D map at (row r0, matrix z)
template <int D>
__device__ __forceinline__ void ft_load(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int rows, int r0,
                                        int z) {
#pragma unroll
  for (int bx = 0; bx < D / 32; ++bx)
    tma_load_3d(dst + bx * rows * 128, map, bar, 32 * bx, r0, z);
}

// #9: Q and dO as loaded, each warpgroup's stage (K's and V's hi and lo
// planes) and dS planes
template <int D>
struct DqShape {
  static constexpr int QR = FT_ROWS * D * 4;       // Q (or dO) as loaded
  static constexpr int KP = FT_KEYS * D * 4;       // a plane of K or V
  static constexpr int STAGE = 4 * KP;             // K hi, lo, V hi, lo
  static constexpr int DP = FT_ROWS * FT_KEYS * 4;  // a plane of dS
  static constexpr int Q_RAW = 0, DO_RAW = QR, KV = 2 * QR;
  static constexpr int DS = KV + 2 * STAGE;
  static constexpr int SMEM = 1024 + DS + 4 * DP;
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(FT_THREADS, 1)
fa_dq_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ di, float* __restrict__ dq,
                  int B, int Hq, int Hkv, int Sq, int Skv, AttnMask m) {
  using S = DqShape<D>;
  constexpr int SD = FT_SLAB<D>;
  constexpr int MB = D < 64 ? 1 : D / 64;  // blocks of 64 rows of dQ^T
  extern __shared__ unsigned char ft_smem[];
  // Q; dO; each warpgroup's K and V
  __shared__ __align__(8) uint64_t ft_bar[6];
  const uint32_t raw0 = smem_u32(ft_smem);
  const uint32_t sb0 = (raw0 + 1023) & ~1023u;
  unsigned char* const base = ft_smem + (sb0 - raw0);

  // the block's (query tile, head, batch): the tiles nearest the end
  // first, the longest walks of a causal band
  const int n_qt = (Sq + FT_ROWS - 1) / FT_ROWS, per = Hq * B;
  const int q0 = (n_qt - 1 - blockIdx.x / per) * FT_ROWS;
  const int h = blockIdx.x % per % Hq, b = blockIdx.x % per / Hq;
  const int hk = h / (Hq / Hkv);
  const int64_t bh = (int64_t)b * Hq + h;
  // the band: key tiles wholly below q0 - window + 1 or past the causal
  // frontier see none of the block's queries
  const int kv_lo =
      m.window > 0 ? max(0, q0 - m.window + 1) / FT_KEYS * FT_KEYS : 0;
  const int kv_end = m.causal ? min(Skv, q0 + FT_ROWS) : Skv;
  const int n_kt = max(0, (kv_end - kv_lo + FT_KEYS - 1) / FT_KEYS);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, qd = lane & 3;
  const int wt = tid & 127;  // the thread's place in its warpgroup
  const uint32_t bar_q = smem_u32(ft_bar), bar_do = bar_q + 8;
  const uint32_t bar_k = bar_q + 16 + 16 * wg, bar_v = bar_k + 8;
  if (tid == 0)
    for (int i = 0; i < 6; ++i) mbar_init(bar_q + 8 * i, 1);
  __syncthreads();
  // this warpgroup's stage, and key tile i's K (or V) into it
  const uint32_t st = sb0 + S::KV + wg * S::STAGE;
  unsigned char* const stp = base + (st - sb0);
  auto load_k = [&](int i) {
    mbar_arrive_tx(bar_k, S::KP);
    ft_load<D>(st, &map_k, bar_k, FT_KEYS, kv_lo + i * FT_KEYS,
               b * Hkv + hk);
  };
  auto load_v = [&](int i) {
    mbar_arrive_tx(bar_v, S::KP);
    ft_load<D>(st + 2 * S::KP, &map_v, bar_v, FT_KEYS, kv_lo + i * FT_KEYS,
               b * Hkv + hk);
  };
  if (tid == 0 && n_kt > 0) {
    mbar_arrive_tx(bar_q, S::QR);
    ft_load<D>(sb0 + S::Q_RAW, &map_q, bar_q, FT_ROWS, q0, b * Hq + h);
    mbar_arrive_tx(bar_do, S::QR);
    ft_load<D>(sb0 + S::DO_RAW, &map_do, bar_do, FT_ROWS, q0, b * Hq + h);
  }
  if (wt == 0 && wg < n_kt) {
    load_v(wg);
    load_k(wg);
  }

  // this thread's query rows in S and dP, their lse, di (0 past Sq) and
  // segment ids
  const int rl0 = 16 * w + g, rl1 = rl0 + 8;
  const int r0 = q0 + rl0, r1 = q0 + rl1;
  const float lse0 = r0 < Sq ? lse[bh * Sq + r0] : 0.f;
  const float lse1 = r1 < Sq ? lse[bh * Sq + r1] : 0.f;
  const float di0 = r0 < Sq ? di[bh * Sq + r0] : 0.f;
  const float di1 = r1 < Sq ? di[bh * Sq + r1] : 0.f;
  const int qs0 = m.qseg && r0 < Sq ? m.qseg[(int64_t)b * Sq + r0] : 0;
  const int qs1 = m.qseg && r1 < Sq ? m.qseg[(int64_t)b * Sq + r1] : 0;
  const unsigned char* const q_raw = base + S::Q_RAW;
  const unsigned char* const do_raw = base + S::DO_RAW;
  auto rows_at = [](int r, int c) { return tf_off(FT_ROWS, r, c); };
  // this warpgroup's dS planes
  const uint32_t ds_hi = sb0 + S::DS + wg * 2 * S::DP;
  unsigned char* const ds = base + (ds_hi - sb0);
  // this warpgroup's part of dQ^T: rows d = 64 mb + 16 w + g (+8),
  // columns q = 8j + 2qd (+1)
  float acc[MB][32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;

  if (wg < n_kt) {
    mbar_wait(bar_q, 0);
    mbar_wait(bar_do, 0);
  }
  // A warpgroup's next tile loads into its own stage: V as soon as dP
  // has read V's planes, K after dQ^T; so the tile starts with V (dP),
  // and K's load runs under dP's product.
  for (int i = wg; i < n_kt; i += 2) {  // the warpgroups' tiles in turns
    const int ph = (i >> 1) & 1, k0 = kv_lo + i * FT_KEYS;
    float s[FT_KEYS / 2], dp[FT_KEYS / 2];
    // dP = dO V^T, then S = Q K^T: A from dO's and Q's rows
    mbar_wait(bar_v, ph);
    ft_split<FT_KEYS, D>(stp + 2 * S::KP, S::KP, wt);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);  // V's planes are in
    tb_product<FT_KEYS, D, SD>(
        dp, true,
        [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
          tb_frag(do_raw, rows_at, rl0, 8 * kk + qd, true, hh, ll);
        },
        st + 2 * S::KP, st + 3 * S::KP, FT_KEYS);
    named_barrier_sync(1 + wg, 128);  // V's planes are read
    if (wt == 0 && i + 2 < n_kt) load_v(i + 2);
    mbar_wait(bar_k, ph);
    ft_split<FT_KEYS, D>(stp, S::KP, wt);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);  // K's planes are in
    tb_product<FT_KEYS, D, SD>(
        s, true,
        [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
          tb_frag(q_raw, rows_at, rl0, 8 * kk + qd, true, hh, ll);
        },
        st, st + S::KP, FT_KEYS);
    // dS to this warpgroup's planes ([q][key])
#pragma unroll
    for (int j = 0; j < FT_KEYS / 8; ++j) {
      int ks[2];  // the segment ids of keys 8j + 2qd and 8j + 2qd + 1
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kvi = k0 + 8 * j + 2 * qd + u;
        ks[u] = m.kseg && kvi < Skv ? m.kseg[(int64_t)b * Skv + kvi] : 0;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? r0 : r1, kvi = k0 + 8 * j + 2 * qd + (e & 1);
        const bool ok = kvi < Skv && qi < Sq &&
                        mask_visible(m, qi, kvi, e < 2 ? qs0 : qs1, ks[e & 1]);
        const float2 pd = ft_p_ds(m, s[4 * j + e], dp[4 * j + e],
                                  e < 2 ? lse0 : lse1, e < 2 ? di0 : di1, ok);
        ft_put(ds, S::DP,
               tf_off(FT_ROWS, e < 2 ? rl0 : rl1, 8 * j + 2 * qd + (e & 1)),
               pd.y);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);  // dS's planes are in

    // dQ^T += K^T dS^T over the tile's keys: A from K's planes (rows d,
    // columns key; zeros past D), B dS's planes
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int d0 = 64 * mb + rl0;
      tb_product<FT_ROWS, FT_KEYS>(
          acc[mb], false,
          [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // A's (row, column) as tb_frag's
              const int d = d0 + 8 * (e & 1);
              const int off = tf_off(FT_KEYS, 8 * kk + qd + 4 * (e >> 1), d);
              hh[e] = d < D ? *reinterpret_cast<const uint32_t*>(stp + off)
                            : 0u;
              ll[e] = d < D ? *reinterpret_cast<const uint32_t*>(
                                  stp + S::KP + off) : 0u;
            }
          },
          ds_hi, ds_hi + S::DP, FT_ROWS);
    }
    named_barrier_sync(1 + wg, 128);  // K's and dS's planes are read
    if (wt == 0 && i + 2 < n_kt) load_k(i + 2);
  }

  // dQ = warpgroup 0's sum + warpgroup 1's, which it hands over in its
  // threads' own slots of stage 0 (every load has landed and been read)
  __syncthreads();
  float* const xs = reinterpret_cast<float*>(base + S::KV);
  if (wg == 1)
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) xs[(32 * mb + i) * 128 + wt] = acc[mb][i];
  __syncthreads();
  if (wg == 1) return;
  float* const dqh = dq + bh * Sq * D;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < FT_ROWS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * mb + rl0 + 8 * (e >> 1);
        const int qi = q0 + 8 * j + 2 * qd + (e & 1);
        if (d < D && qi < Sq)
          dqh[(int64_t)qi * D + d] =
              acc[mb][4 * j + e] + xs[(32 * mb + 4 * j + e) * 128 + wt];
      }
}

// #10: K's and V's hi and lo planes, each warpgroup's Q and dO as loaded,
// and each warpgroup's planes of P^T, then of dS^T
template <int D>
struct DkvShape {
  static constexpr int KP = FT_KEYS * D * 4;        // a plane of K or V
  static constexpr int QR = FT_ROWS * D * 4;        // Q (or dO) as loaded
  static constexpr int PP = FT_KEYS * FT_ROWS * 4;  // a plane of P^T, dS^T
  static constexpr int K_HI = 0, V_HI = 2 * KP, QD = 4 * KP;
  static constexpr int T = QD + 4 * QR;
  static constexpr int SMEM = 1024 + T + 4 * PP;
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(FT_THREADS, 1)
fa_dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dk,
                   float* __restrict__ dv, int B, int Hq, int Hkv, int Sq,
                   int Skv, AttnMask m) {
  using S = DkvShape<D>;
  constexpr int SD = FT_SLAB<D>;
  constexpr int MB = D < 64 ? 1 : D / 64;  // blocks of 64 rows of dK^T, dV^T
  constexpr int NB = FT_KEYS / 2;          // their accumulators a block
  extern __shared__ unsigned char ft_smem[];
  // K and V; each warpgroup's Q and dO
  __shared__ __align__(8) uint64_t ft_bar[5];
  const uint32_t raw0 = smem_u32(ft_smem);
  const uint32_t sb0 = (raw0 + 1023) & ~1023u;
  unsigned char* const base = ft_smem + (sb0 - raw0);

  // the block's (KV tile, KV head, batch): the tiles nearest the start
  // first, the longest walks
  const int per = Hkv * B, t = blockIdx.x / per;
  const int hk = blockIdx.x % per % Hkv, b = blockIdx.x % per / Hkv;
  const int kv0 = t * FT_KEYS, group = Hq / Hkv;
  // the band: from the causal frontier to the last query whose window
  // reaches the tile's last key, kv0 + FT_KEYS - 1 + window - 1
  const int q_first = m.causal ? kv0 / FT_ROWS * FT_ROWS : 0;
  const int q_end =
      m.window > 0 ? min(Sq, kv0 + FT_KEYS - 1 + m.window) : Sq;
  const int n_qt = max(0, (q_end - q_first + FT_ROWS - 1) / FT_ROWS);
  const int steps = group * n_qt;

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, qd = lane & 3;
  const int wt = tid & 127;
  const uint32_t bar_kv = smem_u32(ft_bar);
  const uint32_t bar_q = bar_kv + 8 + 16 * wg, bar_do = bar_q + 8;
  if (tid == 0)
    for (int i = 0; i < 5; ++i) mbar_init(bar_kv + 8 * i, 1);
  __syncthreads();
  // step i's (query head, first row)
  auto step_at = [&](int i, int& h, int& q0) {
    h = hk * group + i / n_qt;
    q0 = q_first + i % n_qt * FT_ROWS;
  };
  // this warpgroup's Q and dO, and step i's Q (or dO) into them
  const uint32_t qb = sb0 + S::QD + wg * 2 * S::QR, dob = qb + S::QR;
  auto load = [&](int i, const CUtensorMap* map, uint32_t dst,
                  uint32_t bar) {
    int h, q0;
    step_at(i, h, q0);
    mbar_arrive_tx(bar, S::QR);
    ft_load<D>(dst, map, bar, FT_ROWS, q0, b * Hq + h);
  };
  if (tid == 0) {
    mbar_arrive_tx(bar_kv, 2 * S::KP);
    ft_load<D>(sb0 + S::K_HI, &map_k, bar_kv, FT_KEYS, kv0, b * Hkv + hk);
    ft_load<D>(sb0 + S::V_HI, &map_v, bar_kv, FT_KEYS, kv0, b * Hkv + hk);
  }
  if (wt == 0 && wg < steps) {
    load(wg, &map_do, dob, bar_do);
    load(wg, &map_q, qb, bar_q);
  }
  // the segment ids of this thread's keys 8j + 2qd + u, at 2j + u
  int ks[FT_KEYS / 4];
#pragma unroll
  for (int j = 0; j < FT_KEYS / 4; ++j) {
    const int kvi = kv0 + 8 * (j >> 1) + 2 * qd + (j & 1);
    ks[j] = m.kseg && kvi < Skv ? m.kseg[(int64_t)b * Skv + kvi] : 0;
  }
  // K and V split in place, by the whole block
  mbar_wait(bar_kv, 0);
  for (int u = tid; u < FT_KEYS * D / 4; u += FT_THREADS) {
    const int off = tf_off(FT_KEYS, u % FT_KEYS, 4 * (u / FT_KEYS));
    tf_split4(base + S::K_HI + off, base + S::K_HI + S::KP + off);
    tf_split4(base + S::V_HI + off, base + S::V_HI + S::KP + off);
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t k_hi = sb0 + S::K_HI, v_hi = sb0 + S::V_HI;
  const unsigned char* const q_raw = base + (qb - sb0);
  const unsigned char* const do_raw = base + (dob - sb0);
  // this warpgroup's planes: P^T's, then dS^T's ([key][q])
  const uint32_t t_hi = sb0 + S::T + wg * 2 * S::PP;
  unsigned char* const tp = base + (t_hi - sb0);
  auto rows_at = [](int r, int c) { return tf_off(FT_ROWS, r, c); };
  auto cols_at = [](int r, int c) { return tf_off(FT_ROWS, c, r); };
  // this warpgroup's parts of dV^T and dK^T: rows d = 64 mb + 16 w + g
  // (+8), columns key 8j + 2qd (+1)
  float acc_v[MB][NB], acc_k[MB][NB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < NB; ++i) acc_v[mb][i] = acc_k[mb][i] = 0.f;

  // A warpgroup's next step loads into its own buffers: dO as soon as
  // dV^T has read it, Q after dK^T; so the step starts with dO (dP), and
  // Q's load runs under dP's product.
  const int rl0 = 16 * w + g, rl1 = rl0 + 8;  // this thread's query rows
  for (int i = wg; i < steps; i += 2) {  // the warpgroups' steps in turns
    int h, q0;
    step_at(i, h, q0);
    const int64_t bh = (int64_t)b * Hq + h;
    const int r0 = q0 + rl0, r1 = q0 + rl1, ph = (i >> 1) & 1;
    const float lse0 = r0 < Sq ? lse[bh * Sq + r0] : 0.f;
    const float lse1 = r1 < Sq ? lse[bh * Sq + r1] : 0.f;
    const float di0 = r0 < Sq ? di[bh * Sq + r0] : 0.f;
    const float di1 = r1 < Sq ? di[bh * Sq + r1] : 0.f;
    const int qs0 = m.qseg && r0 < Sq ? m.qseg[(int64_t)b * Sq + r0] : 0;
    const int qs1 = m.qseg && r1 < Sq ? m.qseg[(int64_t)b * Sq + r1] : 0;

    // dP = dO V^T, then S = Q K^T: A from dO's and Q's rows
    float s[NB], dp[NB];
    mbar_wait(bar_do, ph);
    tb_product<FT_KEYS, D, SD>(
        dp, true,
        [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
          tb_frag(do_raw, rows_at, rl0, 8 * kk + qd, true, hh, ll);
        },
        v_hi, v_hi + S::KP, FT_KEYS);
    mbar_wait(bar_q, ph);
    tb_product<FT_KEYS, D, SD>(
        s, true,
        [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
          tb_frag(q_raw, rows_at, rl0, 8 * kk + qd, true, hh, ll);
        },
        k_hi, k_hi + S::KP, FT_KEYS);
    // P (in s) and dS (in dp); P^T's planes
#pragma unroll
    for (int j = 0; j < FT_KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * qd + (e & 1);
        const int qi = e < 2 ? r0 : r1, kvi = kv0 + key;
        const bool ok = kvi < Skv && qi < Sq &&
                        mask_visible(m, qi, kvi, e < 2 ? qs0 : qs1,
                                     ks[2 * j + (e & 1)]);
        const float2 pd = ft_p_ds(m, s[4 * j + e], dp[4 * j + e],
                                  e < 2 ? lse0 : lse1, e < 2 ? di0 : di1, ok);
        s[4 * j + e] = pd.x;
        dp[4 * j + e] = pd.y;
        ft_put(tp, S::PP, tf_off(FT_KEYS, key, e < 2 ? rl0 : rl1), pd.x);
      }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);  // P^T's planes are in

    // dV^T += dO^T P, then dK^T += Q^T dS: A from dO's or Q's columns, B
    // the planes
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int d0 = 64 * mb + rl0;
      tb_product<FT_KEYS, FT_ROWS>(
          acc_v[mb], false,
          [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
            tb_frag(do_raw, cols_at, d0, 8 * kk + qd, d0 < D, hh, ll);
          },
          t_hi, t_hi + S::PP, FT_KEYS);
    }
    named_barrier_sync(1 + wg, 128);  // P^T's planes and dO are read
    if (wt == 0 && i + 2 < steps) load(i + 2, &map_do, dob, bar_do);
#pragma unroll
    for (int j = 0; j < FT_KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ft_put(tp, S::PP,
               tf_off(FT_KEYS, 8 * j + 2 * qd + (e & 1), e < 2 ? rl0 : rl1),
               dp[4 * j + e]);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);  // dS^T's planes are in
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int d0 = 64 * mb + rl0;
      tb_product<FT_KEYS, FT_ROWS>(
          acc_k[mb], false,
          [&](int kk, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
            tb_frag(q_raw, cols_at, d0, 8 * kk + qd, d0 < D, hh, ll);
          },
          t_hi, t_hi + S::PP, FT_KEYS);
    }
    named_barrier_sync(1 + wg, 128);  // Q and dS^T's planes are read
    if (wt == 0 && i + 2 < steps) load(i + 2, &map_q, qb, bar_q);
  }

  // dV and dK = warpgroup 0's sum + warpgroup 1's: 0 hands over its dK^T
  // and 1 its dV^T in their threads' own slots (in the Q and dO buffers:
  // every load has landed and been read), then 0 writes dV and 1 dK
  __syncthreads();
  float* const xs = reinterpret_cast<float*>(base + S::QD);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < NB; ++i)
      xs[((wg * MB + mb) * NB + i) * 128 + wt] =
          wg == 0 ? acc_k[mb][i] : acc_v[mb][i];
  __syncthreads();
  float* const out = (wg == 0 ? dv : dk) + ((int64_t)b * Hkv + hk) * Skv * D;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < FT_KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int d = 64 * mb + rl0 + 8 * (e >> 1);
        const int kvi = kv0 + 8 * j + 2 * qd + (e & 1);
        // warpgroup 0 adds 1's dV^T (slots 1), 1 adds 0's dK^T (slots 0)
        const float other = xs[(((1 - wg) * MB + mb) * NB + i) * 128 + wt];
        if (d < D && kvi < Skv)
          out[(int64_t)kvi * D + d] =
              wg == 0 ? acc_v[mb][i] + other : other + acc_k[mb][i];
      }
}

// the four maps of a featured launch: Q and dO boxes of FT_ROWS rows, K
// and V of FT_KEYS; with no queries or no keys the empty side's maps are
// encoded over the other side's tensor, which nothing then loads
cudaError_t ft_maps(const float* q, const float* k, const float* v,
                    const float* dout, int D, int B, int Hq, int Hkv, int Sq,
                    int Skv, CUtensorMap* mq, CUtensorMap* mk,
                    CUtensorMap* mv, CUtensorMap* mdo) {
  const bool no_q = Sq == 0, no_k = Skv == 0;
  const uint64_t qz = (uint64_t)B * (no_q ? Hkv : Hq);
  const uint64_t kz = (uint64_t)B * (no_k ? Hq : Hkv);
  const int qn = no_q ? Skv : Sq, kn = no_k ? Sq : Skv;
  cudaError_t e = tma_map_f32(mq, no_q ? k : q, D, qn, 4 * D, 32, FT_ROWS, qz);
  if (e == cudaSuccess)
    e = tma_map_f32(mdo, no_q ? k : dout, D, qn, 4 * D, 32, FT_ROWS, qz);
  if (e == cudaSuccess)
    e = tma_map_f32(mk, no_k ? q : k, D, kn, 4 * D, 32, FT_KEYS, kz);
  if (e == cudaSuccess)
    e = tma_map_f32(mv, no_k ? q : v, D, kn, 4 * D, 32, FT_KEYS, kz);
  return e;
}

template <int D>
cudaError_t launch_ft(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* di,
                      float* dq, float* dk, float* dv, int B, int Hq, int Hkv,
                      int Sq, int Skv, const AttnMask& m,
                      cudaStream_t stream) {
  CUtensorMap mq{}, mk{}, mv{}, mdo{};
  cudaError_t e =
      ft_maps(q, k, v, dout, D, B, Hq, Hkv, Sq, Skv, &mq, &mk, &mv, &mdo);
  if (e != cudaSuccess) return e;
  if (dq) {  // #9: a block a (64 query rows, head, batch)
    auto kernel = fa_dq_tf32_kernel<D>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DqShape<D>::SMEM);
    if (e != cudaSuccess) return e;
    const int64_t blocks = (int64_t)((Sq + FT_ROWS - 1) / FT_ROWS) * Hq * B;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, FT_THREADS, DqShape<D>::SMEM, stream>>>(
        mq, mk, mv, mdo, lse, di, dq, B, Hq, Hkv, Sq, Skv, m);
    return cudaGetLastError();
  }
  // #10: a block a (32 keys, KV head, batch)
  auto kernel = fa_dkv_tf32_kernel<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DkvShape<D>::SMEM);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)((Skv + FT_KEYS - 1) / FT_KEYS) * Hkv * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, FT_THREADS, DkvShape<D>::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, di, dk, dv, B, Hq, Hkv, Sq, Skv, m);
  return cudaGetLastError();
}

}  // namespace

// dq (dk and dv null: #9) or dk and dv (dq null: #10); the caller has
// checked the shapes, the mask and that the output is not empty
cudaError_t flash_attention_featured_tf32_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dq, void* dk, void* dv, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, const AttnMask& m,
    cudaStream_t stream) {
  // TMA reads the operands: 16-byte aligned bases
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return cudaErrorInvalidValue;
  const float *q32 = static_cast<const float*>(q),
              *k32 = static_cast<const float*>(k),
              *v32 = static_cast<const float*>(v),
              *do32 = static_cast<const float*>(dout);
  float *dq32 = static_cast<float*>(dq), *dk32 = static_cast<float*>(dk),
        *dv32 = static_cast<float*>(dv);
  switch (D) {
    case 32: return launch_ft<32>(q32, k32, v32, do32, lse, di, dq32, dk32, dv32, B, Hq, Hkv, Sq, Skv, m, stream);
    case 64: return launch_ft<64>(q32, k32, v32, do32, lse, di, dq32, dk32, dv32, B, Hq, Hkv, Sq, Skv, m, stream);
    case 128: return launch_ft<128>(q32, k32, v32, do32, lse, di, dq32, dk32, dv32, B, Hq, Hkv, Sq, Skv, m, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tk
