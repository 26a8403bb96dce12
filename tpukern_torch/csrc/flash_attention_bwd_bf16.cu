// The fused FlashAttention-2 backward (#8), bf16 tier: bf16 wgmma with
// f32 accumulators, GQA inside the kernel. It replaces
// tpukern/ops/attention_bwd.py:339 `_bwd_fused_kernel` for bf16 inputs
// and computes what that kernel computes for them (use_exp2 there):
//   S  = Q K^T (bf16 operands, f32 sums),  dP = dO V^T (exact products)
//   P  = exp(scale S - lse), rounded to bf16 for dV = P^T dO (:426)
//   dS = P (dP - di) scale (P in f32), rounded to bf16 for dK = dS^T Q
//        and dQ = dS K (:440, :445)
// with the TPU kernel's masks (causal keeps key <= query; zeros past Sq
// and Skv). The f32 tier is csrc/flash_attention_bwd.cu.
//
// A block owns (batch, KV head, a tile of BB_BKV = 64 keys): it keeps the
// tile's K and V in shared memory and walks the Q tiles (BB_BQ = 64 rows)
// of every query head of the KV head's group, each from the causal
// frontier on; dK and dV, summed over the group's heads in registers, are
// written once, and K and V are read once: no copy of them for GQA. The
// keys are wgmma's M (FA3's backward layout): S and dP are computed
// transposed, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T lie in the
// accumulators where the register-A operand of the next product wants
// them (hopper.cuh wgmma_m64n{64,128}k16_bf16_rs):
//   dV += P^T dO and dK += dS^T Q, B = dO or Q read MN-major (the
//   transpose-B bit) from the tiles TMA loaded as they lie ([q][d]);
//   dQ  = dS K, A = dS^T staged in shared memory as bf16 ([key][q]) read
//   with the transpose-A bit, B = K's tile with the transpose-B bit,
//   added to a zeroed f32 dq by 16-byte atomics (FA-2's dQ: a separate
//   pass would recompute S and dP; the sums' order varies from run to
//   run, so the tests compare dq with the plain version at a tolerance,
//   never two runs bit for bit; dk and dv are bit-stable).
//
// Two warpgroups share each step, and issue the same wgmma instructions
// on different operands (where the paths to a wgmma differ, ptxas
// serialises them all): warpgroup 0 computes S^T, P (to shared memory as
// it lies, f32, for warpgroup 1) and dV; warpgroup 1 dP^T, dS (to shared
// memory, bf16) and dK; at D 128 each adds 64 columns of dQ (at D 32 and
// 64 warpgroup 1 repeats warpgroup 0's product and drops it). They meet
// once a step, where P is written. Q and dO go through two stages each,
// by TMA (3-D tensor maps over (D, S, B H): a box never reaches into the
// next head, rows past S arrive as zeros; D 32 loads as a 64-column box
// whose columns past 32 are zeros): each warpgroup loads, at the start of
// a step, the next step's copy of the operand it read last (warpgroup 0
// dO, warpgroup 1 Q), into the stage of the step before, which both are
// done with once they have met at that step's P.
//
// What bounds it: 5 D-deep products a visible (query, key) pair, 10 D
// flops: at (B 2, Hq 16, Hkv 8, S 1024, D 128, causal) 21.5 GFLOP, 21.7
// us at 989 TFLOP/s. Under causal the tiles near the start walk the most
// rows; they launch first. What it takes is latency: a step (a 64 x 64
// tile of a head) holds 0.7 us of products at the bf16 rate, and took
// about 4.8K cycles on an H100 (clock64 per phase, PERF.md §6):
// the dQ additions and the waits behind them about half of it, the
// first product and the softmax or dS most of the rest. Two blocks an SM
// (one stage of Q and dO), dQ by bulk reductions, 128 query rows a step
// and the next step's first product issued under this step's dQ were
// tried and gained nothing.
#include "hopper.cuh"

namespace tk {
namespace {

constexpr int BB_BKV = 64;       // keys a block
constexpr int BB_BQ = 64;        // query rows a step
constexpr int BB_THREADS = 256;  // two warpgroups
constexpr int BB_BOX = 64 * 128;  // a 64-row box of 64 bf16 columns: 8 KiB
constexpr float BB_LOG2E = 1.4426950408889634f;

// shared memory: K, V, two stages of Q and of dO (each DP / 64 boxes),
// dS^T (one box), P as it lies (f32; warpgroup 0 writes the next step's
// only after barrier 5, which warpgroup 1 reaches once it has read it)
template <int D>
struct BbShape {
  static constexpr int DP = D < 64 ? 64 : D;  // columns a row (zeros past D)
  static constexpr int NB = DP / 64;          // boxes a tile
  static constexpr int TILE = NB * BB_BOX;
  static constexpr int K_OFF = 0, V_OFF = TILE, Q_OFF = 2 * TILE;
  static constexpr int DO_OFF = 4 * TILE, DS_OFF = 6 * TILE;
  static constexpr int PX_OFF = DS_OFF + BB_BOX;
  static constexpr int SMEM = 1024 + PX_OFF + BB_BKV * BB_BQ * 4;
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

// d (+)= A B, both from shared memory, K-major (TA = TB = 0: S^T, dP^T)
// or MN-major (1, 1: dQ), 64 columns
template <int TA, int TB>
__device__ __forceinline__ void bb_ss(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  wgmma_m64n64k16_bf16<TA, TB>(d, da, db);
}
// d += A B at DP columns, A from registers, B MN-major (dV, dK)
template <int NR>
__device__ __forceinline__ void bb_rs(float (&d)[NR], const uint32_t (&a)[4],
                                      uint64_t db) {
  if constexpr (NR == 32) wgmma_m64n64k16_bf16_rs<1>(d, a, db);
  else wgmma_m64n128k16_bf16_rs<1>(d, a, db);
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float bb_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc (a 64 x 64 tile of dQ, rows q0 + 16w + g (+8)) added to dq (rows of
// D floats from dqh, its first column there; columns past `cols` left
// out): lanes qd and qd ^ 1 trade halves, so the even one adds columns
// c..c+3 of row r0 and the odd one those of row r1, one 16-byte reduction
// each
__device__ __forceinline__ void bb_dq_add(const float (&acc)[32], float* dqh,
                                          int Sq, int D, int cols, int r0,
                                          int r1, int qd) {
  const bool odd = qd & 1;
  const int r = odd ? r1 : r0;
  float* dqr = dqh + (int64_t)r * D + 2 * (qd & 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float give0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float give1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
    const float got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
    const float4 add =
        odd ? make_float4(got0, got1, acc[4 * j + 2], acc[4 * j + 3])
            : make_float4(acc[4 * j], acc[4 * j + 1], got0, got1);
    if (r < Sq && 8 * j < cols)
      atomicAdd(reinterpret_cast<float4*>(dqr + 8 * j), add);
  }
}

template <int D>
__global__ void __launch_bounds__(BB_THREADS, 1)
fa_bwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dq,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                   int Hq, int Hkv, int Sq, int Skv, float scale,
                   int causal) {
  using S = BbShape<D>;
  constexpr int NA = S::DP / 2;  // dV's or dK's accumulators a thread
  extern __shared__ unsigned char bb_smem[];
  // K and V; Q's two stages; dO's two stages
  __shared__ __align__(8) uint64_t bb_bar[5];
  const uint32_t raw0 = smem_u32(bb_smem);
  const uint32_t sb0 = (raw0 + 1023) & ~1023u;
  unsigned char* const base = bb_smem + (sb0 - raw0);
  const uint32_t bar_kv = smem_u32(bb_bar), bar_q = bar_kv + 8,
                 bar_do = bar_kv + 24;

  // the block's (KV tile, KV head, batch): the tiles nearest the start
  // first, the longest causal walks
  const int per = Hkv * B, t = blockIdx.x / per;
  const int hk = blockIdx.x % per % Hkv, b = blockIdx.x % per / Hkv;
  const int kv0 = t * BB_BKV, group = Hq / Hkv;
  const int q_first = causal ? kv0 / BB_BQ * BB_BQ : 0;
  const int n_qt = (Sq - q_first + BB_BQ - 1) / BB_BQ;
  const int steps = group * n_qt;

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, qd = lane & 3;
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_kv + 8 * i, 1);
  }
  __syncthreads();
  // step i's (query head, first row)
  auto step_at = [&](int i, int& h, int& q0) {
    h = hk * group + i / n_qt;
    q0 = q_first + i % n_qt * BB_BQ;
  };
  // Q (or dO) of step i by TMA into its stage (i & 1)
  auto load = [&](const CUtensorMap* map, uint32_t bar, int off, int i) {
    int h, q0;
    step_at(i, h, q0);
    const uint32_t st = i & 1;
    mbar_arrive_tx(bar + 8 * st, S::TILE);
#pragma unroll
    for (int bx = 0; bx < S::NB; ++bx)
      tma_load_3d(sb0 + off + st * S::TILE + bx * BB_BOX, map, bar + 8 * st,
                  64 * bx, q0, b * Hq + h);
  };
  if (tid == 0) {
    mbar_arrive_tx(bar_kv, 2 * S::TILE);
#pragma unroll
    for (int bx = 0; bx < S::NB; ++bx) {
      tma_load_3d(sb0 + S::K_OFF + bx * BB_BOX, &map_k, bar_kv, 64 * bx, kv0,
                  b * Hkv + hk);
      tma_load_3d(sb0 + S::V_OFF + bx * BB_BOX, &map_v, bar_kv, 64 * bx, kv0,
                  b * Hkv + hk);
    }
    if (steps > 0) {
      load(&map_q, bar_q, S::Q_OFF, 0);
      load(&map_do, bar_do, S::DO_OFF, 0);
    }
  }
  mbar_wait(bar_kv, 0);

  // warpgroup 0: S^T from K and Q, dV from dO; warpgroup 1: dP^T from V
  // and dO, dK from Q
  const uint32_t a1 = sb0 + (wg == 0 ? S::K_OFF : S::V_OFF);
  const int b1_off = wg == 0 ? S::Q_OFF : S::DO_OFF;
  const int b2_off = wg == 0 ? S::DO_OFF : S::Q_OFF;
  const uint32_t bar1 = wg == 0 ? bar_q : bar_do;  // the first product's B
  const uint32_t bar2 = wg == 0 ? bar_do : bar_q;  // the second's
  const uint32_t ds_s = sb0 + S::DS_OFF;
  float* const p_x = reinterpret_cast<float*>(base + S::PX_OFF);
  // this thread's keys (rows of the transposed tiles)
  const int kr0 = kv0 + 16 * w + g, kr1 = kr0 + 8;
  // dV (warpgroup 0) or dK (1): rows key kr0 / kr1, columns d 8j + 2qd (+1)
  float acc2[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc2[i] = 0.f;
  const float c_log2 = scale * BB_LOG2E;
  // the statistic of step i at this thread's 16 query columns (lse for
  // warpgroup 0, di for 1), 0 past Sq: columns q0 + 8j + 2qd (+1)
  auto load_stat = [&](int i, float (&v)[16]) {
    int h, q0;
    step_at(i, h, q0);
    const float* stat = (wg == 0 ? lse : di) + ((int64_t)b * Hq + h) * Sq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = q0 + 8 * j + 2 * qd;
      v[2 * j] = c < Sq ? stat[c] : 0.f;
      v[2 * j + 1] = c + 1 < Sq ? stat[c + 1] : 0.f;
    }
  };
  float sv_next[16];
  if (steps > 0) load_stat(0, sv_next);

  for (int i = 0; i < steps; ++i) {
    int h, q0;
    step_at(i, h, q0);
    const int st = i & 1, ph = (i >> 1) & 1;
    // the next step's copy of the operand this warpgroup reads last, into
    // the stage of the step before (done with: both met at its P)
    if (i + 1 < steps) {
      if (tid == 0) load(&map_do, bar_do, S::DO_OFF, i + 1);
      if (tid == 128) load(&map_q, bar_q, S::Q_OFF, i + 1);
    }
    const int64_t bh = (int64_t)b * Hq + h;
    // this step's statistics (loaded a step ahead), then the next's
    float sv[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) sv[c] = sv_next[c];
    if (i + 1 < steps) load_stat(i + 1, sv_next);

    // S^T = K Q^T (0) or dP^T = V dO^T (1)
    float s[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) s[c] = 0.f;
    mbar_wait(bar1 + 8 * st, ph);
    const uint32_t b1 = sb0 + b1_off + st * S::TILE;
    wgmma_fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      bb_ss<0, 0>(s,
                  wgmma_desc(a1 + (kk >> 2) * BB_BOX + (kk & 3) * 32, 16, 1024),
                  wgmma_desc(b1 + (kk >> 2) * BB_BOX + (kk & 3) * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(s);

    // P^T (0), zero where a pair is masked, to shared memory as it lies;
    // dS^T = P^T (dP^T - di) scale (1), to shared memory as bf16 [key][q]
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? kr0 : kr1, qi = q0 + 8 * j + 2 * qd + (e & 1);
          const bool ok = key < Skv && qi < Sq && (!causal || key <= qi);
          const float p =
              bb_exp2(fmaf(s[4 * j + e], c_log2, -sv[2 * j + (e & 1)] * BB_LOG2E));
          s[4 * j + e] = ok ? p : 0.f;
          p_x[(4 * j + e) * 128 + tid] = s[4 * j + e];
        }
    }
    named_barrier_sync(1, BB_THREADS);  // P is in shared memory
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = p_x[(4 * j + e) * 128 + tid - 128] *
                         (s[4 * j + e] - sv[2 * j + (e & 1)]) * scale;
        unsigned char* row0 = base + S::DS_OFF + sw128_offset(kr0 - kv0, j) + 4 * qd;
        unsigned char* row1 = base + S::DS_OFF + sw128_offset(kr1 - kv0, j) + 4 * qd;
        *reinterpret_cast<uint32_t*>(row0) = pack_f32(s[4 * j], s[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(row1) = pack_f32(s[4 * j + 2], s[4 * j + 3]);
      }
      fence_proxy_async();
      named_barrier_sync(3, 128);          // dS^T is in, for this warpgroup
      named_barrier_arrive(5, BB_THREADS);  // and for warpgroup 0's dQ
    }

    // dV += P^T dO (0) or dK += dS^T Q (1): A the accumulators in bf16
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        af[kk][c] = pack_f32(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
    mbar_wait(bar2 + 8 * st, ph);
    const uint32_t b2 = sb0 + b2_off + st * S::TILE;
    wgmma_fence_acc(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      bb_rs<NA>(acc2, af[kk], wgmma_desc(b2 + kk * 2048, BB_BOX, 1024));
    wgmma_commit();

    // dQ = dS K over the block's keys, 64 columns a warpgroup (box wg of
    // K; at D <= 64 both take box 0 and warpgroup 1 drops its copy)
    if (wg == 0) named_barrier_sync(5, BB_THREADS);  // dS^T is in
    constexpr int NB = S::NB;
    const int bx = NB > 1 ? wg : 0;
    float dqa[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) dqa[c] = 0.f;
    wgmma_fence_acc(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BB_BKV / 16; ++kk)
      bb_ss<1, 1>(dqa, wgmma_desc(ds_s + kk * 2048, BB_BOX, 1024),
                  wgmma_desc(sb0 + S::K_OFF + bx * BB_BOX + kk * 2048, BB_BOX,
                             1024));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(acc2);
    wgmma_fence_acc(dqa);
    tf_fence_frag(af);
    if (wg < NB) {
      const int r0 = q0 + 16 * w + g;
      bb_dq_add(dqa, dq + bh * Sq * D + 64 * bx, Sq, D, D - 64 * bx, r0,
                r0 + 8, qd);
    }
  }

  // dV (warpgroup 0) and dK (1), rows = keys
  bf16* const out = (wg == 0 ? dv : dk) + ((int64_t)b * Hkv + hk) * Skv * D;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int d = 8 * j + 2 * qd;
    if (d >= D) continue;
    if (kr0 < Skv)
      *reinterpret_cast<uint32_t*>(out + (int64_t)kr0 * D + d) =
          pack_f32(acc2[4 * j], acc2[4 * j + 1]);
    if (kr1 < Skv)
      *reinterpret_cast<uint32_t*>(out + (int64_t)kr1 * D + d) =
          pack_f32(acc2[4 * j + 2], acc2[4 * j + 3]);
  }
}

template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* di, float* dq, bf16* dk, bf16* dv,
                            int B, int Hq, int Hkv, int Sq, int Skv,
                            float scale, int causal, cudaStream_t stream) {
  using S = BbShape<D>;
  CUtensorMap mq{}, mk{}, mv{}, mdo{};
  // no queries: nothing loads Q or dO, but the maps must still encode
  const bool none = Sq == 0;
  const uint64_t qz = (uint64_t)B * (none ? Hkv : Hq);
  const int qn = none ? Skv : Sq;
  cudaError_t e = tma_map_bf16(&mq, none ? k : q, D, qn, 2 * D, 64, BB_BQ, qz);
  if (e == cudaSuccess)
    e = tma_map_bf16(&mdo, none ? k : dout, D, qn, 2 * D, 64, BB_BQ, qz);
  if (e == cudaSuccess)
    e = tma_map_bf16(&mk, k, D, Skv, 2 * D, 64, BB_BKV, (uint64_t)B * Hkv);
  if (e == cudaSuccess)
    e = tma_map_bf16(&mv, v, D, Skv, 2 * D, 64, BB_BKV, (uint64_t)B * Hkv);
  if (e != cudaSuccess) return e;
  auto kernel = fa_bwd_bf16_kernel<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::SMEM);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)((Skv + BB_BKV - 1) / BB_BKV) * Hkv * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, BB_THREADS, S::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, di, dq, dk, dv, B, Hq, Hkv, Sq, Skv, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

cudaError_t flash_attention_bwd_bf16_launch(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse, const float* di,
                                            float* dq, void* dk, void* dv,
                                            int B, int Hq, int Hkv, int Sq,
                                            int Skv, int D, float sm_scale,
                                            int causal, cudaStream_t stream) {
  bf16 *dk16 = static_cast<bf16*>(dk), *dv16 = static_cast<bf16*>(dv);
  switch (D) {
    case 32: return launch_bwd_bf16<32>(q, k, v, dout, lse, di, dq, dk16, dv16, B, Hq, Hkv, Sq, Skv, sm_scale, causal, stream);
    case 64: return launch_bwd_bf16<64>(q, k, v, dout, lse, di, dq, dk16, dv16, B, Hq, Hkv, Sq, Skv, sm_scale, causal, stream);
    case 128: return launch_bwd_bf16<128>(q, k, v, dout, lse, di, dq, dk16, dv16, B, Hq, Hkv, Sq, Skv, sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tk
