// The f32 tier of the FlashAttention-2 forward (#6): split-TF32 products
// on the tensor cores. It replaces tpukern/ops/attention.py:62 `_fa_kernel`
// (and its layout twin `_fa_tpv_kernel`, :656) for f32 inputs; the bf16
// tier is csrc/flash_attention.cu, whose launcher calls this one. Every
// f32 instance runs here: the LSE (training) and FEAT (window, sinks,
// softcap, segments) flags, D 32, 64 and 128, GQA (query head h reads KV
// head h / (Hq / Hkv)), tails on both axes. The online softmax, the masks,
// the softcap and the lse are the CUDA-core kernel's it replaced, in
// natural-log units with expf.
//
// The products. wgmma .tf32 reads f32 as TF32 (10 mantissa bits), so each
// operand x is split into hi = x rounded to TF32 and lo = x - hi, and a
// product is A_lo B_hi + A_hi B_lo + A_hi B_hi (csrc/hopper.cuh, the f32
// GEMM's scheme). .tf32 reads shared-memory operands K-major only:
// - S = Q K^T: Q (64 query rows) and K (a tile of FT_BK keys) are K-major
//   as they lie, [row][d]; both from hi and lo planes in shared memory;
// - O += P V: P from registers, split there (tf_frag), so no P reaches
//   memory; its k8 step j reads columns 8j + 2q and 8j + 2q + 1 of the
//   score accumulator as its columns q and q + 4, so V comes as V^T
//   ([d][key], K-major for this product) with its keys in that order
//   within each 8 (tf_perm).
//
// The block: warpgroup 0 consumes (64 query rows), warpgroup 1 produces.
// The consumers' first thread loads Q by TMA into Q's hi plane; the 128
// consumers split it in place (lo beside). For each KV tile of the walk
// the producer's first thread loads K into a stage's K hi plane and V
// into the stage's staging buffer (3-D tensor maps over (D, S, B * H) in
// boxes of 32 columns: rows past S arrive as zeros), and the 128 producer
// threads split K in place, then write V^T's two planes from the staging
// buffer (a transpose through shared memory) and signal K and V apart, so
// S = Q K^T starts before V^T is written. STAGES stages (2 at D 128) let
// the producer prepare the next tile while the consumers compute this one.
//
// The sums. wgmma rounds its accumulator after every k8 product, and not
// to nearest (PERF.md §6): S's D-deep sum takes a fresh accumulator
// each 32 columns of D (its 8 small products first), two accumulators in
// turns so that one slab's products run while the other's are added, in
// f32, into S; each tile's P V takes a fresh accumulator (small products
// first) added to O as O = alpha O + P V. A model of these roundings on
// the CPU put the output's error against f64 at 0.4x and the lse's at
// 0.9x the plain f32 version's, where one accumulator over the whole walk
// gave 2.6x (the accuracy gate is 2x, ops/split_tf32.py SPLIT_GATE); on
// an H100, 0.6-0.9x and 0.7-1.15x (PERF.md §6).
//
// What bounds it: 4 D flops a visible (query, key) pair, as 3 TF32
// products each: at (B 2, Hq 16, S 1024, D 128, causal) 8.6 GFLOP, 52 µs
// at 495 TFLOP/s (128 µs on the CUDA cores' f32 FMAs). Shared memory
// bounds the S product before the tensor cores: at 32 keys a tile each
// k8 step reads A and B, 3 KiB, from shared memory for 32 K flops.
#include "hopper.cuh"

namespace tk {
namespace {

constexpr int FT_QW = 64;        // query rows a block: one consumer warpgroup
constexpr int FT_BK = 32;        // keys a KV tile
constexpr int FT_THREADS = 256;  // the consumer warpgroup, the producer's

// Q's two planes, then STAGES stages of K's two planes, V^T's two planes
// and V's staging buffer; as many stages (2 to 4) as 226 KiB hold, + 1
// KiB for the alignment
template <int D>
struct FtShape {
  static constexpr int QP = FT_QW * D * 4;  // a plane of Q
  static constexpr int KP = FT_BK * D * 4;  // a plane of K or V^T; V staged
  static constexpr int STAGE = 5 * KP;
  static constexpr int FIT = (226 * 1024 - 1024 - 2 * QP) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(STAGES >= 2, "two stages at least");
  static constexpr int SMEM = 1024 + 2 * QP + STAGES * STAGE;
};

// O += P V at the width D of O, A from registers
template <int D>
__device__ __forceinline__ void ft_mma_pv(float (&d)[D / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  if constexpr (D == 32) wgmma_m64n32k8_tf32_rs(d, a, db, scale_d);
  else if constexpr (D == 64) wgmma_m64n64k8_tf32_rs(d, a, db, scale_d);
  else wgmma_m64n128k8_tf32_rs(d, a, db, scale_d);
}

// s = d (first) or s += d, in f32
template <int N>
__device__ __forceinline__ void ft_add(float (&s)[N], const float (&d)[N],
                                       bool first) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = first ? d[i] : s[i] + d[i];
}

template <int D, bool LSE, bool FEAT>
__global__ void __launch_bounds__(FT_THREADS, 1)
fa_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   float* __restrict__ o, float* __restrict__ lse, int B,
                   int Hq, int Hkv, int Sq, int Skv, AttnMask f) {
  using S = FtShape<D>;
  constexpr int NS = D / 32;      // slabs of 32 columns of D
  constexpr int KS = FT_BK / 8;   // k8 steps of P V
  extern __shared__ unsigned char ft_smem[];
  // K ready, V^T ready, raw tiles landed, stage free; then Q's
  __shared__ __align__(8) uint64_t ft_bar[4 * S::STAGES + 1];
  const uint32_t raw0 = smem_u32(ft_smem);
  const uint32_t q_s = (raw0 + 1023) & ~1023u, kv_s = q_s + 2 * S::QP;
  unsigned char* const base = ft_smem + (q_s - raw0);
  const uint32_t full_k = smem_u32(ft_bar), full_v = full_k + 8 * S::STAGES;
  const uint32_t landed = full_v + 8 * S::STAGES;
  const uint32_t empty = landed + 8 * S::STAGES, bar_q = empty + 8 * S::STAGES;

  // the block's (q tile, head, batch): under causal the q tiles in
  // decreasing order, so that the longest walks start first
  const int n_qt = (Sq + FT_QW - 1) / FT_QW, per = Hq * B;
  const int rank = blockIdx.x / per;
  const int h = blockIdx.x % per % Hq, b = blockIdx.x % per / Hq;
  const int q0 = (f.causal ? n_qt - 1 - rank : rank) * FT_QW;
  const int hk = h / (Hq / Hkv);
  const int kv_end = f.causal ? min(Skv, q0 + FT_QW) : Skv;
  const KvRange<FT_BK> kr(f, q0, FEAT);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_k + 8 * s, 128);  // every producer thread
      mbar_init(full_v + 8 * s, 128);
      mbar_init(landed + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // lane 0 of each consumer warp
    }
    mbar_init(bar_q, 1);
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup
    const int p = tid - 128, z = b * Hkv + hk;
    for (int k0 = kr.first(), s = 0, ph = 0; k0 < kv_end; k0 = kr.next(k0)) {
      const uint32_t st = kv_s + s * S::STAGE;
      unsigned char* const sp = base + (st - q_s);
      mbar_wait(empty + 8 * s, ph ^ 1);  // the first round passes
      if (p == 0) {
        mbar_arrive_tx(landed + 8 * s, 2 * S::KP);
#pragma unroll
        for (int bx = 0; bx < NS; ++bx) {
          tma_load_3d(st + bx * FT_BK * 128, &map_k, landed + 8 * s, 32 * bx,
                      k0, z);
          tma_load_3d(st + 4 * S::KP + bx * FT_BK * 128, &map_v,
                      landed + 8 * s, 32 * bx, k0, z);
        }
      }
      mbar_wait(landed + 8 * s, ph);
      // K: hi in place, lo in the next plane
      for (int i = p * 16; i < S::KP; i += 128 * 16)
        tf_split4(sp + i, sp + S::KP + i);
      fence_proxy_async();
      mbar_arrive(full_k + 8 * s);
      // V^T: a warp takes 4 columns of D of the tile's 32 keys (a row of
      // the planes), key c to column tf_perm(c)
      for (int u = p; u < FT_BK * D / 4; u += 128) {
        const int key = u % FT_BK, c = 4 * (u / FT_BK);
        const float4 x = *reinterpret_cast<const float4*>(
            sp + 4 * S::KP + tf_off(FT_BK, key, c));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float hi, lo;
          split_tf32_finite(xs[e], hi, lo);
          const int off = tf_off(D, c + e, tf_perm(key));
          *reinterpret_cast<float*>(sp + 2 * S::KP + off) = hi;
          *reinterpret_cast<float*>(sp + 3 * S::KP + off) = lo;
        }
      }
      fence_proxy_async();
      mbar_arrive(full_v + 8 * s);
      if (++s == S::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // the consumers: this thread's rows r0 and r1 = r0 + 8, its columns of
  // a tile 8j + 2qd (+1)
  const int w = warp, g = lane >> 2, qd = lane & 3;
  const int r0 = q0 + 16 * w + g, r1 = r0 + 8;
  const bool segs = FEAT && f.qseg;
  const int qs0 = segs && r0 < Sq ? f.qseg[(int64_t)b * Sq + r0] : -1;
  const int qs1 = segs && r1 < Sq ? f.qseg[(int64_t)b * Sq + r1] : -1;
  const uint32_t q_hi = q_s, q_lo = q_s + S::QP;

  if (tid == 0) {
    mbar_arrive_tx(bar_q, S::QP);
#pragma unroll
    for (int bx = 0; bx < NS; ++bx)
      tma_load_3d(q_hi + bx * FT_QW * 128, &map_q, bar_q, 32 * bx, q0,
                  b * Hq + h);
  }
  mbar_wait(bar_q, 0);
  for (int i = tid * 16; i < S::QP; i += 128 * 16)
    tf_split4(base + i, base + S::QP + i);
  fence_proxy_async();
  named_barrier_sync(1, 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  // S = Q K^T over slab sb (32 columns of D) into a fresh d, small terms
  // first
  auto slab = [&](float (&d)[FT_BK / 2], int sb, uint32_t k_hi) {
    const uint32_t k_lo = k_hi + S::KP;
    wgmma_fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 4 * sb; kk < 4 * sb + 4; ++kk) {
      wgmma_m64n32k8_tf32(d, tf_desc(q_lo, FT_QW, kk),
                          tf_desc(k_hi, FT_BK, kk), kk > 4 * sb);
      wgmma_m64n32k8_tf32(d, tf_desc(q_hi, FT_QW, kk),
                          tf_desc(k_lo, FT_BK, kk), 1);
    }
#pragma unroll
    for (int kk = 4 * sb; kk < 4 * sb + 4; ++kk)
      wgmma_m64n32k8_tf32(d, tf_desc(q_hi, FT_QW, kk),
                          tf_desc(k_hi, FT_BK, kk), 1);
    wgmma_commit();
  };

  for (int k0 = kr.first(), s = 0, ph = 0; k0 < kv_end; k0 = kr.next(k0)) {
    const uint32_t st = kv_s + s * S::STAGE;
    float sc[FT_BK / 2], d0[FT_BK / 2], d1[FT_BK / 2];
    mbar_wait(full_k + 8 * s, ph);
    // slab sb into d0 (sb even) or d1 (odd); each slab's sum is added to
    // sc once the next one is issued (the last one after the wait)
    slab(d0, 0, st);
#pragma unroll
    for (int sb = 1; sb < NS; ++sb) {
      if (sb & 1) {
        slab(d1, sb, st);
        wgmma_wait<1>();
        wgmma_fence_acc(d0);
        ft_add(sc, d0, sb == 1);
      } else {
        slab(d0, sb, st);
        wgmma_wait<1>();
        wgmma_fence_acc(d1);
        ft_add(sc, d1, false);
      }
    }
    wgmma_wait<0>();
    if constexpr ((NS - 1) & 1) {
      wgmma_fence_acc(d1);
      ft_add(sc, d1, false);
    } else {
      wgmma_fence_acc(d0);
      ft_add(sc, d0, NS == 1);
    }

    // scale, cap and mask in f32; a tile every key of which this warp's
    // rows see needs no mask
    const bool whole = !FEAT && k0 + FT_BK <= Skv &&
                       (!f.causal || k0 + FT_BK - 1 <= q0 + 16 * w);
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int j = 0; j < FT_BK / 8; ++j) {
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int col = k0 + 8 * j + 2 * qd + c2;
        const int ksg = FEAT && segs && col < Skv
                            ? f.kseg[(int64_t)b * Skv + col] : 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& x = sc[4 * j + 2 * hh + c2];
          if constexpr (FEAT) {
            float t;
            const bool ok = col < Skv && mask_visible(f, hh ? r1 : r0, col,
                                                      hh ? qs1 : qs0, ksg);
            x = ok ? soft_cap(f, x * f.scale, t) : NEG_BIG;
          } else {
            x *= f.scale;
            if (!whole) {
              const bool ok =
                  col < Skv && (!f.causal || col <= (hh ? r1 : r0));
              x = ok ? x : NEG_BIG;
            }
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
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < FT_BK / 8; ++j) {
      sc[4 * j] = expf(sc[4 * j] - mn0);
      sc[4 * j + 1] = expf(sc[4 * j + 1] - mn0);
      sc[4 * j + 2] = expf(sc[4 * j + 2] - mn1);
      sc[4 * j + 3] = expf(sc[4 * j + 3] - mn1);
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

    // this tile's P V afresh, its small products first, then into O
    uint32_t ph_[KS][4], pl_[KS][4];
    tf_frag(sc, ph_, pl_);
    const uint32_t vt_hi = st + 2 * S::KP, vt_lo = st + 3 * S::KP;
    float od[D / 2];
    mbar_wait(full_v + 8 * s, ph);
    wgmma_fence_acc(od);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ft_mma_pv<D>(od, pl_[kk], tf_desc(vt_hi, D, kk), kk > 0);
      ft_mma_pv<D>(od, ph_[kk], tf_desc(vt_lo, D, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ft_mma_pv<D>(od, ph_[kk], tf_desc(vt_hi, D, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(od);
    tf_fence_frag(ph_);
    tf_fence_frag(pl_);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage is read
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] = fmaf(acc[4 * j], a0, od[4 * j]);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], a0, od[4 * j + 1]);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], a1, od[4 * j + 2]);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], a1, od[4 * j + 3]);
    }
    if (++s == S::STAGES) {
      s = 0;
      ph ^= 1;
    }
  }

  // a row that saw no key (segments) keeps m == NEG_BIG: output 0
  const float inv0 = l0 == 0.f || (segs && m0 <= 0.5f * NEG_BIG) ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f || (segs && m1 <= 0.5f * NEG_BIG) ? 0.f : 1.f / l1;
  if (LSE && qd == 0) {
    float* lb = lse + (int64_t)(b * Hq + h) * Sq;
    if (r0 < Sq) lb[r0] = m0 + logf(fmaxf(l0, 1e-37f));
    if (r1 < Sq) lb[r1] = m1 + logf(fmaxf(l1, 1e-37f));
  }
  float* ob = o + (int64_t)(b * Hq + h) * Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * qd;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(ob + (int64_t)r0 * D + c) =
          make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(ob + (int64_t)r1 * D + c) =
          make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

// one instance: the three tensor maps (boxes of 32 columns by 64 query
// rows, or by FT_BK keys, one head deep) and a 1-D grid of q tiles x
// heads x batch
template <int D, bool LSE, bool FEAT>
cudaError_t launch_tf32(const float* q, const float* k, const float* v,
                        float* o, float* lse, int B, int Hq, int Hkv, int Sq,
                        int Skv, const AttnMask& f, cudaStream_t stream) {
  using S = FtShape<D>;
  CUtensorMap mq{}, mk{}, mv{};
  cudaError_t e = tma_map_f32(&mq, q, D, Sq, 4 * D, 32, FT_QW,
                              (uint64_t)B * Hq);
  // no keys: the walk loads nothing, but the maps must still encode
  const bool none = Skv == 0;
  if (e == cudaSuccess)
    e = tma_map_f32(&mk, none ? q : k, D, none ? Sq : Skv, 4 * D, 32, FT_BK,
                    (uint64_t)B * (none ? Hq : Hkv));
  if (e == cudaSuccess)
    e = tma_map_f32(&mv, none ? q : v, D, none ? Sq : Skv, 4 * D, 32, FT_BK,
                    (uint64_t)B * (none ? Hq : Hkv));
  if (e != cudaSuccess) return e;
  auto kernel = fa_fwd_tf32_kernel<D, LSE, FEAT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::SMEM);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)((Sq + FT_QW - 1) / FT_QW) * Hq * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, FT_THREADS, S::SMEM, stream>>>(
      mq, mk, mv, o, lse, B, Hq, Hkv, Sq, Skv, f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32_d(const float* q, const float* k, const float* v,
                          float* o, float* lse, int B, int Hq, int Hkv, int Sq,
                          int Skv, const AttnMask& f, cudaStream_t stream) {
  const bool feat = f.window > 0 || f.softcap > 0.f || f.qseg;
  if (lse)
    return feat ? launch_tf32<D, true, true>(q, k, v, o, lse, B, Hq, Hkv, Sq,
                                             Skv, f, stream)
                : launch_tf32<D, true, false>(q, k, v, o, lse, B, Hq, Hkv,
                                              Sq, Skv, f, stream);
  return feat ? launch_tf32<D, false, true>(q, k, v, o, lse, B, Hq, Hkv, Sq,
                                            Skv, f, stream)
              : launch_tf32<D, false, false>(q, k, v, o, lse, B, Hq, Hkv, Sq,
                                             Skv, f, stream);
}

}  // namespace

cudaError_t flash_attention_tf32_launch(const float* q, const float* k,
                                        const float* v, float* o, float* lse,
                                        int B, int Hq, int Hkv, int Sq,
                                        int Skv, int D, const AttnMask& f,
                                        cudaStream_t stream) {
  // TMA reads the operands: 16-byte aligned bases (rows of D >= 32 f32
  // are whole 16-byte chunks)
  if (!(aligned16(q) && aligned16(k) && aligned16(v)))
    return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_tf32_d<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, stream);
    case 64: return launch_tf32_d<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, stream);
    case 128: return launch_tf32_d<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tk
