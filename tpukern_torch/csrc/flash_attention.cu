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
// What bounds it: prefill attention at D = 128 does 4*D flops for every
// (query, key) pair it reads 4*D bytes of K/V for once per 64 queries, so
// it is compute bound. The bf16 kernel computes both products on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), the design of
// the reference's split-Q mma kernel (SURVEY.md §2.3): 4 warps, each
// owning 16 query rows whose Q fragments stay in registers; S = Q K^T of a
// 64-key tile
// stays in registers and is re-packed as the A operand of P V. It stages
// K/V tiles through shared memory with plain loads: no cp.async, TMA or
// wgmma yet, which is the work of a later PR. The f32 tier keeps full f32
// precision with CUDA-core FMAs (a tensor-core product would round to
// TF32).
//
// Softmax: the bf16 kernel runs in log2 space (scores scaled by
// sm_scale * log2(e), exp2), the f32 kernel in natural log space with exp,
// as the two tiers of the TPU kernel do. The scale is applied in f32 to
// the scores; the TPU kernel folds it into q and rounds q back to bf16.
#include <type_traits>

#include "common.cuh"

namespace tk {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16 mma
constexpr int MMA_BQ = 64;   // query rows per block: 4 warps x 16
constexpr int MMA_BK = 64;   // keys per tile
constexpr int MMA_THREADS = 128;

// two adjacent bf16 of row `row` (0 past the end), as one 32-bit register
__device__ __forceinline__ uint32_t load_pair(const bf16* base, int row, int rows,
                                              int col, int D) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (int64_t)row * D + col);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16x16, row): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                   a3 = A[g+8][2t+8..]
//   B (16x8, col):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8):       c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
template <int D, bool LSE, bool FEAT>
__global__ void __launch_bounds__(MMA_THREADS)
fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                  float scale_log2, AttnMask f) {
  constexpr int LDS = D + 8;  // padded smem row: conflict-free B loads of K
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NT = MMA_BK / 8;  // n-tiles of S
  constexpr int DT = D / 8;       // n-tiles of O
  __shared__ __align__(16) bf16 k_s[MMA_BK * LDS];
  __shared__ __align__(16) bf16 v_s[MMA_BK * LDS];
  __shared__ int kseg_s[FEAT ? MMA_BK : 1];

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + (int64_t)(b * Hq + h) * Sq * D;
  const bf16* kb = k + (int64_t)(b * Hkv + hk) * Skv * D;
  const bf16* vb = v + (int64_t)(b * Hkv + hk) * Skv * D;
  bf16* ob = o + (int64_t)(b * Hq + h) * Sq * D;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * MMA_BQ;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const bool segs = FEAT && f.qseg;
  const int qs0 = segs && r0 < Sq ? f.qseg[(int64_t)b * Sq + r0] : -1;
  const int qs1 = segs && r1 < Sq ? f.qseg[(int64_t)b * Sq + r1] : -1;

  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = load_pair(qb, r0, Sq, c, D);
    qf[ks][1] = load_pair(qb, r1, Sq, c, D);
    qf[ks][2] = load_pair(qb, r0, Sq, c + 8, D);
    qf[ks][3] = load_pair(qb, r1, Sq, c + 8, D);
  }

  float of[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) of[i][0] = of[i][1] = of[i][2] = of[i][3] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  const int kv_end = f.causal ? min(Skv, q0 + MMA_BQ) : Skv;
  const KvRange<MMA_BK> kr(f, q0, FEAT);
  for (int k0 = kr.first(); k0 < kv_end; k0 = kr.next(k0)) {
    __syncthreads();  // the previous tile is consumed
    if (segs && threadIdx.x < MMA_BK) {
      const int c = k0 + threadIdx.x;
      kseg_s[threadIdx.x] = c < Skv ? f.kseg[(int64_t)b * Skv + c] : -2;
    }
    for (int i = threadIdx.x; i < MMA_BK * (D / 8); i += MMA_THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Skv) {
        kv = *reinterpret_cast<const uint4*>(kb + (int64_t)(k0 + r) * D + c8);
        vv = *reinterpret_cast<const uint4*>(vb + (int64_t)(k0 + r) * D + c8);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LDS + c8]) = kv;
      *reinterpret_cast<uint4*>(&v_s[r * LDS + c8]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sf[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sf[nt][0] = sf[nt][1] = sf[nt][2] = sf[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kp = &k_s[(nt * 8 + g) * LDS + ks * 16 + 2 * t];
        mma_16816(sf[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // scale to log2 units, mask, row max (a row spans the 4 lanes of a quad)
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        if constexpr (FEAT) {
          float t;
          const bool ok = col < Skv &&
                          mask_visible(f, row, col, e < 2 ? qs0 : qs1,
                                       segs ? kseg_s[col - k0] : 0);
          sf[nt][e] = ok ? soft_cap(f, sf[nt][e] * f.scale, t) * LOG2E : NEG_BIG;
        } else {
          const bool ok = col < Skv && (!f.causal || col <= row);
          sf[nt][e] = ok ? sf[nt][e] * scale_log2 : NEG_BIG;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(sf[nt][0], sf[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sf[nt][2], sf[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sf[nt][0] = exp2f(sf[nt][0] - mn0);
      sf[nt][1] = exp2f(sf[nt][1] - mn0);
      sf[nt][2] = exp2f(sf[nt][2] - mn1);
      sf[nt][3] = exp2f(sf[nt][3] - mn1);
      sum0 += sf[nt][0] + sf[nt][1];
      sum1 += sf[nt][2] + sf[nt][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      of[dt][0] *= a0;
      of[dt][1] *= a0;
      of[dt][2] *= a1;
      of[dt][3] *= a1;
    }

    // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(sf[2 * kk][0], sf[2 * kk][1]);
      a[1] = pack_f32(sf[2 * kk][2], sf[2 * kk][3]);
      a[2] = pack_f32(sf[2 * kk + 1][0], sf[2 * kk + 1][1]);
      a[3] = pack_f32(sf[2 * kk + 1][2], sf[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* vp = &v_s[(kk * 16 + 2 * t) * LDS + dt * 8 + g];
        mma_16816(of[dt], a, pack_bf16(vp[0], vp[LDS]),
                  pack_bf16(vp[8 * LDS], vp[9 * LDS]));
      }
    }
  }

  // a row that saw no key (segments) keeps m == NEG_BIG: output 0
  const float inv0 = l0 == 0.f || (segs && m0 <= 0.5f * NEG_BIG) ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f || (segs && m1 <= 0.5f * NEG_BIG) ? 0.f : 1.f / l1;
  if (LSE && t == 0) {  // m is in log2 units here
    float* lb = lse + (int64_t)(b * Hq + h) * Sq;
    if (r0 < Sq) lb[r0] = LN2 * m0 + logf(fmaxf(l0, 1e-37f));
    if (r1 < Sq) lb[r1] = LN2 * m1 + logf(fmaxf(l1, 1e-37f));
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r0 * D + c) =
          __floats2bfloat162_rn(of[dt][0] * inv0, of[dt][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r1 * D + c) =
          __floats2bfloat162_rn(of[dt][2] * inv1, of[dt][3] * inv1);
  }
}

// ----------------------------------------------------------------- f32 FMA
constexpr int FMA_BQ = 16;  // query rows per block: 4 warps x 4 rows
constexpr int FMA_BK = 32;  // keys per tile: one per lane
constexpr int FMA_THREADS = 128;
constexpr int FMA_RPW = FMA_BQ / (FMA_THREADS / 32);

template <typename T, int D, bool LSE, bool FEAT>
__global__ void __launch_bounds__(FMA_THREADS)
fa_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                  float sm_scale, AttnMask f) {
  constexpr int DPL = D / 32;  // output columns per lane
  __shared__ float q_s[FMA_BQ][D];
  __shared__ float k_s[FMA_BK][D + 1];  // +1: lanes read distinct rows
  __shared__ float v_s[FMA_BK][D];
  __shared__ int kseg_s[FEAT ? FMA_BK : 1];

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (int64_t)(b * Hq + h) * Sq * D;
  const T* kb = k + (int64_t)(b * Hkv + hk) * Skv * D;
  const T* vb = v + (int64_t)(b * Hkv + hk) * Skv * D;
  T* ob = o + (int64_t)(b * Hq + h) * Sq * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * FMA_BQ;

  for (int i = threadIdx.x; i < FMA_BQ * D; i += FMA_THREADS) {
    const int r = i / D, c = i % D;
    q_s[r][c] = q0 + r < Sq ? to_f32(qb[(int64_t)(q0 + r) * D + c]) * sm_scale : 0.f;
  }
  const bool segs = FEAT && f.qseg;
  int qs[FMA_RPW];
#pragma unroll
  for (int rr = 0; rr < FMA_RPW; ++rr) {
    const int qi = q0 + warp * FMA_RPW + rr;
    qs[rr] = segs && qi < Sq ? f.qseg[(int64_t)b * Sq + qi] : -1;
  }

  float m[FMA_RPW], l[FMA_RPW], acc[FMA_RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < FMA_RPW; ++rr) {
    m[rr] = NEG_BIG;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int kv_end = f.causal ? min(Skv, q0 + FMA_BQ) : Skv;
  const KvRange<FMA_BK> kr(f, q0, FEAT);
  for (int k0 = kr.first(); k0 < kv_end; k0 = kr.next(k0)) {
    __syncthreads();
    if (segs && threadIdx.x < FMA_BK) {
      const int c = k0 + threadIdx.x;
      kseg_s[threadIdx.x] = c < Skv ? f.kseg[(int64_t)b * Skv + c] : -2;
    }
    for (int i = threadIdx.x; i < FMA_BK * D; i += FMA_THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Skv;
      k_s[r][c] = in ? to_f32(kb[(int64_t)(k0 + r) * D + c]) : 0.f;
      v_s[r][c] = in ? to_f32(vb[(int64_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();
    const int kj = k0 + lane;  // this lane's key
#pragma unroll
    for (int rr = 0; rr < FMA_RPW; ++rr) {
      const int r = warp * FMA_RPW + rr;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(q_s[r][c], k_s[lane][c], s);
      bool ok;
      if constexpr (FEAT) {
        float t;  // q_s holds q * sm_scale: cap the scaled score
        s = soft_cap(f, s, t);
        ok = kj < Skv && mask_visible(f, q0 + r, kj, qs[rr],
                                      segs ? kseg_s[lane] : 0);
      } else {
        ok = kj < Skv && (!f.causal || kj <= q0 + r);
      }
      s = ok ? s : NEG_BIG;
      const float mn = fmaxf(m[rr], warp_max(s));
      const float alpha = expf(m[rr] - mn);
      const float p = expf(s - mn);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = mn;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
      for (int j = 0; j < FMA_BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[rr][i] = fmaf(pj, v_s[j][lane + 32 * i], acc[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < FMA_RPW; ++rr) {
    const int qi = q0 + warp * FMA_RPW + rr;
    if (qi >= Sq) continue;
    const float inv = l[rr] == 0.f || (segs && m[rr] <= 0.5f * NEG_BIG)
                          ? 0.f : 1.f / l[rr];
    if (LSE && lane == 0)
      lse[(int64_t)(b * Hq + h) * Sq + qi] = m[rr] + logf(fmaxf(l[rr], 1e-37f));
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      ob[(int64_t)qi * D + lane + 32 * i] = from_f32<T>(acc[rr][i] * inv);
  }
}

template <int D, bool LSE, bool FEAT>
void launch_dlf(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                const AttnMask& f, int dtype, cudaStream_t stream) {
  if (dtype == kBF16) {
    dim3 grid((Sq + MMA_BQ - 1) / MMA_BQ, Hq, B);
    fa_fwd_mma_kernel<D, LSE, FEAT><<<grid, MMA_THREADS, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Hq, Hkv, Sq,
        Skv, f.scale * LOG2E, f);
  } else {
    dim3 grid((Sq + FMA_BQ - 1) / FMA_BQ, Hq, B);
    fa_fwd_fma_kernel<float, D, LSE, FEAT><<<grid, FMA_THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv,
        Sq, Skv, f.scale, f);
  }
}

template <int D>
void launch_d(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
              const AttnMask& f, int dtype, cudaStream_t stream) {
  const bool feat = f.window > 0 || f.softcap > 0.f || f.qseg;
  auto go = [&](auto lse_flag, auto feat_flag) {
    launch_dlf<D, decltype(lse_flag)::value, decltype(feat_flag)::value>(
        q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (lse) feat ? go(T{}, T{}) : go(T{}, F{});
  else feat ? go(F{}, T{}) : go(F{}, F{});
}

}  // namespace

cudaError_t flash_attention_launch(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* q_seg,
                                   const int* kv_seg, int B, int Hq, int Hkv,
                                   int Sq, int Skv, int D, float sm_scale,
                                   int causal, int window, int sinks,
                                   float softcap, int dtype,
                                   cudaStream_t stream) {
  if (B < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq < 0 || Skv < 0)
    return cudaErrorInvalidValue;
  if (causal && Sq != Skv) return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  AttnMask f;
  if (!make_mask(q_seg, kv_seg, causal, window, sinks, softcap, sm_scale, &f))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (Hq > 65535 || B > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 32: launch_d<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, stream); break;
    case 64: launch_d<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, stream); break;
    case 128: launch_d<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, f, dtype, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
