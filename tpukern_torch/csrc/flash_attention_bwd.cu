// FlashAttention-2 backward, fused with one recompute of P: a block owns
// one (batch, head, 64-row KV tile), keeps its K and V in shared memory,
// and walks the 32-row Q tiles from the causal frontier on. For each Q
// tile it recomputes
//   P  = exp(scale · K Q^T - lse),   dP = V dO^T          (64 x 32)
//   dS = P · (dP - di) · scale
// and accumulates dV += P dO and dK += dS Q in registers, so dK and dV are
// written once, by the tile's owner. dQ += dS^T K is added with f32
// atomicAdd into a zeroed (B, H, Sq, D) accumulator that the wrapper casts
// to q's dtype: the FA-2 design, chosen because a separate dQ pass would
// recompute P and dP a second time (two more of the five D-deep products)
// where the atomics cost one 4-byte reduction per (q, d) per KV tile. They
// make dQ's summation order vary from run to run, so the tests compare
// with the plain version at a tolerance, never two kernel runs bit for bit.
//
// Replaces tpukern/ops/attention_bwd.py:339 `_bwd_fused_kernel`. Its
// VMEM tiers (resident dQ block, dQ partials, FUSED_BWD_DQ_BUDGET) exist
// because Pallas on a TPU runs the grid in order and cannot revisit an
// output block; blocks here run in parallel and meet only in the dQ
// atomics, so one design serves every S.
//
// Masks, as the TPU kernel's: causal keeps kv <= q; keys at or past Skv
// and queries at or past Sq load as zeros, and P and dS are zeroed there
// after the arithmetic, since lse and di of a padded query are undefined.
//
// What bounds it: five D-deep products per (q, kv) pair, so it is compute
// bound. Every input is converted to f32 in shared memory and every
// product runs on CUDA-core FMAs in f32 (bf16 inputs too: their P and dS
// are not rounded to bf16 as the TPU kernel rounds them). Each thread
// owns a register tile per phase and reads shared memory as float4 with
// rows padded to D + 4 floats, so the 8 (or 4) distinct rows a warp reads
// fall in distinct banks and the rest are broadcasts. Tensor cores
// (mma.sync / wgmma) for the bf16 inputs are a later PR's work.
#include "common.cuh"

namespace tk {
namespace {

constexpr int BKV = 64;      // kv rows per block
constexpr int BQ = 32;       // q rows per step
constexpr int THREADS = 256;
constexpr int LDP = BQ + 4;  // P and dS tiles, [kv][q]

template <int D>
constexpr int smem_floats() {
  return 2 * BKV * (D + 4) + 2 * BQ * (D + 4) + 2 * BKV * LDP + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
              int H, int Sq, int Skv, float scale, int causal) {
  constexpr int LD = D + 4;
  // phases 2 and 3: a thread owns 4 columns c..c+3 of D and the rows
  // rg, rg + RG, ... of the KV tile (dK, dV) or the Q tile (dQ)
  constexpr int DC = D / 4, RG = THREADS / DC;
  constexpr int RPT = BKV / RG, QPT = BQ / RG;
  static_assert(THREADS % DC == 0 && BKV % RG == 0 && BQ % RG == 0, "tiling");
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;               // [BKV][LD]
  float* v_s = k_s + BKV * LD;     // [BKV][LD]
  float* q_s = v_s + BKV * LD;     // [BQ][LD]
  float* do_s = q_s + BQ * LD;     // [BQ][LD]
  float* p_s = do_s + BQ * LD;     // [BKV][LDP]
  float* ds_s = p_s + BKV * LDP;   // [BKV][LDP]
  float* lse_s = ds_s + BKV * LDP; // [BQ]
  float* di_s = lse_s + BQ;        // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // heavy causal tiles (small kv0: the most Q tiles) launch first
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = (int64_t)b * H + h;
  const T* qb = q + bh * Sq * D;
  const T* dob = dout + bh * Sq * D;
  const float* lseb = lse + bh * Sq;
  const float* dib = di + bh * Sq;
  float* dqb = dq + bh * Sq * D;

  stage_rows<T, D, THREADS>(k_s, k + bh * Skv * D, kv0, BKV, Skv);
  stage_rows<T, D, THREADS>(v_s, v + bh * Skv * D, kv0, BKV, Skv);

  const int c = (tid % DC) * 4, rg = tid / DC;
  float dk_acc[RPT][4], dv_acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // the causal frontier: Q tiles wholly before kv0 see none of its keys
  for (int q0 = causal ? kv0 / BQ * BQ : 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous Q tile is consumed
    stage_rows<T, D, THREADS>(q_s, qb, q0, BQ, Sq);
    stage_rows<T, D, THREADS>(do_s, dob, q0, BQ, Sq);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lseb[q0 + tid] : 0.f;
      di_s[tid] = in ? dib[q0 + tid] : 0.f;
    }
    __syncthreads();

    // phase 1: a warp owns 16 kv x 16 q; a lane kv rows kg, kg + 8 and q
    // columns qg, qg + 4, qg + 8, qg + 12 of it
    {
      const int kg = lane & 7, qg = lane >> 3;
      const int kl0 = (warp & 3) * 16 + kg, ql0 = (warp >> 2) * 16 + qg;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 kf[2], vf[2], qf[4], df[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          kf[i] = ld4(&k_s[(kl0 + 8 * i) * LD + d]);
          vf[i] = ld4(&v_s[(kl0 + 8 * i) * LD + d]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qf[j] = ld4(&q_s[(ql0 + 4 * j) * LD + d]);
          df[j] = ld4(&do_s[(ql0 + 4 * j) * LD + d]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = dot4(kf[i], qf[j], s[i][j]);
            dp[i][j] = dot4(vf[i], df[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kl = kl0 + 8 * i, ql = ql0 + 4 * j;
          const int kvi = kv0 + kl, qi = q0 + ql;
          const bool ok = kvi < Skv && qi < Sq && (!causal || kvi <= qi);
          const float p = ok ? expf(s[i][j] * scale - lse_s[ql]) : 0.f;
          p_s[kl * LDP + ql] = p;
          ds_s[kl * LDP + ql] = ok ? p * (dp[i][j] - di_s[ql]) * scale : 0.f;
        }
    }
    __syncthreads();

    // phase 2: dV += P dO and dK += dS Q over this tile's 32 queries
#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 df[4], qf[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        df[e] = ld4(&do_s[(qq + e) * LD + c]);
        qf[e] = ld4(&q_s[(qq + e) * LD + c]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + RG * i;
        const float4 pv = ld4(&p_s[r * LDP + qq]);
        const float4 sv = ld4(&ds_s[r * LDP + qq]);
        const float pw[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[i][0] = fmaf(pw[e], df[e].x, dv_acc[i][0]);
          dv_acc[i][1] = fmaf(pw[e], df[e].y, dv_acc[i][1]);
          dv_acc[i][2] = fmaf(pw[e], df[e].z, dv_acc[i][2]);
          dv_acc[i][3] = fmaf(pw[e], df[e].w, dv_acc[i][3]);
          dk_acc[i][0] = fmaf(sw[e], qf[e].x, dk_acc[i][0]);
          dk_acc[i][1] = fmaf(sw[e], qf[e].y, dk_acc[i][1]);
          dk_acc[i][2] = fmaf(sw[e], qf[e].z, dk_acc[i][2]);
          dk_acc[i][3] = fmaf(sw[e], qf[e].w, dk_acc[i][3]);
        }
      }
    }

    // phase 3: dQ[q0 + r] += sum over the tile's keys of dS K
    {
      float acc[QPT][4];
#pragma unroll
      for (int i = 0; i < QPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < BKV; ++kk) {
        const float4 kf = ld4(&k_s[kk * LD + c]);
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const float sv = ds_s[kk * LDP + rg + RG * i];
          acc[i][0] = fmaf(sv, kf.x, acc[i][0]);
          acc[i][1] = fmaf(sv, kf.y, acc[i][1]);
          acc[i][2] = fmaf(sv, kf.z, acc[i][2]);
          acc[i][3] = fmaf(sv, kf.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qi = q0 + rg + RG * i;
        if (qi >= Sq) continue;
        float* dst = dqb + (int64_t)qi * D + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) atomicAdd(dst + e, acc[i][e]);
      }
    }
  }

  T* dkb = dk + bh * Skv * D;
  T* dvb = dv + bh * Skv * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kvi = kv0 + rg + RG * i;
    if (kvi >= Skv) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dkb[(int64_t)kvi * D + c + e] = from_f32<T>(dk_acc[i][e]);
      dvb[(int64_t)kvi * D + c + e] = from_f32<T>(dv_acc[i][e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* di,
                     float* dq, void* dk, void* dv, int B, int H, int Sq,
                     int Skv, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * 4;
  auto kernel = fa_bwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Skv + BKV - 1) / BKV, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di, dq,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Skv, scale, causal);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* di,
                     float* dq, void* dk, void* dv, int B, int H, int Sq,
                     int Skv, float scale, int causal, int dtype,
                     cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_t<bf16, D>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Sq,
                             Skv, scale, causal, stream);
  if (dtype == kF32)
    return launch_t<float, D>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Sq,
                              Skv, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t flash_attention_bwd_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* di,
                                       float* dq, void* dk, void* dv, int B,
                                       int H, int Sq, int Skv, int D,
                                       float sm_scale, int causal, int dtype,
                                       cudaStream_t stream) {
  if (B < 0 || H <= 0 || Sq < 0 || Skv < 0) return cudaErrorInvalidValue;
  if (causal && Sq != Skv) return cudaErrorInvalidValue;
  if (B == 0 || Skv == 0) return cudaSuccess;
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_d<32>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Sq, Skv, sm_scale, causal, dtype, stream);
    case 64: return launch_d<64>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Sq, Skv, sm_scale, causal, dtype, stream);
    case 128: return launch_d<128>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Sq, Skv, sm_scale, causal, dtype, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tk
