// FlashAttention-2 backward in two kernels, with the featured masks: a
// causal sliding window, a logit softcap and segment ids. Each output has
// one owner, so dQ, dK and dV are each written once, without atomics, and
// the results are the same from run to run; the price against the fused
// kernel (csrc/flash_attention_bwd.cu) is one more recompute of P and dP.
// GQA is inside both: query head h reads KV head h / (Hq / Hkv), and dK
// and dV are summed over each group in registers.
//
// flash_attention_dq_launch and flash_attention_dkv_launch route f32
// inputs to the split-TF32 kernels of csrc/flash_attention_featured_tf32.cu
// and bf16 inputs to the two kernels of this file:
//
// - fa_dq_kernel replaces tpukern/ops/attention_bwd.py:31 `_dq_kernel`
//   (and, in the port, its transposed-layout twin `_dq_t_kernel`, :188).
//   A block owns one (batch, head, 64-row Q tile): it stages its Q, dO,
//   lse and di once, then walks only the 32-row KV tiles of its KV head
//   that meet its band, from the tile holding max(0, q0 - window + 1) to
//   the causal frontier (attention_bwd.py:45-49), and accumulates dQ +=
//   dS K in registers.
// - fa_dkv_kernel replaces :110 `_dkv_kernel` (and `_dkv_t_kernel`, :261).
//   A block owns one (batch, KV head, 64-row KV tile): it stages its K and
//   V once, then walks, for each query head of the group, the 32-row Q
//   tiles from its causal frontier to the last one whose band still
//   reaches it, q <= kv0 + 63 + window - 1 (attention_bwd.py:125-128), and
//   accumulates dV += P^T dO and dK += dS^T Q in registers.
//
// Both recompute, for each visible (q, kv) pair,
//   s  = scale * q.k,  t = tanh(s / cap), s = cap * t     (softcap only)
//   P  = exp2(s log2(e) - lse log2(e)),  dP = dO.v,  dS = P (dP - di) scale (1 - t^2)
// in log2, as JAX's bf16 tier does (attention_bwd.py:623-627), in f32:
// every input is converted to f32 in shared memory and every product runs
// on CUDA-core FMAs (P and dS are not rounded to bf16 as the TPU kernels
// round them). No main path runs this tier: attention stays f32 even
// with bf16 parameters.
//
// Masks, as the TPU kernels' and the forward's (AttnMask, mask_visible
// and soft_cap in common.cuh): causal keeps kv <= q, the window kv >= q -
// window + 1, segments equal ids; keys at or past Skv and queries at or
// past Sq load as zeros. Every mask is a select applied after all the
// arithmetic of P and dS, never a multiply: a row that sees no key (a
// padding segment) carries an lse near NEG_BIG, so exp(s - lse) is inf
// there (attention_bwd.py:84-89, :98-103, :163-164, :178-181).
//
// What bounds them: at D = 128 the dq kernel does 3 D-deep products per
// visible (q, kv) pair (S, dP, dS K) and the dkv kernel 4 (S, dP, P^T dO,
// dS^T Q), so both are compute bound. Each thread owns a register tile
// per phase and reads shared memory as float4 from rows padded to D + 4
// floats; the loops skip whole tiles outside the band, so the work scales
// with S * window. Tensor cores for the bf16 tier are a later PR's work.
#include "common.cuh"

namespace tk {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;
constexpr int OWN = 64;      // rows a block owns (Q in dq, KV in dkv)
constexpr int STREAM = 32;   // rows of each streamed tile (KV in dq, Q in dkv)
constexpr int LDP = STREAM + 4;  // [own][stream] P and dS tiles

__device__ __forceinline__ bool visible(const AttnMask& m, int qi, int kvi,
                                        int Sq, int Skv, int qs, int ks) {
  return qi < Sq && kvi < Skv && mask_visible(m, qi, kvi, qs, ks);
}

// P and dS of one pair from s = q.k and dp = dO.v; lse is in log2 units.
// Both are 0 where the pair is not visible.
__device__ __forceinline__ float2 p_ds(const AttnMask& m, float s, float dp,
                                       bool ok, float lse, float di) {
  float t;
  const float sr = soft_cap(m, s * m.scale, t);
  const float e = exp2f(fmaf(sr, LOG2E, -lse));
  const float p = ok ? e : 0.f;
  float ds = p * (dp - di) * m.scale;
  if (m.softcap > 0.f) ds *= 1.f - t * t;
  return make_float2(p, ok ? ds : 0.f);
}

// Phase 1 of both kernels: a warp owns 16 own rows x 16 streamed rows; a
// lane own rows al0, al0 + 8 and streamed rows bl0 + 4j. s = a1.b1 and
// dp = a2.b2 over D, from [rows][D + 4] f32 tiles.
template <int D>
__device__ __forceinline__ void pair_products(const float* a1, const float* a2,
                                              const float* b1, const float* b2,
                                              int al0, int bl0, float (&s)[2][4],
                                              float (&dp)[2][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x1[2], x2[2], y1[4], y2[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      x1[i] = ld4(&a1[(al0 + 8 * i) * LD + d]);
      x2[i] = ld4(&a2[(al0 + 8 * i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y1[j] = ld4(&b1[(bl0 + 4 * j) * LD + d]);
      y2[j] = ld4(&b2[(bl0 + 4 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = dot4(x1[i], y1[j], s[i][j]);
        dp[i][j] = dot4(x2[i], y2[j], dp[i][j]);
      }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * OWN * (D + 4) + 2 * STREAM * (D + 4) + OWN * LDP + 3 * OWN +
         STREAM;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dq, int H, int Hkv, int Sq, int Skv,
             AttnMask m) {
  constexpr int LD = D + 4;
  // phase 2: a thread owns columns c..c+3 of D and Q rows rg + RG * i
  constexpr int DC = D / 4, RG = THREADS / DC, RPT = OWN / RG;
  static_assert(THREADS % DC == 0 && OWN % RG == 0, "tiling");
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [OWN][LD]
  float* do_s = q_s + OWN * LD;       // [OWN][LD]
  float* k_s = do_s + OWN * LD;       // [STREAM][LD]
  float* v_s = k_s + STREAM * LD;     // [STREAM][LD]
  float* ds_s = v_s + STREAM * LD;    // [OWN][LDP]
  float* lse_s = ds_s + OWN * LDP;    // [OWN], log2 units
  float* di_s = lse_s + OWN;          // [OWN]
  int* qseg_s = reinterpret_cast<int*>(di_s + OWN);  // [OWN]
  int* kseg_s = qseg_s + OWN;         // [STREAM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * OWN, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = (int64_t)b * H + h;
  const int64_t bkv = (int64_t)b * Hkv + h / (H / Hkv);
  const bf16* kb = k + bkv * Skv * D;
  const bf16* vb = v + bkv * Skv * D;

  stage_rows<bf16, D, THREADS>(q_s, q + bh * Sq * D, q0, OWN, Sq);
  stage_rows<bf16, D, THREADS>(do_s, dout + bh * Sq * D, q0, OWN, Sq);
  if (tid < OWN) {
    const int qi = q0 + tid;
    const bool in = qi < Sq;
    lse_s[tid] = in ? lse[bh * Sq + qi] * LOG2E : 0.f;
    di_s[tid] = in ? di[bh * Sq + qi] : 0.f;
    qseg_s[tid] = in && m.qseg ? m.qseg[(int64_t)b * Sq + qi] : -1;
  }

  const int c = (tid % DC) * 4, rg = tid / DC;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // the band: KV tiles wholly below q0 - window + 1 or past the causal
  // frontier see none of this tile's queries
  const int kv_lo = m.window > 0 ? max(0, q0 - m.window + 1) / STREAM * STREAM : 0;
  const int kv_end = m.causal ? min(Skv, q0 + OWN) : Skv;
  for (int k0 = kv_lo; k0 < kv_end; k0 += STREAM) {
    __syncthreads();  // the previous KV tile is consumed
    stage_rows<bf16, D, THREADS>(k_s, kb, k0, STREAM, Skv);
    stage_rows<bf16, D, THREADS>(v_s, vb, k0, STREAM, Skv);
    if (tid < STREAM) {
      const int kvi = k0 + tid;
      kseg_s[tid] = kvi < Skv && m.kseg ? m.kseg[(int64_t)b * Skv + kvi] : -2;
    }
    __syncthreads();

    {  // phase 1: dS of 64 queries x 32 keys
      const int al0 = (warp & 3) * 16 + (lane & 7);
      const int bl0 = (warp >> 2) * 16 + (lane >> 3);
      float s[2][4], dp[2][4];
      pair_products<D>(q_s, do_s, k_s, v_s, al0, bl0, s, dp);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = al0 + 8 * i, kl = bl0 + 4 * j;
          const bool ok = visible(m, q0 + ql, k0 + kl, Sq, Skv, qseg_s[ql],
                                  kseg_s[kl]);
          ds_s[ql * LDP + kl] =
              p_ds(m, s[i][j], dp[i][j], ok, lse_s[ql], di_s[ql]).y;
        }
    }
    __syncthreads();

    // phase 2: dQ[q0 + r] += sum over the tile's keys of dS K
#pragma unroll 4
    for (int kk = 0; kk < STREAM; ++kk) {
      const float4 kf = ld4(&k_s[kk * LD + c]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float sv = ds_s[(rg + RG * i) * LDP + kk];
        acc[i][0] = fmaf(sv, kf.x, acc[i][0]);
        acc[i][1] = fmaf(sv, kf.y, acc[i][1]);
        acc[i][2] = fmaf(sv, kf.z, acc[i][2]);
        acc[i][3] = fmaf(sv, kf.w, acc[i][3]);
      }
    }
  }

  bf16* dqb = dq + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg + RG * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dqb[(int64_t)qi * D + c + e] = from_f32<bf16>(acc[i][e]);
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * OWN * (D + 4) + 2 * STREAM * (D + 4) + 2 * OWN * LDP +
         3 * STREAM + OWN;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv,
              int Sq, int Skv, AttnMask m) {
  constexpr int LD = D + 4;
  // phase 2: a thread owns columns c..c+3 of D and KV rows rg + RG * i
  constexpr int DC = D / 4, RG = THREADS / DC, RPT = OWN / RG;
  static_assert(THREADS % DC == 0 && OWN % RG == 0 && STREAM % 4 == 0,
                "tiling");
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [OWN][LD]
  float* v_s = k_s + OWN * LD;        // [OWN][LD]
  float* q_s = v_s + OWN * LD;        // [STREAM][LD]
  float* do_s = q_s + STREAM * LD;    // [STREAM][LD]
  float* p_s = do_s + STREAM * LD;    // [OWN][LDP]
  float* ds_s = p_s + OWN * LDP;      // [OWN][LDP]
  float* lse_s = ds_s + OWN * LDP;    // [STREAM], log2 units
  float* di_s = lse_s + STREAM;       // [STREAM]
  int* qseg_s = reinterpret_cast<int*>(di_s + STREAM);  // [STREAM]
  int* kseg_s = qseg_s + STREAM;      // [OWN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv0 = blockIdx.x * OWN, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int64_t bkv = (int64_t)b * Hkv + hk;

  stage_rows<bf16, D, THREADS>(k_s, k + bkv * Skv * D, kv0, OWN, Skv);
  stage_rows<bf16, D, THREADS>(v_s, v + bkv * Skv * D, kv0, OWN, Skv);
  if (tid < OWN) {
    const int kvi = kv0 + tid;
    kseg_s[tid] = kvi < Skv && m.kseg ? m.kseg[(int64_t)b * Skv + kvi] : -2;
  }

  const int c = (tid % DC) * 4, rg = tid / DC;
  float dk_acc[RPT][4], dv_acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // each query head of the group, from the causal frontier to the last
  // query whose band reaches the tile's last key, kv0 + OWN - 1 + window - 1
  const int q_lo = m.causal ? kv0 / STREAM * STREAM : 0;
  const int q_end = m.window > 0 ? min(Sq, kv0 + OWN + m.window - 1) : Sq;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const int64_t bh = (int64_t)b * H + h;
    const bf16* qb = q + bh * Sq * D;
    const bf16* dob = dout + bh * Sq * D;
    for (int q0 = q_lo; q0 < q_end; q0 += STREAM) {
      __syncthreads();  // the previous Q tile is consumed
      stage_rows<bf16, D, THREADS>(q_s, qb, q0, STREAM, Sq);
      stage_rows<bf16, D, THREADS>(do_s, dob, q0, STREAM, Sq);
      if (tid < STREAM) {
        const int qi = q0 + tid;
        const bool in = qi < Sq;
        lse_s[tid] = in ? lse[bh * Sq + qi] * LOG2E : 0.f;
        di_s[tid] = in ? di[bh * Sq + qi] : 0.f;
        qseg_s[tid] = in && m.qseg ? m.qseg[(int64_t)b * Sq + qi] : -1;
      }
      __syncthreads();

      {  // phase 1: P and dS of 64 keys x 32 queries
        const int al0 = (warp & 3) * 16 + (lane & 7);
        const int bl0 = (warp >> 2) * 16 + (lane >> 3);
        float s[2][4], dp[2][4];
        pair_products<D>(k_s, v_s, q_s, do_s, al0, bl0, s, dp);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kl = al0 + 8 * i, ql = bl0 + 4 * j;
            const bool ok = visible(m, q0 + ql, kv0 + kl, Sq, Skv,
                                    qseg_s[ql], kseg_s[kl]);
            const float2 pd =
                p_ds(m, s[i][j], dp[i][j], ok, lse_s[ql], di_s[ql]);
            p_s[kl * LDP + ql] = pd.x;
            ds_s[kl * LDP + ql] = pd.y;
          }
      }
      __syncthreads();

      // phase 2: dV += P dO and dK += dS Q over this tile's queries
#pragma unroll 2
      for (int qq = 0; qq < STREAM; qq += 4) {
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
    }
  }

  bf16* dkb = dk + bkv * Skv * D;
  bf16* dvb = dv + bkv * Skv * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kvi = kv0 + rg + RG * i;
    if (kvi >= Skv) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dkb[(int64_t)kvi * D + c + e] = from_f32<bf16>(dk_acc[i][e]);
      dvb[(int64_t)kvi * D + c + e] = from_f32<bf16>(dv_acc[i][e]);
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem_floats, dim3 grid,
                   cudaStream_t stream, Args... args) {
  const int bytes = smem_floats * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, bytes, stream>>>(args...);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* di,
                        void* dq, void* dk, void* dv, int B, int H, int Hkv,
                        int Sq, int Skv, const AttnMask& m,
                        cudaStream_t stream) {
  const bf16 *qt = static_cast<const bf16*>(q),
             *kt = static_cast<const bf16*>(k),
             *vt = static_cast<const bf16*>(v),
             *dot = static_cast<const bf16*>(dout);
  if (dq)
    return launch(fa_dq_kernel<D>, dq_smem_floats<D>(),
                  dim3((Sq + OWN - 1) / OWN, H, B), stream, qt, kt, vt, dot,
                  lse, di, static_cast<bf16*>(dq), H, Hkv, Sq, Skv, m);
  return launch(fa_dkv_kernel<D>, dkv_smem_floats<D>(),
                dim3((Skv + OWN - 1) / OWN, Hkv, B), stream, qt, kt, vt, dot,
                lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
                Hkv, Sq, Skv, m);
}

// dq (dk and dv null) or dk and dv (dq null); f32 on the split-TF32
// kernels, bf16 on this file's
cudaError_t featured_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* di,
                         const int* q_seg, const int* kv_seg, void* dq,
                         void* dk, void* dv, int B, int H, int Hkv, int Sq,
                         int Skv, int D, float sm_scale, int causal,
                         int window, float softcap, int dtype,
                         cudaStream_t stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq < 0 || Skv < 0)
    return cudaErrorInvalidValue;
  if (causal && Sq != Skv) return cudaErrorInvalidValue;
  AttnMask m;  // no sinks: they are forward-only
  if (!make_mask(q_seg, kv_seg, causal, window, 0, softcap, sm_scale, &m))
    return cudaErrorInvalidValue;
  if (B == 0 || (dq ? Sq : Skv) == 0) return cudaSuccess;
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return flash_attention_featured_tf32_launch(q, k, v, dout, lse, di, dq,
                                                dk, dv, B, H, Hkv, Sq, Skv,
                                                D, m, stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_bf16<32>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Hkv, Sq, Skv, m, stream);
    case 64: return launch_bf16<64>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Hkv, Sq, Skv, m, stream);
    case 128: return launch_bf16<128>(q, k, v, dout, lse, di, dq, dk, dv, B, H, Hkv, Sq, Skv, m, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t flash_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const int* q_seg, const int* kv_seg,
    void* dq, int B, int Hq, int Hkv, int Sq, int Skv, int D, float sm_scale,
    int causal, int window, float softcap, int dtype, cudaStream_t stream) {
  return featured_bwd(q, k, v, dout, lse, di, q_seg, kv_seg, dq, nullptr,
                      nullptr, B, Hq, Hkv, Sq, Skv, D, sm_scale, causal,
                      window, softcap, dtype, stream);
}

cudaError_t flash_attention_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const int* q_seg, const int* kv_seg,
    void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    float sm_scale, int causal, int window, float softcap, int dtype,
    cudaStream_t stream) {
  return featured_bwd(q, k, v, dout, lse, di, q_seg, kv_seg, nullptr, dk, dv,
                      B, Hq, Hkv, Sq, Skv, D, sm_scale, causal, window,
                      softcap, dtype, stream);
}

}  // namespace tk
