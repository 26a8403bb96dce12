// The quantized tier of the paged attention kernels: queries against
// 1-byte K/V pools (int8 or fp8 e4m3) with one f32 scale per token, in the
// function of tpukern/ops/paged_attention.py's quantized `_decode_kernel`
// (:77) and `_prefix_kernel` (:513) with `_pv_accumulate` (:37).
// One kernel serves both: paged_prefill_quantized_launch runs it for T new
// tokens per sequence, and decode is T = 1 (the float tiers keep their own
// kernels, csrc/paged_attention.cu and csrc/paged_prefill.cu).
//
// The TPU kernels walk a sequence's pages in blocks of bk = page_size *
// pages_per_block tokens and keep an online softmax across blocks. With
// pv_int8 the function depends on that partition (p is quantized against
// its maximum over one block), so this kernel walks the same blocks:
//   A. scores of the block's tokens, 64 at a time: q . k with the K tile
//      staged in shared memory (16-byte loads through the page table),
//        q_int8: s = float(int32 dot of int8 q and int8 k, __dp4a) * q_scale,
//        else:   s = f32 dot of q and k cast to q's type (exact for int8 and
//                e4m3 in bf16 and f32),
//      then s * k_scale, then * sm_scale, then the softcap and the masks,
//      in the TPU kernel's order (:178-211), into shared memory;
//   B. one warp per query row: the block's max, the running max m, alpha,
//      p = exp(s - m), l = l * alpha + sum p, and p' = p * v_scale, which
//        pv_int8: is quantized to rint(p' * (127 / amax)), amax the row's
//                 max of p' over the block (1 where it is 0),
//        else:    is rounded to the output's type (bf16 in serving), as
//                 `_pv_accumulate` casts p * v_scale to V's cast type;
//   C. acc = acc * alpha + p' V over the block, V staged as in A: with
//      pv_int8 an exact int32 sum against the raw int8 V, scaled by
//      amax / 127 once a block; else f32 products with V cast to f32.
// The output is acc / l, and 0 for a row that saw no position (JAX: the
// mean of V). One block owns a (sequence, KV head, tile of 16 query rows),
// rows flattened t-major as in csrc/paged_prefill.cu; a block of pages no
// row of the tile sees under a window is skipped, as the TPU decode
// kernel skips it (a skipped block would add nothing). On a ring pool
// (slot_pos, common.cuh) no block is skipped and every written slot is
// visited, since any may hold a position inside the window; ALiBi slopes
// add slopes[head] * (k_pos - q_pos) after the softcap, before the masks,
// in the TPU kernels' order (:232-240, :639-645).
//
// What bounds it: it reads each live K/V byte once per row tile (half the
// bytes of bf16 pools) and does 4 D operations per visible (row, token)
// pair, but with B * Hkv blocks (32 at the serving shape) each tile costs
// a chain of dependent global loads (table, scales, rows) and barriers,
// for K and again for V, so at decode it is latency bound (on an H100,
// about twice the float decode kernel, and skipping a decode tile's 14
// padding rows cut only 10% of it). The scores of a block wait in shared
// memory ((16 + 1) * bk floats) for its softmax. Split-KV and cp.async
// staging are later work.
#include <cuda_fp8.h>

#include "common.cuh"

namespace tk {
namespace {

constexpr int PQ_THREADS = 128;
constexpr int PQ_WARPS = PQ_THREADS / 32;
constexpr int PQ_RB = 16;              // query rows per block
constexpr int PQ_TK = 64;              // tokens per K/V tile
constexpr int PQ_DMAX = 128;
constexpr int PQ_LDK = PQ_DMAX + 16;   // padded tile row (bytes): no bank conflicts
constexpr int PQ_BK_MAX = 2048;        // tokens per page block (shared memory)

struct PQArgs {
  const void* q;            // (B, Hq, T, D) bf16/f32, or int8 with q_scales
  const float* q_scales;    // (B, Hq, T) for q_int8, else null
  const uint8_t* k_pages;   // (Hkv, P, page, D) int8 or e4m3
  const float* k_scales;    // (Hkv, P, page)
  const uint8_t* v_pages;
  const float* v_scales;
  const int* lengths;       // (B,) live tokens including the T new ones
  const int* page_table;    // (B, pages_per_seq)
  void* o;                  // (B, Hq, T, D) in q's float type
  int Hq, Hkv, T, P, page_size, pages_per_seq, D, bk;
  AttnMask f;
};

template <bool FP8>
__device__ __forceinline__ float kv_f32(uint8_t b) {
  if constexpr (FP8) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  } else {
    return static_cast<float>(static_cast<int8_t>(b));
  }
}

// QT: the float type of q and o; FP8: e4m3 pools (else int8); Q8: int8 q
// and the int32 score dot; PV8: the int8 P V dot
template <typename QT, bool FP8, bool Q8, bool PV8>
__global__ void __launch_bounds__(PQ_THREADS) paged_quant_kernel(PQArgs a) {
  extern __shared__ float dyn_s[];
  float* s_s = dyn_s;                  // [PQ_RB][bk]: scores, then p'
  float* vs_b = dyn_s + PQ_RB * a.bk;  // [bk]: the block's V scales
  __shared__ float q_s[PQ_RB][PQ_DMAX];
  __shared__ __align__(16) int8_t qi_s[PQ_RB][PQ_DMAX];
  __shared__ __align__(16) uint8_t kv_s[PQ_TK * PQ_LDK];
  __shared__ float ks_s[PQ_TK];
  __shared__ int64_t row_s[PQ_TK];
  __shared__ float m_s[PQ_RB], l_s[PQ_RB], alpha_s[PQ_RB], sc_s[PQ_RB],
      qsc_s[PQ_RB];

  const int D = a.D, bk = a.bk, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.z, hk = blockIdx.y;
  const int group = a.Hq / a.Hkv, R = a.T * group;
  const int row0 = blockIdx.x * PQ_RB;
  const int S = a.pages_per_seq * a.page_size;
  const int base = a.lengths[b] - a.T;  // the position of token 0
  const int last = min(row0 + PQ_RB, R) - 1;
  // a ring's slots hold positions in no order: every written one
  const int kv_end =
      max(0, min(S, a.f.ring ? base + a.T : base + last / group + 1));
  const int q_first = base + row0 / group;
  const int* table = a.page_table + b * a.pages_per_seq;
  const int64_t pool = hk * a.P * a.page_size;  // this head's first pool row
  auto offset = [&](int r) {  // row r's offset in q and o, in elements
    return ((b * a.Hq + hk * group + r % group) * a.T + r / group) * (int64_t)D;
  };
  auto qpos = [&](int r) { return base + r / group; };

  for (int i = tid; i < PQ_RB * D; i += PQ_THREADS) {
    const int r = i / D, c = i % D, gr = row0 + r;
    if constexpr (Q8)
      qi_s[r][c] = gr < R ? static_cast<const int8_t*>(a.q)[offset(gr) + c] : 0;
    else
      q_s[r][c] = gr < R ? to_f32(static_cast<const QT*>(a.q)[offset(gr) + c]) : 0.f;
  }
  if (tid < PQ_RB) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
    if constexpr (Q8)
      qsc_s[tid] = row0 + tid < R ? a.q_scales[offset(row0 + tid) / D] : 0.f;
  }

  // P V ownership: 4 columns, rows pv_r0 .. pv_r0 + D / 32 - 1
  const int c4 = (tid % (D / 4)) * 4;
  const int rpt = D / 32, pv_r0 = (tid / (D / 4)) * rpt;
  float acc[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[rr][e] = 0.f;

  // the pool rows of tile [t0, t0 + n) into row_s (and scales); the tile's
  // D-byte rows of `pages` into kv_s
  auto tile_rows = [&](int t0, int n, int blk0, bool scores) {
    if (tid < n) {
      const int pos = t0 + tid;
      const int64_t row = pool + (int64_t)table[pos / a.page_size] * a.page_size +
                          pos % a.page_size;
      row_s[tid] = row;
      if (scores) {
        ks_s[tid] = a.k_scales[row];
        vs_b[t0 - blk0 + tid] = a.v_scales[row];
      }
    }
  };
  auto stage = [&](const uint8_t* pages, int n) {
    const int chunks = D / 16;
    for (int i = tid; i < PQ_TK * chunks; i += PQ_THREADS) {
      const int j = i / chunks, c = (i % chunks) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (j < n) v = *reinterpret_cast<const uint4*>(pages + row_s[j] * D + c);
      *reinterpret_cast<uint4*>(kv_s + j * PQ_LDK + c) = v;
    }
  };

  for (int blk0 = 0; blk0 < kv_end; blk0 += bk) {
    // a block older than every row's band (and past the sinks) adds nothing
    if (a.f.window > 0 && a.f.ring == 0 &&
        blk0 + bk - 1 < q_first - a.f.window + 1 && blk0 >= a.f.sinks)
      continue;
    const int blk_end = min(blk0 + bk, kv_end), nb = blk_end - blk0;

    // A. scores: thread -> token j of the tile, rows rb .. rb + 7
    for (int t0 = blk0; t0 < blk_end; t0 += PQ_TK) {
      const int n = min(PQ_TK, blk_end - t0);
      __syncthreads();  // the previous tile (or q_s, m_s) is done
      tile_rows(t0, n, blk0, true);
      __syncthreads();
      stage(a.k_pages, n);
      __syncthreads();
      const int j = tid % PQ_TK, rb = (tid / PQ_TK) * 8;
      if (j < n) {
        float fs[8];
        int is[8];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          fs[rr] = 0.f;
          is[rr] = 0;
        }
        for (int c = 0; c < D; c += 16) {
          const uint4 kv = *reinterpret_cast<const uint4*>(kv_s + j * PQ_LDK + c);
          if constexpr (Q8) {
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) {
              const uint4 qv = *reinterpret_cast<const uint4*>(&qi_s[rb + rr][c]);
              is[rr] = __dp4a((int)kv.x, (int)qv.x, is[rr]);
              is[rr] = __dp4a((int)kv.y, (int)qv.y, is[rr]);
              is[rr] = __dp4a((int)kv.z, (int)qv.z, is[rr]);
              is[rr] = __dp4a((int)kv.w, (int)qv.w, is[rr]);
            }
          } else {
            const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kv);
            float kf[16];
#pragma unroll
            for (int x = 0; x < 16; ++x) kf[x] = kv_f32<FP8>(kb[x]);
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) {
#pragma unroll
              for (int x = 0; x < 16; ++x)
                fs[rr] = fmaf(q_s[rb + rr][c + x], kf[x], fs[rr]);
            }
          }
        }
        const int slot = t0 + j, pos = slot_pos(a.f, slot, base + a.T - 1);
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const int r = rb + rr, gr = row0 + r;
          float s = Q8 ? __fmul_rn((float)is[rr], qsc_s[r]) : fs[rr];
          s = __fmul_rn(__fmul_rn(s, ks_s[j]), a.f.scale);
          float th;
          s = alibi(a.f, static_cast<int>(hk) * group + min(gr, R - 1) % group,
                    soft_cap(a.f, s, th), pos, qpos(gr));
          const bool ok = gr < R && pos >= 0 && mask_visible(a.f, qpos(gr), pos, 0, 0);
          s_s[r * bk + slot - blk0] = ok ? s : NEG_BIG;
        }
      }
    }
    __syncthreads();

    // B. the block's softmax step, one warp per row
    for (int r = warp; r < PQ_RB; r += PQ_WARPS) {
      float* sr = s_s + r * bk;
      float mx = NEG_BIG;
      for (int j = lane; j < nb; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r], mn = fmaxf(m_old, mx);
      float sum = 0.f, amax = 0.f;
      for (int j = lane; j < nb; j += 32) {
        const float p = expf(sr[j] - mn);
        sum += p;
        const float pv = __fmul_rn(p, vs_b[j]);
        if constexpr (PV8) {
          amax = fmaxf(amax, pv);
          sr[j] = pv;
        } else {
          sr[j] = to_f32(from_f32<QT>(pv));
        }
      }
      sum = warp_sum(sum);
      if constexpr (PV8) {
        amax = warp_max(amax);
        amax = amax <= 0.f ? 1.f : amax;
        const float k = __fdiv_rn(127.f, amax);
        // as JAX's cast to int8: where 127 / amax overflows (a block far
        // below the running max, as ALiBi makes), inf saturates to 127
        // and 0 * inf (NaN) gives 0
        for (int j = lane; j < nb; j += 32) {
          const float r = rintf(__fmul_rn(sr[j], k));
          sr[j] = r != r ? 0.f : fminf(r, 127.f);
        }
      }
      if (lane == 0) {
        const float alpha = expf(m_old - mn);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mn;
        sc_s[r] = __fmul_rn(amax, 1.f / 127.f);
      }
    }

    // C. acc = acc * alpha + p' V
    int ip[4][4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) ip[rr][e] = 0;
    for (int t0 = blk0; t0 < blk_end; t0 += PQ_TK) {
      const int n = min(PQ_TK, blk_end - t0);
      __syncthreads();  // B is done, or the previous V tile
      tile_rows(t0, n, blk0, false);
      __syncthreads();
      stage(a.v_pages, n);
      __syncthreads();
      if constexpr (!PV8) {
        if (t0 == blk0) {
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            if (rr < rpt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[rr][e] *= alpha_s[pv_r0 + rr];
        }
      }
      for (int j = 0; j < n; ++j) {
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(kv_s + j * PQ_LDK + c4);
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(&vw);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          if (rr < rpt) {
            const float p = s_s[(pv_r0 + rr) * bk + t0 - blk0 + j];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (PV8)
                ip[rr][e] += (int)p * (int)(int8_t)vb[e];
              else
                acc[rr][e] = fmaf(p, kv_f32<FP8>(vb[e]), acc[rr][e]);
            }
          }
        }
      }
    }
    if constexpr (PV8) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        if (rr < rpt) {
          const int r = pv_r0 + rr;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[rr][e] = __fadd_rn(__fmul_rn(acc[rr][e], alpha_s[r]),
                                   __fmul_rn((float)ip[rr][e], sc_s[r]));
        }
    }
  }

  // o = acc / l; a row whose max stays NEG_BIG saw no position: 0. The
  // barrier publishes m_s and l_s where no block ran (kv_end == 0, or every
  // block outside the window)
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int r = pv_r0 + rr, gr = row0 + r;
    if (rr >= rpt || gr >= R) continue;
    const float l = m_s[r] <= 0.5f * NEG_BIG ? 0.f : l_s[r];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    QT* orow = static_cast<QT*>(a.o) + offset(gr);
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[c4 + e] = from_f32<QT>(acc[rr][e] * inv);
  }
}

template <typename QT, bool FP8, bool Q8, bool PV8>
cudaError_t launch_pq(const PQArgs& a, int B, cudaStream_t stream) {
  auto kernel = paged_quant_kernel<QT, FP8, Q8, PV8>;
  const int smem = (PQ_RB + 1) * a.bk * (int)sizeof(float);
  // the static tiles (about 20 KiB) count against the 48 KiB default too,
  // so the limit is raised for any block size above what this instance
  // has been allowed so far
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const int R = a.T * (a.Hq / a.Hkv);
  const dim3 grid((R + PQ_RB - 1) / PQ_RB, a.Hkv, B);
  kernel<<<grid, PQ_THREADS, smem, stream>>>(a);
  return cudaSuccess;
}

// Checks the arguments and launches the instance of (dtype, kv_dtype,
// q_int8 = q_scales given, pv_int8); q_int8 and pv_int8 need int8 pools.
cudaError_t paged_quant_launch(PQArgs a, int B, int window, int sinks,
                               float softcap, int ring, const float* slopes,
                               float sm_scale, int dtype, int kv_dtype,
                               int pv_int8, cudaStream_t stream) {
  const bool q8 = a.q_scales != nullptr, pv8 = pv_int8 != 0;
  if (B < 0 || a.T < 0 || a.Hkv <= 0 || a.Hkv > 65535 || a.Hq % a.Hkv ||
      a.page_size <= 0 || a.pages_per_seq < 0 || a.P < 0 || B > 65535 ||
      a.bk < 1 || a.bk > PQ_BK_MAX ||
      (a.D != 32 && a.D != 64 && a.D != 128))
    return cudaErrorInvalidValue;
  if ((dtype != kBF16 && dtype != kF32) || (kv_dtype != kI8 && kv_dtype != kE4M3) ||
      (kv_dtype == kE4M3 && (q8 || pv8)))
    return cudaErrorInvalidValue;
  // a ring keeps the earliest token's window after the T wrapped writes
  if (!make_paged_mask(window, sinks, softcap, ring, slopes, sm_scale, &a.f) ||
      (ring && (ring != a.pages_per_seq * a.page_size ||
                window + a.T - 1 > ring - sinks)))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.k_pages) |
       reinterpret_cast<uintptr_t>(a.v_pages)) % 16)
    return cudaErrorMisalignedAddress;
  if (B == 0 || a.T == 0) return cudaSuccess;
  const bool bf = dtype == kBF16;
  if (kv_dtype == kE4M3)
    return bf ? launch_pq<bf16, true, false, false>(a, B, stream)
              : launch_pq<float, true, false, false>(a, B, stream);
  if (q8 && pv8)
    return bf ? launch_pq<bf16, false, true, true>(a, B, stream)
              : launch_pq<float, false, true, true>(a, B, stream);
  if (q8)
    return bf ? launch_pq<bf16, false, true, false>(a, B, stream)
              : launch_pq<float, false, true, false>(a, B, stream);
  if (pv8)
    return bf ? launch_pq<bf16, false, false, true>(a, B, stream)
              : launch_pq<float, false, false, true>(a, B, stream);
  return bf ? launch_pq<bf16, false, false, false>(a, B, stream)
            : launch_pq<float, false, false, false>(a, B, stream);
}

}  // namespace

cudaError_t paged_prefill_quantized_launch(
    const void* q, const float* q_scales, const void* k_pages,
    const float* k_scales, const void* v_pages, const float* v_scales,
    const int* lengths, const int* page_table, void* o, int B, int Hq, int Hkv,
    int T, int P, int page_size, int pages_per_seq, int D, int block_tokens,
    float sm_scale, int window, int sinks, float softcap, int ring,
    const float* slopes, int dtype, int kv_dtype, int pv_int8,
    cudaStream_t stream) {
  const PQArgs a{q, q_scales, static_cast<const uint8_t*>(k_pages), k_scales,
                 static_cast<const uint8_t*>(v_pages), v_scales, lengths,
                 page_table, o, Hq, Hkv, T, P, page_size, pages_per_seq, D,
                 block_tokens, AttnMask{}};
  return paged_quant_launch(a, B, window, sinks, softcap, ring, slopes,
                            sm_scale, dtype, kv_dtype, pv_int8, stream);
}

}  // namespace tk
