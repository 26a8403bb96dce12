// The quantized tier of the paged attention kernels: queries against
// 1-byte K/V pools (int8 or fp8 e4m3) with one f32 scale per token, in the
// function of tpukern/ops/paged_attention.py's quantized `_decode_kernel`
// (:77) and `_prefix_kernel` (:513) with `_pv_accumulate` (:37).
// One kernel serves both: paged_prefill_quantized_launch runs it for T new
// tokens per sequence, and decode is T = 1 (the float tiers keep their own
// kernels, csrc/paged_attention.cu and csrc/paged_prefill.cu).
//
// Split-KV, as the float kernels are (csrc/paged_attention.cu,
// csrc/paged_prefill.cu): a block owns (a tile of PQ_RB query rows, a KV
// head, a sequence, a split of `chunk` slots), the rows flattened t-major
// (row = t * group + g, csrc/paged_split.cuh PrefixRows), so one pass over
// the KV head's pages serves every query head of the group and all T
// tokens of the tile. ops/paged_attention.py quant_splits picks the chunk
// from the shapes alone. With one split the block writes the output; with
// more it writes its rows' f32 partials (m, l, the unnormalized o) and the
// last block of the row tile to take a ticket merges them in split order
// (paged_split.cuh merge_splits): the same bits from run to run.
//
// A split walks tiles of 64 slots. For each:
//   A. scores: q . k against the K tile in shared memory,
//        q_int8: s = float(int32 dot of int8 q and int8 k, __dp4a) * q_scale,
//        else:   s = f32 dot of q and k cast to q's type (exact for int8 and
//                e4m3 in bf16 and f32),
//      then s * k_scale, then * sm_scale, then the softcap, ALiBi and the
//      masks, in the TPU kernel's order (:178-211, :232-240);
//   B. one warp per query row: the running max m, alpha, p = exp(s - m),
//      l = l * alpha + sum p, and p' = p * v_scale rounded to the output's
//      type (bf16 in serving), as `_pv_accumulate` casts p * v_scale to V's
//      cast type;
//   C. acc = acc * alpha + p' V, V from shared memory. A thread owns 4
//      columns of every row of the tile and every TG-th token (TG = 512 /
//      D token groups), so all 128 threads work at any row count; the
//      groups' partial sums meet once, at the end.
// pv_int8 quantizes p * v_scale against its maximum over a page block of
// bk = page_size * pages_per_block slots, the TPU walk's unit, so a split
// that cuts a block needs that block's maximum from the other splits:
// two launches. A split holds whole blocks or a whole share of one, in
// pieces of min(chunk, bk) slots, each inside one block (tiles of 64
// slots, or of the power of two dividing bk).
//   1. (PQ_STATS) each piece's m_z, the max of its scores, and a_z, the
//      max of exp(s - m_z) v_scale, per row;
//   2. (PQ_MAIN) at each block a split reaches, M = the largest m_z of the
//      pieces of the blocks up to it (the TPU walk's running max there) and
//      amax = the largest exp(m_z - M) a_z of the block's pieces (1 where
//      0); then per tile p = exp(s - M), l += sum p, and
//      pq = rint(p v_scale (127 / amax)); the block's share is an exact
//      int32 sum of pq against the raw int8 V, scaled by amax / 127 once.
// amax is the TPU kernel's up to rounding (exp(m_z - M) a_z for
// exp(s - M) v_scale), where one split a sequence walked 16 dependent
// tiles at the serving shape (PERF.md).
// The loads: each tile's K and V rows (pool rows from the split's page-
// table entries, staged once) and its scales, by cp.async, 16 bytes a
// copy, in a ring of PQ_STAGES stages, so the next tiles' copies are in
// flight while a tile's products run (a decode split's two tiles load at
// once). The output is acc / l, and 0 for a row that saw no position
// (JAX: the mean of V). A tile no row of the block sees under a window is
// skipped, as the TPU decode kernel skips such a block (it would add
// nothing). On a ring pool (slot_pos, common.cuh) no tile is skipped and
// every written slot is visited, since any may hold a position inside the
// window.
//
// What bounds it: it reads each live K/V byte once per row tile (half the
// bytes of bf16 pools; pv_int8's first pass K again) with its scales, and
// does 4 D operations per visible (row, token) pair: at decode the bytes,
// 1.2 us for the serving shape on an H100 (PERF.md). What it takes is a
// chain per split: the page table, the tiles' copies, a few microseconds
// a tile of dependent shared-memory phases and barriers (a block of four
// warps hides little of their latency), then the merge.
#include <cuda_fp8.h>

#include "paged_split.cuh"

namespace tk {
namespace {

constexpr int PQ_THREADS = 128;
constexpr int PQ_WARPS = PQ_THREADS / 32;
constexpr int PQ_RB = 16;              // query rows per block
constexpr int PQ_TK = 64;              // tokens per K/V tile (at most)
constexpr int PQ_DMAX = 128;
constexpr int PQ_LDK = PQ_DMAX + 16;   // padded tile row (bytes): no bank conflicts
constexpr int PQ_TILE = PQ_TK * PQ_LDK;  // a K or a V tile's bytes
// a stage: a K tile, a V tile, their K and V scales (64 floats each)
constexpr int PQ_STAGE = 2 * PQ_TILE + 2 * PQ_TK * 4;
constexpr int PQ_STAGES = 3;           // loads in flight: a decode split's two tiles at once
constexpr int PQ_BK_MAX = 2048;        // tokens per page block
// the dynamic shared memory: the stages; the scores of a tile (rows x
// PQ_TK floats, rows = min(PQ_RB, T group)); the split's page-table
// entries (pages ints)
__host__ __device__ constexpr int pq_smem(int rows, int pages) {
  return PQ_STAGES * PQ_STAGE + rows * PQ_TK * 4 + pages * 4;
}
// the end-of-block sum of the token groups' partials (TG x PQ_RB x D
// floats, 32 KiB at every D) reuses the stages
static_assert(4 * PQ_THREADS * PQ_RB * 4 <= 2 * PQ_STAGE, "stages");

// A launch's pass: PQ_ONE, the tiers without pv_int8; with pv_int8 two,
// PQ_STATS then PQ_MAIN (the header's pass 1 and pass 2)
enum PqMode { PQ_ONE = 0, PQ_STATS = 1, PQ_MAIN = 2 };

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
  int tk;                   // tokens a tile: 64, or with pv_int8 gcd(bk, 64)
  int pz;                   // pv_int8: slots a piece, min(chunk, bk)
  int pages_split;          // page-table entries a split spans, at most
  Split sp;                 // slots a split (a multiple of tk), ws, tickets
  float* stats;             // pv_int8: each piece's (m, a) per row
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

__device__ __forceinline__ void pq_copy16(void* dst, const void* src,
                                          bool load) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(load ? 16 : 0)
               : "memory");
}

// QT: the float type of q and o; FP8: e4m3 pools (else int8); Q8: int8 q
// and the int32 score dot; MODE: PqMode (PQ_STATS and PQ_MAIN: pv_int8,
// the int8 P V dot)
template <typename QT, bool FP8, bool Q8, int MODE>
__global__ void __launch_bounds__(PQ_THREADS) paged_quant_kernel(PQArgs a) {
  constexpr bool PV8 = MODE != PQ_ONE, STATS = MODE == PQ_STATS;
  constexpr int NST = PQ_STAGES;
  extern __shared__ __align__(16) unsigned char pq_dyn[];
  const int D = a.D, TK = a.tk, tid = threadIdx.x;
  auto kv_s = [&](int st, int which) {  // stage st's K (0) or V (1) tile
    return pq_dyn + st * PQ_STAGE + which * PQ_TILE;
  };
  auto sc_of = [&](int st, int which) {  // its K (0) or V (1) scales
    return reinterpret_cast<float*>(pq_dyn + st * PQ_STAGE + 2 * PQ_TILE +
                                    which * PQ_TK * 4);
  };
  // q (f32), or with q_int8 its int8 values in the same bytes
  __shared__ __align__(16) float q_s[PQ_RB][PQ_DMAX];
  int8_t(*const qi_s)[PQ_DMAX] = reinterpret_cast<int8_t(*)[PQ_DMAX]>(q_s);
  // per row: the running max m and sum l (PQ_STATS: the piece's m and a);
  // a tile's alpha; pv_int8: the block's 127 / amax and amax / 127
  __shared__ float m_s[PQ_RB], l_s[PQ_RB], alpha_s[PQ_RB], kq_s[PQ_RB],
      sc_s[PQ_RB], qsc_s[PQ_RB];
  __shared__ bool last_s;

  const int lane = tid & 31, warp = tid >> 5;
  const int S = a.pages_per_seq * a.page_size;
  const int n_split = max(1, (S + a.sp.chunk - 1) / a.sp.chunk);
  const int split = blockIdx.x % n_split;
  const int row0 = blockIdx.x / n_split * PQ_RB;
  const PrefixRows rows(a.lengths, a.Hq, a.Hkv, a.T, S, row0, PQ_RB,
                        a.f.ring > 0);
  const int nrows = min(PQ_RB, rows.R - row0);
  const int tq = min(PQ_RB, rows.R);
  float* const p_s = reinterpret_cast<float*>(pq_dyn + NST * PQ_STAGE);  // [tq][PQ_TK]
  int* const table_s = reinterpret_cast<int*>(p_s + tq * PQ_TK);
  const int* table = a.page_table + rows.b * a.pages_per_seq;
  const int64_t pool = rows.hk * a.P * a.page_size;  // this head's first pool row
  // this split's slots [c0, end), and its page-table entries from page
  // p0 on in table_s
  const int c0 = split * a.sp.chunk, end = min(rows.kv_end, c0 + a.sp.chunk);
  const int p0 = c0 / a.page_size;
  for (int i = tid; i < a.pages_split; i += PQ_THREADS)
    table_s[i] = p0 + i < a.pages_per_seq ? table[p0 + i] : 0;
  // pv_int8: the row tile's pieces' (m, a), piece z of row i at z tq + i
  const int n_pieces = PV8 ? (S + a.pz - 1) / a.pz : 0;
  const int64_t pt = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) *
                         (gridDim.x / n_split) + blockIdx.x / n_split;
  float* const st_m = PV8 ? a.stats + pt * n_pieces * tq : nullptr;
  float* const st_a = PV8 ? st_m + (int64_t)gridDim.z * gridDim.y *
                                       (gridDim.x / n_split) * n_pieces * tq
                          : nullptr;

  for (int i = tid; i < PQ_RB * D; i += PQ_THREADS) {
    const int r = i / D, c = i % D, gr = row0 + r;
    if constexpr (Q8)
      qi_s[r][c] = gr < rows.R
                       ? static_cast<const int8_t*>(a.q)[rows.offset(gr, D) + c]
                       : 0;
    else
      q_s[r][c] = gr < rows.R ? to_f32(static_cast<const QT*>(
                                    a.q)[rows.offset(gr, D) + c])
                              : 0.f;
  }
  if (tid < PQ_RB) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
    if constexpr (Q8)
      qsc_s[tid] = row0 + tid < rows.R
                       ? a.q_scales[rows.offset(row0 + tid, D) / D]
                       : 0.f;
  }
  if constexpr (STATS) {  // this split's pieces: none seen yet
    const int z0 = c0 / a.pz, nz = min(n_pieces, (c0 + a.sp.chunk + a.pz - 1) / a.pz) - z0;
    for (int i = tid; i < nz * nrows; i += PQ_THREADS) {
      st_m[(z0 + i / nrows) * tq + i % nrows] = NEG_BIG;
      st_a[(z0 + i / nrows) * tq + i % nrows] = 0.f;
    }
  }

  // the walk: tiles from c0 on, a tile older than every row's band (and
  // past the sinks) skipped; each a load of K and V (PQ_STATS: K and the
  // scales)
  auto tile_from = [&](int t0) {
    for (; t0 < end; t0 += TK)
      if (!(a.f.window > 0 && a.f.ring == 0 &&
            t0 + TK - 1 < rows.q_first - a.f.window + 1 && t0 >= a.f.sinks))
        return t0;
    return end;
  };
  // the pool row of position pos (its page from table_s)
  auto pool_row = [&](int pos) {
    return pool + (int64_t)table_s[pos / a.page_size - p0] * a.page_size +
           pos % a.page_size;
  };
  // a tile's copies into stage st, one commit group: its K and V rows
  // (zeros past its tokens; no V in PQ_STATS) and its K and V scales, 16
  // bytes a copy (4 tokens of one page: the launcher requires
  // page_size % 4 == 0)
  auto copy = [&](int t0, int st) {
    const int n = min(TK, end - t0), chunks = D / 16;
    for (int which = 0; which < (STATS ? 1 : 2); ++which) {
      const uint8_t* pages = which ? a.v_pages : a.k_pages;
      uint8_t* dst = kv_s(st, which);
      for (int i = tid; i < PQ_TK * chunks; i += PQ_THREADS) {
        const int j = i / chunks, c = (i % chunks) * 16;
        pq_copy16(dst + j * PQ_LDK + c,
                  pages + (j < n ? pool_row(t0 + j) * D + c : 0), j < n);
      }
    }
    if (tid < 2 * PQ_TK / 4) {
      const int which = tid / (PQ_TK / 4), j = 4 * (tid % (PQ_TK / 4));
      pq_copy16(sc_of(st, which) + j,
                (which ? a.v_scales : a.k_scales) +
                    (j < n ? pool_row(t0 + j) : 0),
                j < n);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // C's ownership: columns 4 cg .. 4 cg + 3 of every row, tokens tg, tg +
  // TG, ... of each tile
  const int cg = tid % (D / 4), tg = tid / (D / 4), TG = PQ_THREADS / (D / 4);
  float acc[PQ_RB][4];
  int ip[PQ_RB][4];
#pragma unroll
  for (int r = 0; r < PQ_RB; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[r][e] = 0.f;
      ip[r][e] = 0;
    }

  // the tiles NST - 1 ahead of the one computed on: each load a commit
  // group (empty past the walk's end), so a wait for all but the newest
  // NST - 2 finds this tile's copies in
  __syncthreads();  // table_s, and the pieces' first stats
  int t0 = tile_from(c0), ahead = t0;
  for (int j = 0; j < NST - 1; ++j) {
    if (ahead < end) {
      copy(ahead, j);
      ahead = tile_from(ahead + TK);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  int block = -1;  // pv_int8: the page block of the last tile
  for (int i = 0; t0 < end; ++i) {
    const int st = i % NST, n = min(TK, end - t0);
    const int nx = tile_from(t0 + TK);  // the next tile (end: none)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
    // this tile's copies are in; every thread is done with the stage the
    // tile ahead fills (the last tile's)
    __syncthreads();
    if (ahead < end) {
      copy(ahead, (i + NST - 1) % NST);
      ahead = tile_from(ahead + TK);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // pv_int8: the first tile of a page block, and the last of it here
    const int beta = PV8 ? t0 / a.bk : 0;
    const bool first = PV8 && beta != block;
    const bool last = PV8 && (nx >= end || nx / a.bk != beta);
    block = beta;

    {  // A. scores: thread -> token j, rows rb .. rb + 7
      const int j = tid % PQ_TK, rb = (tid / PQ_TK) * 8;
      if (j < n && rb < nrows) {
        const uint8_t* krow = kv_s(st, 0) + j * PQ_LDK;
        float fs[8];
        int is[8];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          fs[rr] = 0.f;
          is[rr] = 0;
        }
#pragma unroll
        for (int c = 0; c < PQ_DMAX; c += 16) {
          if (c >= D) break;
          const uint4 kv = *reinterpret_cast<const uint4*>(krow + c);
          if constexpr (Q8) {
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) {
              if (rb + rr < nrows) {
                const uint4 qv =
                    *reinterpret_cast<const uint4*>(&qi_s[rb + rr][c]);
                is[rr] = __dp4a((int)kv.x, (int)qv.x, is[rr]);
                is[rr] = __dp4a((int)kv.y, (int)qv.y, is[rr]);
                is[rr] = __dp4a((int)kv.z, (int)qv.z, is[rr]);
                is[rr] = __dp4a((int)kv.w, (int)qv.w, is[rr]);
              }
            }
          } else {
            const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kv);
            float kf[16];
#pragma unroll
            for (int x = 0; x < 16; ++x) kf[x] = kv_f32<FP8>(kb[x]);
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) {
              if (rb + rr < nrows) {
#pragma unroll
                for (int x = 0; x < 16; ++x)
                  fs[rr] = fmaf(q_s[rb + rr][c + x], kf[x], fs[rr]);
              }
            }
          }
        }
        const int slot = t0 + j;
        const int pos = slot_pos(a.f, slot, rows.base + a.T - 1);
        const float ks = sc_of(st, 0)[j];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const int r = rb + rr, gr = row0 + r;
          if (r >= nrows) continue;
          float s = Q8 ? __fmul_rn((float)is[rr], qsc_s[r]) : fs[rr];
          s = __fmul_rn(__fmul_rn(s, ks), a.f.scale);
          float th;
          s = alibi(a.f, rows.head(gr), soft_cap(a.f, s, th), pos,
                    rows.pos(gr));
          const bool ok = pos >= 0 && mask_visible(a.f, rows.pos(gr), pos, 0, 0);
          p_s[r * PQ_TK + j] = ok ? s : NEG_BIG;
        }
      }
    }

    // B. one warp a row: the softmax step (PQ_ONE), the pieces' (m, a)
    // (PQ_STATS), or p against the page block's running max and its
    // quantization against the block's amax (PQ_MAIN)
    __syncthreads();
    const float* vsr = sc_of(st, 1);
    for (int r = warp; r < nrows; r += PQ_WARPS) {
      float* sr = p_s + r * PQ_TK;
      if constexpr (STATS) {
        // m the piece's max; a its max of exp(s - m) v_scale, rescaled
        // to each new max
        float mx = NEG_BIG;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
        mx = warp_max(mx);
        const float mn = fmaxf(m_s[r], mx);
        float am = 0.f;
        for (int j = lane; j < n; j += 32)
          am = fmaxf(am, __fmul_rn(expf(sr[j] - mn), vsr[j]));
        am = warp_max(am);
        if (lane == 0) {
          const float an = fmaxf(__fmul_rn(l_s[r], expf(m_s[r] - mn)), am);
          if (nx >= end || nx / a.pz != t0 / a.pz) {  // the piece's last tile
            st_m[(t0 / a.pz) * tq + r] = mn;
            st_a[(t0 / a.pz) * tq + r] = an;
            m_s[r] = NEG_BIG;
            l_s[r] = 0.f;
          } else {
            m_s[r] = mn;
            l_s[r] = an;
          }
        }
        continue;
      }
      float mn = m_s[r];
      if constexpr (PV8) {
        if (first) {
          // the block's running max M over the pieces of blocks <= beta
          // (JAX's, as its walk reaches the block) and its amax: the
          // largest exp(m_z - M) a_z over the block's pieces
          const int zb = beta * a.bk / a.pz, ze = min(n_pieces, (beta + 1) * a.bk / a.pz);
          float M = NEG_BIG;
          for (int z = lane; z < ze; z += 32) M = fmaxf(M, __ldcg(st_m + z * tq + r));
          M = warp_max(M);
          float am = 0.f;
          for (int z = zb + lane; z < ze; z += 32)
            am = fmaxf(am, __fmul_rn(expf(__ldcg(st_m + z * tq + r) - M),
                                     __ldcg(st_a + z * tq + r)));
          am = warp_max(am);
          am = am <= 0.f ? 1.f : am;
          if (lane == 0) {
            const float alpha = expf(m_s[r] - M);
            alpha_s[r] = alpha;
            l_s[r] *= alpha;
            m_s[r] = M;
            kq_s[r] = __fdiv_rn(127.f, am);
            sc_s[r] = __fmul_rn(am, 1.f / 127.f);
          }
          mn = M;
        }
      } else {
        float mx = NEG_BIG;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
        mn = fmaxf(mn, warp_max(mx));
      }
      const float k = PV8 ? kq_s[r] : 0.f;
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sr[j] - mn);
        sum += p;
        const float pv = __fmul_rn(p, vsr[j]);
        if constexpr (PV8) {
          // as JAX's cast to int8: where 127 / amax overflows (a block far
          // below the running max, as ALiBi makes), inf saturates to 127
          // and 0 * inf (NaN) gives 0
          const float q = rintf(__fmul_rn(pv, k));
          sr[j] = q != q ? 0.f : fminf(q, 127.f);
        } else {
          sr[j] = to_f32(from_f32<QT>(pv));
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        if constexpr (PV8) {
          l_s[r] += sum;
        } else {
          const float alpha = expf(m_s[r] - mn);
          alpha_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = mn;
        }
      }
    }
    __syncthreads();

    if constexpr (!STATS) {  // C. acc = acc * alpha + p' V
      if (!PV8 || first) {
#pragma unroll
        for (int r = 0; r < PQ_RB; ++r)
          if (r < nrows)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[r][e] *= alpha_s[r];
              if constexpr (PV8) ip[r][e] = 0;
            }
      }
      const uint8_t* vt = kv_s(st, 1) + 4 * cg;
      // four of this thread's tokens a pass, their loads issued together
      // (a pass a token left each product waiting on its own loads)
      for (int j0 = tg; j0 < n; j0 += 4 * TG) {
        uint32_t vw[4];
        float vf[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u * TG;
          vw[u] = j < n ? *reinterpret_cast<const uint32_t*>(vt + j * PQ_LDK)
                        : 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vf[u][e] = kv_f32<FP8>(static_cast<uint8_t>(vw[u] >> (8 * e)));
        }
#pragma unroll
        for (int r = 0; r < PQ_RB; ++r) {
          if (r < nrows) {
            float p[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              p[u] = j0 + u * TG < n ? p_s[r * PQ_TK + j0 + u * TG] : 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if constexpr (PV8)
                  ip[r][e] += (int)p[u] *
                              (int)static_cast<int8_t>(vw[u] >> (8 * e));
                else
                  acc[r][e] = fmaf(p[u], vf[u][e], acc[r][e]);
              }
          }
        }
      }
      if (PV8 && last) {  // the block's int sum, scaled once
#pragma unroll
        for (int r = 0; r < PQ_RB; ++r)
          if (r < nrows)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][e] = __fadd_rn(acc[r][e],
                                    __fmul_rn((float)ip[r][e], sc_s[r]));
      }
    }
    t0 = nx;
  }
  if constexpr (STATS) return;

  // the token groups' partial sums meet in shared memory (the stages are
  // free: the loop's last products are done); then each row's o = acc / l
  // (one split; 0 for a row whose max stays NEG_BIG: it saw no position),
  // or this split's partial and the merge
  __syncthreads();
  float* red = reinterpret_cast<float*>(pq_dyn);  // [TG][PQ_RB][D]
#pragma unroll
  for (int r = 0; r < PQ_RB; ++r)
    if (r < nrows)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(tg * PQ_RB + r) * D + 4 * cg + e] = acc[r][e];
  __syncthreads();
  const SplitWs w(a.sp.ws, n_split, PQ_RB, rows.R, D);
  for (int i = tid; i < nrows * D; i += PQ_THREADS) {
    const int r = i / D, d = i % D;
    float s = 0.f;
    for (int t = 0; t < TG; ++t) s += red[(t * PQ_RB + r) * D + d];
    const bool none = m_s[r] <= 0.5f * NEG_BIG;
    const float l = none ? 0.f : l_s[r];
    if (n_split == 1) {
      const float inv = l == 0.f ? 0.f : 1.f / l;
      static_cast<QT*>(a.o)[rows.offset(row0 + r, D) + d] = from_f32<QT>(s * inv);
    } else {
      w.o[w.at(split, n_split, r) * D + d] = none ? 0.f : s;
    }
  }
  if (n_split == 1) return;
  if (tid < nrows) {
    const bool none = m_s[tid] <= 0.5f * NEG_BIG;
    const int64_t at = w.at(split, n_split, tid);
    w.m[at] = none ? NEG_BIG : m_s[tid];
    w.l[at] = none ? 0.f : l_s[tid];
  }
  merge_splits(rows, row0, nrows, w, n_split, D, a.sp.tickets,
               static_cast<QT*>(a.o), m_s, l_s, &last_s);
}

template <typename QT, bool FP8, bool Q8, int MODE>
cudaError_t launch_mode(const PQArgs& a, const dim3& grid, int smem,
                        cudaStream_t stream) {
  auto kernel = paged_quant_kernel<QT, FP8, Q8, MODE>;
  // the static arrays (about 8.5 KiB) count against the 48 KiB default
  // too, so the limit is raised for any size above what this instance
  // has been allowed so far
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  kernel<<<grid, PQ_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// one launch, or with pv_int8 the pieces' statistics, then the main pass
template <typename QT, bool FP8, bool Q8, bool PV8>
cudaError_t launch_pq(const PQArgs& a, int B, int n_split,
                      cudaStream_t stream) {
  const int R = a.T * (a.Hq / a.Hkv);
  const int smem = pq_smem(min(PQ_RB, R), a.pages_split);
  const dim3 grid((R + PQ_RB - 1) / PQ_RB * n_split, a.Hkv, B);
  if constexpr (!PV8) return launch_mode<QT, FP8, Q8, PQ_ONE>(a, grid, smem, stream);
  const cudaError_t e = launch_mode<QT, FP8, Q8, PQ_STATS>(a, grid, smem, stream);
  return e != cudaSuccess ? e
                          : launch_mode<QT, FP8, Q8, PQ_MAIN>(a, grid, smem, stream);
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
  // tiles of 64 slots, or with pv_int8 of gcd(bk, 64): no tile crosses a
  // page block; a pv_int8 split holds whole page blocks or a whole share
  // of one (its pieces of min(chunk, bk) slots each in one block); a
  // scale copy takes 4 tokens of one page
  a.tk = PQ_TK;
  if (pv8)
    while (a.bk % a.tk) a.tk /= 2;
  if (a.sp.chunk <= 0 || a.sp.chunk % a.tk || a.page_size % 4 ||
      (pv8 && a.sp.chunk % a.bk && a.bk % a.sp.chunk))
    return cudaErrorInvalidValue;
  a.pz = min(a.sp.chunk, a.bk);
  a.pages_split = min(a.pages_per_seq, a.sp.chunk / a.page_size + 2);
  const int64_t R = (int64_t)a.T * (a.Hq / a.Hkv);
  // (the static arrays: about 8.5 KiB)
  if (pq_smem(R < PQ_RB ? (int)R : PQ_RB, a.pages_split) + 8704 > 227 * 1024)
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
       reinterpret_cast<uintptr_t>(a.v_pages) |
       reinterpret_cast<uintptr_t>(a.k_scales) |
       reinterpret_cast<uintptr_t>(a.v_scales)) % 16)
    return cudaErrorMisalignedAddress;
  if (B == 0 || a.T == 0) return cudaSuccess;
  // n_split from shapes alone; more than one needs the workspace (B Hkv
  // row tiles n_split min(PQ_RB, R) (D + 2) floats) and B Hkv row-tile
  // zeroed tickets; pv_int8 its statistics (B Hkv row tiles pieces
  // min(PQ_RB, R) 2 floats)
  const int64_t splits =
      ((int64_t)a.pages_per_seq * a.page_size + a.sp.chunk - 1) / a.sp.chunk;
  const int64_t tiles = (R + PQ_RB - 1) / PQ_RB;
  if (tiles * splits > 0x7fffffff || (splits > 1 && (!a.sp.ws || !a.sp.tickets)) ||
      (pv8 && !a.stats))
    return cudaErrorInvalidValue;
  const int n = splits > 1 ? (int)splits : 1;
  const bool bf = dtype == kBF16;
  if (kv_dtype == kE4M3)
    return bf ? launch_pq<bf16, true, false, false>(a, B, n, stream)
              : launch_pq<float, true, false, false>(a, B, n, stream);
  if (q8 && pv8)
    return bf ? launch_pq<bf16, false, true, true>(a, B, n, stream)
              : launch_pq<float, false, true, true>(a, B, n, stream);
  if (q8)
    return bf ? launch_pq<bf16, false, true, false>(a, B, n, stream)
              : launch_pq<float, false, true, false>(a, B, n, stream);
  if (pv8)
    return bf ? launch_pq<bf16, false, false, true>(a, B, n, stream)
              : launch_pq<float, false, false, true>(a, B, n, stream);
  return bf ? launch_pq<bf16, false, false, false>(a, B, n, stream)
            : launch_pq<float, false, false, false>(a, B, n, stream);
}

}  // namespace

cudaError_t paged_prefill_quantized_launch(
    const void* q, const float* q_scales, const void* k_pages,
    const float* k_scales, const void* v_pages, const float* v_scales,
    const int* lengths, const int* page_table, void* o, int B, int Hq, int Hkv,
    int T, int P, int page_size, int pages_per_seq, int D, int block_tokens,
    float sm_scale, int window, int sinks, float softcap, int ring,
    const float* slopes, int chunk, float* ws, int* tickets, float* stats,
    int dtype, int kv_dtype, int pv_int8, cudaStream_t stream) {
  const PQArgs a{q, q_scales, static_cast<const uint8_t*>(k_pages), k_scales,
                 static_cast<const uint8_t*>(v_pages), v_scales, lengths,
                 page_table, o, Hq, Hkv, T, P, page_size, pages_per_seq, D,
                 block_tokens, PQ_TK, 0, 0, Split{chunk, ws, tickets}, stats,
                 AttnMask{}};
  return paged_quant_launch(a, B, window, sinks, softcap, ring, slopes,
                            sm_scale, dtype, kv_dtype, pv_int8, stream);
}

}  // namespace tk
