// Paged prefix prefill: T new query tokens per sequence against the
// sequence's KV pages. lengths[b] counts the live tokens including the T
// new ones, whose K/V are already in the pages, so token t sits at
// position qi = lengths[b] - T + t and sees positions [0, qi] of the pool
// (causal within the new tokens). With the FEAT masks (AttnMask,
// common.cuh) a sliding window keeps only positions >= qi - window + 1,
// or < sinks, and a softcap maps each scaled score s to cap * tanh(s / cap)
// before the mask. A row that sees no position outputs 0. The FEAT
// instance also takes a ring pool, where slot j holds the newest position
// congruent to j (slot_pos, common.cuh; the TPU kernel's :621-634) and
// every live slot is visited (the KV loop neither starts at the band nor
// stops at the block's last position), and ALiBi slopes, which add
// slopes[head] * (k_pos - q_pos) to the scaled score before the mask
// (:639-645).
//
// Replaces tpukern/ops/paged_attention.py:513 `_prefix_kernel` for float
// pools (its wrapper `paged_prefill_attention`, :681). There, one grid
// cell owns a (sequence, KV head), flattens its GQA group's T tokens into
// one MXU operand g-major (:714-716), and DMAs whole pages through a
// double buffer. Here one block owns a (tile of query rows, KV head,
// sequence, split) with the rows flattened t-major (row = t * group + g):
// one pass over the KV head's pages serves the whole group, and a tile's
// rows span a contiguous range of positions, so its KV loop stops at the
// last row's position and, with a window, starts at the tile of the first
// row's band (sink tiles first: KvRange). Each 64-token KV tile first
// turns its positions into pool rows through the page table
// ((table[pos / page] * page + pos % page) * D, as csrc/paged_attention.cu
// does), then loads the rows with 16-byte loads (bf16) into shared memory.
//
// Split-KV (csrc/paged_attention.cu's design): the sequence's slots are
// cut into n_split splits of `chunk` slots (a multiple of the 64-key
// tile; ops/paged_attention.py prefill_splits picks it from the shapes
// alone, never the lengths), and a block walks only the tiles of its
// row tile's walk inside its split; a split wholly past the tile's last
// position, or wholly older than its band, runs no tile. With one split
// the block writes the output. With more, it writes its rows' f32
// partials (m, l and the unnormalized o; m = NEG_BIG, l = o = 0 for a row
// that saw no position in it) to a workspace, then takes a ticket from a
// per-(row tile, KV head, sequence) counter that stays zero between
// launches: the last block merges the partials in split order and resets
// the counter. One launch a call, the same bits from run to run.
//
// The bf16 kernel is csrc/flash_attention.cu's split-Q mma.sync m16n8k16
// tile (4 warps of 16 query rows, Q fragments in registers, S re-packed as
// the A operand of P V) with these paged loads in place of the dense ones;
// the f32 kernel runs on CUDA-core FMAs in full f32 (16 rows, one lane per
// key of a 32-key tile). Both keep the online softmax in f32 with natural
// exp, as the TPU kernel does. Positions are clamped to the pool: an
// inactive slot of the speculative batcher verifies at its frozen length,
// and lengths[b] may pass the pool's end.
//
// What bounds it: a chunk of T = 256 tokens over a 900-token prefix does
// 4 * D flops per visible (query, key) pair and reads each K/V row once per
// 64-row tile, so it is compute bound on the tensor cores; a verification
// of T = 5 tokens reads every live K/V byte once for 10 rows and is memory
// bound. Either way a block's tiles run one after another, each a few
// memory latencies (its loads wait behind the previous tile's barriers):
// at one block a (row tile, KV head, sequence), B * Hkv = 32 blocks of up
// to 16 tiles each at the verify shape. The splits put several blocks on
// each row tile, each walking a few tiles, at the cost of the partials
// and the merge (PERF.md). No cp.async, TMA or wgmma yet.
#include "paged_split.cuh"

namespace tk {
namespace {

constexpr int PP_THREADS = 128;
constexpr int PP_GMAX = 8;   // largest GQA group
// bf16 mma tier
constexpr int MMA_BQ = 64;   // query rows per block: 4 warps x 16
constexpr int MMA_BK = 64;   // keys per tile
// f32 FMA tier
constexpr int FMA_BQ = 16;   // query rows per block: 4 warps x 4 rows
constexpr int FMA_BK = 32;   // keys per tile: one per lane
constexpr int FMA_RPW = FMA_BQ / (PP_THREADS / 32);

// pool-row offsets of the tile's positions [k0, k0 + n) into row_s, -1
// past kv_end; the first n threads of the block
__device__ __forceinline__ void tile_rows(int64_t* row_s, const int* table,
                                          int k0, int n, int kv_end,
                                          int page_size, int D) {
  if (threadIdx.x < n) {
    const int p = k0 + threadIdx.x;
    row_s[threadIdx.x] =
        p < kv_end ? ((int64_t)table[p / page_size] * page_size + p % page_size) * D
                   : -1;
  }
}

// The block's split of its row tile: blockIdx.x = tile * n_split + split.
// Its KV tiles are those of KvRange's walk inside slots [c0, c0 + chunk)
// (both ends multiples of the tile), below kv_end.
struct SplitPart {
  int n_split, split, first, end;
  template <int BK>
  __device__ SplitPart(const KvRange<BK>& kr, int kv_end, int chunk,
                       int n_split_)
      : n_split(n_split_) {
    split = blockIdx.x % n_split;
    const int c0 = split * chunk;
    end = min(kv_end, c0 + chunk);
    first = c0 < kr.sink_end ? c0 : max(c0, kr.lo);
  }
};

template <int D, bool FEAT>
__global__ void __launch_bounds__(PP_THREADS)
paged_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                         const bf16* __restrict__ v_pages,
                         const int* __restrict__ lengths,
                         const int* __restrict__ page_table, bf16* __restrict__ o,
                         int Hq, int Hkv, int T, int P, int page_size,
                         int pages_per_seq, AttnMask f, Split sp) {
  constexpr int LDS = D + 8;      // padded smem row: conflict-free B loads of K
  constexpr int KS = D / 16;      // k-steps of Q K^T
  constexpr int NT = MMA_BK / 8;  // n-tiles of S
  constexpr int DT = D / 8;       // n-tiles of O
  __shared__ __align__(16) bf16 k_s[MMA_BK * LDS];
  __shared__ __align__(16) bf16 v_s[MMA_BK * LDS];
  __shared__ int64_t row_s[MMA_BK];
  __shared__ float m_s[MMA_BQ], l_s[MMA_BQ];
  __shared__ bool last_s;

  const int S = pages_per_seq * page_size;
  const int n_split = max(1, (S + sp.chunk - 1) / sp.chunk);
  const int row0 = blockIdx.x / n_split * MMA_BQ;
  const PrefixRows rows(lengths, Hq, Hkv, T, S, row0, MMA_BQ, f.ring > 0);
  const bf16* k_h = k_pages + rows.hk * P * page_size * D;
  const bf16* v_h = v_pages + rows.hk * P * page_size * D;
  const int* table = page_table + rows.b * pages_per_seq;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const int qi0 = rows.pos(r0), qi1 = rows.pos(r1);
  const bf16* q0p = q + rows.offset(min(r0, rows.R - 1), D);
  const bf16* q1p = q + rows.offset(min(r1, rows.R - 1), D);
  auto pair = [&](const bf16* p, int r, int c) -> uint32_t {
    return r < rows.R ? *reinterpret_cast<const uint32_t*>(p + c) : 0u;
  };

  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = pair(q0p, r0, c);
    qf[ks][1] = pair(q1p, r1, c);
    qf[ks][2] = pair(q0p, r0, c + 8);
    qf[ks][3] = pair(q1p, r1, c + 8);
  }

  float of[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) of[i][0] = of[i][1] = of[i][2] = of[i][3] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  const KvRange<MMA_BK> kr(f, max(rows.q_first, 0), FEAT);
  const SplitPart part(kr, rows.kv_end, sp.chunk, n_split);
  for (int k0 = part.first; k0 < part.end; k0 = kr.next(k0)) {
    __syncthreads();  // the previous tile is consumed
    tile_rows(row_s, table, k0, MMA_BK, rows.kv_end, page_size, D);
    __syncthreads();
    for (int i = threadIdx.x; i < MMA_BK * (D / 8); i += PP_THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const int64_t off = row_s[r];
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (off >= 0) {
        kv = *reinterpret_cast<const uint4*>(k_h + off + c8);
        vv = *reinterpret_cast<const uint4*>(v_h + off + c8);
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

    // scale, cap, mask, row max (a row spans the 4 lanes of a quad)
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? qi0 : qi1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float s = sf[nt][e] * f.scale;
        bool ok = col < rows.kv_end && col <= qi;
        if constexpr (FEAT) {
          float th;
          const int pos = slot_pos(f, col, rows.base + T - 1);
          s = alibi(f, rows.head(e < 2 ? r0 : r1), soft_cap(f, s, th), pos, qi);
          ok = col < rows.kv_end && pos >= 0 && mask_visible(f, qi, pos, 0, 0);
        }
        sf[nt][e] = ok ? s : NEG_BIG;
      }
      mx0 = fmaxf(mx0, fmaxf(sf[nt][0], sf[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sf[nt][2], sf[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sf[nt][0] = expf(sf[nt][0] - mn0);
      sf[nt][1] = expf(sf[nt][1] - mn0);
      sf[nt][2] = expf(sf[nt][2] - mn1);
      sf[nt][3] = expf(sf[nt][3] - mn1);
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

  // a row whose max stays NEG_BIG saw no position (in this split): it
  // outputs 0, or its partial is m = NEG_BIG, l = o = 0
  const bool none0 = m0 <= 0.5f * NEG_BIG, none1 = m1 <= 0.5f * NEG_BIG;
  if (part.n_split == 1) {
    const float inv0 = l0 == 0.f || none0 ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f || none1 ? 0.f : 1.f / l1;
    bf16* o0 = o + rows.offset(min(r0, rows.R - 1), D);
    bf16* o1 = o + rows.offset(min(r1, rows.R - 1), D);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (r0 < rows.R)
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
            __floats2bfloat162_rn(of[dt][0] * inv0, of[dt][1] * inv0);
      if (r1 < rows.R)
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
            __floats2bfloat162_rn(of[dt][2] * inv1, of[dt][3] * inv1);
    }
    return;
  }
  const SplitWs w(sp.ws, part.n_split, MMA_BQ, rows.R, D);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    const bool none = h ? none1 : none0;
    if (r >= rows.R) continue;
    const int64_t at = w.at(part.split, part.n_split, r - row0);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(w.o + at * D + dt * 8 + 2 * t) =
          none ? make_float2(0.f, 0.f)
               : make_float2(of[dt][2 * h], of[dt][2 * h + 1]);
    if (t == 0) {
      w.m[at] = none ? NEG_BIG : (h ? m1 : m0);
      w.l[at] = none ? 0.f : (h ? l1 : l0);
    }
  }
  merge_splits(rows, row0, min(MMA_BQ, rows.R - row0), w, part.n_split, D,
               sp.tickets, o, m_s, l_s, &last_s);
}

template <int D, bool FEAT>
__global__ void __launch_bounds__(PP_THREADS)
paged_prefill_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k_pages,
                         const float* __restrict__ v_pages,
                         const int* __restrict__ lengths,
                         const int* __restrict__ page_table, float* __restrict__ o,
                         int Hq, int Hkv, int T, int P, int page_size,
                         int pages_per_seq, AttnMask f, Split sp) {
  constexpr int DPL = D / 32;  // output columns per lane
  __shared__ float q_s[FMA_BQ][D];
  __shared__ float k_s[FMA_BK][D + 1];  // +1: lanes read distinct rows
  __shared__ float v_s[FMA_BK][D];
  __shared__ int64_t row_s[FMA_BK];
  __shared__ float m_s[FMA_BQ], l_s[FMA_BQ];
  __shared__ bool last_s;

  const int S = pages_per_seq * page_size;
  const int n_split = max(1, (S + sp.chunk - 1) / sp.chunk);
  const int row0 = blockIdx.x / n_split * FMA_BQ;
  const PrefixRows rows(lengths, Hq, Hkv, T, S, row0, FMA_BQ, f.ring > 0);
  const float* k_h = k_pages + rows.hk * P * page_size * D;
  const float* v_h = v_pages + rows.hk * P * page_size * D;
  const int* table = page_table + rows.b * pages_per_seq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < FMA_BQ * D; i += PP_THREADS) {
    const int r = i / D, c = i % D;
    q_s[r][c] = row0 + r < rows.R ? q[rows.offset(row0 + r, D) + c] * f.scale : 0.f;
  }

  float m[FMA_RPW], l[FMA_RPW], acc[FMA_RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < FMA_RPW; ++rr) {
    m[rr] = NEG_BIG;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const KvRange<FMA_BK> kr(f, max(rows.q_first, 0), FEAT);
  const SplitPart part(kr, rows.kv_end, sp.chunk, n_split);
  for (int k0 = part.first; k0 < part.end; k0 = kr.next(k0)) {
    __syncthreads();
    tile_rows(row_s, table, k0, FMA_BK, rows.kv_end, page_size, D);
    __syncthreads();
    for (int i = threadIdx.x; i < FMA_BK * D; i += PP_THREADS) {
      const int r = i / D, c = i % D;
      const int64_t off = row_s[r];
      k_s[r][c] = off >= 0 ? k_h[off + c] : 0.f;
      v_s[r][c] = off >= 0 ? v_h[off + c] : 0.f;
    }
    __syncthreads();
    const int kj = k0 + lane;  // this lane's key
#pragma unroll
    for (int rr = 0; rr < FMA_RPW; ++rr) {
      const int r = warp * FMA_RPW + rr;
      const int qi = rows.pos(row0 + r);
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(q_s[r][c], k_s[lane][c], s);
      bool ok = kj < rows.kv_end && kj <= qi;
      if constexpr (FEAT) {
        float th;  // q_s holds q * sm_scale: cap the scaled score
        const int pos = slot_pos(f, kj, rows.base + T - 1);
        s = alibi(f, rows.head(row0 + r), soft_cap(f, s, th), pos, qi);
        ok = kj < rows.kv_end && pos >= 0 && mask_visible(f, qi, pos, 0, 0);
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

  if (part.n_split == 1) {
#pragma unroll
    for (int rr = 0; rr < FMA_RPW; ++rr) {
      const int r = row0 + warp * FMA_RPW + rr;
      if (r >= rows.R) continue;
      const float inv = l[rr] == 0.f || m[rr] <= 0.5f * NEG_BIG ? 0.f : 1.f / l[rr];
      float* orow = o + rows.offset(r, D);
#pragma unroll
      for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[rr][i] * inv;
    }
    return;
  }
  // this split's partials (m = NEG_BIG, l = o = 0 for a row that saw no
  // position in it), then the merge
  const SplitWs w(sp.ws, part.n_split, FMA_BQ, rows.R, D);
#pragma unroll
  for (int rr = 0; rr < FMA_RPW; ++rr) {
    const int r = row0 + warp * FMA_RPW + rr;
    if (r >= rows.R) continue;
    const bool none = m[rr] <= 0.5f * NEG_BIG;
    const int64_t at = w.at(part.split, part.n_split, r - row0);
#pragma unroll
    for (int i = 0; i < DPL; ++i) w.o[at * D + lane + 32 * i] = none ? 0.f : acc[rr][i];
    if (lane == 0) {
      w.m[at] = none ? NEG_BIG : m[rr];
      w.l[at] = none ? 0.f : l[rr];
    }
  }
  merge_splits(rows, row0, min(FMA_BQ, rows.R - row0), w, part.n_split, D,
               sp.tickets, o, m_s, l_s, &last_s);
}

template <int D, bool FEAT>
void launch_df(const void* q, const void* k_pages, const void* v_pages,
               const int* lengths, const int* page_table, void* o, int B,
               int Hq, int Hkv, int T, int P, int page_size, int pages_per_seq,
               const AttnMask& f, const Split& sp, int n_split, int dtype,
               cudaStream_t stream) {
  const int R = T * (Hq / Hkv);
  if (dtype == kBF16) {
    dim3 grid((R + MMA_BQ - 1) / MMA_BQ * n_split, Hkv, B);
    paged_prefill_mma_kernel<D, FEAT><<<grid, PP_THREADS, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
        static_cast<const bf16*>(v_pages), lengths, page_table,
        static_cast<bf16*>(o), Hq, Hkv, T, P, page_size, pages_per_seq, f, sp);
  } else {
    dim3 grid((R + FMA_BQ - 1) / FMA_BQ * n_split, Hkv, B);
    paged_prefill_fma_kernel<D, FEAT><<<grid, PP_THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), lengths, page_table,
        static_cast<float*>(o), Hq, Hkv, T, P, page_size, pages_per_seq, f,
        sp);
  }
}

template <int D>
void launch_d(const void* q, const void* k_pages, const void* v_pages,
              const int* lengths, const int* page_table, void* o, int B, int Hq,
              int Hkv, int T, int P, int page_size, int pages_per_seq,
              const AttnMask& f, const Split& sp, int n_split, int dtype,
              cudaStream_t stream) {
  if (f.window > 0 || f.softcap > 0.f || f.ring > 0 || f.slopes)
    launch_df<D, true>(q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv,
                       T, P, page_size, pages_per_seq, f, sp, n_split, dtype,
                       stream);
  else
    launch_df<D, false>(q, k_pages, v_pages, lengths, page_table, o, B, Hq,
                        Hkv, T, P, page_size, pages_per_seq, f, sp, n_split,
                        dtype, stream);
}

}  // namespace

cudaError_t paged_prefill_launch(const void* q, const void* k_pages,
                                 const void* v_pages, const int* lengths,
                                 const int* page_table, void* o, int B, int Hq,
                                 int Hkv, int T, int P, int page_size,
                                 int pages_per_seq, int D, float sm_scale,
                                 int window, int sinks, float softcap,
                                 int ring, const float* slopes, int chunk,
                                 float* ws, int* tickets, int dtype,
                                 cudaStream_t stream) {
  if (B < 0 || T < 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > PP_GMAX ||
      page_size <= 0 || pages_per_seq < 0 || P < 0 || B > 65535 ||
      Hkv > 65535 || chunk <= 0 || chunk % MMA_BK)
    return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  // a ring keeps the earliest token's window after the T wrapped writes
  AttnMask f;
  if (!make_paged_mask(window, sinks, softcap, ring, slopes, sm_scale, &f) ||
      (ring && (ring != pages_per_seq * page_size || window + T - 1 > ring - sinks)))
    return cudaErrorInvalidValue;
  // the bf16 kernel's 16-byte K/V loads need 16-byte aligned pools, and
  // its 4-byte q loads a 4-byte aligned q
  if ((reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages)) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 4)
    return cudaErrorMisalignedAddress;
  if (B == 0 || T == 0) return cudaSuccess;
  // n_split from shapes alone; more than one needs the workspace (B Hkv
  // row tiles n_split min(BQ, R) (D + 2) floats) and B Hkv row-tile
  // zeroed tickets
  const int64_t splits = ((int64_t)pages_per_seq * page_size + chunk - 1) / chunk;
  const int64_t tiles = ((int64_t)T * (Hq / Hkv) + FMA_BQ - 1) / FMA_BQ;
  if (tiles * splits > 0x7fffffff || (splits > 1 && (!ws || !tickets)))
    return cudaErrorInvalidValue;
  const int n_split = splits > 1 ? (int)splits : 1;
  const Split sp{chunk, ws, tickets};
  switch (D) {
    case 32: launch_d<32>(q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv, T, P, page_size, pages_per_seq, f, sp, n_split, dtype, stream); break;
    case 64: launch_d<64>(q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv, T, P, page_size, pages_per_seq, f, sp, n_split, dtype, stream); break;
    case 128: launch_d<128>(q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv, T, P, page_size, pages_per_seq, f, sp, n_split, dtype, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
