// Paged decode attention: one query token per sequence against its KV
// pages. Sequence b's logical page i lives at physical page
// page_table[b][i] of the (Hkv, P, page_size, D) pools; positions at or
// past lengths[b] are masked, and a sequence of length 0 outputs 0.
//
// Replaces tpukern/ops/paged_attention.py:77 `_decode_kernel` for float
// pools. There, scalar prefetch hands the page table to the grid and async
// DMAs copy whole pages into VMEM, one sequence's blocks in order on one
// core. Here the sequence's slots are cut into splits of `chunk` tokens
// (a multiple of the 64-token tile; flash-decoding), and one block owns
// one (KV head, sequence, split): the grid is (Hkv, B, n_split), n_split
// = ceil(pages_per_seq * page_size / chunk) from shapes alone. A block
// reads the page table itself and walks its split's tiles: each first
// turns positions into pool rows, then issues all of the tile's K and V
// loads at once (16 bytes per load, several per thread, so many are in
// flight), and
//   1. scores: PA_TPR threads share a K row and, for every query head of
//      the GQA group, dot it with q (shuffle-reduced across those threads),
//   2. one warp per query head folds the tile into the split's running
//      max and sum (natural exp in f32, as the TPU kernel does) and keeps
//      P rounded to the pools' dtype for step 3, as the TPU kernel's P V
//      dot takes it (against the split's running max),
//   3. each thread owns one 16-byte column chunk of V and a strided subset
//      of the tile's tokens, and accumulates p * V for every head of the
//      group; the token subsets are summed once, at the end.
// All `group` query heads share one pass over the KV head's pages, as the
// TPU kernel batches them (paged_attention.py:324-325). Each instance
// unrolls its per-head loops over G heads (1, 2, 4 or 8, the smallest
// that holds the call's group): a group of 2 on loops over 8 heads spent
// most of its issue slots on masked-off heads and ran about half as
// fast (PERF.md).
//
// With one split the block writes the output. With more, each writes its
// f32 partial (m, l, and the unnormalized o of each head; m = NEG_BIG and
// l = o = 0 where it saw no position) to a workspace, then takes a ticket
// from a per-(sequence, KV head) counter that stays zero between launches
// (the pattern of csrc/matmul_w8a16.cu): the last block of the pair
// merges the partials in split order, in f32 (M = the largest m; o = sum
// exp(m_z - M) o_z / sum exp(m_z - M) l_z, 0 where that sum is 0), and
// resets the counter. One launch a call; the merge's order is fixed, so a
// call's result is the same bit for bit from run to run.
//
// The FEAT instance adds the masks of the TPU kernel's float pools
// (:209-249): a sliding window keeps positions >= length - window, or
// < sinks, and a softcap maps each scaled score s to cap * tanh(s / cap)
// before the mask. Its tile loop visits the sink tiles, then the tiles
// from the one holding length - window on (KvRange, common.cuh), as the
// TPU kernel skips blocks wholly older than the band (:111-122); a split
// visits those of them inside its slots, so a split wholly older than
// the band runs no tile. It also takes the TPU kernel's last two
// options: a ring pool, where slot j holds the newest position congruent
// to j (slot_pos, common.cuh: the TPU kernel's :213-231) and every live
// slot is visited, since any may hold a position inside the window
// (:113-120), and ALiBi, which adds slopes[head] * (k_pos - q_pos) to the
// scaled score before the mask (:232-240). The plain decode instance
// (FEAT off) compiles without them.
//
// What bounds it: decode reads every live K/V byte once and does 4 flops
// per group and per byte pair, so it is bound by memory bandwidth. One
// block a (sequence, KV head) put 32 blocks on 132 SMs at B = 4, Hkv = 8,
// each walking its tiles one after another, a few memory latencies a
// tile: split-KV puts B * Hkv * n_split blocks in flight, and a block's
// dependent tiles are those of one chunk. What is left (PERF.md):
// a tile's loads still wait behind the previous tile's three barriers
// (no second tile in flight in a block), each block pays its own q
// staging and partial, and the merge adds a pass over the partials at
// the end of each (sequence, KV head), longer with more splits.
#include "common.cuh"

namespace tk {
namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_TILE = 64;  // tokens per tile: 2 per lane in the softmax
constexpr int PA_GMAX = 8;   // largest GQA group
constexpr int PA_TPR = 8;    // threads per K row in the score pass (at most)

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

// The workspace of a launch with n_split > 1: for each (b, hk) pair bh =
// b * Hkv + hk, split z and head gi of the group, the partial o (D
// floats), then all the m, then all the l.
struct SplitWs {
  float* o;
  float* m;
  float* l;
  __device__ SplitWs(float* ws, int pairs, int n_split, int group, int D) {
    const int64_t heads = (int64_t)pairs * n_split * group;
    o = ws;
    m = ws + heads * D;
    l = m + heads;
  }
};

// G: the instance's largest GQA group (1, 2, 4 or 8; the launcher takes
// the smallest that holds the call's group), so that a group of 2 runs
// no loop over 8 heads
template <typename T, int D, bool FEAT, int G>
__global__ void __launch_bounds__(PA_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ page_table, T* __restrict__ o, int Hq,
                    int Hkv, int P, int page_size, int pages_per_seq,
                    AttnMask f, int chunk, float* __restrict__ ws,
                    int* __restrict__ tickets) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CH = D / VEC;          // 16-byte chunks per row
  // score pass: TPR threads per K row, CPT chunks each, PA_THREADS / TPR
  // rows at once, K_PASSES times per tile
  constexpr int TPR = CH < PA_TPR ? CH : PA_TPR;
  constexpr int CPT = CH / TPR;
  constexpr int K_PASSES = PA_TILE / (PA_THREADS / TPR);
  // P V pass: one chunk per thread, TG token groups, V_PASSES tokens each
  constexpr int TG = PA_THREADS / CH;
  constexpr int V_PASSES = PA_TILE / TG;
  static_assert(D % VEC == 0 && PA_THREADS % CH == 0 && CH % TPR == 0 &&
                    K_PASSES >= 1 && V_PASSES >= 1,
                "unsupported head dim");

  __shared__ float q_s[G][D];
  __shared__ float p_s[G][PA_TILE];
  __shared__ int64_t row_s[PA_TILE];
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ __align__(16) float red_s[PA_THREADS * VEC];
  __shared__ bool last_s;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % TPR, krow = tid / TPR;  // score pass
  const int ch = tid % CH, tg = tid / CH;       // P V pass
  const T* q_b = q + ((int64_t)b * Hq + (int64_t)hk * group) * D;
  const T* k_h = k_pages + (int64_t)hk * P * page_size * D;
  const T* v_h = v_pages + (int64_t)hk * P * page_size * D;
  const int* table = page_table + (int64_t)b * pages_per_seq;
  // a caller may pass length + 1 for a slot already at the pool's end
  // (an inactive slot's dead decode); nothing past the pool exists
  const int len = max(0, min(lengths[b], pages_per_seq * page_size));
  // the query token's position: the band is taken from the unclamped
  // length, as the TPU kernel's mask is
  const int qpos = lengths[b] - 1;
  const KvRange<PA_TILE> kr(f, max(qpos, 0), FEAT);
  // this split's slots [c0, c0 + chunk): the tiles of KvRange's walk
  // among them (c0 and the walk's tiles are PA_TILE-aligned)
  const int c0 = split * chunk, end = min(len, c0 + chunk);
  const int first = c0 < kr.sink_end ? c0 : max(c0, kr.lo);

  for (int i = tid; i < group * D; i += PA_THREADS)
    q_s[i / D][i % D] = to_f32(q_b[i]) * f.scale;
  if (tid < G) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }
  float acc[G][VEC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.f;

  for (int t0 = first; t0 < end; t0 = kr.next(t0)) {
    const int n = min(PA_TILE, end - t0);
    __syncthreads();  // q_s/m_s written, or the previous tile consumed
    if (tid < n) {
      const int pos = t0 + tid;
      const int64_t page = table[pos / page_size];
      row_s[tid] = (page * page_size + pos % page_size) * D;
    }
    __syncthreads();

    // every K and V load of the tile, issued before any is used
    uint4 kr[K_PASSES][CPT], vr[V_PASSES];
#pragma unroll
    for (int ps = 0; ps < K_PASSES; ++ps) {
      const int j = ps * (PA_THREADS / TPR) + krow;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        kr[ps][c] = load16(k_h + (j < n ? row_s[j] : 0) + (sub + c * TPR) * VEC, j < n);
    }
#pragma unroll
    for (int ps = 0; ps < V_PASSES; ++ps) {
      const int j = ps * TG + tg;
      vr[ps] = load16(v_h + (j < n ? row_s[j] : 0) + ch * VEC, j < n);
    }

    // 1. scores
#pragma unroll
    for (int ps = 0; ps < K_PASSES; ++ps) {
      const int j = ps * (PA_THREADS / TPR) + krow;
      float part[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) part[gi] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const T* e = reinterpret_cast<const T*>(&kr[ps][c]);
        const int col = (sub + c * TPR) * VEC;
#pragma unroll
        for (int x = 0; x < VEC; ++x) {
          const float kv = to_f32(e[x]);
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
            if (gi < group) part[gi] = fmaf(q_s[gi][col + x], kv, part[gi]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (gi < group) {
          float s = part[gi];
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (sub == 0) {
            bool ok = j < n;
            if constexpr (FEAT) {
              float t;
              const int pos = slot_pos(f, t0 + j, qpos);
              s = alibi(f, hk * group + gi, soft_cap(f, s, t), pos, qpos);
              ok = ok && pos >= 0 && mask_visible(f, qpos, pos, 0, 0);
            }
            p_s[gi][j] = ok ? s : NEG_BIG;
          }
        }
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head. The sum l takes p in
    //    f32; the P V pass takes p in the pools' dtype, as the TPU kernel
    //    casts p to V's dtype before its P V dot (paged_attention.py:69-74)
    for (int gi = warp; gi < group; gi += PA_WARPS) {
      const float s0 = p_s[gi][lane], s1 = p_s[gi][lane + 32];
      const float m_old = m_s[gi];
      const float mn = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - mn), p1 = expf(s1 - mn);
      const float sum = warp_sum(p0 + p1);
      p_s[gi][lane] = to_f32(from_f32<T>(p0));
      p_s[gi][lane + 32] = to_f32(from_f32<T>(p1));
      if (lane == 0) {
        const float alpha = expf(m_old - mn);
        alpha_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = mn;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p V over this thread's tokens and columns
    //    (masked tokens have p = 0 and zero V)
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < group) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[gi][e] *= alpha_s[gi];
      }
    }
#pragma unroll
    for (int ps = 0; ps < V_PASSES; ++ps) {
      const int j = ps * TG + tg;
      const T* e = reinterpret_cast<const T*>(&vr[ps]);
#pragma unroll
      for (int x = 0; x < VEC; ++x) {
        const float vv = to_f32(e[x]);
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          if (gi < group) acc[gi][x] = fmaf(p_s[gi][j], vv, acc[gi][x]);
      }
    }
  }

  // sum the TG token groups' partial outputs, one query head at a time:
  // the output (one split), or this split's partial
  T* o_b = o + ((int64_t)b * Hq + (int64_t)hk * group) * D;
  const int64_t bh = (int64_t)b * Hkv + hk;
  const SplitWs w(ws, gridDim.x * gridDim.y, n_split, group, D);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < group) {
      __syncthreads();  // the tile loop or the previous head is done with red_s
#pragma unroll
      for (int e = 0; e < VEC; ++e) red_s[tid * VEC + e] = acc[gi][e];
      __syncthreads();
      // a head whose max stays NEG_BIG saw no position (a length of 0, a
      // split past the length or older than the window): l = o = 0
      const bool none = m_s[gi] <= 0.5f * NEG_BIG;
      const float l = none ? 0.f : l_s[gi];
      const int64_t head = (bh * n_split + split) * group + gi;
      for (int d = tid; d < D; d += PA_THREADS) {
        float s = 0.f;
        for (int t = 0; t < TG; ++t) s += red_s[(t * CH + d / VEC) * VEC + d % VEC];
        if (n_split == 1)
          o_b[(int64_t)gi * D + d] = from_f32<T>(l == 0.f ? 0.f : s / l);
        else
          w.o[head * D + d] = none ? 0.f : s;
      }
      if (n_split > 1 && tid == 0) {
        w.m[head] = none ? NEG_BIG : m_s[gi];
        w.l[head] = l;
      }
    }
  }
  if (n_split == 1) return;

  // the last split of (b, hk) to finish merges them all
  __threadfence();  // the partial is visible to every block before the ticket
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[bh], 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // (reads through L2 only: other blocks wrote the partials.) Each head's
  // largest m, a warp a head, the splits across its lanes; then each
  // output sums its splits in order, the loop unrolled so that the loads
  // of many splits are in flight at once
  const int64_t h0 = bh * n_split * group;  // split z, head gi: h0 + z group + gi
  for (int gi = warp; gi < group; gi += PA_WARPS) {
    float mx = NEG_BIG;
    for (int z = lane; z < n_split; z += 32)
      mx = fmaxf(mx, __ldcg(w.m + h0 + (int64_t)z * group + gi));
    mx = warp_max(mx);
    if (lane == 0) m_s[gi] = mx;
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += PA_THREADS) {
    const int gi = i / D, d = i % D;
    const float M = m_s[gi];
    float L = 0.f, O = 0.f;
#pragma unroll 16
    for (int z = 0; z < n_split; ++z) {
      const int64_t h = h0 + (int64_t)z * group + gi;
      const float a = expf(__ldcg(w.m + h) - M);
      L = fmaf(a, __ldcg(w.l + h), L);
      O = fmaf(a, __ldcg(w.o + h * D + d), O);
    }
    o_b[(int64_t)gi * D + d] = from_f32<T>(L == 0.f ? 0.f : O / L);
  }
  if (tid == 0) tickets[bh] = 0;
}

// the split of a launch: tokens a split, the workspace and the tickets
struct Split {
  int chunk;
  float* ws;
  int* tickets;
};

template <typename T, int D, bool FEAT>
void launch_tdf(dim3 grid, cudaStream_t stream, const void* q,
                const void* k_pages, const void* v_pages, const int* lengths,
                const int* page_table, void* o, int Hq, int Hkv, int P,
                int page_size, int pages_per_seq, const AttnMask& f,
                const Split& sp) {
  const int group = Hq / Hkv;
  auto go = [&](auto kernel) {
    kernel<<<grid, PA_THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), lengths, page_table,
        static_cast<T*>(o), Hq, Hkv, P, page_size, pages_per_seq, f,
        sp.chunk, sp.ws, sp.tickets);
  };
  if (group <= 1) go(paged_decode_kernel<T, D, FEAT, 1>);
  else if (group <= 2) go(paged_decode_kernel<T, D, FEAT, 2>);
  else if (group <= 4) go(paged_decode_kernel<T, D, FEAT, 4>);
  else go(paged_decode_kernel<T, D, FEAT, PA_GMAX>);
}

template <int D>
void launch_d(dim3 grid, cudaStream_t stream, const void* q, const void* k_pages,
              const void* v_pages, const int* lengths, const int* page_table,
              void* o, int Hq, int Hkv, int P, int page_size, int pages_per_seq,
              const AttnMask& f, const Split& sp, int dtype) {
  const bool feat = f.window > 0 || f.softcap > 0.f || f.ring > 0 || f.slopes;
  auto go = [&](auto kernel) {
    kernel(grid, stream, q, k_pages, v_pages, lengths, page_table, o, Hq, Hkv,
           P, page_size, pages_per_seq, f, sp);
  };
  if (dtype == kBF16)
    feat ? go(&launch_tdf<bf16, D, true>) : go(&launch_tdf<bf16, D, false>);
  else
    feat ? go(&launch_tdf<float, D, true>) : go(&launch_tdf<float, D, false>);
}

}  // namespace

cudaError_t paged_attention_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const int* lengths,
                                   const int* page_table, void* o, int B, int Hq,
                                   int Hkv, int P, int page_size,
                                   int pages_per_seq, int D, float sm_scale,
                                   int window, int sinks, float softcap,
                                   int ring, const float* slopes, int chunk,
                                   float* ws, int* tickets, int dtype,
                                   cudaStream_t stream) {
  if (B < 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > PA_GMAX || page_size <= 0 ||
      pages_per_seq < 0 || P < 0 || B > 65535 || chunk <= 0 ||
      chunk % PA_TILE)
    return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  AttnMask f;
  if (!make_paged_mask(window, sinks, softcap, ring, slopes, sm_scale, &f) ||
      (ring && ring != pages_per_seq * page_size))
    return cudaErrorInvalidValue;
  // the 16-byte loads need 16-byte aligned pools (rows are, given the D)
  if ((reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages)) % 16)
    return cudaErrorMisalignedAddress;
  if (B == 0) return cudaSuccess;
  // n_split from shapes alone; more than one needs the workspace (B Hkv
  // n_split (Hq / Hkv) (D + 2) floats) and B Hkv zeroed tickets
  const int64_t splits =
      ((int64_t)pages_per_seq * page_size + chunk - 1) / chunk;
  if (splits > 65535 || (splits > 1 && (!ws || !tickets)))
    return cudaErrorInvalidValue;
  const int n_split = splits > 1 ? (int)splits : 1;
  const Split sp{chunk, ws, tickets};
  dim3 grid(Hkv, B, n_split);
  switch (D) {
    case 32: launch_d<32>(grid, stream, q, k_pages, v_pages, lengths, page_table, o, Hq, Hkv, P, page_size, pages_per_seq, f, sp, dtype); break;
    case 64: launch_d<64>(grid, stream, q, k_pages, v_pages, lengths, page_table, o, Hq, Hkv, P, page_size, pages_per_seq, f, sp, dtype); break;
    case 128: launch_d<128>(grid, stream, q, k_pages, v_pages, lengths, page_table, o, Hq, Hkv, P, page_size, pages_per_seq, f, sp, dtype); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
