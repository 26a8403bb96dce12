// Token sampling: the streaming gumbel-max / argmax pass and the per-row
// top-k / top-p logit threshold.
//
// sample_kernel replaces tpukern/ops/sampling.py:45 `_sample_kernel`: per
// row, the first index of the largest x * inv_temp (+ Gumbel noise), with
// columns whose raw logit is below the row's threshold masked to NEG_BIG,
// in the TPU kernel's order (scale, add the noise, mask). The TPU kernel
// walks the vocabulary's blocks in order and carries (best value, best
// index) in scratch; CUDA blocks run in no order and carry nothing, so
// here the vocabulary is split over blocks of SA_CHUNK columns. Each block
// reduces its columns to one 64-bit key, (order key of the value) << 32 |
// ~index, whose maximum is the largest value and, among equal values, the
// first index; a second kernel, one warp per row, takes the maximum of a
// row's partial keys. -0 counts as +0, as the comparisons of the TPU
// kernel do. The noise is read from a (B, V) tensor (the TPU kernel's
// interpret-mode "input" noise) or made in the kernel: Philox4x32-10
// keyed by the 64-bit seed, with counter (column, row, 0, 0), so a draw
// depends on neither the launch shape nor the split; u = (low 23 bits +
// 0.5) / 2^23 and g = -log(-log u), as the TPU kernel makes it from its
// on-chip PRNG (sampling.py:75-80). ops/sampling.py's plain version
// computes the same Philox bits. The products and sums are rounded one
// by one (__fmul_rn, __fadd_rn: no fused multiply-add), so with the same
// noise the index equals the plain version's bit for bit.
//
// threshold_cluster_kernel replaces sampling.py:182 `_threshold_kernel`:
// the k-th largest logit of a row (count mode), or the smallest kept logit
// of the top-p nucleus (mass mode): the smallest data value d with
//   sum of w over the values strictly above d  <  target,
// where w = exp((x - max) * inv_temp) and target = k (count: w = 1) or
// p * sum(w) (mass). The TPU kernel bisects that predicate in 33 steps
// over monotone int32 keys of the values, its 8 rows resident in VMEM.
// Here a thread-block cluster of C blocks (up to 16, the non-portable
// size above 8) owns a row and runs a radix select over the same keys (as
// unsigned, the sign bit flipped): 4 passes of 8 bits. Block r of the
// cluster owns n columns of the row (n = C's share rounded up to 4) and
//   1. stages them in shared memory, once (16-byte loads where the row
//      allows); in mass mode the row's max is merged over the cluster
//      through distributed shared memory (after a cluster barrier lane r
//      of warp 0 reads block r's max) and w is computed once a value, in
//      pass 0, and kept beside it;
//   2. in each pass builds a 256-bin histogram (count, and the mass as
//      w * 2^40 in 64-bit fixed point) of its values that match the
//      digits chosen so far, one histogram a warp with warp-aggregated
//      adds: the lanes of a warp whose values fall in one bin
//      (__match_any_sync) add their count once, by their first lane, and
//      their masses in rounds by their rank in the group, so that in a
//      round each bin of the warp's own histogram has one writer and the
//      adds need no atomics (summing a group's masses by
//      __reduce_add_sync under the group's mask instead ran mass mode at
//      35.2 µs against count mode's 11.8 on an H100 at (4, 32768); the
//      rounds take it to 21.9);
//   3. merges the cluster's histograms: each block folds its warps'
//      histograms and adds its non-empty bins into every block's merged
//      histogram (red.shared::cluster, integers, so in any order; two
//      alternating merged histograms, so a block that runs ahead never
//      adds into one still being read), then after a cluster barrier
//      every block picks the same digit from its merged bins: warp 0
//      scans the bins from the top for the lowest non-empty bin whose
//      mass above stays below the target; no broadcast is needed;
//   4. compacts the values that still match the chosen digits into a
//      list in shared memory (with their w), which the next pass walks
//      instead of the whole share; where the chosen bin holds a single
//      value of the row, the block that holds it writes it and the
//      passes stop (the later ones would only spell out its key).
// Masses are integers, so their sums depend on neither the order of the
// adds nor the split over blocks, and with the same order key, the same
// expf((v - m) * inv_temp) and the same __double2ull_rn the threshold
// equals a one-block radix select's over the whole row bit for bit; the
// result is always a data value. The cluster's size follows from B and V
// (threshold_plan, mirrored by ops/sampling.py threshold_plan): 16 blocks
// a row, halved while a block would get fewer than TH_BLOCK_MIN values or
// B C would pass the card's 132 SMs. A share too large to stage
// (TH_STAGE_MAX bytes) is re-read from global memory (L2) in each pass,
// with w recomputed, and no compaction. A launch the card refuses (no
// cluster of the size fits) fails with an error; no other kernel stands
// in for it.
//
// What bounds them: each reads B * V logits once (sample also the noise);
// at the serving shape, (4, 32768) f32, that is 512 KB, 0.16 us at 3.35
// TB/s, so launch latency and, for the threshold, its cluster barriers
// (one before the first pass, one a pass, one at the end) bound them.
#include <map>
#include <tuple>

#include "hopper.cuh"

namespace tk {
namespace {

constexpr int SA_THREADS = 256;
constexpr int SA_CHUNK = 2048;  // columns per block (8 per thread)
constexpr int TH_THREADS = 512;
constexpr int TH_WARPS = TH_THREADS / 32;
constexpr int TH_BINS = 256;
constexpr double TH_FIX = 1099511627776.0;  // 2^40: fixed-point scale of w
// the cluster's shape rule (threshold_plan): blocks a row, at most
constexpr int TH_CLUSTER_MAX = 16;
constexpr int TH_CLUSTER_PORTABLE = 8;
constexpr int TH_BLOCK_MIN = 2048;  // values a block at least
constexpr int TH_SMS = 132;         // an H100 SXM's SMs: B C at most this
constexpr int TH_STAGE_MAX = 160 * 1024;  // staged bytes a block at most
// the histograms ahead of the staged values: [2][256] merged masses (u64)
// and counts (u32), [TH_WARPS][256] the warps' counts, and in mass mode
// [TH_WARPS][256] the warps' masses
__host__ __device__ constexpr int th_head_bytes(bool mass) {
  return 2 * TH_BINS * 12 + TH_WARPS * TH_BINS * (mass ? 12 : 4);
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = (static_cast<float>(bits & 0x7FFFFFu) + 0.5f) *
                  (1.f / 8388608.f);
  return -logf(-logf(u));
}

// monotone unsigned key of a float (the TPU kernel's int32 key with the
// sign bit flipped), and back
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// (value, column) as one key: larger value first, then the smaller column
__device__ __forceinline__ unsigned long long best_key(float v, int col) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;  // -0 ties +0
  return (static_cast<unsigned long long>(order_key(__uint_as_float(u)))
          << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(col));
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_max64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = umax64(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int column_of(unsigned long long key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

// mode: 0 no noise (argmax), 1 noise read from `noise`, 2 Philox noise
template <typename T>
__global__ void __launch_bounds__(SA_THREADS)
sample_kernel(const T* __restrict__ x, const float* __restrict__ thr,
              const float* __restrict__ noise, int mode, uint32_t k0,
              uint32_t k1, float inv_temp, int V, int n_split,
              unsigned long long* __restrict__ part, int* __restrict__ out) {
  __shared__ unsigned long long red_s[SA_THREADS / 32];
  const int b = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(b) * V;
  const int c_end = min(V, (split + 1) * SA_CHUNK);
  const float t = thr ? thr[b] : 0.f;
  unsigned long long best = 0;
  for (int c = split * SA_CHUNK + threadIdx.x; c < c_end; c += SA_THREADS) {
    const float raw = to_f32(x[row + c]);
    float v = __fmul_rn(raw, inv_temp);
    if (mode == 1) v = __fadd_rn(v, noise[row + c]);
    else if (mode == 2) v = __fadd_rn(v, gumbel(philox_word0(c, b, k0, k1)));
    if (thr && !(raw >= t)) v = NEG_BIG;
    best = umax64(best, best_key(v, c));
  }
  best = warp_max64(best);
  if (lane == 0) red_s[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = warp_max64(lane < SA_THREADS / 32 ? red_s[lane] : 0ull);
    if (lane == 0) {
      if (n_split == 1) out[b] = column_of(best);
      else part[static_cast<int64_t>(b) * n_split + split] = best;
    }
  }
}

// one warp per row: the best of the row's n_split partial keys
__global__ void __launch_bounds__(SA_THREADS)
sample_combine_kernel(const unsigned long long* __restrict__ part, int B,
                      int n_split, int* __restrict__ out) {
  const int b = blockIdx.x * (SA_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  unsigned long long best = 0;
  for (int i = lane; i < n_split; i += 32)
    best = umax64(best, part[static_cast<int64_t>(b) * n_split + i]);
  best = warp_max64(best);
  if (lane == 0) out[b] = column_of(best);
}

// the fixed-point mass of a weight, as the one-block kernel computed it
__device__ __forceinline__ unsigned long long fixed_mass(float w) {
  return __double2ull_rn(static_cast<double>(w) * TH_FIX);
}

// One cluster of C blocks a row (blockIdx.x / C), block r on columns
// [r n, r n + n) of it. STAGED: those columns (and in mass mode their
// weights) in shared memory, compacted after each pass; else re-read from
// global memory every pass. vec: 16-byte loads (V a multiple of 4, x
// aligned).
template <bool MASS, bool STAGED>
__global__ void __launch_bounds__(TH_THREADS)
threshold_cluster_kernel(const float* __restrict__ x, float* __restrict__ thr,
                         int V, int C, int n, bool vec, int kk, float pp,
                         float inv_temp) {
  extern __shared__ __align__(16) unsigned char th_smem[];
  auto* mm = reinterpret_cast<unsigned long long*>(th_smem);  // [2][256]
  auto* mc = reinterpret_cast<unsigned int*>(mm + 2 * TH_BINS);  // [2][256]
  auto* hcw = mc + 2 * TH_BINS;                     // [TH_WARPS][256]
  auto* hmw = reinterpret_cast<unsigned long long*>(
      hcw + TH_WARPS * TH_BINS);                    // MASS: [TH_WARPS][256]
  // STAGED: the share (xa, wa) and a list (xb, wb); wa, wb in mass mode
  float* xa = reinterpret_cast<float*>(th_smem + th_head_bytes(MASS));
  float* wa = xa + n;
  float* xb = xa + (MASS ? 2 : 1) * n;
  float* wb = xb + n;
  __shared__ float max_s[TH_WARPS];
  __shared__ float cmax_s;  // this block's max, read by the cluster
  __shared__ float m_s;     // the row's
  __shared__ uint32_t prefix_s;
  __shared__ unsigned long long above_s;
  __shared__ int found_s, len_s, single_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = cluster_rank();
  const int row = blockIdx.x / C;
  const float* xr = x + static_cast<int64_t>(row) * V;
  const int c0 = min(V, static_cast<int>(rank) * n);
  const int len0 = min(V, c0 + n) - c0;  // this block's columns
  const float* xs = xr + c0;

  // both merged histograms zeroed before any block adds into them (the
  // first cluster barrier, below)
  for (int i = tid; i < 2 * TH_BINS; i += TH_THREADS) {
    mm[i] = 0;
    mc[i] = 0;
  }
  // 1. the share into shared memory; in mass mode the row's max
  float lmax = -__uint_as_float(0x7F800000u);  // -inf
  if constexpr (STAGED) {
    if (vec) {
      for (int i = tid * 4; i < len0; i += TH_THREADS * 4) {
        const float4 q = *reinterpret_cast<const float4*>(xs + i);
        *reinterpret_cast<float4*>(xa + i) = q;
        if (MASS) lmax = fmaxf(fmaxf(lmax, q.x), fmaxf(fmaxf(q.y, q.z), q.w));
      }
    } else {
      for (int i = tid; i < len0; i += TH_THREADS) {
        xa[i] = xs[i];
        if (MASS) lmax = fmaxf(lmax, xa[i]);
      }
    }
  } else if (MASS) {
    for (int i = tid; i < len0; i += TH_THREADS) lmax = fmaxf(lmax, xs[i]);
  }
  float m = 0.f;
  if constexpr (MASS) {
    lmax = warp_max(lmax);
    if (lane == 0) max_s[warp] = lmax;
    __syncthreads();
    if (tid == 0) {
      float b = max_s[0];
#pragma unroll
      for (int w = 1; w < TH_WARPS; ++w) b = fmaxf(b, max_s[w]);
      cmax_s = b;
    }
  }
  cluster_sync<true>();  // every block's max posted, merged bins zeroed
  if constexpr (MASS) {
    if (warp == 0) {
      float b = -__uint_as_float(0x7F800000u);
      if (lane < C)
        b = __uint_as_float(dsmem_ld_u32(cluster_addr(&cmax_s, lane)));
      b = warp_max(b);
      if (lane == 0) m_s = b;
    }
    __syncthreads();
    m = m_s;
  }

  const float* lx = xa;  // the values (and weights) the pass walks
  const float* lw = wa;
  float* ox = xb;        // where the values that stay go
  float* ow = wb;
  int len = len0;
  uint32_t prefix = 0;             // the key digits chosen so far
  unsigned long long above = 0;    // the weight of the values above them
  double target = 0.0;             // warp 0's, from the first pass
  bool found = true, written = false;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t high = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
    unsigned long long* mm_p = mm + (pass & 1) * TH_BINS;
    unsigned int* mc_p = mc + (pass & 1) * TH_BINS;
    unsigned int* my_c = hcw + warp * TH_BINS;  // this warp's histogram
    unsigned long long* my_m = hmw + warp * TH_BINS;
    for (int i = lane; i < TH_BINS; i += 32) {
      my_c[i] = 0;
      if (MASS) my_m[i] = 0;
    }
    __syncwarp();
    // 2. the histogram of the values matching the prefix (every value of
    // a staged list does); all lanes of a warp take each step
    for (int base = warp * 32; base < len; base += TH_THREADS) {
      const int i = base + lane;
      bool live = i < len;
      float v = 0.f, w = 0.f;
      if (live) {
        if constexpr (STAGED) {
          v = lx[i];
          if (MASS) {
            if (pass == 0) {
              w = expf((v - m) * inv_temp);
              wa[i] = w;
            } else {
              w = lw[i];
            }
          }
        } else {
          v = xs[i];
          live = (order_key(v) & high) == prefix;
          if (MASS && live) w = expf((v - m) * inv_temp);
        }
      }
      const uint32_t u = order_key(v);
      const int bin = live ? static_cast<int>((u >> shift) & (TH_BINS - 1))
                           : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      const int rank = __popc(peers & ((1u << lane) - 1));  // in the group
      if (live && rank == 0) my_c[bin] += static_cast<unsigned>(__popc(peers));
      if (MASS) {
        // the lanes of rank r add their masses in round r: one lane a bin
        // a round, so plain adds; as many rounds as the largest group
        const unsigned long long fm = live ? fixed_mass(w) : 0ull;
        int rounds = live ? __popc(peers) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          rounds = max(rounds, __shfl_xor_sync(0xffffffffu, rounds, o));
        for (int r = 0; r < rounds; ++r) {
          if (live && rank == r) my_m[bin] += fm;
          __syncwarp();
        }
      }
      __syncwarp();
    }
    __syncthreads();
    // 3. this block's non-empty bins (its warps' histograms folded) into
    // every block's merged histogram (block rank + j first, so the blocks
    // spread their adds); the other merged histogram zeroed for the next
    // pass
    for (int i = tid; i < TH_BINS; i += TH_THREADS) {
      mm[((pass + 1) & 1) * TH_BINS + i] = 0;
      mc[((pass + 1) & 1) * TH_BINS + i] = 0;
    }
    for (int bin = tid; bin < TH_BINS; bin += TH_THREADS) {
      unsigned int c = 0;
      unsigned long long s = 0;
#pragma unroll
      for (int w = 0; w < TH_WARPS; ++w) {
        c += hcw[w * TH_BINS + bin];
        if (MASS) s += hmw[w * TH_BINS + bin];
      }
      if (c == 0) continue;
      for (int j = 0; j < C; ++j) {
        const uint32_t r = (rank + j) % C;
        dsmem_add_u32(cluster_addr(&mc_p[bin], r), c);
        if (MASS) dsmem_add_u64(cluster_addr(&mm_p[bin], r), s);
      }
    }
    cluster_sync<true>();  // every block's adds in
    if (warp == 0) {
      // lane l owns bins 255 - 8l - j, j = 0..7 (lane 0 the top ones)
      unsigned int cnt[8];
      unsigned long long wt[8], seg = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bin = TH_BINS - 1 - 8 * lane - j;
        cnt[j] = mc_p[bin];
        wt[j] = MASS ? mm_p[bin] : cnt[j];
        seg += wt[j];
      }
      unsigned long long incl = seg;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      if (pass == 0) {
        const unsigned long long total = __shfl_sync(0xffffffffu, incl, 31);
        target = MASS ? static_cast<double>(pp) * static_cast<double>(total)
                      : static_cast<double>(kk);
      }
      // the lowest non-empty bin whose weight above stays below the target
      unsigned long long run = above + incl - seg, cand_above = 0;
      int cand = -1;
      unsigned int cand_cnt = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cnt[j] > 0 && static_cast<double>(run) < target) {
          cand = TH_BINS - 1 - 8 * lane - j;
          cand_above = run;
          cand_cnt = cnt[j];
        }
        run += wt[j];
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, cand >= 0);
      // every thread read the last pass's list length before this
      // pass's barriers: the count restarts for this pass's list
      if (lane == 0) len_s = 0;
      if (ballot == 0) {
        if (lane == 0) found_s = 0;
      } else if (lane == 31 - __clz(static_cast<int>(ballot))) {
        prefix_s = prefix | (static_cast<uint32_t>(cand) << shift);
        above_s = cand_above;
        found_s = 1;
        single_s = cand_cnt == 1;
      }
    }
    __syncthreads();
    if (!found_s) {
      found = false;  // every block of the cluster alike
      break;
    }
    prefix = prefix_s;
    above = above_s;
    if constexpr (STAGED) {
      if (pass < 3) {
        // 4. the values that keep matching, into the list
        const uint32_t keep_high = 0xFFFFFFFFu << shift;
        for (int base = warp * 32; base < len; base += TH_THREADS) {
          const int i = base + lane;
          const bool keep =
              i < len && (order_key(lx[i]) & keep_high) == prefix;
          const unsigned bal = __ballot_sync(0xffffffffu, keep);
          int at = 0;
          if (lane == 0 && bal) at = atomicAdd(&len_s, __popc(bal));
          at = __shfl_sync(0xffffffffu, at, 0);
          if (keep) {
            const int j = at + __popc(bal & ((1u << lane) - 1));
            ox[j] = lx[i];
            if (MASS) ow[j] = lw[i];
          }
        }
        __syncthreads();
        len = len_s;
        const float* tx = lx;
        const float* tw = lw;
        lx = ox;
        lw = ow;
        ox = const_cast<float*>(tx);
        ow = const_cast<float*>(tw);
        if (single_s) {
          // the chosen bin holds one value of the row: the later passes
          // would only spell out its key, so the block that holds it
          // writes it (the value is its key's float, bit for bit)
          if (tid == 0 && len == 1) thr[row] = lx[0];
          written = true;  // in every block of the cluster alike
          break;
        }
      }
    }
  }
  if (rank == 0 && tid == 0 && !written)
    // no value qualifies (a target <= 0): NaN keeps nothing, as the TPU
    // kernel's bisection then returns the key 0x7fffffff
    thr[row] = found ? from_order_key(prefix) : __uint_as_float(0x7FFFFFFFu);
  cluster_sync<false>();  // no block leaves while others read or add
}

// The cluster's shape for B rows of V values: C blocks a row, n values a
// block (a multiple of 4), whether the share is staged, and the dynamic
// shared bytes a block (ops/sampling.py threshold_plan mirrors it)
struct ThPlan {
  int C, n, staged, smem;
};

ThPlan threshold_plan(int B, int V, bool mass) {
  ThPlan p;
  p.C = TH_CLUSTER_MAX;
  while (p.C > 1 && (static_cast<int64_t>(p.C) * TH_BLOCK_MIN > V ||
                     static_cast<int64_t>(B) * p.C > TH_SMS))
    p.C >>= 1;
  p.n = ((V + p.C - 1) / p.C + 3) / 4 * 4;
  const int64_t stage = static_cast<int64_t>(p.n) * (mass ? 16 : 8);
  p.staged = stage <= TH_STAGE_MAX;
  p.smem = th_head_bytes(mass) + (p.staged ? static_cast<int>(stage) : 0);
  return p;
}

template <bool MASS, bool STAGED>
cudaError_t launch_threshold(const float* x, float* thr, int B, int V,
                             const ThPlan& p, int kk, float pp,
                             float inv_temp, cudaStream_t stream) {
  auto kernel = threshold_cluster_kernel<MASS, STAGED>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  cfg.gridDim = dim3(static_cast<unsigned>(B) * p.C);
  cfg.blockDim = dim3(TH_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = static_cast<unsigned>(p.C);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  // each configuration's limits raised and its fit asked once
  static std::map<std::tuple<int, int>, int> fit;  // (C, smem) -> clusters
  static int smem_limit = 48 * 1024;
  const auto key = std::make_tuple(p.C, p.smem);
  auto it = fit.find(key);
  if (it == fit.end()) {
    cudaError_t e = cudaSuccess;
    if (p.smem > smem_limit) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (e == cudaSuccess) smem_limit = p.smem;
    }
    if (e == cudaSuccess && p.C > TH_CLUSTER_PORTABLE)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return e;
    it = fit.emplace(key, n).first;
  }
  if (it->second == 0) return cudaErrorInvalidConfiguration;
  const bool vec = V % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, thr, V, p.C, p.n, vec, kk, pp,
                            inv_temp);
}

}  // namespace

cudaError_t sample_launch(const void* x, const float* thr, const float* noise,
                          int mode, long long seed, float inv_temp, int B,
                          int V, int n_split, unsigned long long* part,
                          int* out, int dtype, cudaStream_t stream) {
  if (B < 0 || V <= 0 || mode < 0 || mode > 2 || (mode == 1 && !noise) ||
      n_split != (V + SA_CHUNK - 1) / SA_CHUNK || n_split > 65535 ||
      (n_split > 1 && !part))
    return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto useed = static_cast<unsigned long long>(seed);
  const uint32_t k0 = static_cast<uint32_t>(useed);
  const uint32_t k1 = static_cast<uint32_t>(useed >> 32);
  const dim3 grid(B, n_split);
  if (dtype == kBF16)
    sample_kernel<bf16><<<grid, SA_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), thr, noise, mode, k0, k1, inv_temp, V,
        n_split, part, out);
  else
    sample_kernel<float><<<grid, SA_THREADS, 0, stream>>>(
        static_cast<const float*>(x), thr, noise, mode, k0, k1, inv_temp, V,
        n_split, part, out);
  if (n_split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    constexpr int rows = SA_THREADS / 32;
    sample_combine_kernel<<<(B + rows - 1) / rows, SA_THREADS, 0, stream>>>(
        part, B, n_split, out);
  }
  return cudaSuccess;
}

cudaError_t sample_threshold_launch(const float* x, float* thr, int B, int V,
                                    int mode, int kk, float pp,
                                    float inv_temp, cudaStream_t stream) {
  if (B < 0 || V <= 0 || V > (1 << 20) || (mode != 0 && mode != 1) ||
      (mode == 0 && kk < 1) || !(inv_temp > 0.f) || B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const ThPlan p = threshold_plan(B, V, mode == 1);
  if (mode == 1)
    return p.staged ? launch_threshold<true, true>(x, thr, B, V, p, kk, pp,
                                                    inv_temp, stream)
                    : launch_threshold<true, false>(x, thr, B, V, p, kk, pp,
                                                     inv_temp, stream);
  return p.staged ? launch_threshold<false, true>(x, thr, B, V, p, kk, pp,
                                                   inv_temp, stream)
                  : launch_threshold<false, false>(x, thr, B, V, p, kk, pp,
                                                    inv_temp, stream);
}

// #27's plan for B rows of V values (out: C, n, staged, shared bytes)
cudaError_t sample_threshold_plan(int B, int V, int mode, int* out) {
  if (!out || B <= 0 || V <= 0 || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  const ThPlan p = threshold_plan(B, V, mode == 1);
  out[0] = p.C;
  out[1] = p.n;
  out[2] = p.staged;
  out[3] = p.smem;
  return cudaSuccess;
}

}  // namespace tk
