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
// threshold_kernel replaces sampling.py:182 `_threshold_kernel`: the k-th
// largest logit of a row (count mode), or the smallest kept logit of the
// top-p nucleus (mass mode): the smallest data value d with
//   sum of w over the values strictly above d  <  target,
// where w = exp((x - max) * inv_temp) and target = k (count: w = 1) or
// p * sum(w) (mass). The TPU kernel bisects that predicate in 33 steps
// over monotone int32 keys of the values, its 8 rows resident in VMEM.
// Here one block owns one row and runs a radix select over the same keys
// (as unsigned, the sign bit flipped): 4 passes of 8 bits, each a 256-bin
// histogram of the values whose key matches the digits chosen so far (one
// histogram per warp, folded afterwards), then a warp scans the bins from
// the top for the lowest non-empty bin whose mass above stays below the
// target. Masses are fixed point (w * 2^40 in 64-bit integers), so the
// sums do not depend on the order of the atomics and the threshold is the
// same from run to run; the result is always a data value. A row of up to
// TH_SMEM_MAX values is staged in shared memory once; a longer one is
// re-read from global memory (L2) in each pass.
//
// What bounds them: each reads B * V logits once (sample also the noise);
// at the serving shape, (4, 32768) f32, that is 512 KB, 0.16 us at 3.35
// TB/s, so launch latency and, for the threshold, one block per row
// bound them. A cluster per row would spread the threshold's passes over
// more SMs; that is left to a later PR.
#include "common.cuh"

namespace tk {
namespace {

constexpr int SA_THREADS = 256;
constexpr int SA_CHUNK = 2048;  // columns per block (8 per thread)
constexpr int TH_THREADS = 512;
constexpr int TH_WARPS = TH_THREADS / 32;
constexpr int TH_BINS = 256;
constexpr int TH_SMEM_MAX = 40960;  // values of a row staged in shared memory
constexpr double TH_FIX = 1099511627776.0;  // 2^40: fixed-point scale of w

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

template <bool SMEM>
__global__ void __launch_bounds__(TH_THREADS)
threshold_kernel(const float* __restrict__ x, float* __restrict__ thr, int V,
                 int mass_mode, int kk, float pp, float inv_temp) {
  // dynamic shared memory: per-warp histograms (mass, then count), then
  // the row when SMEM
  extern __shared__ __align__(16) unsigned char th_smem[];
  auto* hm = reinterpret_cast<unsigned long long*>(th_smem);
  auto* hc = reinterpret_cast<unsigned int*>(hm + TH_WARPS * TH_BINS);
  auto* xs = reinterpret_cast<float*>(hc + TH_WARPS * TH_BINS);
  __shared__ float max_s[TH_WARPS];
  __shared__ uint32_t prefix_s;
  __shared__ unsigned long long above_s;
  __shared__ int found_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = x + static_cast<int64_t>(blockIdx.x) * V;
  if constexpr (SMEM) {
    for (int i = tid; i < V; i += TH_THREADS) xs[i] = xr[i];
  }
  const float* row = SMEM ? xs : xr;
  float m = 0.f;
  if (mass_mode) {
    __syncthreads();  // the staged row
    float v = -__uint_as_float(0x7F800000u);  // -inf
    for (int i = tid; i < V; i += TH_THREADS) v = fmaxf(v, row[i]);
    v = warp_max(v);
    if (lane == 0) max_s[warp] = v;
    __syncthreads();
    m = max_s[0];
#pragma unroll
    for (int w = 1; w < TH_WARPS; ++w) m = fmaxf(m, max_s[w]);
  }

  uint32_t prefix = 0;         // the key digits chosen so far
  unsigned long long above = 0;  // the weight of the values above them
  double target = 0.0;         // warp 0's, from the first pass
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t high = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
    for (int i = tid; i < TH_WARPS * TH_BINS; i += TH_THREADS) {
      hm[i] = 0;
      hc[i] = 0;
    }
    __syncthreads();
    unsigned long long* my_m = hm + warp * TH_BINS;
    unsigned int* my_c = hc + warp * TH_BINS;
    for (int i = tid; i < V; i += TH_THREADS) {
      const float v = row[i];
      const uint32_t u = order_key(v);
      if ((u & high) == prefix) {
        const int bin = (u >> shift) & (TH_BINS - 1);
        atomicAdd(&my_c[bin], 1u);
        if (mass_mode)
          atomicAdd(&my_m[bin], __double2ull_rn(
                                    static_cast<double>(expf((v - m) * inv_temp)) *
                                    TH_FIX));
      }
    }
    __syncthreads();
    for (int bin = tid; bin < TH_BINS; bin += TH_THREADS) {
      unsigned long long s = 0;
      unsigned int c = 0;
      for (int w = 0; w < TH_WARPS; ++w) {
        s += hm[w * TH_BINS + bin];
        c += hc[w * TH_BINS + bin];
      }
      hm[bin] = s;
      hc[bin] = c;
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 255 - 8l - j, j = 0..7 (lane 0 the top ones)
      unsigned int cnt[8];
      unsigned long long wt[8], seg = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bin = TH_BINS - 1 - 8 * lane - j;
        cnt[j] = hc[bin];
        wt[j] = mass_mode ? hm[bin] : cnt[j];
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
        target = mass_mode ? static_cast<double>(pp) * static_cast<double>(total)
                           : static_cast<double>(kk);
      }
      // the lowest non-empty bin whose weight above stays below the target
      unsigned long long run = above + incl - seg, cand_above = 0;
      int cand = -1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cnt[j] > 0 && static_cast<double>(run) < target) {
          cand = TH_BINS - 1 - 8 * lane - j;
          cand_above = run;
        }
        run += wt[j];
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, cand >= 0);
      if (ballot == 0) {
        if (lane == 0) found_s = 0;
      } else if (lane == 31 - __clz(static_cast<int>(ballot))) {
        prefix_s = prefix | (static_cast<uint32_t>(cand) << shift);
        above_s = cand_above;
        found_s = 1;
      }
    }
    __syncthreads();
    if (!found_s) {
      // no value qualifies (a target <= 0): NaN keeps nothing, as the
      // TPU kernel's bisection then returns the key 0x7fffffff
      if (tid == 0) thr[blockIdx.x] = __uint_as_float(0x7FFFFFFFu);
      return;
    }
    prefix = prefix_s;
    above = above_s;
  }
  if (tid == 0) thr[blockIdx.x] = from_order_key(prefix);
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
      (mode == 0 && kk < 1) || !(inv_temp > 0.f))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t hist = static_cast<size_t>(TH_WARPS) * TH_BINS *
                      (sizeof(unsigned long long) + sizeof(unsigned int));
  if (V <= TH_SMEM_MAX) {
    const size_t bytes = hist + static_cast<size_t>(V) * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        threshold_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    threshold_kernel<true><<<B, TH_THREADS, bytes, stream>>>(
        x, thr, V, mode, kk, pp, inv_temp);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        threshold_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(hist));
    if (e != cudaSuccess) return e;
    threshold_kernel<false><<<B, TH_THREADS, hist, stream>>>(
        x, thr, V, mode, kk, pp, inv_temp);
  }
  return cudaSuccess;
}

}  // namespace tk
