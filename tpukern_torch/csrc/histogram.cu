// Histogram: out[b] counts the values b in [0, num_bins) of an int32
// array; values outside [0, num_bins), negatives included, are never
// counted.
//
// #41 histogram_kernel replaces tpukern/ops/histogram.py:47 `kernel`
// (histogram :35), which streams blocks of values through one core and
// compares each against every bin of a histogram held in VMEM: a TPU has
// no atomics. The card has them, so this is the reference's design
// (histogram.cu:18-26) with a shared stage: each block counts into a
// histogram of its own in shared memory with atomicAdd, then adds each
// non-zero bin to the output (zeroed by the wrapper) with one global
// atomicAdd. Integer atomics are exact in any order, so the counts are
// those of any other count.
//
// Bound by memory bandwidth: the values are read once, with 16-byte loads,
// and the bins written once. What could hold it below that is contention:
// a bin that many values hit serialises its atomics. So each warp counts
// into a copy of its own (8 copies a block, where they fit in shared
// memory: bins <= HIST_SMEM_BINS / 8), and the flush sums the copies. On
// an H100 that is enough: chip_smoke.py times an input of one value as
// fast as uniform values. Aggregating a warp's equal values first with
// __match_any_sync, this kernel's first design, was slower on both.
// Above HIST_SMEM_BINS bins a block's histogram does not fit in shared
// memory, and the counts go straight to global atomics.
//
// block_rows (the TPU's rows of 128 values a grid step) is the values a
// block takes a step, 128 block_rows: each thread issues its block_rows / 8
// 16-byte loads before it counts any of them.
#include "common.cuh"

namespace tk {
namespace {

constexpr int HIST_THREADS = 256;
constexpr int HIST_COPIES = HIST_THREADS / 32;  // a histogram a warp
// the int32 bins a block can hold in its 227 KB of shared memory
constexpr int HIST_SMEM_BINS = 232448 / 4;

// LOADS: 16-byte loads a thread a step (block_rows / 8); SHARED: count in
// shared memory (`copies` histograms of `bins` int32, dynamic; warp w
// counts into copy w % copies), else in out; vec: x is 16-byte aligned
template <int LOADS, bool SHARED>
__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(const int* __restrict__ x, int64_t n, int* __restrict__ out,
                 int bins, int copies, int vec) {
  extern __shared__ int sh[];
  int* h = out;
  if (SHARED) {
    for (int b = threadIdx.x; b < bins * copies; b += HIST_THREADS) sh[b] = 0;
    h = sh + (threadIdx.x >> 5) % copies * bins;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  constexpr int64_t STEP = 32 * 4 * LOADS;  // values a warp takes a step
  const int64_t warp =
      ((int64_t)blockIdx.x * HIST_THREADS + threadIdx.x) >> 5;
  const int64_t stride = (int64_t)gridDim.x * (HIST_THREADS / 32) * STEP;
  for (int64_t base = warp * STEP; base < n; base += stride) {
    int v[LOADS][4];
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int64_t i = base + (int64_t)(l * 32 + lane) * 4;
      if (vec && i + 4 <= n) {
        const int4 q = *reinterpret_cast<const int4*>(x + i);
        v[l][0] = q.x, v[l][1] = q.y, v[l][2] = q.z, v[l][3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[l][e] = i + e < n ? x[i + e] : -1;
      }
    }
#pragma unroll
    for (int l = 0; l < LOADS; ++l)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((unsigned)v[l][e] < (unsigned)bins) atomicAdd(&h[v[l][e]], 1);
  }
  if (SHARED) {
    __syncthreads();
    for (int b = threadIdx.x; b < bins; b += HIST_THREADS) {
      int c = 0;
      for (int k = 0; k < copies; ++k) c += sh[k * bins + b];
      if (c) atomicAdd(&out[b], c);
    }
  }
}

template <int LOADS, bool SHARED>
cudaError_t hist_launch(const int* x, int64_t n, int* out, int bins,
                        cudaStream_t stream) {
  auto kernel = histogram_kernel<LOADS, SHARED>;
  const int copies = SHARED && bins <= HIST_SMEM_BINS / HIST_COPIES
                         ? HIST_COPIES : 1;
  const int smem = SHARED ? bins * copies * 4 : 0;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      HIST_THREADS, smem);
  if (e != cudaSuccess) return e;
  // one wave at most: each block's flush costs up to `bins` atomics
  const int64_t step = (int64_t)HIST_THREADS * 4 * LOADS;
  int64_t blocks = (n + step - 1) / step;
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  const int vec = (uintptr_t)x % 16 == 0;
  kernel<<<(unsigned)blocks, HIST_THREADS, smem, stream>>>(x, n, out, bins,
                                                           copies, vec);
  return cudaSuccess;
}

template <bool SHARED>
cudaError_t hist_by_loads(const int* x, int64_t n, int* out, int bins,
                          int loads, cudaStream_t stream) {
  switch (loads) {
    case 1: return hist_launch<1, SHARED>(x, n, out, bins, stream);
    case 2: return hist_launch<2, SHARED>(x, n, out, bins, stream);
    case 4: return hist_launch<4, SHARED>(x, n, out, bins, stream);
    case 8: return hist_launch<8, SHARED>(x, n, out, bins, stream);
    default: return hist_launch<16, SHARED>(x, n, out, bins, stream);
  }
}

}  // namespace

// out: bins int32, zeroed by the caller; block_rows 8, 16, 32, 64 or 128
cudaError_t histogram_launch(const int* x, int64_t n, int* out, int bins,
                             int block_rows, cudaStream_t stream) {
  const int loads = block_rows / 8;
  if (n < 0 || bins <= 0 || block_rows % 8 ||
      (loads != 1 && loads != 2 && loads != 4 && loads != 8 && loads != 16))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;  // an empty tensor: a null pointer
  if (!x || !out) return cudaErrorInvalidValue;
  return bins <= HIST_SMEM_BINS
             ? hist_by_loads<true>(x, n, out, bins, loads, stream)
             : hist_by_loads<false>(x, n, out, bins, loads, stream);
}

}  // namespace tk
