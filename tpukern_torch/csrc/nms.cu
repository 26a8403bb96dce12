// NMS keep flags: greedy IoU suppression over boxes sorted by descending
// score. keep[i] = 1 unless a kept box j < i overlaps box i with an IoU
// above the threshold.
//
// #43 nms_mask_kernel + nms_keep_kernel replace tpukern/ops/nms.py:24
// `_nms_keep_kernel` (nms :55), which builds the whole (N, N) IoU matrix
// in VMEM and then walks its rows in order, a keep vector in registers.
// Two launches here:
// - nms_mask_kernel, one block of 64 threads a 64 x 64 tile of the upper
//   triangle, writes bit j % 64 of word (i, j / 64) where j > i and
//   IoU(i, j) > threshold: N^2 / 2 IoUs, all in parallel;
// - nms_keep_kernel, one block of 1024 threads, walks the 64-row tiles in
//   order. Warp 0 decides a tile's rows one after another from the tile's
//   diagonal words (which rows of the tile each row suppresses), loaded a
//   tile ahead into registers and staged in shared memory; then every
//   thread takes (kept row, later word) pairs of the tile, all its loads
//   in flight together, and ORs them into a removed bitmap in shared
//   memory (N / 8 bytes) with atomicOr.
// The walk is sequential by nature, so the kernel is bound by latency, not
// by bytes or operations: a tile costs warp 0's 64 dependent steps, two
// barriers and one round trip to memory for the kept rows' words. N is any
// size: the mask takes N^2 / 8 bytes of device memory, the bitmap N / 8 of
// shared memory.
//
// The IoU is that of nms.py:26-38 in f32, in the same order: area =
// max(x2 - x1, 0) max(y2 - y1, 0), inter = max(xx2 - xx1, 0) max(yy2 -
// yy1, 0), union = (area_i + area_j) - inter, iou = inter / max(union,
// 1e-12), and a strict `>`. nvcc contracts a * b + c into one FMA by
// default, which would fuse inter's product into union's subtraction and
// flip decisions that lie at the threshold; the _rn intrinsics are IEEE
// operations that are never contracted.
#include "common.cuh"

namespace tk {
namespace {

using u64 = unsigned long long;

constexpr int NMS_TILE = 64;
constexpr int NMS_KEEP_THREADS = 1024;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

// a: x1, y1, x2, y2, area of box i; b: of box j
__device__ __forceinline__ bool iou_above(const float (&a)[5],
                                          const float (&b)[5], float thr) {
  const float xx1 = fmaxf(a[0], b[0]), yy1 = fmaxf(a[1], b[1]);
  const float xx2 = fminf(a[2], b[2]), yy2 = fminf(a[3], b[3]);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(xx2, xx1), 0.f),
                                fmaxf(__fsub_rn(yy2, yy1), 0.f));
  const float uni = __fsub_rn(__fadd_rn(a[4], b[4]), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thr;
}

__device__ __forceinline__ void load_box(const float* boxes, int i,
                                         float (&b)[5]) {
  const float4 v = reinterpret_cast<const float4*>(boxes)[i];
  b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  b[4] = box_area(v.x, v.y, v.z, v.w);
}

// grid (words, words): block (cb, rb) writes word cb of rows rb * 64 + t
__global__ void __launch_bounds__(NMS_TILE)
nms_mask_kernel(const float* __restrict__ boxes, int n, int words, float thr,
                u64* __restrict__ mask) {
  const int rb = blockIdx.y, cb = blockIdx.x, t = threadIdx.x;
  if (cb < rb) return;  // below the diagonal: never read
  __shared__ float cols[NMS_TILE][5];
  const int j0 = cb * NMS_TILE;
  if (j0 + t < n) {
    float b[5];
    load_box(boxes, j0 + t, b);
#pragma unroll
    for (int e = 0; e < 5; ++e) cols[t][e] = b[e];
  }
  __syncthreads();
  const int i = rb * NMS_TILE + t;
  if (i >= n) return;
  float a[5];
  load_box(boxes, i, a);
  const int jn = n - j0 < NMS_TILE ? n - j0 : NMS_TILE;
  u64 bits = 0;
  for (int jj = 0; jj < jn; ++jj) {
    if (j0 + jj <= i) continue;
    float b[5];
#pragma unroll
    for (int e = 0; e < 5; ++e) b[e] = cols[jj][e];
    if (iou_above(a, b, thr)) bits |= 1ull << jj;
  }
  mask[(int64_t)i * words + cb] = bits;
}

// lane l of warp 0: the diagonal words of rows l and l + 32 of tile `tile`
__device__ __forceinline__ void diag_words(const u64* mask, int n, int words,
                                           int tile, int lane, u64& d0,
                                           u64& d1) {
  const int r = tile * NMS_TILE + lane;
  d0 = r < n ? mask[(int64_t)r * words + tile] : 0;
  d1 = r + 32 < n ? mask[(int64_t)(r + 32) * words + tile] : 0;
}

// (row, word) pairs a thread ORs a tile, loads in flight together
constexpr int NMS_ORS = 4;

// one block of NMS_KEEP_THREADS; removed: `words` u64 of dynamic shared
// memory
__global__ void __launch_bounds__(NMS_KEEP_THREADS)
nms_keep_kernel(const u64* __restrict__ mask, int n, int words,
                int* __restrict__ keep) {
  extern __shared__ u64 removed[];
  __shared__ u64 diag[NMS_TILE];
  __shared__ u64 kept_s;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int w = tid; w < words; w += NMS_KEEP_THREADS) removed[w] = 0;
  u64 d0 = 0, d1 = 0;
  if (tid < 32) diag_words(mask, n, words, 0, lane, d0, d1);
  __syncthreads();
  for (int tile = 0; tile < words; ++tile) {
    const int row0 = tile * NMS_TILE;
    if (tid < 32) {
      diag[lane] = d0;
      diag[lane + 32] = d1;
      // the next tile's diagonal, in flight while this one is walked
      if (tile + 1 < words) diag_words(mask, n, words, tile + 1, lane, d0, d1);
      __syncwarp();
      // every lane walks the same rows and holds the same rem and kept
      const int rows = n - row0 < NMS_TILE ? n - row0 : NMS_TILE;
      u64 rem = removed[tile], kept = 0;
#pragma unroll
      for (int r = 0; r < NMS_TILE; ++r) {
        const u64 dr = diag[r];
        if (r < rows && !((rem >> r) & 1)) {
          kept |= 1ull << r;
          rem |= dr;
        }
      }
      if (lane == 0) kept_s = kept;
      if (row0 + lane < n) keep[row0 + lane] = (int)((kept >> lane) & 1);
      if (row0 + lane + 32 < n)
        keep[row0 + lane + 32] = (int)((kept >> (lane + 32)) & 1);
    }
    __syncthreads();
    const u64 kept = kept_s;
    const int later = words - tile - 1;  // words past the tile
    for (int p0 = tid; p0 < NMS_TILE * later;
         p0 += NMS_ORS * NMS_KEEP_THREADS) {
      u64 v[NMS_ORS];
      int w[NMS_ORS];
#pragma unroll
      for (int u = 0; u < NMS_ORS; ++u) {
        const int p = p0 + u * NMS_KEEP_THREADS, r = p / later;
        w[u] = tile + 1 + (p - r * later);
        v[u] = p < NMS_TILE * later && ((kept >> r) & 1)
                   ? mask[(int64_t)(row0 + r) * words + w[u]]
                   : 0;
      }
#pragma unroll
      for (int u = 0; u < NMS_ORS; ++u)
        if (v[u]) atomicOr(&removed[w[u]], v[u]);
    }
    __syncthreads();
  }
}

}  // namespace

// boxes: (n, 4) f32 sorted by descending score, 16-byte aligned; mask:
// scratch of n x ceil(n / 64) u64; keep: n int32 (0 or 1)
cudaError_t nms_keep_launch(const float* boxes, int n, float thr,
                            unsigned long long* mask, int* keep,
                            cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;  // empty tensors: null pointers
  if (!boxes || !mask || !keep || (uintptr_t)boxes % 16)
    return cudaErrorInvalidValue;
  const int words = (n + NMS_TILE - 1) / NMS_TILE;
  if (words > 65535) return cudaErrorInvalidValue;
  nms_mask_kernel<<<dim3(words, words), NMS_TILE, 0, stream>>>(boxes, n, words,
                                                               thr, mask);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = words * (int)sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (a != cudaSuccess) return a;
  }
  nms_keep_kernel<<<1, NMS_KEEP_THREADS, smem, stream>>>(mask, n, words,
                                                     keep);
  return cudaSuccess;
}

}  // namespace tk
