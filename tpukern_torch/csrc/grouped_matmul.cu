// Grouped (ragged) GEMM for the dropless MoE block: the rows of x are
// sorted by expert, group e owning rows [off_e, off_e + group_sizes[e]),
// off_e the running sum of the sizes before it.
//
// Replaces tpukern/ops/grouped_matmul.py's two Pallas bodies:
//   #28 `kernel` of `gmm` (:147)  -> gmm_*_kernel:
//       y[rows_e] = x[rows_e] · W[e], or x[rows_e] · W[e]^T (TRANS_W, the
//       dx of the VJP); rows past sum(group_sizes) are written as zeros
//       (unspecified in JAX, grouped_matmul.py:44-46).
//   #29 `kernel` of `tgmm` (:235) -> tgmm_*_kernel:
//       dW[e] = x[rows_e]^T · dy[rows_e]; an empty group writes zeros (the
//       VJP's `where`, :298-300).
//
// The TPU design is not carried over. There, a tile table in SMEM
// (`_tile_table`, :64-98) schedules (m-block, group) work items, and
// consecutive grid steps merge a boundary m-block held in VMEM (:168-180).
// Hopper runs blocks in no order, so nothing merges across blocks:
// - gmm: work items as the TPU's table, computed on the card (gmm_item):
//   the (segment, 128-row M tile) pairs that meet, where the segments are
//   the E groups' rows and then the rows past the groups, at most
//   ceil(T / 128) + E items an N tile. A grid of (N tiles, that bound);
//   each block walks the E sizes to find its item (blocks past the real
//   count leave before the pipeline) and runs one main loop: A = x's 128
//   rows from the tile's first, K-major (row r of the product depends on
//   x's row r alone, whatever group it belongs to); B = W[e]; the
//   epilogue stores the item's rows [r_lo, r_hi) only. The rows past the
//   groups are an item that runs no slab and stores zeros. Two items never
//   write one row: no atomics, no merge. Launch order runs 8 items at a
//   time across the N tiles (gemm_tile_order), so the blocks in flight
//   share x's rows and W's columns in L2. bf16 (gmm_wgmma_kernel): W[e]
//   MN-major in NN and K-major with TRANS_W, by TMA from a 3-D map of the
//   E matrices (one matrix a box: the rows past K of W[e] arrive as
//   zeros, never W[e + 1]'s first rows, which would meet x's zero-filled
//   K tail and give 0 * NaN), or copied by the producer's threads within
//   W[e]'s own rows and columns. f32 (gmm_tf32_kernel): W's planes (E, 2,
//   N, K4), K-major for every expert (NN: each W[e] split transposed, the
//   E matrices in one pass), under one 3-D map of depth 2E whose boxes are
//   one plane deep: K is every map's inner extent, so a K tail reads
//   zeros, never a neighbour expert's values, and the rows past N of a
//   plane arrive as zeros and reach only the columns the epilogue drops.
// - tgmm: a grid of (N tiles, K tiles, E). Each block walks its own
//   group's rows and writes its (e, k, n) tile once; rows outside the
//   group never enter the sum (the token axis is the contraction here, so
//   the rows are masked as JAX masks x before its dot, :242-247). A hot
//   expert's blocks walk all of its rows, so when one expert holds most
//   rows its K x N tiles are most of the grid's work and too few to fill
//   the card (splitting one group's rows across blocks is later work).
//
// What bounds it: at the Mixtral expert shapes (8192 routed rows, K/N 4096
// and 14336) a tile does 128·128·K multiply-adds per 2·128·K elements
// loaded: compute bound, as csrc/matmul.cu, whose two tiers these follow.
// bf16 runs hopper.cuh's gemm_pipeline: 128 x 256 tiles, a ring of 4
// stages of 64-wide slabs, TMA and wgmma. A boundary item computes all
// 128 rows for the few it keeps: at most E - 1 such items an N tile
// beyond the ceil(T / 128) the rows need. bf16 tgmm has both operands
// MN-major (A = x^T by the transpose-A bit, B = dy by the transpose-B
// bit, in 64-column boxes), one tensor map over the whole of x and of dy.
// A group's slabs start at its first row s and step by 64; where fewer
// than 64 of its rows are left, that last slab loads as the others and
// the consumers zero its rows >= t in both operands before the products
// (the next group's rows, or NaN past the groups, never reach the sum).
// An operand whose rows are no whole 16-byte chunks (gmm: K % 8 for x and
// a TRANS_W W, N % 8 for an NN W; tgmm: K or N % 8) is copied by the
// producer's threads in every slab. f32 runs split-TF32 products
// (hopper.cuh gemm_pipeline_tf32, 128 x 128 tiles, 3 stages of 32-wide
// slabs, each slab's 12 wgmma .tf32 summed afresh, small terms first,
// then added to f32 registers) on the planes that csrc/split_tf32.cu
// writes into the caller's scratch first: three TF32 products a product,
// 5830.7 µs at the Mixtral w1 product against 14359.3 on the CUDA cores'
// f32 FMAs (ops/split_tf32.py bound_s). f32 tgmm reads x^T's and dy^T's
// planes, (2, K, T4) and (2, N, T4), split once a call over the whole of
// x and dy; a group's slabs start at its first token s rounded down to a
// multiple of 4 (TMA's 16-byte inner coordinates) and step by 32; the
// consumers zero the columns before s of the first slab and from t on of
// the last in all four planes before its products (gemm_pipeline_tf32's
// TAIL_ZERO).
// An empty group runs no slab (tgmm: writes zeros). f32 accumulation
// throughout.
#include "hopper.cuh"

namespace tk {
namespace {

// The rows [s, t) of group e inside [0, T): off is the running sum of
// the sizes before e (each size clamped at 0). Every thread of a block
// reads the same sizes, so the bounds are uniform across the block.
__device__ __forceinline__ void group_rows(const int* __restrict__ sizes,
                                           int e, int T, int& off, int& s,
                                           int& t) {
  s = min(off, T);
  off += max(sizes[e], 0);
  t = min(off, T);
}

// Work item `item` of an N tile, as tpukern's `_tile_table` (:64-98)
// schedules (group, 128-row M tile) pairs, computed here from the sizes:
// the rows [0, T) fall into E + 1 segments, group e's rows and, last,
// the rows past sum(group_sizes); the items are the (segment, M tile)
// pairs that meet, in segment order, at most ceil(T / 128) + E of them.
// Returns false past the last item; else the segment e (E: the rows past
// the groups), the tile's first row m0 and its rows [r_lo, r_hi) of the
// segment. Every thread of a block reads the same sizes.
__device__ __forceinline__ bool gmm_item(const int* __restrict__ sizes,
                                         int E, int T, int item, int& e,
                                         int& m0, int& r_lo, int& r_hi) {
  int off = 0, before = 0;  // items of the segments before e
  for (e = 0; e <= E; ++e) {
    int s, t;
    if (e < E) {
      group_rows(sizes, e, T, off, s, t);
    } else {
      s = min(off, T);
      t = T;
    }
    if (s >= t) continue;
    const int first = s / GP_BM, n = (t - 1) / GP_BM - first + 1;
    if (item < before + n) {
      m0 = (first + item - before) * GP_BM;
      r_lo = max(s, m0);
      r_hi = min(t, m0 + GP_BM);
      return true;
    }
    before += n;
  }
  return false;
}

// One work item of one N tile a block: its 128 rows of x (K-major, as
// #2's A, whatever group they belong to: row r of the product depends on
// x's row r alone) times W[e] (MN-major (K, N) in NN, as #2's B; K-major
// (N, K) with TRANS_W, as #2's TN), the item's rows of the product
// written, the others discarded. W loads by TMA from a 3-D map of the E
// matrices (one matrix a box: rows past K, or past N, arrive as zeros,
// never W[e + 1]'s), or by the producer's copy bounded by W[e]'s own rows
// and columns. The item of the rows past the groups runs no slab and
// writes zeros.
template <bool TRANS_W, bool TMA_X, bool TMA_W>
__global__ void __launch_bounds__(GP_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const int* __restrict__ sizes, float* __restrict__ y32,
                 bf16* __restrict__ y16, int T, int N, int K, int E) {
  int item, tile_n;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  item, tile_n);
  int e, m0, r_lo, r_hi;
  // past the last item: the whole block leaves before the pipeline
  if (!gmm_item(sizes, E, T, item, e, m0, r_lo, r_hi)) return;
  const int n0 = tile_n * GP_BN;
  const bool live = e < E;
  // W[e] starts `we` elements into w: its copy reads from the aligned
  // word at or before it
  const int64_t we = live ? (int64_t)e * K * N : 0;
  const bf16* wp = w + (we & ~int64_t{7});
  const int woff = (int)(we & 7);
  const GemmOperand ob = TRANS_W ? GemmOperand{wp, N, K, n0, e, woff}
                                 : GemmOperand{wp, K, N, n0, e, woff};
  gemm_pipeline<false, !TRANS_W, TMA_X, TMA_W, false>(
      &map_x, &map_w, GemmOperand{x, T, K, m0}, ob, 0, live ? K : 0,
      [&](const float (&d)[128]) {
        gemm_store(d, y32, y16, r_hi, N, m0, n0, r_lo);
      });
}

template <bool TRANS_W, bool TMA_X, bool TMA_W>
cudaError_t launch_gmm(const CUtensorMap& mx, const CUtensorMap& mw,
                       const bf16* x, const bf16* w, const int* sizes,
                       float* y32, bf16* y16, int T, int N, int K, int E,
                       const dim3& grid, cudaStream_t stream) {
  const auto kernel = gmm_wgmma_kernel<TRANS_W, TMA_X, TMA_W>;
  constexpr int smem = gemm_smem(!(TMA_X && TMA_W));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, GP_THREADS, smem, stream>>>(mx, mw, x, w, sizes, y32, y16,
                                                T, N, K, E);
  return cudaSuccess;
}

template <bool TRANS_W>
cudaError_t dispatch_gmm(bool tma_x, bool tma_w, const CUtensorMap& mx,
                         const CUtensorMap& mw, const bf16* x, const bf16* w,
                         const int* sizes, float* y32, bf16* y16, int T,
                         int N, int K, int E, const dim3& grid,
                         cudaStream_t stream) {
  if (tma_x && tma_w)
    return launch_gmm<TRANS_W, true, true>(mx, mw, x, w, sizes, y32, y16, T,
                                           N, K, E, grid, stream);
  if (tma_x)
    return launch_gmm<TRANS_W, true, false>(mx, mw, x, w, sizes, y32, y16, T,
                                            N, K, E, grid, stream);
  if (tma_w)
    return launch_gmm<TRANS_W, false, true>(mx, mw, x, w, sizes, y32, y16, T,
                                            N, K, E, grid, stream);
  return launch_gmm<TRANS_W, false, false>(mx, mw, x, w, sizes, y32, y16, T,
                                           N, K, E, grid, stream);
}

// the rows [s, t) of group blockIdx.z
__device__ __forceinline__ void own_group(const int* __restrict__ sizes,
                                          int T, int& s, int& t) {
  int off = 0;
  for (int e = 0; e < (int)blockIdx.z; ++e) off += max(sizes[e], 0);
  group_rows(sizes, blockIdx.z, T, off, s, t);
}

template <bool TMA_X, bool TMA_DY>
__global__ void __launch_bounds__(GP_THREADS, 1)
tgmm_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_dy,
                 const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 const int* __restrict__ sizes, float* __restrict__ o32,
                 bf16* __restrict__ o16, int T, int K, int N) {
  int tile_k, tile_n;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tile_k, tile_n);
  const int k0 = tile_k * GP_BM, n0 = tile_n * GP_BN;
  int s, t;
  own_group(sizes, T, s, t);
  const int64_t base = (int64_t)blockIdx.z * K * N;
  float* c32 = o32 ? o32 + base : nullptr;
  bf16* c16 = o16 ? o16 + base : nullptr;
  // x (T, K) and dy (T, N) MN-major, their rows the contraction; rows
  // >= t of the last slab are zeroed
  gemm_pipeline<true, true, TMA_X, TMA_DY, true>(
      &map_x, &map_dy, GemmOperand{x, t, K, k0}, GemmOperand{dy, t, N, n0},
      s, t,
      [&](const float (&d)[128]) { gemm_store(d, c32, c16, K, N, k0, n0); });
}

template <bool TMA_X, bool TMA_DY>
cudaError_t launch_tgmm(const CUtensorMap& mx, const CUtensorMap& md,
                        const bf16* x, const bf16* dy, const int* sizes,
                        float* o32, bf16* o16, int T, int K, int N,
                        const dim3& grid, cudaStream_t stream) {
  const auto kernel = tgmm_bf16_kernel<TMA_X, TMA_DY>;
  constexpr int smem = gemm_smem(!(TMA_X && TMA_DY));
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, GP_THREADS, smem, stream>>>(mx, md, x, dy, sizes, o32,
                                                o16, T, K, N);
  return cudaSuccess;
}

// One work item of one N tile a block, as gmm_wgmma_kernel's, on
// split-TF32 products: A = x's planes (2, T, K4), B = W[e]'s planes, the
// depths 2e and 2e + 1 of map_w ((E, 2, N, K4)), both K-major. The item
// of the rows past the groups runs no slab (and reads no plane) and
// writes zeros.
__global__ void __launch_bounds__(GP_THREADS, 1)
gmm_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const int* __restrict__ sizes, float* __restrict__ y32,
                bf16* __restrict__ y16, int T, int N, int K, int E) {
  int item, tile_n;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  item, tile_n);
  int e, m0, r_lo, r_hi;
  // past the last item: the whole block leaves before the pipeline
  if (!gmm_item(sizes, E, T, item, e, m0, r_lo, r_hi)) return;
  const int n0 = tile_n * TF_BN;
  gemm_pipeline_tf32(
      &map_x, &map_w, m0, n0, 0, e < E ? K : 0,
      [&](const float (&d)[64]) {
        gemm_store(d, y32, y16, r_hi, N, m0, n0, r_lo);
      },
      2 * e);
}

// The (e, k, n) tile of dW on split-TF32 products: A = x^T's planes (2,
// K, T4), B = dy^T's (2, N, T4), the contraction over the group's tokens
// [s, t) in slabs of 32 from s rounded down to 4, the columns outside
// [s, t) zeroed.
__global__ void __launch_bounds__(GP_THREADS, 1)
tgmm_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_dy,
                 const int* __restrict__ sizes, float* __restrict__ o32,
                 bf16* __restrict__ o16, int T, int K, int N) {
  int tile_k, tile_n;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tile_k, tile_n);
  const int k0 = tile_k * GP_BM, n0 = tile_n * TF_BN;
  int s, t;
  own_group(sizes, T, s, t);
  const int64_t base = (int64_t)blockIdx.z * K * N;
  float* c32 = o32 ? o32 + base : nullptr;
  bf16* c16 = o16 ? o16 + base : nullptr;
  gemm_pipeline_tf32<true>(&map_x, &map_dy, k0, n0, s, t,
                           [&](const float (&d)[64]) {
                             gemm_store(d, c32, c16, K, N, k0, n0);
                           });
}

// #28's f32 tier: x's planes and W's (every expert's, K-major: NN splits
// each W[e] transposed) into scratch, then one split-TF32 launch
cudaError_t gmm_tf32(const float* x, const float* w, const int* sizes,
                     float* y32, bf16* y16, int T, int N, int K, int E,
                     int trans_w, float* scratch, int* passes,
                     cudaStream_t stream) {
  const dim3 grid((N + TF_BN - 1) / TF_BN, (T + GP_BM - 1) / GP_BM + E);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  CUtensorMap mx{}, mw{};
  // no slab at K = 0 (and no map of a zero extent): every row is zeros
  if (K > 0) {
    if (!scratch || !aligned16(scratch)) return cudaErrorInvalidValue;
    const int64_t k4 = (K + 3) / 4 * 4;
    float* sx = scratch;                    // x's planes (2, T, k4)
    float* sw = sx + 2 * (int64_t)T * k4;  // W's planes (E, 2, N, k4)
    const int64_t we = (int64_t)K * N;      // one W[e]
    cudaError_t e =
        split_tf32_launch(x, T, K, K, sx, k4, nullptr, 0, passes, stream);
    if (e == cudaSuccess)
      e = trans_w ? split_tf32_launch(w, N, K, K, sw, k4, nullptr, 0, passes,
                                      stream, E, we)
                  : split_tf32_launch(w, K, N, N, nullptr, 0, sw, k4, passes,
                                      stream, E, we);
    if (e == cudaSuccess) e = tma_map_planes(&mx, sx, K, T, k4, GP_BM);
    if (e == cudaSuccess)
      e = tma_map_f32(&mw, sw, K, N, (uint64_t)k4 * 4, TF_BK, TF_BN, 2 * E);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TF_SMEM);
  if (e != cudaSuccess) return e;
  gmm_tf32_kernel<<<grid, GP_THREADS, TF_SMEM, stream>>>(mx, mw, sizes, y32,
                                                         y16, T, N, K, E);
  return cudaSuccess;
}

// #29's f32 tier: x^T's and dy^T's planes into scratch, then one
// split-TF32 launch
cudaError_t tgmm_tf32(const float* x, const float* dy, const int* sizes,
                      float* o32, bf16* o16, int T, int K, int N, int E,
                      float* scratch, int* passes, cudaStream_t stream) {
  const dim3 grid((N + TF_BN - 1) / TF_BN, (K + GP_BM - 1) / GP_BM, E);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  CUtensorMap mx{}, md{};
  // no token, no slab: no map of a zero extent, every slab zeros
  if (T > 0) {
    if (!scratch || !aligned16(scratch)) return cudaErrorInvalidValue;
    const int64_t t4 = (T + 3) / 4 * 4;
    float* sx = scratch;                    // x^T's planes (2, K, t4)
    float* sd = sx + 2 * (int64_t)K * t4;  // dy^T's planes (2, N, t4)
    cudaError_t e =
        split_tf32_launch(x, T, K, K, nullptr, 0, sx, t4, passes, stream);
    if (e == cudaSuccess)
      e = split_tf32_launch(dy, T, N, N, nullptr, 0, sd, t4, passes, stream);
    if (e == cudaSuccess) e = tma_map_planes(&mx, sx, T, K, t4, GP_BM);
    if (e == cudaSuccess) e = tma_map_planes(&md, sd, T, N, t4, TF_BN);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      tgmm_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TF_SMEM);
  if (e != cudaSuccess) return e;
  tgmm_tf32_kernel<<<grid, GP_THREADS, TF_SMEM, stream>>>(mx, md, sizes, o32,
                                                          o16, T, K, N);
  return cudaSuccess;
}

}  // namespace

cudaError_t gmm_launch(const void* x, const void* w, const int* group_sizes,
                       void* y32, void* y16, int T, int N, int K, int E,
                       int trans_w, int dtype, void* scratch, int* passes,
                       cudaStream_t stream) {
  if (T < 0 || N < 0 || K < 0 || E < 1 || (!y32 && !y16))
    return cudaErrorInvalidValue;
  if (T == 0 || N == 0) return cudaSuccess;
  float* o32 = static_cast<float*>(y32);
  bf16* o16 = static_cast<bf16*>(y16);
  if (dtype == kF32) {
    return gmm_tf32(static_cast<const float*>(x),
                    static_cast<const float*>(w), group_sizes, o32, o16, T, N,
                    K, E, trans_w, static_cast<float*>(scratch), passes,
                    stream);
  } else if (dtype == kBF16) {
    // (N tiles, work items): every item an N tile can hold, ceil(T / 128)
    // + E (gmm_item); the blocks past the real count leave at once
    const dim3 grid((N + GP_BN - 1) / GP_BN, (T + GP_BM - 1) / GP_BM + E);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bf16* hx = static_cast<const bf16*>(x);
    const bf16* hw = static_cast<const bf16*>(w);
    // each operand by TMA where its rows are whole 16-byte chunks on an
    // aligned base, else copied in every slab (ops/grouped_matmul.py
    // gmm_items mirrors the rule and the items)
    const bool tma_x = K % 8 == 0 && aligned16(x);
    const bool tma_w = (trans_w ? K : N) % 8 == 0 && aligned16(w);
    CUtensorMap mx{}, mw{};
    // no slab at K = 0 (and no map of a zero extent): every row is zeros
    if (tma_x && K > 0) {
      const cudaError_t e = tma_map_bf16(&mx, x, K, T, (uint64_t)K * 2,
                                         GP_BK, GP_BM);
      if (e != cudaSuccess) return e;
    }
    if (tma_w && K > 0) {
      const cudaError_t e =
          trans_w ? tma_map_bf16(&mw, w, K, N, (uint64_t)K * 2, GP_BK, GP_BN,
                                 E)
                  : tma_map_bf16(&mw, w, N, K, (uint64_t)N * 2, 64, GP_BK, E);
      if (e != cudaSuccess) return e;
    }
    return trans_w ? dispatch_gmm<true>(tma_x, tma_w, mx, mw, hx, hw,
                                        group_sizes, o32, o16, T, N, K, E,
                                        grid, stream)
                   : dispatch_gmm<false>(tma_x, tma_w, mx, mw, hx, hw,
                                         group_sizes, o32, o16, T, N, K, E,
                                         grid, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

cudaError_t tgmm_launch(const void* x, const void* dy, const int* group_sizes,
                        void* o32, void* o16, int T, int K, int N, int E,
                        int dtype, void* scratch, int* passes,
                        cudaStream_t stream) {
  if (T < 0 || N < 0 || K < 0 || E < 1 || (!o32 && !o16))
    return cudaErrorInvalidValue;
  if (K == 0 || N == 0) return cudaSuccess;
  if (E > 65535) return cudaErrorInvalidValue;
  float* f32o = static_cast<float*>(o32);
  bf16* b16o = static_cast<bf16*>(o16);
  if (dtype == kF32) {
    return tgmm_tf32(static_cast<const float*>(x),
                     static_cast<const float*>(dy), group_sizes, f32o, b16o,
                     T, K, N, E, static_cast<float*>(scratch), passes,
                     stream);
  } else if (dtype == kBF16) {
    const dim3 grid((N + GP_BN - 1) / GP_BN, (K + GP_BM - 1) / GP_BM, E);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bf16* hx = static_cast<const bf16*>(x);
    const bf16* hd = static_cast<const bf16*>(dy);
    // each operand by TMA where its rows are whole 16-byte chunks on an
    // aligned base, else copied in every slab (ops/grouped_matmul.py
    // tgmm_slabs mirrors the rule and the zeroed tails)
    const bool tma_x = K % 8 == 0 && aligned16(x);
    const bool tma_dy = N % 8 == 0 && aligned16(dy);
    CUtensorMap mx{}, md{};
    // no row, no slab: no map of a zero extent
    if (tma_x && T > 0) {
      const cudaError_t e = tma_map_bf16(&mx, x, K, T, (uint64_t)K * 2, 64,
                                         GP_BK);
      if (e != cudaSuccess) return e;
    }
    if (tma_dy && T > 0) {
      const cudaError_t e = tma_map_bf16(&md, dy, N, T, (uint64_t)N * 2, 64,
                                         GP_BK);
      if (e != cudaSuccess) return e;
    }
    if (tma_x && tma_dy)
      return launch_tgmm<true, true>(mx, md, hx, hd, group_sizes, f32o, b16o,
                                     T, K, N, grid, stream);
    if (tma_x)
      return launch_tgmm<true, false>(mx, md, hx, hd, group_sizes, f32o,
                                      b16o, T, K, N, grid, stream);
    if (tma_dy)
      return launch_tgmm<false, true>(mx, md, hx, hd, group_sizes, f32o,
                                      b16o, T, K, N, grid, stream);
    return launch_tgmm<false, false>(mx, md, hx, hd, group_sizes, f32o, b16o,
                                     T, K, N, grid, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
