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
// - gmm: a grid of (N tiles, M tiles). Each block reads the E group sizes
//   itself and keeps their running sum (no host sync, no offsets tensor),
//   finds the groups whose rows meet its 128-row tile and runs the K loop
//   once for each of them with that group's W[e]. Row r of the product
//   depends on x's row r alone, so no row of x needs masking: the block
//   writes only the group's rows of each product. Two blocks never write
//   one row: no atomics, no merge. A tile holding a group boundary runs
//   the K loop once per group that meets it (at most tiles + E - 1 loops
//   over the grid).
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
// loaded: compute bound, as csrc/matmul.cu. f32 runs common.cuh's
// sgemm_tile on CUDA-core FMAs in full f32 (never TF32). bf16 gmm runs
// common.cuh's hgemm_tile (mma.sync m16n8k16, K slices of 32 through
// padded shared memory, one stage). bf16 tgmm runs hopper.cuh's
// gemm_pipeline, as csrc/matmul.cu's bf16 GEMM: 128 x 256 tiles of
// (K, N), a group's in runs of 8 tile rows (gemm_tile_order), a ring of
// 4 stages of 64-row slabs, TMA and wgmma, with both operands MN-major (A
// = x^T by the transpose-A bit, B = dy by the transpose-B bit, in
// 64-column boxes), one tensor map over the whole of x and of dy. A
// group's slabs start at its first row s and step by 64; where fewer
// than 64 of its rows are left, that last slab loads as the others and
// the consumers zero its rows >= t in both operands before the products
// (the next group's rows, or NaN past the groups, never reach the sum).
// x or dy whose rows are no whole 16-byte chunks (K or N % 8 != 0) is
// copied by the producer's threads in every slab. An empty group runs no
// slab and writes zeros. f32 accumulation throughout; gmm on the same
// pipeline is later work.
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

// two blocks an SM, as csrc/matmul.cu's sgemm_kernel (127 registers)
// runs: without the bound the group loop took 145-155 registers, which
// left room for one block an SM
template <bool TRANS_W>
__global__ void __launch_bounds__(F_THREADS, 2)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ sizes, float* __restrict__ y32,
               bf16* __restrict__ y16, int T, int N, int K, int E) {
  __shared__ __align__(16) float as[F_BK][F_BM];
  __shared__ __align__(16) float bs[F_BK][F_BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const int m1 = min(m0 + F_BM, T);
  auto store = [&](int r, int c, float v) {
    if (y32) y32[(int64_t)r * N + c] = v;
    if (y16) y16[(int64_t)r * N + c] = __float2bfloat16(v);
  };
  int off = 0;
  for (int e = 0; e < E; ++e) {
    int s, t;
    group_rows(sizes, e, T, off, s, t);
    s = max(s, m0);
    t = min(t, m1);
    if (s >= t) continue;
    float acc[8][8];
    sgemm_tile<TRANS_W>(x, w + (int64_t)e * K * N, T, N, K, m0, n0, as, bs,
                        acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + sgemm_pos(i, ty);
      if (r < s || r >= t) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + sgemm_pos(j, tx);
        if (c < N) store(r, c, acc[i][j]);
      }
    }
  }
  // rows past the last group belong to none: zeros
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + sgemm_pos(i, ty);
    if (r < off || r >= m1) continue;
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + sgemm_pos(j, tx);
      if (c < N) store(r, c, 0.f);
    }
  }
}

template <bool TRANS_W>
__global__ void __launch_bounds__(H_THREADS)
gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const int* __restrict__ sizes, float* __restrict__ y32,
                bf16* __restrict__ y16, int T, int N, int K, int E,
                int vec_a, int vec_b) {
  __shared__ __align__(16) bf16 as[H_BM * H_LDK];
  __shared__ __align__(16) bf16 bs[TRANS_W ? H_BN * H_LDK : H_BK * H_LDN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;
  const int m1 = min(m0 + H_BM, T);
  auto store = [&](int r, int c, float v) {
    if (y32) y32[(int64_t)r * N + c] = v;
    if (y16) y16[(int64_t)r * N + c] = __float2bfloat16(v);
  };
  int off = 0;
  for (int e = 0; e < E; ++e) {
    int s, t;
    group_rows(sizes, e, T, off, s, t);
    s = max(s, m0);
    t = min(t, m1);
    if (s >= t) continue;
    float acc[4][4][4];
    hgemm_tile<TRANS_W>(x, w + (int64_t)e * K * N, T, N, K, m0, n0, vec_a,
                        vec_b, as, bs, acc);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m0 + hgemm_row(warp, mt, g, q);
          const int c = n0 + hgemm_col(warp, nt, tq, q);
          if (r >= s && r < t && c < N) store(r, c, acc[mt][nt][q]);
        }
      }
    }
  }
  for (int mt = 0; mt < 4; ++mt)
    for (int nt = 0; nt < 4; ++nt)
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + hgemm_row(warp, mt, g, q);
        const int c = n0 + hgemm_col(warp, nt, tq, q);
        if (r >= off && r < m1 && c < N) store(r, c, 0.f);
      }
}

// the rows [s, t) of group blockIdx.z
__device__ __forceinline__ void own_group(const int* __restrict__ sizes,
                                          int T, int& s, int& t) {
  int off = 0;
  for (int e = 0; e < (int)blockIdx.z; ++e) off += max(sizes[e], 0);
  group_rows(sizes, blockIdx.z, T, off, s, t);
}

__global__ void __launch_bounds__(F_THREADS)
tgmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                const int* __restrict__ sizes, float* __restrict__ o32,
                bf16* __restrict__ o16, int T, int K, int N) {
  __shared__ __align__(16) float as[F_BK][F_BM];
  __shared__ __align__(16) float bs[F_BK][F_BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  int s, t;
  own_group(sizes, T, s, t);
  float acc[8][8];
  // an empty group runs no slice and writes its zeros
  sgemm_tile<false, true>(x, dy, K, N, t, k0, n0, as, bs, acc, s);
  const int64_t base = (int64_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = k0 + sgemm_pos(i, ty);
    if (r >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + sgemm_pos(j, tx);
      if (c >= N) continue;
      if (o32) o32[base + (int64_t)r * N + c] = acc[i][j];
      if (o16) o16[base + (int64_t)r * N + c] = __float2bfloat16(acc[i][j]);
    }
  }
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

}  // namespace

cudaError_t gmm_launch(const void* x, const void* w, const int* group_sizes,
                       void* y32, void* y16, int T, int N, int K, int E,
                       int trans_w, int dtype, cudaStream_t stream) {
  if (T < 0 || N < 0 || K < 0 || E < 1 || (!y32 && !y16))
    return cudaErrorInvalidValue;
  if (T == 0 || N == 0) return cudaSuccess;
  float* o32 = static_cast<float*>(y32);
  bf16* o16 = static_cast<bf16*>(y16);
  if (dtype == kF32) {
    const dim3 grid((N + F_BN - 1) / F_BN, (T + F_BM - 1) / F_BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const float* fx = static_cast<const float*>(x);
    const float* fw = static_cast<const float*>(w);
    if (trans_w)
      gmm_f32_kernel<true><<<grid, F_THREADS, 0, stream>>>(
          fx, fw, group_sizes, o32, o16, T, N, K, E);
    else
      gmm_f32_kernel<false><<<grid, F_THREADS, 0, stream>>>(
          fx, fw, group_sizes, o32, o16, T, N, K, E);
  } else if (dtype == kBF16) {
    const dim3 grid((N + H_BN - 1) / H_BN, (T + H_BM - 1) / H_BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bf16* hx = static_cast<const bf16*>(x);
    const bf16* hw = static_cast<const bf16*>(w);
    // 16-byte loads need 16-byte aligned rows (the wrapper aligns the
    // bases; W[e]'s base then is aligned too when its rows are)
    if (trans_w)
      gmm_bf16_kernel<true><<<grid, H_THREADS, 0, stream>>>(
          hx, hw, group_sizes, o32, o16, T, N, K, E, K % 8 == 0, K % 8 == 0);
    else
      gmm_bf16_kernel<false><<<grid, H_THREADS, 0, stream>>>(
          hx, hw, group_sizes, o32, o16, T, N, K, E, K % 8 == 0, N % 8 == 0);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

cudaError_t tgmm_launch(const void* x, const void* dy, const int* group_sizes,
                        void* o32, void* o16, int T, int K, int N, int E,
                        int dtype, cudaStream_t stream) {
  if (T < 0 || N < 0 || K < 0 || E < 1 || (!o32 && !o16))
    return cudaErrorInvalidValue;
  if (K == 0 || N == 0) return cudaSuccess;
  if (E > 65535) return cudaErrorInvalidValue;
  float* f32o = static_cast<float*>(o32);
  bf16* b16o = static_cast<bf16*>(o16);
  if (dtype == kF32) {
    const dim3 grid((N + F_BN - 1) / F_BN, (K + F_BM - 1) / F_BM, E);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    tgmm_f32_kernel<<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        group_sizes, f32o, b16o, T, K, N);
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
