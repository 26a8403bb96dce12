// GEMM: C[M,N] = A[M,K] · B[K,N] (NN), or A[M,K] · B[N,K]^T (TN,
// trans_b), accumulated in f32. A block owns one tile of C (f32 128 x
// 128, bf16 128 x 256) and walks K; every load is bounds-checked or
// zero-filled past the edges (TMA), so M, N and K need not be tile
// multiples (the K tail reads zeros, the M/N edges are not stored).
//
// Replaces tpukern/ops/matmul.py `matmul`'s three Pallas bodies, which
// differ only in where the f32 accumulator ends up; here it lives in
// registers and one epilogue writes it through two nullable pointers:
//   `kernel` (:172)            -> the out dtype: c32 or c16 alone
//   `kernel_accio` (:140)      -> the f32 accumulator: c32 alone
//   `kernel_accio_dual` (:155) -> f32 plus a bf16 copy: c32 and c16
//
// What bounds it: at the training shapes (K = 2048-8192, M = 2048 tokens)
// a tile does 128·128·K multiply-adds per 2·128·K elements loaded, so the
// kernel is compute bound and the tier decides the rate.
// - f32 inputs run on CUDA-core FMAs in full f32, never TF32 (the JAX CPU
//   reference is exact f32): 256 threads, each an 8 x 8 register tile
//   split in two 4-wide halves so shared-memory reads are float4 and
//   conflict-free (the reference's sgemm_t_8x8_sliced_k_f32x4 design,
//   SURVEY.md §2.2). The next K slice is fetched into registers while the
//   current one is multiplied.
// - bf16 inputs run on hopper.cuh's gemm_pipeline: a 128 x 256 tile a
//   block of three warpgroups, K in slabs of 64 through a ring of 4
//   stages of 128B-swizzled shared memory, one producer warpgroup filling
//   them by TMA and two consumers each issuing wgmma m64n256k16 on 64
//   rows with one group in flight. A (M, K) is K-major; B is MN-major in
//   NN ((K, N), the transpose-B bit, four 64-column boxes) and K-major in
//   TN ((N, K), as A). TMA's zero fill covers the K tail and the M/N
//   edges. An operand whose rows are not whole 16-byte chunks (K % 8 for
//   A and a TN B, N % 8 for an NN B; the wrapper aligns the bases) is
//   copied into the same layout by the producer's threads instead
//   (cp.async of the aligned words, then shifts; 3 stages), a template
//   flag each (ops/matmul.py tma_operands mirrors the rule).
//   One block an SM (192-199 KiB); the grid is one block a tile,
//   not persistent, its tiles in groups of 8 tile rows (gemm_tile_order)
//   so that the blocks in flight share A's rows and B's columns in L2.
//   The epilogue writes the accumulators from wgmma's layout, in column
//   pairs.
#include "hopper.cuh"

namespace tk {
namespace {

// The main loops are common.cuh's sgemm_tile (shared with
// csrc/cross_entropy.cu) and hopper.cuh's gemm_pipeline (shared with
// csrc/grouped_matmul.cu's tgmm); each kernel adds the epilogue.
template <bool TRANS_B>
__global__ void __launch_bounds__(F_THREADS)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c32, bf16* __restrict__ c16, int M, int N,
             int K) {
  __shared__ __align__(16) float as[F_BK][F_BM];  // A tile, k-major
  __shared__ __align__(16) float bs[F_BK][F_BN];  // B tile, k-major
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  float acc[8][8];
  sgemm_tile<TRANS_B>(a, b, M, N, K, m0, n0, as, bs, acc);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + sgemm_pos(i, ty);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + sgemm_pos(j, tx);
      if (c >= N) continue;
      if (c32) c32[(int64_t)r * N + c] = acc[i][j];
      if (c16) c16[(int64_t)r * N + c] = __float2bfloat16(acc[i][j]);
    }
  }
}

template <bool TRANS_B, bool TMA_A, bool TMA_B>
__global__ void __launch_bounds__(GP_THREADS, 1)
hgemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const bf16* __restrict__ a, const bf16* __restrict__ b,
                   float* __restrict__ c32, bf16* __restrict__ c16, int M,
                   int N, int K) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * GP_BN;
  const GemmOperand oa{a, M, K, m0};
  // TN: B (N, K) K-major as A; NN: B (K, N) MN-major, K its rows
  const GemmOperand ob = TRANS_B ? GemmOperand{b, N, K, n0}
                                 : GemmOperand{b, K, N, n0};
  gemm_pipeline<false, !TRANS_B, TMA_A, TMA_B, false>(
      &map_a, &map_b, oa, ob, 0, K,
      [&](const float (&d)[128]) { gemm_store(d, c32, c16, M, N, m0, n0); });
}

template <bool TRANS_B, bool TMA_A, bool TMA_B>
cudaError_t launch_hgemm(const CUtensorMap& ma, const CUtensorMap& mb,
                         const bf16* a, const bf16* b, float* c32, bf16* c16,
                         int M, int N, int K, const dim3& grid,
                         cudaStream_t stream) {
  const auto kernel = hgemm_wgmma_kernel<TRANS_B, TMA_A, TMA_B>;
  constexpr int smem = gemm_smem(!(TMA_A && TMA_B));
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, GP_THREADS, smem, stream>>>(ma, mb, a, b, c32, c16, M, N,
                                                K);
  return cudaSuccess;
}

template <bool TRANS_B>
cudaError_t dispatch_hgemm(bool tma_a, bool tma_b, const CUtensorMap& ma,
                         const CUtensorMap& mb, const bf16* a, const bf16* b,
                         float* c32, bf16* c16, int M, int N, int K,
                         const dim3& grid, cudaStream_t stream) {
  if (tma_a && tma_b)
    return launch_hgemm<TRANS_B, true, true>(ma, mb, a, b, c32, c16, M, N, K,
                                             grid, stream);
  if (tma_a)
    return launch_hgemm<TRANS_B, true, false>(ma, mb, a, b, c32, c16, M, N,
                                              K, grid, stream);
  if (tma_b)
    return launch_hgemm<TRANS_B, false, true>(ma, mb, a, b, c32, c16, M, N,
                                              K, grid, stream);
  return launch_hgemm<TRANS_B, false, false>(ma, mb, a, b, c32, c16, M, N, K,
                                             grid, stream);
}

}  // namespace

cudaError_t matmul_launch(const void* a, const void* b, void* c32, void* c16,
                          int M, int N, int K, int trans_b, int dtype,
                          cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || (!c32 && !c16)) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  float* o32 = static_cast<float*>(c32);
  bf16* o16 = static_cast<bf16*>(c16);
  if (dtype == kF32) {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    if (trans_b)
      sgemm_kernel<true><<<grid, F_THREADS, 0, stream>>>(fa, fb, o32, o16, M, N, K);
    else
      sgemm_kernel<false><<<grid, F_THREADS, 0, stream>>>(fa, fb, o32, o16, M, N, K);
  } else if (dtype == kBF16) {
    const dim3 grid((N + GP_BN - 1) / GP_BN, (M + GP_BM - 1) / GP_BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bf16* ha = static_cast<const bf16*>(a);
    const bf16* hb = static_cast<const bf16*>(b);
    // an operand by TMA where its base is 16-byte aligned and its rows are
    // whole 16-byte chunks, else by the producer's copy
    const bool tma_a = K % 8 == 0 && aligned16(a);
    const bool tma_b = (trans_b ? K : N) % 8 == 0 && aligned16(b);
    CUtensorMap ma{}, mb{};
    // no slab at K = 0 (and no map of a zero extent): the tile is zeros
    if (tma_a && K > 0) {
      const cudaError_t e = tma_map_bf16(&ma, a, K, M, (uint64_t)K * 2,
                                         GP_BK, GP_BM);
      if (e != cudaSuccess) return e;
    }
    if (tma_b && K > 0) {
      const cudaError_t e =
          trans_b ? tma_map_bf16(&mb, b, K, N, (uint64_t)K * 2, GP_BK, GP_BN)
                  : tma_map_bf16(&mb, b, N, K, (uint64_t)N * 2, 64, GP_BK);
      if (e != cudaSuccess) return e;
    }
    return trans_b ? dispatch_hgemm<true>(tma_a, tma_b, ma, mb, ha, hb, o32,
                                          o16, M, N, K, grid, stream)
                   : dispatch_hgemm<false>(tma_a, tma_b, ma, mb, ha, hb, o32,
                                           o16, M, N, K, grid, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
