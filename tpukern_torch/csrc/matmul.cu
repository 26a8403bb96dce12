// GEMM: C[M,N] = A[M,K] · B[K,N] (NN), or A[M,K] · B[N,K]^T (TN,
// trans_b), accumulated in f32. A block owns one tile of C (bf16 128 x
// 256, f32 128 x 128) and walks K; TMA fills zeros past the edges, so M,
// N and K need not be tile
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
// a tile does 128·256·K multiply-adds per (128 + 256)·K elements loaded
// (f32: 128·128·K per 2·2·128·K, the hi and lo planes), so the kernel is
// compute bound and the tier decides the rate.
// - f32 inputs run split-TF32 products on the tensor cores (hopper.cuh
//   gemm_pipeline_tf32), the counterpart of the JAX f32 tier's
//   Precision.HIGHEST, which the TPU runs as bf16 passes on its matrix
//   unit: split_tf32_kernel (csrc/split_tf32.cu) writes A's hi and lo
//   planes (M, K4) and B's K-major (N, K4) (NN: B transposed; TN: as it
//   is) into the caller's scratch, K4 = K rounded up to 4, then one
//   launch runs A_lo·B_hi + A_hi·B_lo + A_hi·B_hi on wgmma .tf32, 3
//   stages of 128 x 128 x 32, each slab's products summed afresh and
//   added to f32 registers (hopper.cuh: the tensor core's own rounding
//   over all of K missed the accuracy gate 7.5x). Three TF32 products a
//   product: the bound is 3 · 2MNK / 495 TFLOP/s (416.5 µs at 2048 x 8192
//   x 2048, against 1025.7 on the CUDA cores' f32 FMAs, which no FMA
//   design can beat). Where the tiles fill less than half the SMs and K
//   is long (ops/split_tf32.py matmul_splits), K is split too: each split
//   block posts its partial tile to the scratch, and the tile's last
//   split (a ticket a tile) sums them in split order, so the result is
//   the same bits from run to run; one tile of K = 8192 chained 256 slab
//   sums and erred 2.2x cuBLAS's (which splits K there; PERF.md §6).
//   A product errs by less than 1.25·2^-20 of |a b|
//   (the split's), and the sums run in f32: on the card the result's
//   error against an f64 product is held to at most twice cuBLAS f32's
//   (TF32 off) at the training and odd shapes (chip_smoke.py [train
//   kernels] accuracy gate). The split passes' time is part of the
//   call's.
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
// Both tiers: one block an SM (192-199 KiB); the grid is one block a
// tile, not persistent, its tiles in groups of 8 tile rows
// (gemm_tile_order) so that the blocks in flight share A's rows and B's
// columns in L2. The epilogue writes the accumulators from wgmma's
// layout, in column pairs.
#include "hopper.cuh"

namespace tk {
namespace {

// The main loops are hopper.cuh's gemm_pipeline (shared with
// csrc/grouped_matmul.cu's bf16 gmm and tgmm and csrc/cross_entropy.cu's
// bf16 kernels) and gemm_pipeline_tf32 (shared with the f32 CE backward);
// each kernel adds the epilogue.
// Block (x, y, z): the tile of launch-order block (x, y) over split z of
// the slabs, `per` slabs a split; with more than one split the partial
// sums meet in split_k_merge and the last split of the tile stores it.
__global__ void __launch_bounds__(GP_THREADS, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 float* __restrict__ c32, bf16* __restrict__ c16, int M,
                 int N, int K, int per, float* __restrict__ ws,
                 int* __restrict__ tickets) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * TF_BN, z = blockIdx.z;
  const int k0 = z * per * TF_BK, k1 = min(K, k0 + per * TF_BK);
  gemm_pipeline_tf32(&map_a, &map_b, m0, n0, k0, k1, [&](float (&d)[64]) {
    if (gridDim.z > 1 && !split_k_merge(d, ws, tickets,
                                        tm * gridDim.x + tn, z, gridDim.z))
      return;
    gemm_store(d, c32, c16, M, N, m0, n0);
  });
}

// the f32 tier: A's planes and B's K-major planes into scratch, then the
// split-TF32 GEMM over `splits` splits of K (its partial tiles after the
// planes in scratch, a ticket a tile in tickets)
cudaError_t matmul_tf32(const float* a, const float* b, float* c32,
                        bf16* c16, int M, int N, int K, int trans_b,
                        float* scratch, int splits, int* tickets,
                        int* passes, cudaStream_t stream) {
  const int slabs = (K + TF_BK - 1) / TF_BK;
  const int per = splits > 0 ? (slabs + splits - 1) / splits : 0;
  const dim3 grid((N + TF_BN - 1) / TF_BN, (M + GP_BM - 1) / GP_BM, splits);
  // every split takes a slab; more than one needs partials and tickets
  if (grid.y > 65535 || splits < 1 || splits > 65535 ||
      (splits > 1 && ((slabs + per - 1) / per != splits || !tickets)))
    return cudaErrorInvalidValue;
  CUtensorMap ma{}, mb{};
  // no slab at K = 0 (and no map of a zero extent): the tile is zeros
  if (K > 0) {
    if (!scratch || !aligned16(scratch)) return cudaErrorInvalidValue;
    const int64_t k4 = (K + 3) / 4 * 4;
    float* sa = scratch;               // A's planes (2, M, k4)
    float* sb = sa + 2 * (int64_t)M * k4;  // B's planes (2, N, k4)
    cudaError_t e =
        split_tf32_launch(a, M, K, K, sa, k4, nullptr, 0, passes, stream);
    if (e == cudaSuccess)
      e = trans_b ? split_tf32_launch(b, N, K, K, sb, k4, nullptr, 0, passes,
                                      stream)
                  : split_tf32_launch(b, K, N, N, nullptr, 0, sb, k4, passes,
                                      stream);
    if (e == cudaSuccess) e = tma_map_planes(&ma, sa, K, M, k4, GP_BM);
    if (e == cudaSuccess) e = tma_map_planes(&mb, sb, K, N, k4, TF_BN);
    if (e != cudaSuccess) return e;
  }
  float* ws = scratch ? scratch + 2 * (int64_t)(M + N) * ((K + 3) / 4 * 4)
                     : nullptr;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TF_SMEM);
  if (e != cudaSuccess) return e;
  gemm_tf32_kernel<<<grid, GP_THREADS, TF_SMEM, stream>>>(
      ma, mb, c32, c16, M, N, K, per, ws, tickets);
  return cudaSuccess;
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
                          void* scratch, int splits, int* tickets,
                          int* passes, cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || (!c32 && !c16)) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  float* o32 = static_cast<float*>(c32);
  bf16* o16 = static_cast<bf16*>(c16);
  if (dtype == kF32)
    return matmul_tf32(static_cast<const float*>(a),
                       static_cast<const float*>(b), o32, o16, M, N, K,
                       trans_b, static_cast<float*>(scratch), splits,
                       tickets, passes, stream);
  if (dtype == kBF16) {
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
  }
  return cudaErrorInvalidValue;
}

}  // namespace tk
