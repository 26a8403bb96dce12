// GEMM: C[M,N] = A[M,K] · B[K,N] (NN), or A[M,K] · B[N,K]^T (TN,
// trans_b), accumulated in f32. A block owns one 128 x 128 tile of C and
// walks K; every global load is bounds-checked, so M, N and K need not be
// tile multiples (the K tail reads zeros, the M/N edges are not stored).
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
// - bf16 inputs run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), as csrc/flash_attention.cu does: 8 warps in a 2 x 4
//   grid, each a 64 x 32 sub-tile, K in slices of 32 staged through
//   padded shared memory with 16-byte loads where a row is whole.
// Plain loads through shared memory: cp.async/TMA stages and wgmma are a
// later PR's work.
#include "common.cuh"

namespace tk {
namespace {

// The main loops are common.cuh's sgemm_tile and hgemm_tile (shared with
// csrc/cross_entropy.cu); each kernel adds the epilogue.
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

template <bool TRANS_B>
__global__ void __launch_bounds__(H_THREADS)
hgemm_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 float* __restrict__ c32, bf16* __restrict__ c16, int M,
                 int N, int K, int vec_a, int vec_b) {
  __shared__ __align__(16) bf16 as[H_BM * H_LDK];
  // TRANS_B: [n][k] like A; NN: [k][n]
  __shared__ __align__(16) bf16 bs[TRANS_B ? H_BN * H_LDK : H_BK * H_LDN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;
  float acc[4][4][4];
  hgemm_tile<TRANS_B>(a, b, M, N, K, m0, n0, vec_a, vec_b, as, bs, acc);

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + hgemm_row(warp, mt, g, e);
        const int c = n0 + hgemm_col(warp, nt, t, e);
        if (r >= M || c >= N) continue;
        if (c32) c32[(int64_t)r * N + c] = acc[mt][nt][e];
        if (c16) c16[(int64_t)r * N + c] = __float2bfloat16(acc[mt][nt][e]);
      }
    }
  }
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
    const dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bf16* ha = static_cast<const bf16*>(a);
    const bf16* hb = static_cast<const bf16*>(b);
    // 16-byte loads need 16-byte aligned rows: the wrapper aligns the
    // base, so rows are aligned when their length is a multiple of 8
    const int vec_a = K % 8 == 0;
    if (trans_b)
      hgemm_mma_kernel<true><<<grid, H_THREADS, 0, stream>>>(
          ha, hb, o32, o16, M, N, K, vec_a, K % 8 == 0);
    else
      hgemm_mma_kernel<false><<<grid, H_THREADS, 0, stream>>>(
          ha, hb, o32, o16, M, N, K, vec_a, N % 8 == 0);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
