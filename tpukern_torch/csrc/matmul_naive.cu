// Naive GEMM: C[M,N] = A[M,K] · B[K,N], one thread per output element,
// accumulated in f32 and written in the input dtype.
//
// Replaces tpukern/ops/matmul.py:384 `kernel` (matmul_naive), the naive
// rung of the GEMM ladder (the reference's sgemm_naive_f32 and
// hgemm_naive_f16: no tiling, no shared memory). A block is 32 x 8
// threads: the 32 threads of a warp take 32 neighbouring columns of one
// row, so every load of B is one coalesced 128-byte (f32) or 64-byte
// (bf16) line and A's element is one broadcast load. K runs in steps of 4
// with a tail for K % 4.
//
// What bounds it: nothing is reused through shared memory, so each output
// reads 2K elements through L1/L2 for K multiply-adds; at 4096^3 it runs
// far below both the card's FLOP rate and its bandwidth. The tiled
// kernels of csrc/matmul.cu are the ladder's next rungs.
#include "common.cuh"

namespace tk {
namespace {

constexpr int NV_BX = 32, NV_BY = 8;

template <typename T>
__global__ void __launch_bounds__(NV_BX * NV_BY)
matmul_naive_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int M, int N, int K) {
  const int n = blockIdx.x * NV_BX + threadIdx.x;
  const int m = blockIdx.y * NV_BY + threadIdx.y;
  if (m >= M || n >= N) return;
  const T* ar = a + (int64_t)m * K;
  const T* bc = b + n;
  float acc = 0.f;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc += to_f32(ar[k + j]) * to_f32(bc[(int64_t)(k + j) * N]);
  }
  for (; k < K; ++k) acc += to_f32(ar[k]) * to_f32(bc[(int64_t)k * N]);
  c[(int64_t)m * N + n] = from_f32<T>(acc);
}

template <typename T>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            const dim3& grid, cudaStream_t stream) {
  matmul_naive_kernel<T><<<grid, dim3(NV_BX, NV_BY), 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
}

}  // namespace

cudaError_t matmul_naive_launch(const void* a, const void* b, void* c, int M,
                                int N, int K, int dtype, cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || !a || !b || !c) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + NV_BX - 1) / NV_BX, (M + NV_BY - 1) / NV_BY);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (dtype == kF32)
    launch<float>(a, b, c, M, N, K, grid, stream);
  else if (dtype == kBF16)
    launch<bf16>(a, b, c, M, N, K, grid, stream);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace tk
