// The split-TF32 operand pass: an f32 matrix into the hi and lo planes
// that csrc/hopper.cuh gemm_pipeline_tf32 reads (common.cuh split_tf32),
// as it is and transposed, K-major either way for the product that reads
// it. It replaces no TPU kernel: it is the first step of the f32 tier of
// #1-#3 and #17 (csrc/matmul.cu: A, and B, transposed in NN) and of
// #14/#15 (csrc/cross_entropy.cu: x and W's vocab chunk, each both ways),
// whose wgmma .tf32 takes both operands K-major only. The TPU kernels need
// no such pass: their f32 tier splits inside the matrix unit's passes.
//
// Block (32, 8) takes a 32 x 32 tile of the source, padded with zeros to
// the outputs' row strides: each thread splits 4 elements of a column,
// read a row at a time (coalesced), and writes the plain planes directly;
// the transposed planes go through shared memory (rows of 33 floats, no
// bank conflicts), so their writes are coalesced too.
//
// What bounds it: bytes. Each input value is read once and written as 2
// (one layout) or 4 (both) floats: at 3.35 TB/s, 2048 x 8192 f32 split
// and transposed takes at least 60 µs. Its share of a GEMM's time is
// reported beside the GEMM's (PERF.md).
#include "common.cuh"

namespace tk {
namespace {

constexpr int SP_T = 32;

__global__ void __launch_bounds__(256)
split_tf32_kernel(const float* __restrict__ src, int R, int C, int64_t ld,
                  float* __restrict__ out, int64_t ldo,
                  float* __restrict__ outT, int64_t ldoT) {
  __shared__ float th[SP_T][SP_T + 1], tl[SP_T][SP_T + 1];
  const int c0 = blockIdx.x * SP_T, r0 = blockIdx.y * SP_T;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t plane = (int64_t)R * ldo, planeT = (int64_t)C * ldoT;
#pragma unroll
  for (int i = 0; i < SP_T; i += 8) {
    const int r = r0 + ty + i, c = c0 + tx;
    const float x = r < R && c < C ? src[(int64_t)r * ld + c] : 0.f;
    float hi, lo;
    split_tf32(x, hi, lo);
    if (out && r < R && c < ldo) {
      out[(int64_t)r * ldo + c] = hi;
      out[plane + (int64_t)r * ldo + c] = lo;
    }
    th[ty + i][tx] = hi;
    tl[ty + i][tx] = lo;
  }
  if (!outT) return;  // the same for the whole block
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SP_T; i += 8) {
    const int c = c0 + ty + i, r = r0 + tx;  // row c of outT, column r
    if (c < C && r < ldoT) {
      outT[(int64_t)c * ldoT + r] = th[tx][ty + i];
      outT[planeT + (int64_t)c * ldoT + r] = tl[tx][ty + i];
    }
  }
}

}  // namespace

cudaError_t split_tf32_launch(const float* src, int R, int C, int64_t ld,
                              float* out, int64_t ldo, float* outT,
                              int64_t ldoT, int* passes,
                              cudaStream_t stream) {
  if (R <= 0 || C <= 0 || ld < C || (!out && !outT) ||
      (out && (ldo < C || ldo % 4)) || (outT && (ldoT < R || ldoT % 4)))
    return cudaErrorInvalidValue;
  // the tiles cover the source and the outputs' padding
  const int64_t rows = outT ? ldoT : R, cols = out ? ldo : C;
  const dim3 grid((unsigned)((cols + SP_T - 1) / SP_T),
                  (unsigned)((rows + SP_T - 1) / SP_T));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  split_tf32_kernel<<<grid, dim3(SP_T, 8), 0, stream>>>(src, R, C, ld, out,
                                                         ldo, outT, ldoT);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && passes) ++*passes;
  return e;
}

}  // namespace tk
