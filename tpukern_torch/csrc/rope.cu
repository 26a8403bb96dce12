// RoPE: half-split (NeoX) rotation of each row's pairs (x[j], x[j + D/2]).
//
// rope_cached replaces tpukern/ops/rope.py:118 `kernel` (rope_cached): the
// angle's cos/sin are row r, column j of f32 (rows, D/2) tables.
// rope_batched replaces tpukern/ops/rope.py:81 `kernel` (rope_batched): the
// angle is computed in the kernel, as the TPU kernel does, from position
// = row % seq_len and frequency exp(j * (-2 ln 1e4 / D)), in f32 with the
// accurate expf and sincosf. Angles reach ~1e3 rad at S = 1024, where the
// fast intrinsics (__expf, __sinf) would lose several digits. sign = -1
// is the inverse rotation (the backward).
//
// Both are elementwise and bound by memory bandwidth: one thread per
// (row, pair) reads two elements of x and writes two. Neighbouring
// threads take neighbouring pairs of one row, so every access of a warp is
// contiguous.
#include "common.cuh"

namespace tk {
namespace {

template <typename T>
__global__ void rope_cached_kernel(const T* __restrict__ x,
                                   const float* __restrict__ cos,
                                   const float* __restrict__ sin,
                                   T* __restrict__ y, int64_t rows, int half) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  const int64_t r = idx / half;
  const int j = (int)(idx - r * half);
  const int64_t base = r * 2 * half;
  const float x1 = to_f32(x[base + j]), x2 = to_f32(x[base + j + half]);
  const float c = cos[idx], s = sin[idx];
  y[base + j] = from_f32<T>(x1 * c - x2 * s);
  y[base + j + half] = from_f32<T>(x1 * s + x2 * c);
}

template <typename T>
__global__ void rope_batched_kernel(const T* __restrict__ x, T* __restrict__ y,
                                    int64_t rows, int half, int seq_len,
                                    float coef, float sign) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  const int64_t r = idx / half;
  const int j = (int)(idx - r * half);
  // f32 products in the order of the JAX kernel: pos * exp(j * coef)
  const float freq = expf((float)j * coef);
  const float ang = __fmul_rn((float)(r % seq_len), freq);
  float s, c;
  sincosf(ang, &s, &c);
  s *= sign;
  const int64_t base = r * 2 * half;
  const float x1 = to_f32(x[base + j]), x2 = to_f32(x[base + j + half]);
  y[base + j] = from_f32<T>(x1 * c - x2 * s);
  y[base + j + half] = from_f32<T>(x1 * s + x2 * c);
}

}  // namespace

cudaError_t rope_batched_launch(const void* x, void* y, int64_t rows,
                                int head_dim, int seq_len, float sign,
                                int dtype, cudaStream_t stream) {
  if (head_dim <= 0 || head_dim % 2 || rows < 0 || seq_len <= 0)
    return cudaErrorInvalidValue;
  const int half = head_dim / 2;
  const int64_t n = rows * half;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  // -2 ln(1e4) / D in double, rounded once to f32 as JAX's weak-typed
  // Python scalar is
  const float coef = (float)(-2.0 * 9.210340371976184 / head_dim);
  if (dtype == kBF16)
    rope_batched_kernel<bf16><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), rows, half,
        seq_len, coef, sign);
  else if (dtype == kF32)
    rope_batched_kernel<float><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(y), rows, half,
        seq_len, coef, sign);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t rope_cached_launch(const void* x, const void* cos, const void* sin,
                               void* y, int64_t rows, int head_dim, int dtype,
                               cudaStream_t stream) {
  if (head_dim <= 0 || head_dim % 2 || rows < 0) return cudaErrorInvalidValue;
  const int half = head_dim / 2;
  const int64_t n = rows * half;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  if (dtype == kBF16)
    rope_cached_kernel<bf16><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const bf16*>(x), c, s, static_cast<bf16*>(y), rows, half);
  else if (dtype == kF32)
    rope_cached_kernel<float><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const float*>(x), c, s, static_cast<float*>(y), rows, half);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace tk
