// RMS norm: y = x * rsqrt(mean(x^2) + eps) * g per row, stats in f32.
//
// Replaces tpukern/ops/rmsnorm.py:34 `kernel` (rms_norm), with its options:
// g a vector (f32 or bf16) or one scalar (g == null: g_scalar), a bf16
// accumulator (acc_bf16: the row's mean square rounded through bf16,
// rmsnorm.py:44-46; an f16 accumulator is storage-only and sums in f32),
// and f16 rows, storage-only too (f32 math, one rounding on the way out).
// The TPU kernel holds a block of rows in VMEM; here one block of threads
// owns one row. Bound by memory bandwidth: it reads each row once for the
// sum of squares and once more (from L1/L2, the row is at most a few KB)
// to scale it, and writes it once. Each thread reads 16 bytes at a time
// when the row allows it (8 bf16 or f16, 4 f32), the sum is reduced with
// warp shuffles and then across warps through shared memory.
#include "common.cuh"

namespace tk {
namespace {

template <typename T, typename G>
__global__ void rms_norm_kernel(const T* __restrict__ x, const G* __restrict__ g,
                                float g_scalar, T* __restrict__ y,
                                int64_t cols, float eps, int acc_bf16) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + blockIdx.x * cols;
  T* yr = y + blockIdx.x * cols;
  // rows are 16-byte aligned when the base is and cols is a VEC multiple
  const bool vec = cols % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const int64_t nvec = vec ? cols / VEC : 0;

  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(e[j]);
      ss += f * f;
    }
  }
  for (int64_t i = nvec * VEC + threadIdx.x; i < cols; i += blockDim.x) {
    const float f = to_f32(xr[i]);
    ss += f * f;
  }

  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  float ms = red[0] / (float)cols;
  if (acc_bf16) ms = __bfloat162float(__float2bfloat16(ms));
  const float inv = rsqrtf(ms + eps);

  for (int64_t i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = from_f32<T>(to_f32(e[j]) * inv *
                         (g ? to_f32(g[i * VEC + j]) : g_scalar));
    reinterpret_cast<uint4*>(yr)[i] = out;
  }
  for (int64_t i = nvec * VEC + threadIdx.x; i < cols; i += blockDim.x)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * (g ? to_f32(g[i]) : g_scalar));
}

template <typename T, typename G>
void launch(const void* x, const void* g, float g_scalar, void* y,
            int64_t rows, int64_t cols, float eps, int acc_bf16,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // one thread per 16-byte chunk, 32..256 threads
  int64_t want = (cols + VEC - 1) / VEC;
  int threads = 32;
  while (threads < 256 && threads < want) threads *= 2;
  rms_norm_kernel<T, G><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(g), g_scalar,
      static_cast<T*>(y), cols, eps, acc_bf16);
}

template <typename T>
bool launch_g(const void* x, const void* g, float g_scalar, void* y,
              int64_t rows, int64_t cols, float eps, int acc_bf16,
              int g_dtype, cudaStream_t stream) {
  if (g == nullptr || g_dtype == kF32)
    launch<T, float>(x, g, g_scalar, y, rows, cols, eps, acc_bf16, stream);
  else if (g_dtype == kBF16)
    launch<T, bf16>(x, g, g_scalar, y, rows, cols, eps, acc_bf16, stream);
  else
    return false;
  return true;
}

}  // namespace

// g (cols,) of g_dtype, or null for the scalar g_scalar
cudaError_t rms_norm_launch(const void* x, const void* g, float g_scalar,
                            void* y, int64_t rows, int64_t cols, float eps,
                            int acc_bf16, int x_dtype, int g_dtype,
                            cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return rows == 0 ? cudaSuccess : cudaErrorInvalidValue;
  if (rows > 0x7fffffff) return cudaErrorInvalidValue;
  bool ok;
  if (x_dtype == kBF16)
    ok = launch_g<bf16>(x, g, g_scalar, y, rows, cols, eps, acc_bf16, g_dtype,
                        stream);
  else if (x_dtype == kF32)
    ok = launch_g<float>(x, g, g_scalar, y, rows, cols, eps, acc_bf16,
                         g_dtype, stream);
  else if (x_dtype == kF16)
    ok = launch_g<f16>(x, g, g_scalar, y, rows, cols, eps, acc_bf16, g_dtype,
                       stream);
  else
    ok = false;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tk
