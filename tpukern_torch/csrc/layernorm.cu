// Layer norm: y = (x - mean) * rsqrt(var + eps) * g + b per row, with
// mean = sum(x) / K and var = sum(x^2) / K - mean^2 in f32.
//
// Replaces tpukern/ops/layernorm.py:52 `kernel` (layer_norm :34) and
// computes its function: the one-pass variance E[x^2] - mean^2 (:60-62),
// not Welford's, so a row with a large mean and a small spread cancels as
// it does in JAX; with acc_bf16 both statistics are rounded through bf16
// after var is formed from the unrounded mean (:63-65); g and b are each
// a vector (f32 or bf16) or one scalar (null: g_scalar, b_scalar); f16
// rows are storage-only (tpukern/core/config.py): read directly, f32
// math, one rounding on the way out. The divisions by K are IEEE
// divisions, as JAX's `/ K`, and every step of the normalization is one
// rounded operation (no FMA contraction), as the plain version's
// elementwise ops are.
//
// The TPU kernel holds a block of rows in VMEM; here one block of threads
// owns one row. Bound by memory bandwidth: x is read from HBM once and y
// written once. One pass accumulates each thread's sum and sum of squares
// together over its 16-byte packs (4 f32, 8 bf16 or f16; elements one at
// a time where the row is no whole packs on an aligned base), copying
// each pack into shared memory as it goes (rows up to ROW_STAGE_MAX
// bytes, common.cuh read_row, as softmax #33 does); the two sums are
// reduced with warp shuffles, then across the warps (block_fold2). The
// normalize pass reads the thread's own packs back from shared memory,
// or from global memory (L2) for a wider row, inside the same kernel, so
// any width gives the right result.
#include "common.cuh"

namespace tk {
namespace {

template <typename T, typename G, int N>
__device__ __forceinline__ void ln_row(const T* xr, T* yr, T* st, const G* g,
                                       float g_scalar, const G* b,
                                       float b_scalar, int64_t cols,
                                       float eps, int acc_bf16, float* red) {
  const int t = threadIdx.x, tsz = blockDim.x;
  float s = 0.f, ss = 0.f;
  read_row<T, N>(xr, st, cols, t, tsz, [&](const Pack<T, N>& q) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = to_f32(q.v[j]);
      s += f;
      ss += f * f;
    }
  });
  block_fold2(s, ss, 0.f, 0.f, red, [](float& a, float& b) {
    a = warp_sum(a);
    b = warp_sum(b);
  });

  const float k = (float)cols;
  float mean = __fdiv_rn(s, k);
  float var = __fsub_rn(__fdiv_rn(ss, k), __fmul_rn(mean, mean));
  if (acc_bf16) {
    mean = __bfloat162float(__float2bfloat16(mean));
    var = __bfloat162float(__float2bfloat16(var));
  }
  const float inv = rsqrtf(__fadd_rn(var, eps));

  const T* src = st ? st : xr;
  for (int64_t c = (int64_t)t * N; c < cols; c += (int64_t)tsz * N) {
    const Pack<T, N> q = *reinterpret_cast<const Pack<T, N>*>(src + c);
    Pack<T, N> o;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float y = __fmul_rn(__fsub_rn(to_f32(q.v[j]), mean), inv);
      const float gj = g ? to_f32(g[c + j]) : g_scalar;
      const float bj = b ? to_f32(b[c + j]) : b_scalar;
      o.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(y, gj), bj));
    }
    *reinterpret_cast<Pack<T, N>*>(yr + c) = o;
  }
}

// one block a row; vec: the rows are whole 16-byte packs on an aligned
// base; stage: the row is copied to dynamic shared memory
template <typename T, typename G>
__global__ void __launch_bounds__(1024)
layer_norm_kernel(const T* __restrict__ x, const G* __restrict__ g,
                  float g_scalar, const G* __restrict__ b, float b_scalar,
                  T* __restrict__ y, int64_t cols, float eps, int acc_bf16,
                  int vec, int stage) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char ln_stage[];
  __shared__ float red[64];
  const T* xr = x + (int64_t)blockIdx.x * cols;
  T* yr = y + (int64_t)blockIdx.x * cols;
  T* st = stage ? reinterpret_cast<T*>(ln_stage) : nullptr;
  if (vec)
    ln_row<T, G, VEC>(xr, yr, st, g, g_scalar, b, b_scalar, cols, eps,
                      acc_bf16, red);
  else
    ln_row<T, G, 1>(xr, yr, st, g, g_scalar, b, b_scalar, cols, eps,
                    acc_bf16, red);
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* g, float g_scalar,
                   const void* b, float b_scalar, void* y, int64_t rows,
                   int64_t cols, float eps, int acc_bf16,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec = whole_packs<T>(cols, x, y);
  const int threads = row_threads(vec ? cols / VEC : cols, 32);
  auto kernel = layer_norm_kernel<T, G>;
  int smem;
  const cudaError_t e =
      row_stage_smem(kernel, cols * (int64_t)sizeof(T), &smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(g), g_scalar,
      static_cast<const G*>(b), b_scalar, static_cast<T*>(y), cols, eps,
      acc_bf16, vec, smem > 0);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_gb(const void* x, const void* g, float g_scalar,
                      const void* b, float b_scalar, void* y, int64_t rows,
                      int64_t cols, float eps, int acc_bf16, int gb_dtype,
                      cudaStream_t stream) {
  if (gb_dtype == kF32)
    return launch<T, float>(x, g, g_scalar, b, b_scalar, y, rows, cols, eps,
                            acc_bf16, stream);
  if (gb_dtype == kBF16)
    return launch<T, bf16>(x, g, g_scalar, b, b_scalar, y, rows, cols, eps,
                           acc_bf16, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// g and b (cols,) of gb_dtype each, or null for g_scalar / b_scalar
cudaError_t layer_norm_launch(const void* x, const void* g, float g_scalar,
                              const void* b, float b_scalar, void* y,
                              int64_t rows, int64_t cols, float eps,
                              int acc_bf16, int x_dtype, int gb_dtype,
                              cudaStream_t stream) {
  if (rows < 0 || cols < 0 || rows > 0x7fffffff) return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;  // empty: null pointers
  if (!x || !y) return cudaErrorInvalidValue;
  if (x_dtype == kF32)
    return launch_gb<float>(x, g, g_scalar, b, b_scalar, y, rows, cols, eps,
                            acc_bf16, gb_dtype, stream);
  if (x_dtype == kBF16)
    return launch_gb<bf16>(x, g, g_scalar, b, b_scalar, y, rows, cols, eps,
                           acc_bf16, gb_dtype, stream);
  if (x_dtype == kF16)
    return launch_gb<f16>(x, g, g_scalar, b, b_scalar, y, rows, cols, eps,
                          acc_bf16, gb_dtype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tk
