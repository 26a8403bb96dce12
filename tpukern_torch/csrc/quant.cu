// Per-row quantization: int8 (round to nearest, or stochastic) and fp8
// e4m3 with one f32 scale per row, and int8 dequantization.
//
// quantize_kernel replaces tpukern/ops/quant.py:36 `kernel` (quantize_int8,
// #20) and :128 `kernel` (quantize_fp8, #22); dequantize_kernel replaces
// :89 `kernel` (dequantize_int8, #21). The TPU kernels take blocks of 256
// rows padded to 128 lanes, with the scale broadcast over a (rows, 128)
// block; here one warp owns one row of the natural width K, reads it with
// 16-byte loads (a lane's chunk of 4 f32 or 8 bf16; element by element
// where K or the base does not allow them), reduces |x| to the row's
// absmax with warp shuffles, and then converts each element:
//   scale = absmax / 127 (or / 448), 1 where absmax is 0,
//   int8:  rint(x / scale)                 (round half to even, as
//          jnp.round and torch.round),
//   int8 stochastic: clip(floor(x / scale + u), -128, 127), u in [0, 1)
//          from the low 23 bits of Philox4x32-10 keyed by the seed at
//          counter (column, row) (the TPU kernel draws from its on-chip
//          PRNG, seeded with seed + block; no bit parity is possible),
//   fp8:   x / scale rounded to nearest even, saturated to +-448.
// The divisions are true IEEE divisions (__fdiv_rn, no fast math), so the
// values and scales equal tpukern/ops/quant.py's quantize_ref and
// quantize_fp8_ref bit for bit. |x / scale| is at most 127 (448) up to one
// ulp, which rounds back, so saturation never differs from a plain cast.
//
// What bounds them: each reads a row once and writes 1 byte a value and 4
// bytes a row (dequantize: reads 1, writes 2 or 4), so they are bound by
// memory bandwidth; at the serving shapes (32 to 4096 rows of 128) the
// launch takes longer than the bytes.
#include <cuda_fp8.h>

#include "common.cuh"

namespace tk {
namespace {

constexpr int Q_THREADS = 256;
constexpr int Q_ROWS = Q_THREADS / 32;  // rows per block, one warp each

enum QuantMode { kRoundInt8 = 0, kStochasticInt8 = 1, kFp8 = 2 };

template <typename T>
__device__ __forceinline__ float row_absmax(const T* x, int K, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  float m = 0.f;
  if (vec) {
    for (int c = lane * VEC; c < K; c += 32 * VEC) {
      const uint4 u = *reinterpret_cast<const uint4*>(x + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) m = fmaxf(m, fabsf(to_f32(e[i])));
    }
  } else {
    for (int c = lane; c < K; c += 32) m = fmaxf(m, fabsf(to_f32(x[c])));
  }
  return warp_max(m);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(Q_THREADS)
quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ values,
                float* __restrict__ scales, int64_t S, int K, bool vec,
                uint32_t k0, uint32_t k1) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t row = (int64_t)blockIdx.x * Q_ROWS + (threadIdx.x >> 5);
  if (row >= S) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * K;
  uint8_t* out = values + row * K;
  const float absmax = row_absmax(xr, K, vec);
  const float scale =
      absmax == 0.f ? 1.f : __fdiv_rn(absmax, MODE == kFp8 ? 448.f : 127.f);
  if (lane == 0) scales[row] = scale;

  auto convert = [&](float xv, int c) -> uint8_t {
    const float v = __fdiv_rn(xv, scale);
    if constexpr (MODE == kFp8) {
      return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
    } else if constexpr (MODE == kStochasticInt8) {
      const uint32_t bits = philox_word0(c, (uint32_t)row, k0, k1);
      const float u = (float)(bits & 0x7FFFFFu) * (1.f / 8388608.f);
      const float f = fminf(fmaxf(floorf(__fadd_rn(v, u)), -128.f), 127.f);
      return (uint8_t)(int8_t)f;
    } else {
      return (uint8_t)(int8_t)__float2int_rn(v);
    }
  };

  if (vec) {
    for (int c = lane * VEC; c < K; c += 32 * VEC) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&u);
      union { uint8_t b[VEC]; uint32_t w[VEC / 4]; } o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.b[i] = convert(to_f32(e[i]), c + i);
      if constexpr (VEC == 4)
        *reinterpret_cast<uint32_t*>(out + c) = o.w[0];
      else
        *reinterpret_cast<uint2*>(out + c) = make_uint2(o.w[0], o.w[1]);
    }
  } else {
    for (int c = lane; c < K; c += 32) out[c] = convert(to_f32(xr[c]), c);
  }
}

// out = values * scale per row, in out's dtype; 16 values a lane at a time
// where K and the bases allow 16-byte loads
template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
dequantize_kernel(const int8_t* __restrict__ values,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int64_t S, int K, bool vec) {
  const int64_t row = (int64_t)blockIdx.x * Q_ROWS + (threadIdx.x >> 5);
  if (row >= S) return;
  const int lane = threadIdx.x & 31;
  const float s = scales[row];
  const int8_t* vr = values + row * K;
  T* orow = out + row * K;
  if (vec) {
    for (int c = lane * 16; c < K; c += 32 * 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(vr + c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&u);
      float f[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) f[i] = __fmul_rn((float)e[i], s);
      uint4* dst = reinterpret_cast<uint4*>(orow + c);
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[i] = make_uint4(__float_as_uint(f[4 * i]), __float_as_uint(f[4 * i + 1]),
                              __float_as_uint(f[4 * i + 2]), __float_as_uint(f[4 * i + 3]));
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          dst[i] = make_uint4(pack_f32(f[8 * i], f[8 * i + 1]),
                              pack_f32(f[8 * i + 2], f[8 * i + 3]),
                              pack_f32(f[8 * i + 4], f[8 * i + 5]),
                              pack_f32(f[8 * i + 6], f[8 * i + 7]));
      }
    }
  } else {
    for (int c = lane; c < K; c += 32)
      orow[c] = from_f32<T>(__fmul_rn((float)vr[c], s));
  }
}

template <typename T>
void launch_quantize(const void* x, void* values, float* scales, int64_t S,
                     int K, int mode, uint64_t seed, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = K % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  const dim3 grid((unsigned)((S + Q_ROWS - 1) / Q_ROWS));
  const auto* xt = static_cast<const T*>(x);
  auto* v = static_cast<uint8_t*>(values);
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  if (mode == kFp8)
    quantize_kernel<T, kFp8><<<grid, Q_THREADS, 0, stream>>>(xt, v, scales, S, K, vec, k0, k1);
  else if (mode == kStochasticInt8)
    quantize_kernel<T, kStochasticInt8><<<grid, Q_THREADS, 0, stream>>>(xt, v, scales, S, K, vec, k0, k1);
  else
    quantize_kernel<T, kRoundInt8><<<grid, Q_THREADS, 0, stream>>>(xt, v, scales, S, K, vec, k0, k1);
}

template <typename T>
void launch_dequantize(const int8_t* values, const float* scales, void* out,
                       int64_t S, int K, cudaStream_t stream) {
  const bool vec = K % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(values) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const dim3 grid((unsigned)((S + Q_ROWS - 1) / Q_ROWS));
  dequantize_kernel<T><<<grid, Q_THREADS, 0, stream>>>(
      values, scales, static_cast<T*>(out), S, K, vec);
}

}  // namespace

cudaError_t quantize_launch(const void* x, void* values, float* scales,
                            int64_t S, int K, int mode, long long seed,
                            int dtype, cudaStream_t stream) {
  if (S < 0 || K <= 0 || mode < kRoundInt8 || mode > kFp8 ||
      (S + Q_ROWS - 1) / Q_ROWS > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  if (dtype == kBF16)
    launch_quantize<bf16>(x, values, scales, S, K, mode, (uint64_t)seed, stream);
  else
    launch_quantize<float>(x, values, scales, S, K, mode, (uint64_t)seed, stream);
  return cudaSuccess;
}

cudaError_t dequantize_launch(const void* values, const float* scales,
                              void* out, int64_t S, int K, int dtype,
                              cudaStream_t stream) {
  if (S < 0 || K <= 0 || (S + Q_ROWS - 1) / Q_ROWS > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const auto* v = static_cast<const int8_t*>(values);
  if (dtype == kBF16)
    launch_dequantize<bf16>(v, scales, out, S, K, stream);
  else
    launch_dequantize<float>(v, scales, out, S, K, stream);
  return cudaSuccess;
}

}  // namespace tk
