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
//
// write_kv_quant_kernel is #20 (round to nearest) or #22 as the serving
// path runs them: one launch a layer quantizes the step's new K and V
// tokens and stores them into the paged pools (unfused, the write takes a
// quantize_kernel launch for K and one for V, then four index_put
// scatters of values and scales, and their host ops). A group of D / 16
// lanes (8 at D 128; a whole warp for other widths) owns a (tensor, b, h,
// t) row: it reads the token new[b, h, src[b, t]] through the tensor's
// strides (V is a transposed view of the projection; no copy), each lane
// 16 values into registers, reduces |x| with shuffles, computes the scale
// and the values as quantize_kernel does (quant_round: the same divisions
// and roundings, so the bytes are those of quantize_ref /
// quantize_fp8_ref), and stores its 16 bytes straight into pages[h, phys,
// row], the group's first lane the scale into scales[h, phys, row].
// (phys, row, src) are the step's slots (models/serving.py _slots): rows
// that share a slot carry the same src, so they store the same bytes. A
// block holds 1-8 warps, fewer while the blocks would not fill every SM
// once (a decode step's 2 x 32 rows take 16 blocks of one warp, a
// 512-token prefill's 2 x 16384 take 1024 of 8). A decode step's layer
// moves 16 KiB of bf16 in and 8.3 KiB out, nanoseconds of HBM: latency
// sets its time (4.1 µs on an H100, #20 alone on half the rows 1.7).
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

// x / scale as one int8 (round half to even) or e4m3 (saturating) byte:
// the rounding of #20 and #22, shared by both of their kernels
template <int MODE>
__device__ __forceinline__ uint8_t quant_round(float xv, float scale) {
  const float v = __fdiv_rn(xv, scale);
  if constexpr (MODE == kFp8)
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  else
    return (uint8_t)(int8_t)__float2int_rn(v);
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
    if constexpr (MODE == kStochasticInt8) {
      const float v = __fdiv_rn(xv, scale);
      const uint32_t bits = philox_word0(c, (uint32_t)row, k0, k1);
      const float u = (float)(bits & 0x7FFFFFu) * (1.f / 8388608.f);
      const float f = fminf(fmaxf(floorf(__fadd_rn(v, u)), -128.f), 127.f);
      return (uint8_t)(int8_t)f;
    } else {
      return quant_round<MODE>(xv, scale);
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

// the fused K/V write's operands: the two tensors (0 K, 1 V) of (B, H, T,
// D) new tokens with their element strides of b, h and t (D's is 1), the
// step's slots (B, T) (src null: token t), and the layer's pools (H, P,
// page, D) bytes and (H, P, page) f32 scales
struct WriteKV {
  const void* x[2];
  int64_t stride[2][3];
  const int64_t* phys;
  const int64_t* row;
  const int64_t* src;
  uint8_t* pages[2];
  float* scales[2];
  int B, H, T, D, P, page;
};

constexpr int WQ_LANE = 16;  // values a lane converts at a time: 16 bytes out

// 16 values of T from p (16-byte aligned) as f32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&f)[WQ_LANE]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < WQ_LANE; j += VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + j);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[j + i] = to_f32(e[i]);
  }
}

// A group of G lanes a (tensor, b, h, t) row (blockIdx.y: 0 K, 1 V; i in
// [0, B H T) row-major over (b, h, t)), 32 / G rows a warp. vec (16-byte
// loads and stores) with D = 16 G, G a power of two up to 32: each lane
// holds its 16 values in registers between the row's max and the
// conversion. Else (G = 32) the warp walks the row 16 values (or, without
// vec, one value) a lane at a time and reads it twice.
template <typename T, int MODE>
__global__ void __launch_bounds__(Q_THREADS)
write_kv_quant_kernel(const WriteKV a, int rows, int G, bool vec) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / G;
  const int i = ((int)blockIdx.x * (int)(blockDim.x >> 5) +
                 (int)(threadIdx.x >> 5)) * per_warp + lane / G;
  const int gl = lane % G;  // the lane's place in its group
  const bool live = i < rows;
  const int which = blockIdx.y;
  const int t = live ? i % a.T : 0;
  const int h = live ? (i / a.T) % a.H : 0;
  const int b = live ? i / (a.T * a.H) : 0;
  const int bt = b * a.T + t;
  const int64_t ts = live && a.src ? a.src[bt] : t;
  // the tensor's operands by selects (a dynamic index into the parameter
  // block would copy it to local memory)
  const int64_t sb = which ? a.stride[1][0] : a.stride[0][0];
  const int64_t sh = which ? a.stride[1][1] : a.stride[0][1];
  const int64_t stt = which ? a.stride[1][2] : a.stride[0][2];
  const T* x = static_cast<const T*>(which ? a.x[1] : a.x[0]) + b * sb +
               h * sh + ts * stt;
  const int64_t slot =
      live ? ((int64_t)h * a.P + a.phys[bt]) * a.page + a.row[bt] : 0;
  uint8_t* out = (which ? a.pages[1] : a.pages[0]) + slot * a.D;
  float* scales = which ? a.scales[1] : a.scales[0];
  const int D = a.D;
  constexpr float QMAX = MODE == kFp8 ? 448.f : 127.f;

  if (vec && G * WQ_LANE == D) {
    float f[WQ_LANE];
    float m = 0.f;
    if (live) {
      load16(x + gl * WQ_LANE, f);
#pragma unroll
      for (int j = 0; j < WQ_LANE; ++j) m = fmaxf(m, fabsf(f[j]));
    }
    for (int o = G >> 1; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float scale = m == 0.f ? 1.f : __fdiv_rn(m, QMAX);
    if (!live) return;
    if (gl == 0) scales[slot] = scale;
    union { uint8_t b[WQ_LANE]; uint4 u; } o;
#pragma unroll
    for (int j = 0; j < WQ_LANE; ++j) o.b[j] = quant_round<MODE>(f[j], scale);
    *reinterpret_cast<uint4*>(out + gl * WQ_LANE) = o.u;
    return;
  }
  // a warp a row (G = 32, one row a warp: every lane shares live)
  float m = 0.f;
  if (live) {
    if (vec) {
      for (int c = lane * WQ_LANE; c < D; c += 32 * WQ_LANE) {
        float f[WQ_LANE];
        load16(x + c, f);
#pragma unroll
        for (int j = 0; j < WQ_LANE; ++j) m = fmaxf(m, fabsf(f[j]));
      }
    } else {
      for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(to_f32(x[c])));
    }
  }
  m = warp_max(m);
  const float scale = m == 0.f ? 1.f : __fdiv_rn(m, QMAX);
  if (!live) return;
  if (lane == 0) scales[slot] = scale;
  if (vec) {
    for (int c = lane * WQ_LANE; c < D; c += 32 * WQ_LANE) {
      float f[WQ_LANE];
      load16(x + c, f);
      union { uint8_t b[WQ_LANE]; uint4 u; } o;
#pragma unroll
      for (int j = 0; j < WQ_LANE; ++j) o.b[j] = quant_round<MODE>(f[j], scale);
      *reinterpret_cast<uint4*>(out + c) = o.u;
    }
  } else {
    for (int c = lane; c < D; c += 32)
      out[c] = quant_round<MODE>(to_f32(x[c]), scale);
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

template <typename T>
void launch_write_kv(const WriteKV& a, int mode, cudaStream_t stream) {
  static int sms = 0;  // the current device's SMs, read once
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  constexpr int VEC = 16 / sizeof(T);
  bool vec = a.D % WQ_LANE == 0;
  for (int w = 0; w < 2; ++w) {
    vec &= reinterpret_cast<uintptr_t>(a.x[w]) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(a.pages[w]) % 16 == 0;
    for (int d = 0; d < 3; ++d) vec &= a.stride[w][d] % VEC == 0;
  }
  // lanes a row: D / 16 where that is a power of two up to 32, else 32
  int G = 32;
  if (vec && a.D <= 32 * WQ_LANE) {
    const int g = a.D / WQ_LANE;
    if ((g & (g - 1)) == 0) G = g;
  }
  const int rows = a.B * a.H * a.T;
  const int per_warp = 32 / G;
  int warps = Q_ROWS;  // halved while the blocks would not fill every SM
  auto blocks = [&](int w) {
    return (rows + (int64_t)w * per_warp - 1) / ((int64_t)w * per_warp);
  };
  while (warps > 1 && 2 * blocks(warps) < sms) warps >>= 1;
  const dim3 grid((unsigned)blocks(warps), 2);
  if (mode == kFp8)
    write_kv_quant_kernel<T, kFp8><<<grid, warps * 32, 0, stream>>>(
        a, rows, G, vec);
  else
    write_kv_quant_kernel<T, kRoundInt8><<<grid, warps * 32, 0, stream>>>(
        a, rows, G, vec);
}

}  // namespace

cudaError_t write_kv_quantized_launch(
    const void* k, const void* v, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* phys, const int64_t* row,
    const int64_t* src, void* k_pages, float* k_scales, void* v_pages,
    float* v_scales, int B, int H, int T, int D, int P, int page, int mode,
    int dtype, cudaStream_t stream) {
  if (!k || !v || !k_strides || !v_strides || !phys || !row || !k_pages ||
      !k_scales || !v_pages || !v_scales || B < 0 || H <= 0 || T < 0 ||
      D <= 0 || P <= 0 || page <= 0 || (mode != kRoundInt8 && mode != kFp8) ||
      (dtype != kBF16 && dtype != kF32) ||
      (int64_t)B * H * T > 0x7FFFFFFFLL || (int64_t)B * T > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  WriteKV a;
  a.x[0] = k;
  a.x[1] = v;
  for (int d = 0; d < 3; ++d) {
    a.stride[0][d] = k_strides[d];
    a.stride[1][d] = v_strides[d];
  }
  a.phys = phys;
  a.row = row;
  a.src = src;
  a.pages[0] = static_cast<uint8_t*>(k_pages);
  a.pages[1] = static_cast<uint8_t*>(v_pages);
  a.scales[0] = k_scales;
  a.scales[1] = v_scales;
  a.B = B;
  a.H = H;
  a.T = T;
  a.D = D;
  a.P = P;
  a.page = page;
  if (dtype == kBF16)
    launch_write_kv<bf16>(a, mode, stream);
  else
    launch_write_kv<float>(a, mode, stream);
  return cudaSuccess;
}

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
