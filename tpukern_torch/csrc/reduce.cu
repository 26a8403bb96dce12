// Whole-array reductions in two passes: the sum or max of every element
// (#31) and the dot product sum(a * b) (#32), each into one 0-d value on
// the device.
//
// Replaces tpukern/ops/reduce.py:68 `kernel` (_reduce_all) and
// tpukern/ops/dot_product.py:27 `kernel` (dot_prod). The TPU kernels walk
// row blocks in order on one core and carry (1, 128) lane accumulators
// from step to step in VMEM scratch. Blocks here run in parallel and in no
// order, so pass 1 gives each of G blocks a grid-stride share of the array
// and reduces it to one partial (a thread's own loop, then warp shuffles,
// then the block's warps through shared memory), and pass 2 reduces the G
// partials in one block. Every combine happens in a fixed order, so a call
// repeats bit for bit (no float atomics), and max needs no atomic trick.
// G depends on n and the input's width alone, not on the card.
//
// The accumulator follows tpukern/core/config.py:24-45's dtype policy:
// f16 and fp8 are storage-only, so those inputs, and an f16 accumulator,
// sum in f32 and round once at the end; a bf16 accumulator is a real bf16
// one (every add, in the thread's loop and in both trees, rounds to
// bf16); i8 sums and maxes exactly in int32; a max of floats is exact in
// f32 whatever the result's type. The dot product multiplies and sums in
// f32.
//
// Bound by memory bandwidth: every element is read once, 16 bytes a
// thread a load (4 f32, 8 bf16 or f16, 16 i8 or fp8), and one value
// written; G blocks of 256 threads are about one wave on an H100.
#include <climits>

#include "common.cuh"

namespace tk {
namespace {

enum RedMode { kSum = 0, kMax = 1, kDot = 2 };
enum AccKind { kAccF32 = 0, kAccBF16 = 1, kAccI32 = 2 };

constexpr int RED_THREADS = 256;
// the most partials pass 1 writes: tpukern_torch/ops/reduce.py PARTIALS
constexpr int MAX_PARTIALS = 1024;

template <int ACC> struct AccT { using T = float; };
template <> struct AccT<kAccI32> { using T = int; };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int ACC, int MODE>
__device__ __forceinline__ typename AccT<ACC>::T identity() {
  if constexpr (MODE == kMax) {
    if constexpr (ACC == kAccI32) return INT_MIN;
    else return -INFINITY;
  } else {
    return 0;
  }
}

template <int ACC, int MODE>
__device__ __forceinline__ typename AccT<ACC>::T combine(
    typename AccT<ACC>::T a, typename AccT<ACC>::T b) {
  if constexpr (MODE == kMax) {
    if constexpr (ACC == kAccI32) return a > b ? a : b;
    else return (a != a || a > b) ? a : b;  // a NaN wins, as in jnp.max
  } else if constexpr (ACC == kAccBF16) {
    // the f32 sum of two bf16 values rounded once is their correctly
    // rounded bf16 sum (24 >= 2 * 8 + 2 bits)
    return round_bf16(a + b);
  } else {
    return a + b;
  }
}

// one input element in the accumulator's domain
template <int ACC, typename In>
__device__ __forceinline__ typename AccT<ACC>::T value(In x) {
  if constexpr (ACC == kAccI32) return static_cast<int>(x);
  else if constexpr (ACC == kAccBF16) return round_bf16(to_f32(x));
  else return to_f32(x);
}

// the block's combined value, valid in thread 0
template <int ACC, int MODE>
__device__ typename AccT<ACC>::T block_reduce(typename AccT<ACC>::T v) {
  using T = typename AccT<ACC>::T;
  __shared__ T red[RED_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = combine<ACC, MODE>(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < RED_THREADS / 32 ? red[lane] : identity<ACC, MODE>();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = combine<ACC, MODE>(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

template <typename In, int ACC, int MODE>
__global__ void __launch_bounds__(RED_THREADS)
reduce_pass1(const In* __restrict__ x, const In* __restrict__ y, int64_t n,
             typename AccT<ACC>::T* __restrict__ partials) {
  constexpr int VEC = 16 / sizeof(In);
  auto acc = identity<ACC, MODE>();
  const int64_t stride = (int64_t)gridDim.x * RED_THREADS;
  const int64_t first = (int64_t)blockIdx.x * RED_THREADS + threadIdx.x;
  const int64_t nvec = n / VEC;
  for (int64_t i = first; i < nvec; i += stride) {
    const Pack<In, VEC> a = reinterpret_cast<const Pack<In, VEC>*>(x)[i];
    if constexpr (MODE == kDot) {
      const Pack<In, VEC> b = reinterpret_cast<const Pack<In, VEC>*>(y)[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc = combine<ACC, MODE>(acc, to_f32(a.v[j]) * to_f32(b.v[j]));
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc = combine<ACC, MODE>(acc, value<ACC>(a.v[j]));
    }
  }
  // the tail past the last whole pack
  for (int64_t i = nvec * VEC + first; i < n; i += stride) {
    if constexpr (MODE == kDot)
      acc = combine<ACC, MODE>(acc, to_f32(x[i]) * to_f32(y[i]));
    else
      acc = combine<ACC, MODE>(acc, value<ACC>(x[i]));
  }
  acc = block_reduce<ACC, MODE>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <int ACC, int MODE>
__global__ void __launch_bounds__(RED_THREADS)
reduce_pass2(const typename AccT<ACC>::T* __restrict__ partials, int g,
             void* __restrict__ out, int out_dtype) {
  auto acc = identity<ACC, MODE>();
  for (int i = threadIdx.x; i < g; i += RED_THREADS)
    acc = combine<ACC, MODE>(acc, partials[i]);
  acc = block_reduce<ACC, MODE>(acc);
  if (threadIdx.x != 0) return;
  if constexpr (ACC == kAccI32) {
    *static_cast<int*>(out) = acc;
  } else if (out_dtype == kBF16) {
    *static_cast<bf16*>(out) = __float2bfloat16(acc);
  } else if (out_dtype == kF16) {
    *static_cast<f16*>(out) = __float2half_rn(acc);
  } else {
    *static_cast<float*>(out) = acc;
  }
}

template <typename In, int ACC, int MODE>
void run(const void* x, const void* y, void* partials, void* out, int64_t n,
         int out_dtype, cudaStream_t stream) {
  using T = typename AccT<ACC>::T;
  constexpr int64_t per_block = (int64_t)RED_THREADS * (16 / sizeof(In)) * 8;
  int64_t g = (n + per_block - 1) / per_block;
  g = g < 1 ? 1 : g > MAX_PARTIALS ? MAX_PARTIALS : g;
  T* part = static_cast<T*>(partials);
  reduce_pass1<In, ACC, MODE><<<(unsigned)g, RED_THREADS, 0, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(y), n, part);
  reduce_pass2<ACC, MODE><<<1, RED_THREADS, 0, stream>>>(part, (int)g, out,
                                                         out_dtype);
}

template <int ACC, int MODE>
bool run_float(int in_dtype, const void* x, const void* y, void* partials,
               void* out, int64_t n, int out_dtype, cudaStream_t stream) {
  if (in_dtype == kF32)
    run<float, ACC, MODE>(x, y, partials, out, n, out_dtype, stream);
  else if (in_dtype == kBF16)
    run<bf16, ACC, MODE>(x, y, partials, out, n, out_dtype, stream);
  else if (in_dtype == kF16)
    run<f16, ACC, MODE>(x, y, partials, out, n, out_dtype, stream);
  else if constexpr (MODE == kDot)
    return false;  // the dot product takes f32, bf16 and f16
  else if (in_dtype == kE4M3)
    run<e4m3, ACC, MODE>(x, y, partials, out, n, out_dtype, stream);
  else if (in_dtype == kE5M2)
    run<e5m2, ACC, MODE>(x, y, partials, out, n, out_dtype, stream);
  else
    return false;
  return true;
}

}  // namespace

// mode: 0 sum, 1 max, 2 dot (y the second input); acc_dtype is the
// result's dtype: f32, f16 (an f32 sum rounded once), bf16 (a bf16
// accumulator for a sum, an exact max rounded once) or i32 (i8 inputs).
// partials holds MAX_PARTIALS 4-byte words.
cudaError_t reduce_launch(const void* x, const void* y, void* partials,
                          void* out, int64_t n, int mode, int in_dtype,
                          int acc_dtype, cudaStream_t stream) {
  if (n < 0 || !x || !partials || !out || (mode == kDot) != (y != nullptr) ||
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)partials) % 16)
    return cudaErrorInvalidValue;
  const bool ints = in_dtype == kI8;
  if (ints != (acc_dtype == kI32)) return cudaErrorInvalidValue;
  bool ok;
  if (ints) {
    ok = mode == kSum || mode == kMax;
    if (mode == kSum)
      run<int8_t, kAccI32, kSum>(x, y, partials, out, n, kI32, stream);
    else if (mode == kMax)
      run<int8_t, kAccI32, kMax>(x, y, partials, out, n, kI32, stream);
  } else if (acc_dtype != kF32 && acc_dtype != kF16 && acc_dtype != kBF16) {
    ok = false;
  } else if (mode == kSum) {
    ok = acc_dtype == kBF16
             ? run_float<kAccBF16, kSum>(in_dtype, x, y, partials, out, n,
                                         acc_dtype, stream)
             : run_float<kAccF32, kSum>(in_dtype, x, y, partials, out, n,
                                        acc_dtype, stream);
  } else if (mode == kMax) {
    ok = run_float<kAccF32, kMax>(in_dtype, x, y, partials, out, n, acc_dtype,
                                  stream);
  } else if (mode == kDot) {
    ok = acc_dtype == kF32 &&
         run_float<kAccF32, kDot>(in_dtype, x, y, partials, out, n, acc_dtype,
                                  stream);
  } else {
    ok = false;
  }
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tk
