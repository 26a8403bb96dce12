// Elementwise ops over a flat array: y = op(x0) or op(x0, x1 or s), each
// element computed in f32 and rounded once to the storage dtype.
//
// Replaces tpukern/ops/_ew.py:57 `kernel` (ew_call): one template for the
// nine ops of the elementwise and activation families and the two steps
// of softmax_global, taken from a fixed table (EwOp, the order of
// tpukern_torch/ops/_ew.py OPS) instead of a traced closure. The formulas
// are tpukern/ops/activations.py:23-57's: elu is exp(x) - 1 (not expm1),
// gelu the tanh form, hardshrink at 0.5; and tpukern/ops/softmax.py:201,
// 205's: exp_sub is exp(a - s), div the true division a / s (never a
// multiply by 1 / s); all in f32 with the accurate expf/tanhf (this file
// is built without --use_fast_math). For add, mul and relu the f32 result
// rounded once is the correctly rounded bf16 result, so the bf16 tiers
// equal JAX's bf16 arithmetic bit for bit; the transcendental ops may
// differ by an ulp.
//
// A binary op's second operand is an array x1 of x0's shape, or one f32
// scalar s read from device memory by every thread (the traced scalars of
// tpukern/ops/softmax.py softmax_global), so a caller never reads it back
// on the host.
//
// The TPU's variant axis, the block height in sublanes, becomes VEC: the
// elements one thread loads and stores at once (the reference's f32 /
// f32x4 / f16 / f16x2 / f16x8_pack ladder): f32 1, 2, 4 and bf16 1, 2, 8,
// the widest on 128-bit loads and stores. The wrapper hands 16-byte
// aligned arrays.
//
// Bound by memory bandwidth: each input element is read once and each
// output written once; the f32 math is a few instructions a byte. Holding
// 3.35 TB/s across a load latency near 0.7 us needs about 18 KiB in
// flight an SM, so a thread keeps several packs in flight: it owns U
// packs of its tier, EW_THREADS * VEC elements apart inside its block's
// span of EW_THREADS * VEC * U elements (each warp instruction still
// covers one contiguous segment), issues the U loads of every operand
// before its first operation, then its U stores. U is 16 bytes over the
// pack's bytes (8 at bf16 x1, 4 at f32 x1 and bf16 x2, 2 at f32 x2, 1 at
// the 16-byte tiers), and the grid is one block a span. In the last span
// the packs that pass n are skipped and the thread whose pack straddles n
// does the tail element by element. ops/_ew.py ew_plan mirrors this map.
#include "common.cuh"

namespace tk {
namespace {

enum EwOp { kAdd = 0, kMul, kRelu, kElu, kGelu, kSigmoid, kSwish, kHardswish,
            kHardshrink, kExpSub, kDiv, kNumOps };

constexpr int EW_THREADS = 256;
// sqrt(2 / pi) rounded to f32, as JAX's weak-typed Python float is
constexpr float kSqrt2OverPi = 0.7978845608028654f;

__device__ __forceinline__ float sigmoid(float a) {
  return 1.f / (1.f + expf(-a));
}

template <int OP>
__device__ __forceinline__ float ew_apply(float a, float b) {
  if constexpr (OP == kAdd) return a + b;
  if constexpr (OP == kMul) return a * b;
  if constexpr (OP == kRelu) return a < 0.f ? 0.f : a;
  if constexpr (OP == kElu) return a > 0.f ? a : expf(a) - 1.f;
  if constexpr (OP == kGelu) {
    const float inner = kSqrt2OverPi * (a + 0.044715f * a * a * a);
    return 0.5f * a * (1.f + tanhf(inner));
  }
  if constexpr (OP == kSigmoid) return sigmoid(a);
  if constexpr (OP == kSwish) return a * sigmoid(a);
  if constexpr (OP == kHardswish) return a * fminf(fmaxf(a + 3.f, 0.f), 6.f) / 6.f;
  if constexpr (OP == kHardshrink) return (a > 0.5f || a < -0.5f) ? a : 0.f;
  if constexpr (OP == kExpSub) return expf(a - b);
  if constexpr (OP == kDiv) return __fdiv_rn(a, b);
  return 0.f;
}

__host__ __device__ constexpr bool binary(int op) {
  return op == kAdd || op == kMul || op == kExpSub || op == kDiv;
}

template <typename T, int VEC, int OP>
__device__ __forceinline__ Pack<T, VEC> ew_pack(const Pack<T, VEC>& a,
                                                const Pack<T, VEC>& b,
                                                bool two, float sv) {
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o.v[j] = from_f32<T>(ew_apply<OP>(to_f32(a.v[j]),
                                      two ? to_f32(b.v[j]) : sv));
  return o;
}

template <typename T, int VEC, int U, int OP>
__global__ void __launch_bounds__(EW_THREADS)
ew_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
          const float* __restrict__ s, T* __restrict__ y, int64_t n) {
  using P = Pack<T, VEC>;
  constexpr int64_t STEP = (int64_t)EW_THREADS * VEC;  // a thread's packs apart
  constexpr int64_t SPAN = STEP * U;
  const bool two = binary(OP) && x1 != nullptr;
  const float sv = binary(OP) && !x1 ? *s : 0.f;
  const int64_t b = blockIdx.x;
  const int64_t i0 = b * SPAN + (int64_t)threadIdx.x * VEC;
  if ((b + 1) * SPAN <= n) {
    P a[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      a[u] = *reinterpret_cast<const P*>(x0 + i0 + u * STEP);
    if (two) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        c[u] = *reinterpret_cast<const P*>(x1 + i0 + u * STEP);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      *reinterpret_cast<P*>(y + i0 + u * STEP) =
          ew_pack<T, VEC, OP>(a[u], c[u], two, sv);
  } else {
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u * STEP;
      if (i + VEC <= n) {
        const P a = *reinterpret_cast<const P*>(x0 + i);
        P c;
        if (two) c = *reinterpret_cast<const P*>(x1 + i);
        *reinterpret_cast<P*>(y + i) = ew_pack<T, VEC, OP>(a, c, two, sv);
      } else {
        for (int64_t k = i; k < n; ++k)
          y[k] = from_f32<T>(ew_apply<OP>(
              to_f32(x0[k]), two ? to_f32(x1[k]) : sv));
      }
    }
  }
}

template <typename T, int VEC, int OP>
void go(const void* x0, const void* x1, const float* s, void* y, int64_t n,
        cudaStream_t stream) {
  // the packs a thread keeps in flight: 16 bytes of each operand
  constexpr int U = 16 / (VEC * (int)sizeof(T)) > 1
                        ? 16 / (VEC * (int)sizeof(T)) : 1;
  constexpr int64_t span = (int64_t)EW_THREADS * VEC * U;
  ew_kernel<T, VEC, U, OP><<<(unsigned)((n + span - 1) / span), EW_THREADS,
                             0, stream>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x1), s,
      static_cast<T*>(y), n);
}

template <typename T, int VEC>
void dispatch_op(int op, const void* x0, const void* x1, const float* s,
                 void* y, int64_t n, cudaStream_t stream) {
#define TK_EW_OP(code)                                                     \
  case code:                                                               \
    go<T, VEC, code>(x0, x1, s, y, n, stream);                             \
    break;
  switch (op) {
    TK_EW_OP(kAdd) TK_EW_OP(kMul) TK_EW_OP(kRelu) TK_EW_OP(kElu)
    TK_EW_OP(kGelu) TK_EW_OP(kSigmoid) TK_EW_OP(kSwish) TK_EW_OP(kHardswish)
    TK_EW_OP(kExpSub) TK_EW_OP(kDiv)
    default: go<T, VEC, kHardshrink>(x0, x1, s, y, n, stream);
  }
#undef TK_EW_OP
}

}  // namespace

cudaError_t ew_launch(int op, const void* x0, const void* x1, const float* s,
                      void* y, int64_t n, int vec, int dtype,
                      cudaStream_t stream) {
  // a binary op takes x1 or s (not both); a unary op neither
  if (op < 0 || op >= kNumOps || n < 0 || vec <= 0 || !x0 || !y ||
      (binary(op) ? (x1 == nullptr) == (s == nullptr) : (x1 || s)))
    return cudaErrorInvalidValue;
  const int size = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
  if (!size) return cudaErrorInvalidValue;
  // the packs need their width's alignment on every array
  const uintptr_t bytes = (uintptr_t)vec * size;
  if (((uintptr_t)x0 | (uintptr_t)x1 | (uintptr_t)y) % bytes)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  // a grid of one block a span (at least one element a thread)
  if ((n + EW_THREADS - 1) / EW_THREADS > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (dtype == kF32) {
    if (vec == 1) dispatch_op<float, 1>(op, x0, x1, s, y, n, stream);
    else if (vec == 2) dispatch_op<float, 2>(op, x0, x1, s, y, n, stream);
    else if (vec == 4) dispatch_op<float, 4>(op, x0, x1, s, y, n, stream);
    else return cudaErrorInvalidValue;
  } else {
    if (vec == 1) dispatch_op<bf16, 1>(op, x0, x1, s, y, n, stream);
    else if (vec == 2) dispatch_op<bf16, 2>(op, x0, x1, s, y, n, stream);
    else if (vec == 8) dispatch_op<bf16, 8>(op, x0, x1, s, y, n, stream);
    else return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
