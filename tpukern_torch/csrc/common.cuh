// Shared device helpers and the host launchers each kernel file defines.
// capi.cu wraps the launchers in the C interface that ctypes loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tk {

// dtype codes: tpukern_torch/_build.py DTYPE_CODES
enum Dtype { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

// mask value of tpukern/ops/attention.py NEG_BIG: finite, so a fully
// masked tile never forms exp(-inf - -inf) = NaN
constexpr float NEG_BIG = -0.7f * 3.4e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Host launchers. Each checks its arguments, returns cudaErrorInvalidValue
// for a shape or dtype it does not take, and otherwise launches on
// `stream` and returns cudaSuccess; capi.cu then reports cudaGetLastError().
cudaError_t rms_norm_launch(const void* x, const void* g, void* y, int64_t rows,
                            int64_t cols, float eps, int x_dtype, int g_dtype,
                            cudaStream_t stream);
cudaError_t rope_cached_launch(const void* x, const void* cos, const void* sin,
                               void* y, int64_t rows, int head_dim, int dtype,
                               cudaStream_t stream);
cudaError_t rope_batched_launch(const void* x, void* y, int64_t rows,
                                int head_dim, int seq_len, float sign,
                                int dtype, cudaStream_t stream);
cudaError_t flash_attention_launch(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int Hq, int Hkv,
                                   int Sq, int Skv, int D, float sm_scale,
                                   int causal, int dtype, cudaStream_t stream);
cudaError_t flash_attention_bwd_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* di,
                                       float* dq, void* dk, void* dv, int B,
                                       int H, int Sq, int Skv, int D,
                                       float sm_scale, int causal, int dtype,
                                       cudaStream_t stream);
cudaError_t matmul_launch(const void* a, const void* b, void* c32, void* c16,
                          int M, int N, int K, int trans_b, int dtype,
                          cudaStream_t stream);
cudaError_t paged_attention_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const int* lengths,
                                   const int* page_table, void* o, int B, int Hq,
                                   int Hkv, int P, int page_size,
                                   int pages_per_seq, int D, float sm_scale,
                                   int dtype, cudaStream_t stream);

}  // namespace tk
