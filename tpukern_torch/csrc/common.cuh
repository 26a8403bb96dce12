// Shared device helpers and the host launchers each kernel file defines.
// capi.cu wraps the launchers in the C interface that ctypes loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tk {

// dtype codes: tpukern_torch/_build.py DTYPE_CODES (the float types of
// activations), KV_CODES (the 1-byte pools of the quantized tier) and
// CODES (all of them, with the storage types of the op-family zoo)
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3, kF16 = 4, kE5M2 = 5,
             kI32 = 6 };

using bf16 = __nv_bfloat16;
using f16 = __half;
using e4m3 = __nv_fp8_e4m3;
using e5m2 = __nv_fp8_e5m2;

// mask value of tpukern/ops/attention.py NEG_BIG: finite, so a fully
// masked tile never forms exp(-inf - -inf) = NaN
constexpr float NEG_BIG = -0.7f * 3.4e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(e5m2 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half_rn(x);
}

// VEC elements of T in one aligned load or store (16 bytes at most)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

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

// The block's fold of every thread's pair (a, b), in every thread: each
// warp folds its lanes by warp_fold(a, b), lane 0 posts the warp's pair
// to red (64 floats of shared memory), then every warp folds the posted
// pairs by the same tree, lanes past the last warp taking the fold's
// identity (a0, b0), so every thread holds the same pair bit for bit.
template <typename F>
__device__ __forceinline__ void block_fold2(float& a, float& b, float a0,
                                            float b0, float* red,
                                            F&& warp_fold) {
  warp_fold(a, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the last reader of red is done
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  const bool in = lane < (int)(blockDim.x >> 5);
  a = in ? red[lane] : a0;
  b = in ? red[32 + lane] : b0;
  warp_fold(a, b);
}

// A block-a-row kernel (softmax #33, layer_norm #37) stages its row in
// dynamic shared memory as it first reads it, up to ROW_STAGE_MAX bytes,
// and reads a wider row again from global memory (L2). read_row: thread t
// of a team of tsz calls f on its packs t, t + tsz, ... of N elements,
// copying each to st (null: no staging) as it goes; a later pass of the
// same thread reads back only its own packs (from st, or xr), so it needs
// no barrier.
constexpr int ROW_STAGE_MAX = 200 * 1024;

template <typename T, int N, typename F>
__device__ __forceinline__ void read_row(const T* xr, T* st, int64_t cols,
                                         int t, int tsz, F&& f) {
  for (int64_t c = (int64_t)t * N; c < cols; c += (int64_t)tsz * N) {
    const Pack<T, N> q = *reinterpret_cast<const Pack<T, N>*>(xr + c);
    if (st) *reinterpret_cast<Pack<T, N>*>(st + c) = q;
    f(q);
  }
}

// host: whether rows of n elements of T are whole 16-byte packs on the
// 16-byte aligned bases a and b
template <typename T>
bool whole_packs(int64_t n, const void* a, const void* b) {
  constexpr int VEC = 16 / sizeof(T);
  return n % VEC == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
}

// host: the threads of a block a row, a power of two from lo up to 1024
// with about four packs each
inline int row_threads(int64_t packs, int lo) {
  int threads = lo;
  while (threads < 1024 && threads * 4 < packs) threads *= 2;
  return threads;
}

// host: the dynamic shared memory that stages a row of `bytes` (0 above
// ROW_STAGE_MAX: the row is read again), with the kernel's limit raised
// where it is above the default 48 KiB
template <typename K>
cudaError_t row_stage_smem(K kernel, int64_t bytes, int* smem) {
  *smem = bytes <= ROW_STAGE_MAX ? (int)bytes : 0;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// One bf16 tensor-core product on 16x16 A and 16x8 B fragments with f32
// accumulation. Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16x16, row): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                   a3 = A[g+8][2t+8..]
//   B (16x8, col):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8):       c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two f32 rounded to bf16 in one register (lo in the low half): an A
// fragment of P for the P V product of the attention kernels
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// word 0 of Philox4x32-10 at counter (c0, c1, 0, 0) and key (k0, k1): the
// in-kernel random bits of csrc/sampling.cu and csrc/quant.cu
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// ------------------------------------------------ attention masks
// The masks of the featured attention path, one definition for the
// forward (csrc/flash_attention.cu) and the two-kernel backward
// (csrc/flash_attention_featured_bwd.cu), in the semantics of
// tpukern/ops/attention.py: causal keeps key c for query r iff c <= r; a
// window also needs c >= r - window + 1, or c < sinks (sinks are
// forward-only); segment ids need equal ids. The tails (r >= Sq,
// c >= Skv) are the kernels' own. The paged kernels add two options of
// tpukern/ops/paged_attention.py: a ring pool (slot_pos) and ALiBi
// slopes (alibi).
struct AttnMask {
  const int* qseg;  // (B, Sq) segment ids, or null
  const int* kseg;  // (B, Skv), null with qseg
  int causal;
  int window;       // 0: no window
  int sinks;        // 0: no sinks
  float softcap;    // 0: no cap
  float inv_cap;
  float scale;      // sm_scale
  int ring;         // paged: slots a sequence of a ring pool; 0: flat pool
  const float* slopes;  // paged: (Hq,) ALiBi slopes, or null
};

// The mask of a launcher's arguments, or false if they make none: a
// window needs causal, sinks a window, a softcap is >= 0 (0: none), and
// segment ids come as a pair.
inline bool make_mask(const int* q_seg, const int* kv_seg, int causal,
                      int window, int sinks, float softcap, float sm_scale,
                      AttnMask* m) {
  if (window < 0 || sinks < 0 || (window > 0 && !causal) ||
      (sinks > 0 && window == 0) || !(softcap >= 0.f) ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return false;
  *m = AttnMask{q_seg, kv_seg, causal, window, sinks, softcap,
                softcap > 0.f ? 1.f / softcap : 0.f, sm_scale};
  return true;
}

// The mask of a paged kernel: causal, the window, sinks and softcap of
// make_mask, a ring of `ring` slots a sequence (0: a flat pool; a ring
// needs a window no wider than ring - sinks) and ALiBi slopes (null: none;
// not with a softcap). False if the arguments make no mask.
inline bool make_paged_mask(int window, int sinks, float softcap, int ring,
                            const float* slopes, float sm_scale,
                            AttnMask* m) {
  if (ring < 0 || (ring > 0 && (window == 0 || window > ring - sinks)) ||
      (slopes && softcap > 0.f) ||
      !make_mask(nullptr, nullptr, 1, window, sinks, softcap, sm_scale, m))
    return false;
  m->ring = ring;
  m->slopes = slopes;
  return true;
}

// whether query qi sees key kvi; qs and ks are their segment ids (read
// only with segments)
__device__ __forceinline__ bool mask_visible(const AttnMask& m, int qi,
                                             int kvi, int qs, int ks) {
  return (!m.causal || kvi <= qi) &&
         (m.window == 0 || kvi >= qi - m.window + 1 || kvi < m.sinks) &&
         (!m.qseg || qs == ks);
}

// The position that slot `slot` of a paged sequence holds when its newest
// token sits at position `last`: the slot itself on a flat pool (and in
// the sink slots of a ring); on a ring of m.ring slots, whose slots past
// the sinks rotate with period R = ring - sinks, the largest position
// <= last congruent to the slot mod R (paged_attention.py:213-231), or -1
// where that falls below the ring region (a slot not written yet). The
// caller masks positions < 0 and > its query's.
__device__ __forceinline__ int slot_pos(const AttnMask& m, int slot,
                                        int last) {
  if (m.ring == 0 || slot < m.sinks) return slot;
  const int R = m.ring - m.sinks;
  int d = (last - slot) % R;
  if (d < 0) d += R;
  return last - d < m.sinks ? -1 : last - d;
}

// ALiBi: the scaled score of query head `head` at position qpos for the
// key at position kpos, plus slopes[head] * (kpos - qpos), rounded as
// JAX's f32 ops round it (paged_attention.py:232-240); unchanged without
// slopes.
__device__ __forceinline__ float alibi(const AttnMask& m, int head, float s,
                                       int kpos, int qpos) {
  return m.slopes ? __fadd_rn(s, __fmul_rn(m.slopes[head],
                                           static_cast<float>(kpos - qpos)))
                  : s;
}

// The KV tiles a query tile whose first query sits at position q0 visits,
// in order: the sink tiles [0, sink_end), then the band [lo, end). Without
// a window (or with FEAT off, or on a ring pool, where any slot may hold a
// position inside the band) lo is 0; sink_end and lo are multiples of BK
// with sink_end <= lo. The query tile's own end bounds the loop.
template <int BK>
struct KvRange {
  int lo, sink_end;
  __device__ KvRange(const AttnMask& f, int q0, bool feat) {
    lo = feat && f.window > 0 && f.ring == 0
             ? max(0, q0 - f.window + 1) / BK * BK : 0;
    sink_end = feat ? min(lo, (f.sinks + BK - 1) / BK * BK) : 0;
  }
  __device__ int first() const { return sink_end > 0 ? 0 : lo; }
  __device__ int next(int k0) const {
    return k0 + BK == sink_end ? lo : k0 + BK;
  }
};

// A scaled score s under the softcap: cap * tanh(s / cap) with the
// accurate tanhf (tanh.approx.f32 has about 11 bits), applied before any
// mask (attention.py:207-214); t = tanh(s / cap) for the backward's chain
// dS *= 1 - t^2. Without a cap, s and t = 0.
__device__ __forceinline__ float soft_cap(const AttnMask& m, float s,
                                          float& t) {
  t = 0.f;
  if (m.softcap > 0.f) {
    t = tanhf(s * m.inv_cap);
    s = m.softcap * t;
  }
  return s;
}

// ------------------------------------------- attention backward tiles
// csrc/flash_attention_featured_bwd.cu stages its tiles as f32 in shared
// memory, rows padded to D + 4 floats, and reads them as float4.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows x D of a (rows_total, D) matrix from row r0 into smem [rows][D + 4]
// as f32, zeros past rows_total; a block of NT threads
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int rows, int rows_total) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < rows_total
                          ? to_f32(src[(int64_t)(r0 + r) * D + c]) : 0.f;
  }
}

// The split of an f32 x into two TF32 values for the split-TF32
// products (csrc/hopper.cuh gemm_pipeline_tf32): hi is x rounded to TF32
// (10 mantissa bits; the low 13 bits zero) half away from zero, the
// rounding of cvt.rna.tf32.f32, written on the bits so that the plain
// version (ops/split_tf32.py split_tf32_ref) computes the same; lo = x -
// hi, exact in f32 (hi is within half a TF32 ulp of x, so Sterbenz's
// lemma holds), with x's sign where it is zero, so that hi + lo == x bit
// for bit. A finite x within half a TF32 ulp of FLT_MAX would round to
// inf: hi is its truncation there. inf keeps hi = x, lo = 0; a NaN gets
// hi = its truncation with the quiet bit set (still NaN as the tensor core
// reads it) and lo = 0, so that no inf - inf appears.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  const uint32_t u = __float_as_uint(x), mag = u & 0x7FFFFFFFu;
  const uint32_t sign = u & 0x80000000u;
  if (mag >= 0x7F800000u) {  // inf, NaN
    hi = mag > 0x7F800000u ? __uint_as_float((u & 0xFFFFE000u) | 0x00400000u)
                           : x;
    lo = 0.f;
    return;
  }
  uint32_t r = (mag + 0x1000u) & 0xFFFFE000u;
  if (r >= 0x7F800000u) r = mag & 0xFFFFE000u;
  hi = __uint_as_float(r | sign);
  lo = x - hi;
  if (lo == 0.f) lo = __uint_as_float(sign);
}

// The same split for the operands of a kernel that splits in its inner
// loop (csrc/flash_attention_tf32.cu, csrc/flash_attention_bwd.cu),
// in five instructions and no branch (split_tf32's cases cost each split
// a divergence region there): for a finite x below FLT_MAX's last half
// TF32 ulp it gives split_tf32's hi, and its lo rounded to TF32 the same
// way, where the tensor core would truncate it (a truncated lo put the
// f32 #8's dq at 2.2x the plain f32 version's error against f64 on one
// draw, PERF.md §6: a rounded one halves that term of each
// product's error); a non-finite x leaves a NaN in lo, so its products
// are NaN.
__device__ __forceinline__ void split_tf32_finite(float x, float& hi,
                                                  float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
  lo = __uint_as_float((__float_as_uint(x - hi) + 0x1000u) & 0xFFFFE000u);
}

// ------------------------------------------------------------ GEMM tiles
// One block of 256 threads accumulates the 128 x 128 tile at (m0, n0) of
// C = A[M,K] · B[K,N] in f32 registers. Every global load is
// bounds-checked: past M, N or K it reads zeros. csrc/matmul_naive.cu
// writes the tile out (#16 f32); the f32 #1-#3, #13-#15, #17, #28 and #29
// run the split-TF32 products of csrc/hopper.cuh instead.

// f32 inputs on CUDA-core FMAs in full f32 (no TF32). Thread (tx, ty)
// = (tid % 16, tid / 16) holds acc[i][j] at row sgemm_pos(i, ty) and
// column sgemm_pos(j, tx): an 8 x 8 register tile split in two 4-wide
// halves, so shared-memory reads are float4 and conflict-free. `as` and
// `bs` are shared [F_BK][128] buffers; the next K slice is fetched into
// registers while the current one is multiplied.
constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_THREADS = 256;

__device__ __forceinline__ int sgemm_pos(int i, int t) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4;
}

// acc += a · b (four lanes of a and b each), the 8 x 8 FMA step
__device__ __forceinline__ void fma_8x8(float (&acc)[8][8], float4 a0,
                                        float4 a1, float4 b0, float4 b1) {
  const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
}

__device__ __forceinline__ void sgemm_tile(const float* __restrict__ a,
                                           const float* __restrict__ b, int M,
                                           int N, int K, int m0, int n0,
                                           float (*as)[F_BM], float (*bs)[F_BN],
                                           float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // loader: A rows tid/2, k (tid%2)*4..+3; B k tid/32, n (tid%32)*4..+3
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const int bk_ = tid >> 5, bn_ = (tid & 31) * 4;
  float pa[4], pb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + lr, kk = k0 + lk + i;
      pa[i] = r < M && kk < K ? a[(int64_t)r * K + kk] : 0.f;
      const int kb = k0 + bk_, n = n0 + bn_ + i;
      pb[i] = kb < K && n < N ? b[(int64_t)kb * N + n] : 0.f;
    }
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      as[lk + i][lr] = pa[i];
      bs[bk_][bn_ + i] = pb[i];
    }
    __syncthreads();
    if (k0 + F_BK < K) fetch(k0 + F_BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk)
      fma_8x8(acc, *reinterpret_cast<const float4*>(&as[kk][ty * 4]),
              *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]),
              *reinterpret_cast<const float4*>(&bs[kk][tx * 4]),
              *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]));
    __syncthreads();
  }
}

// 8 consecutive bf16 of a row-major (rows, cols) matrix at (r, c), zeros
// past either edge; one 16-byte load when the chunk is whole and aligned
__device__ __forceinline__ uint4 load8(const bf16* p, int r, int rows, int c,
                                       int cols, bool vec) {
  if (r >= rows) return make_uint4(0, 0, 0, 0);
  const bf16* row = p + (int64_t)r * cols;
  if (vec && c + 8 <= cols) return *reinterpret_cast<const uint4*>(row + c);
  union { uint4 u; unsigned short h[8]; } v;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v.h[e] = c + e < cols ? __bfloat16_as_ushort(row[c + e]) : 0;
  return v.u;
}

// Host launchers. Each checks its arguments, returns cudaErrorInvalidValue
// for a shape or dtype it does not take, and otherwise launches on
// `stream` and returns cudaSuccess; capi.cu then reports cudaGetLastError().
cudaError_t rms_norm_launch(const void* x, const void* g, float g_scalar,
                            void* y, int64_t rows, int64_t cols, float eps,
                            int acc_bf16, int x_dtype, int g_dtype,
                            cudaStream_t stream);
cudaError_t rope_cached_launch(const void* x, const void* cos, const void* sin,
                               void* y, int64_t rows, int head_dim, int dtype,
                               cudaStream_t stream);
cudaError_t rope_batched_launch(const void* x, void* y, int64_t rows,
                                int head_dim, int seq_len, float sign,
                                int dtype, cudaStream_t stream);
cudaError_t flash_attention_launch(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* q_seg,
                                   const int* kv_seg, int B, int Hq, int Hkv,
                                   int Sq, int Skv, int D, float sm_scale,
                                   int causal, int window, int sinks,
                                   float softcap, int dtype, int config,
                                   cudaStream_t stream);
// f32: the split-TF32 kernel below; the masks of struct AttnMask
cudaError_t flash_attention_tf32_launch(const float* q, const float* k,
                                        const float* v, float* o, float* lse,
                                        int B, int Hq, int Hkv, int Sq,
                                        int Skv, int D, const AttnMask& f,
                                        cudaStream_t stream);
// f32 or bf16 (dq f32 in both, zeroed: the kernels add to it); GQA: Hkv
// divides Hq, dk and dv summed over each group
cudaError_t flash_attention_bwd_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* di,
                                       float* dq, void* dk, void* dv, int B,
                                       int Hq, int Hkv, int Sq, int Skv, int D,
                                       float sm_scale, int causal, int dtype,
                                       cudaStream_t stream);
// the bf16 tier of flash_attention_bwd_launch (arguments checked there)
cudaError_t flash_attention_bwd_bf16_launch(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse, const float* di,
                                            float* dq, void* dk, void* dv,
                                            int B, int Hq, int Hkv, int Sq,
                                            int Skv, int D, float sm_scale,
                                            int causal, cudaStream_t stream);
// the two-kernel featured backward, f32 or bf16; GQA: Hkv divides Hq,
// dk and dv summed over each group
cudaError_t flash_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const int* q_seg, const int* kv_seg,
    void* dq, int B, int Hq, int Hkv, int Sq, int Skv, int D, float sm_scale,
    int causal, int window, float softcap, int dtype, cudaStream_t stream);
cudaError_t flash_attention_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, const int* q_seg, const int* kv_seg,
    void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D,
    float sm_scale, int causal, int window, float softcap, int dtype,
    cudaStream_t stream);
// their f32 tier on split-TF32 wgmma (csrc/flash_attention_featured_tf32.cu;
// arguments checked there): dq (dk, dv null) or dk and dv (dq null)
cudaError_t flash_attention_featured_tf32_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dq, void* dk, void* dv, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, const AttnMask& m,
    cudaStream_t stream);
// f32 inputs: scratch holds the split-TF32 planes of A (2, M, K4) and of
// B (2, N, K4), K4 = K rounded up to 4 (null at K = 0), then, with splits
// of K > 1, the partial tiles (tiles, splits, 128 x 128); tickets: a
// zeroed counter a tile (splits > 1); passes: split_tf32_launch's
cudaError_t matmul_launch(const void* a, const void* b, void* c32, void* c16,
                          int M, int N, int K, int trans_b, int dtype,
                          void* scratch, int splits, int* tickets,
                          int* passes, cudaStream_t stream);
// the split-TF32 operand pass: src (R, C) at row stride ld into planes
// (hi, then lo) of (R, ldo) (out) and of its transpose (C, ldoT) (outT),
// either null; ldo >= C and ldoT >= R, multiples of 4, their padding 0.
// passes (host memory, or null) is raised by one when the pass launches.
// batch matrices, sbatch floats apart, in one launch: each one's planes
// after the previous one's, (batch, 2, rows, ld).
cudaError_t split_tf32_launch(const float* src, int R, int C, int64_t ld,
                              float* out, int64_t ldo, float* outT,
                              int64_t ldoT, int* passes, cudaStream_t stream,
                              int batch = 1, int64_t sbatch = 0);
// f32 inputs: scratch holds the split-TF32 planes, gmm_launch's x's (2, T,
// K4) then W's (E, 2, N, K4), tgmm_launch's x^T's (2, K, T4) then dy^T's
// (2, N, T4), K4 and T4 rounded up to 4 (null without a product); passes:
// split_tf32_launch's
cudaError_t gmm_launch(const void* x, const void* w, const int* group_sizes,
                       void* y32, void* y16, int T, int N, int K, int E,
                       int trans_w, int dtype, void* scratch, int* passes,
                       cudaStream_t stream);
cudaError_t tgmm_launch(const void* x, const void* dy, const int* group_sizes,
                        void* o32, void* o16, int T, int K, int N, int E,
                        int dtype, void* scratch, int* passes,
                        cudaStream_t stream);
cudaError_t matmul_w8a16_launch(const void* x, const void* w, const float* s,
                                void* out, float* ws, int* tickets, int M,
                                int N, int K, int splits, int kt_per,
                                int dtype, int out_dtype, cudaStream_t stream);
cudaError_t paged_attention_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const int* lengths,
                                   const int* page_table, void* o, int B, int Hq,
                                   int Hkv, int P, int page_size,
                                   int pages_per_seq, int D, float sm_scale,
                                   int window, int sinks, float softcap,
                                   int ring, const float* slopes, int chunk,
                                   float* ws, int* tickets, int dtype,
                                   cudaStream_t stream);
cudaError_t paged_prefill_launch(const void* q, const void* k_pages,
                                 const void* v_pages, const int* lengths,
                                 const int* page_table, void* o, int B, int Hq,
                                 int Hkv, int T, int P, int page_size,
                                 int pages_per_seq, int D, float sm_scale,
                                 int window, int sinks, float softcap,
                                 int ring, const float* slopes, int chunk,
                                 float* ws, int* tickets, int dtype,
                                 cudaStream_t stream);
cudaError_t paged_prefill_quantized_launch(
    const void* q, const float* q_scales, const void* k_pages,
    const float* k_scales, const void* v_pages, const float* v_scales,
    const int* lengths, const int* page_table, void* o, int B, int Hq, int Hkv,
    int T, int P, int page_size, int pages_per_seq, int D, int block_tokens,
    float sm_scale, int window, int sinks, float softcap, int ring,
    const float* slopes, int chunk, float* ws, int* tickets, float* stats,
    int dtype, int kv_dtype, int pv_int8, cudaStream_t stream);
cudaError_t quantize_launch(const void* x, void* values, float* scales,
                            int64_t S, int K, int mode, long long seed,
                            int dtype, cudaStream_t stream);
cudaError_t dequantize_launch(const void* values, const float* scales,
                              void* out, int64_t S, int K, int dtype,
                              cudaStream_t stream);
// #20 / #22 on the serving path: a layer's new K and V tokens (B, H, T, D)
// quantized and stored at the step's slots, one launch; k_strides and
// v_strides: host arrays of the (b, h, t) element strides; src null for
// token t; mode 0 int8, 2 fp8
cudaError_t write_kv_quantized_launch(
    const void* k, const void* v, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* phys, const int64_t* row,
    const int64_t* src, void* k_pages, float* k_scales, void* v_pages,
    float* v_scales, int B, int H, int T, int D, int P, int page, int mode,
    int dtype, cudaStream_t stream);
// the bf16 forward: one partial a 256-column vocab tile into part
// (cdiv(V, 256), 3, N)
cudaError_t ce_fwd_launch(const void* x, const void* w, const int* targets,
                          float* part, int N, int D, int V, int log2,
                          cudaStream_t stream);
// the f32 forward's launch for vocab columns [v0, v0 + vc): with split_x,
// x's split-TF32 planes into xs (2, N, D4); the chunk's transposed planes
// into ws (2, vc, D4); one partial a 128-column tile of the chunk into
// part, from partial tile0 on
cudaError_t ce_fwd_f32_launch(const float* x, const float* w,
                              const int* targets, float* part, float* xs,
                              float* ws, int N, int D, int V, int v0, int vc,
                              int tile0, int split_x, int log2, int* passes,
                              cudaStream_t stream);
cudaError_t ce_combine_launch(const float* part, const int* targets,
                              float* loss, float* lse, int N, int n_split,
                              cudaStream_t stream);
// the f32 backward's launches for vocab columns [v0, v0 + vc): with
// split_x, x's split-TF32 planes into xs (2, N, D4) and (2, D, N4); W's
// chunk's into ws (2, vc, D4) and (2, D, vc4); dlog's into ds (2, N, vc4)
// and (2, vc, N4) (n4: n rounded up to 4); then dlog, dx (stored, or
// added to with add) and dW[:, v0 .. v0 + vc); passes: split_tf32_launch's
cudaError_t ce_bwd_launch(const float* x, const float* w, const int* targets,
                          const float* lse, const float* g, float* dx,
                          float* dw, float* xs, float* ws, float* ds, int N,
                          int D, int V, int v0, int vc, int add, int split_x,
                          int log2, int* passes, cudaStream_t stream);
// the bf16 backward's three launches for vocab columns [v0, v0 + vc):
// dlog (scratch, N rows of vc rounded up to 8), dx (stored, or added to
// with add), dW[:, v0 .. v0 + vc)
cudaError_t ce_bwd_chunk_launch(const void* x, const void* w,
                                const int* targets, const float* lse,
                                const float* g, float* dx, float* dw,
                                void* dlog, int N, int D, int V, int v0,
                                int vc, int add, int log2,
                                cudaStream_t stream);
cudaError_t sample_launch(const void* x, const float* thr, const float* noise,
                          int mode, long long seed, float inv_temp, int B,
                          int V, int n_split, unsigned long long* part,
                          int* out, int dtype, cudaStream_t stream);
cudaError_t ew_launch(int op, const void* x0, const void* x1, const float* s,
                      void* y, int64_t n, int vec, int dtype,
                      cudaStream_t stream);
cudaError_t reduce_launch(const void* x, const void* y, void* partials,
                          void* out, int64_t n, int mode, int in_dtype,
                          int acc_dtype, cudaStream_t stream);
cudaError_t matmul_naive_launch(const void* a, const void* b, void* c, int M,
                                int N, int K, int dtype, cudaStream_t stream);
cudaError_t sample_threshold_launch(const float* x, float* thr, int B, int V,
                                    int mode, int kk, float pp,
                                    float inv_temp, cudaStream_t stream);
// #27's cluster shape for B rows of V values: out[0] blocks a row, out[1]
// values a block, out[2] 1 if staged in shared memory, out[3] its bytes
cudaError_t sample_threshold_plan(int B, int V, int mode, int* out);
// mode 0: safe softmax (#33), 1: online (#34)
cudaError_t softmax_launch(const void* x, void* y, int64_t rows, int64_t cols,
                           int mode, int dtype, cudaStream_t stream);
cudaError_t softmax_grid_stats_launch(const void* x, float* pm, float* pd,
                                      int64_t rows, int64_t cols, int br,
                                      int bc, int ncb, int dtype,
                                      cudaStream_t stream);
cudaError_t softmax_grid_norm_launch(const void* x, const float* pm,
                                     const float* pd, void* y, int64_t rows,
                                     int64_t cols, int br, int bc, int ncb,
                                     int dtype, cudaStream_t stream);
// #35 + #36 as one cluster launch
cudaError_t softmax_grid_fused_launch(const void* x, void* y, int64_t rows,
                                      int64_t cols, int bc, int ncb,
                                      int dtype, cudaStream_t stream);
cudaError_t softmax_grid_fused_plan(int64_t rows, int64_t cols, int bc,
                                    int ncb, int dtype, int* out);
// g and b (cols,) of gb_dtype each, or null for g_scalar / b_scalar
cudaError_t layer_norm_launch(const void* x, const void* g, float g_scalar,
                              const void* b, float b_scalar, void* y,
                              int64_t rows, int64_t cols, float eps,
                              int acc_bf16, int x_dtype, int gb_dtype,
                              cudaStream_t stream);
// mode 0: one block a token (#38), 1: block_tokens a block (#39)
cudaError_t embedding_gather_launch(const int* idx, const void* w, void* out,
                                    int64_t S, int V, int64_t D,
                                    int block_tokens, int mode, int dtype,
                                    cudaStream_t stream);
cudaError_t embedding_onehot_launch(const int* idx, const void* w, void* out,
                                    int S, int V, int D, int dtype,
                                    cudaStream_t stream);
// out: bins int32, zeroed by the caller; block_rows 8, 16, 32, 64 or 128
cudaError_t histogram_launch(const int* x, int64_t n, int* out, int bins,
                             int block_rows, cudaStream_t stream);
// order 0 row, 1 col, 2 diag; bm and bn multiples of 64
cudaError_t transpose_launch(const void* x, void* out, int64_t M, int64_t N,
                             int bm, int bn, int order, int dtype,
                             cudaStream_t stream);
// mode 0 vpu, 1 mxu; bk: the K block
cudaError_t gemv_launch(const void* A, const void* x, float* y, int M,
                        int64_t K, int64_t bk, int mode, int dtype,
                        cudaStream_t stream);
// boxes (n, 4) f32 sorted by score; mask: n x ceil(n / 64) u64 scratch
cudaError_t nms_keep_launch(const float* boxes, int n, float thr,
                            unsigned long long* mask, int* keep,
                            cudaStream_t stream);
// the ring collectives of n ranks on this card (csrc/ring.cu): x holds the
// ranks' operands one after another, out their outputs; flags max_blocks
// u64 (all-gather) or 2 max_blocks (reduce-scatter), slots max_blocks x 2
// tiles of 16 KiB; base: the call's epoch
cudaError_t ring_all_gather_launch(const void* x, void* out,
                                   unsigned long long* flags, int n,
                                   int64_t chunk_bytes,
                                   unsigned long long base, int max_blocks,
                                   cudaStream_t stream);
cudaError_t ring_reduce_scatter_launch(const void* x, void* out, void* slots,
                                       unsigned long long* flags, int n,
                                       int64_t chunk, int dtype,
                                       unsigned long long base,
                                       int max_blocks, cudaStream_t stream);

}  // namespace tk
