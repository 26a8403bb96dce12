// GEMV: y[M] = A[M, K] . x[K] in f32, for f32, bf16 or f16 A and x.
//
// #44 gemv_kernel and gemv_mma_kernel replace tpukern/ops/gemv.py:37
// `kernel` (gemv :27), which walks (bm, bk) tiles of A, sums each tile's
// products a K block at a time and adds that block's sum to the row's
// running sum in block order (:47-50), by a multiply and row sum (`vpu`)
// or a jnp.dot (`mxu`). The product is bound by memory bandwidth: A is
// read once (M K elements; x and y add K and M), and its 2 M K operations
// are far below any peak of the card.
//
// vpu (gemv_kernel): a team of TEAM lanes a row (32, or 16, 8 or 4 for
// short rows: 32 / TEAM rows a warp), each lane summing 16-byte packs of A
// (4 f32 or 8 bf16/f16, widened in registers) times the same packs of x
// (through the read-only cache: every warp reads all of x, which stays in
// L1 and L2) with f32 FMAs, GEMV_ELEMS elements of each in flight before
// their FMAs; at the end of each K block the team folds its sums by
// shuffles and adds the block's sum to the row's running sum, as JAX adds
// each block's.
// mxu (gemv_mma_kernel): bf16 on mma.sync m16n8k16 with x as B (its 8
// columns all x: a product bound by bandwidth has tensor cores to spare).
// A block of 8 warps owns 16 rows; each warp takes every 8th 32-column
// chunk of a K block, lane (g, t) loading the 16-byte packs at columns
// [8t, 8t + 8) of rows g and g + 8 and the same pack of x. The mma's k
// order inside a step is then a permutation, applied alike to A and x,
// which leaves the product as it is. At the end of a K block the 8 warps'
// f32 sums are added in warp order, and then to the running sum. f32 and
// f16 `mxu` run the vpu kernel: the tensor cores' f32 path is TF32, which
// rounds A and x to 10 mantissa bits, and JAX's interpret-mode f32 dot is
// full f32.
//
// f16 is storage-only, as in JAX (gemv.py:30 widens it to f32 before the
// kernel): the kernel reads f16 and widens it in registers, the same
// function with half the bytes. The K tail is masked: packs past K, or
// past their K block, read zeros (JAX's kernel sums the padded tail of its
// last block unmasked).
#include "common.cuh"

namespace tk {
namespace {

constexpr int GEMV_THREADS = 256;  // 8 warps
// vpu: the elements of A a lane loads before it sums them (2 f32 packs, 1
// bf16/f16 pack): on an H100 more packs in flight cost registers and
// occupancy, and the 2-byte types ran slower with them
constexpr int GEMV_ELEMS = 8;
// mxu: the 32-column chunks a warp loads before their mmas
constexpr int GEMV_CHUNKS = 4;

// the 16 bytes at p, widened to f32 (4 f32, or 8 bf16/f16) by bit
// operations on the loaded words
__device__ __forceinline__ void load_pack(const float* p, float (&f)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
}
__device__ __forceinline__ void load_pack(const bf16* p, float (&f)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_pack(const f16* p, float (&f)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half((unsigned short)w[i]));
    f[2 * i + 1] =
        __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

// VEC elements of p widened to f32: one 16-byte load where VEC is
// 16 / sizeof(T), else VEC = 1
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1)
    f[0] = to_f32(__ldg(p));
  else
    load_pack(p, f);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kernel(const T* __restrict__ A, const T* __restrict__ x,
            float* __restrict__ y, int M, int64_t K, int64_t bk, int team) {
  const int lane = threadIdx.x & 31, tl = lane % team;
  const int64_t row =
      ((int64_t)blockIdx.x * (GEMV_THREADS / 32) + (threadIdx.x >> 5)) *
          (32 / team) + lane / team;
  const bool live = row < M;
  const T* a = A + (live ? row : 0) * K;
  float acc = 0.f;
  for (int64_t k0 = 0; k0 < K; k0 += bk) {
    const int64_t kend = k0 + bk < K ? k0 + bk : K;
    float part = 0.f;
    if (live) {
      // LOADS packs of A and x in flight before their FMAs; VEC > 1: K
      // and bk are multiples of VEC, so every pack is whole
      constexpr int LOADS = GEMV_ELEMS / VEC;
      const int64_t step = (int64_t)team * VEC;
      for (int64_t c0 = k0 + (int64_t)tl * VEC; c0 < kend;
           c0 += LOADS * step) {
        float av[LOADS][VEC], xv[LOADS][VEC];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int64_t c = c0 + u * step;
          if (c < kend) {
            load_f32<T, VEC>(a + c, av[u]);
            load_f32<T, VEC>(x + c, xv[u]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) av[u][i] = xv[u][i] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u)
#pragma unroll
          for (int i = 0; i < VEC; ++i) part = fmaf(av[u][i], xv[u][i], part);
      }
    }
    for (int o = team / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    acc += part;
  }
  if (live && tl == 0) y[row] = acc;
}

// 8 bf16 of row r of A (or of x, r = 0 and rows = 1) at column c, zeros
// past row `rows` or column kend; vec: one 16-byte load (whole packs)
__device__ __forceinline__ uint4 pack8(const bf16* p, int64_t r, int rows,
                                       int64_t c, int64_t K, int64_t kend,
                                       bool vec) {
  if (r >= rows || c >= kend) return make_uint4(0, 0, 0, 0);
  const bf16* q = p + r * K + c;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(q));
  union { uint4 u; unsigned short h[8]; } v;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v.h[e] = c + e < kend ? __bfloat16_as_ushort(q[e]) : 0;
  return v.u;
}

__global__ void __launch_bounds__(GEMV_THREADS)
gemv_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ x,
                float* __restrict__ y, int M, int64_t K, int64_t bk,
                int vec) {
  __shared__ float red[GEMV_THREADS / 32][16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t r0 = (int64_t)blockIdx.x * 16;
  float acc = 0.f;  // threads 0-15: row r0 + threadIdx.x's running sum
  for (int64_t k0 = 0; k0 < K; k0 += bk) {
    const int64_t kend = k0 + bk < K ? k0 + bk : K;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    // warp-uniform: every lane reaches the mma; GEMV_CHUNKS chunks' packs
    // in flight before their mmas
    constexpr int64_t step = (GEMV_THREADS / 32) * 32;
    for (int64_t c0 = k0 + (int64_t)warp * 32; c0 < kend;
         c0 += GEMV_CHUNKS * step) {
      uint4 a0[GEMV_CHUNKS], a1[GEMV_CHUNKS], xv[GEMV_CHUNKS];
#pragma unroll
      for (int u = 0; u < GEMV_CHUNKS; ++u) {
        const int64_t cc = c0 + u * step + 8 * t;
        a0[u] = pack8(A, r0 + g, M, cc, K, kend, vec);
        a1[u] = pack8(A, r0 + g + 8, M, cc, K, kend, vec);
        xv[u] = pack8(x, 0, 1, cc, K, kend, vec);
      }
#pragma unroll
      for (int u = 0; u < GEMV_CHUNKS; ++u) {
        const uint32_t s0[4] = {a0[u].x, a1[u].x, a0[u].y, a1[u].y};
        mma_16816(d, s0, xv[u].x, xv[u].y);
        const uint32_t s1[4] = {a0[u].z, a1[u].z, a0[u].w, a1[u].w};
        mma_16816(d, s1, xv[u].z, xv[u].w);
      }
    }
    // lane (g, 0) holds column 0: row g in d[0], row g + 8 in d[2]
    if (t == 0) {
      red[warp][g] = d[0];
      red[warp][g + 8] = d[2];
    }
    __syncthreads();
    if (threadIdx.x < 16) {
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < GEMV_THREADS / 32; ++w) p += red[w][threadIdx.x];
      acc += p;
    }
    __syncthreads();
  }
  if (threadIdx.x < 16 && r0 + threadIdx.x < M) y[r0 + threadIdx.x] = acc;
}

template <typename T>
void vpu_launch(const T* A, const T* x, float* y, int M, int64_t K,
                int64_t bk, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = K % VEC == 0 && bk % VEC == 0 &&
                   ((uintptr_t)A | (uintptr_t)x) % 16 == 0;
  const int64_t packs = (bk + (vec ? VEC : 1) - 1) / (vec ? VEC : 1);
  int team = 4;
  while (team < 32 && team * 2 <= packs) team *= 2;
  const int rows = (GEMV_THREADS / 32) * (32 / team);
  const unsigned blocks = (unsigned)((M + rows - 1) / rows);
  if (vec)
    gemv_kernel<T, VEC><<<blocks, GEMV_THREADS, 0, stream>>>(A, x, y, M, K,
                                                             bk, team);
  else
    gemv_kernel<T, 1><<<blocks, GEMV_THREADS, 0, stream>>>(A, x, y, M, K,
                                                           bk, team);
}

}  // namespace

// mode 0: vpu, 1: mxu (bf16 on the tensor cores; f32 and f16 as vpu);
// bk: the K block (K for one block)
cudaError_t gemv_launch(const void* A, const void* x, float* y, int M,
                        int64_t K, int64_t bk, int mode, int dtype,
                        cudaStream_t stream) {
  if (M < 0 || K < 0 || bk <= 0 || (mode != 0 && mode != 1) ||
      (dtype != kF32 && dtype != kBF16 && dtype != kF16))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;  // an empty y: a null pointer
  if (!y || (K > 0 && (!A || !x))) return cudaErrorInvalidValue;
  if (mode == 1 && dtype == kBF16) {
    const bool vec = K % 8 == 0 && bk % 8 == 0 &&
                     ((uintptr_t)A | (uintptr_t)x) % 16 == 0;
    gemv_mma_kernel<<<(unsigned)((M + 15) / 16), GEMV_THREADS, 0, stream>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(x), y, M, K, bk,
        vec);
  } else if (dtype == kF32) {
    vpu_launch(static_cast<const float*>(A), static_cast<const float*>(x), y,
               M, K, bk, stream);
  } else if (dtype == kBF16) {
    vpu_launch(static_cast<const bf16*>(A), static_cast<const bf16*>(x), y,
               M, K, bk, stream);
  } else {
    vpu_launch(static_cast<const f16*>(A), static_cast<const f16*>(x), y, M,
               K, bk, stream);
  }
  return cudaSuccess;
}

}  // namespace tk
