// GEMM: C[M,N] = A[M,K] · B[K,N] (NN), or A[M,K] · B[N,K]^T (TN,
// trans_b), accumulated in f32. A block owns one 128 x 128 tile of C and
// walks K; every global load is bounds-checked, so M, N and K need not be
// tile multiples (the K tail reads zeros, the M/N edges are not stored).
//
// Replaces tpukern/ops/matmul.py `matmul`'s three Pallas bodies, which
// differ only in where the f32 accumulator ends up; here it lives in
// registers and one epilogue writes it through two nullable pointers:
//   `kernel` (:172)            -> the out dtype: c32 or c16 alone
//   `kernel_accio` (:140)      -> the f32 accumulator: c32 alone
//   `kernel_accio_dual` (:155) -> f32 plus a bf16 copy: c32 and c16
//
// What bounds it: at the training shapes (K = 2048-8192, M = 2048 tokens)
// a tile does 128·128·K multiply-adds per 2·128·K elements loaded, so the
// kernel is compute bound and the tier decides the rate.
// - f32 inputs run on CUDA-core FMAs in full f32, never TF32 (the JAX CPU
//   reference is exact f32): 256 threads, each an 8 x 8 register tile
//   split in two 4-wide halves so shared-memory reads are float4 and
//   conflict-free (the reference's sgemm_t_8x8_sliced_k_f32x4 design,
//   SURVEY.md §2.2). The next K slice is fetched into registers while the
//   current one is multiplied.
// - bf16 inputs run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), as csrc/flash_attention.cu does: 8 warps in a 2 x 4
//   grid, each a 64 x 32 sub-tile, K in slices of 32 staged through
//   padded shared memory with 16-byte loads where a row is whole.
// Plain loads through shared memory: cp.async/TMA stages and wgmma are a
// later PR's work.
#include "common.cuh"

namespace tk {
namespace {

// ---------------------------------------------------------- f32 CUDA cores
constexpr int F_BM = 128, F_BN = 128, F_BK = 8, F_THREADS = 256;

template <bool TRANS_B>
__global__ void __launch_bounds__(F_THREADS)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c32, bf16* __restrict__ c16, int M, int N,
             int K) {
  __shared__ __align__(16) float as[F_BK][F_BM];  // A tile, k-major
  __shared__ __align__(16) float bs[F_BK][F_BN];  // B tile, k-major
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;

  // loader: A (and B^T) rows tid/2, k (tid%2)*4..+3; B (NN) k tid/32,
  // n (tid%32)*4..+3
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const int bk_ = tid >> 5, bn_ = (tid & 31) * 4;
  float pa[4], pb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + lr, kk = k0 + lk + i;
      pa[i] = r < M && kk < K ? a[(int64_t)r * K + kk] : 0.f;
      if constexpr (TRANS_B) {
        const int n = n0 + lr;
        pb[i] = n < N && kk < K ? b[(int64_t)n * K + kk] : 0.f;
      } else {
        const int kb = k0 + bk_, n = n0 + bn_ + i;
        pb[i] = kb < K && n < N ? b[(int64_t)kb * N + n] : 0.f;
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      as[lk + i][lr] = pa[i];
      if constexpr (TRANS_B) bs[lk + i][lr] = pb[i];
      else bs[bk_][bn_ + i] = pb[i];
    }
    __syncthreads();
    if (k0 + F_BK < K) fetch(k0 + F_BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= N) continue;
      if (c32) c32[(int64_t)r * N + c] = acc[i][j];
      if (c16) c16[(int64_t)r * N + c] = __float2bfloat16(acc[i][j]);
    }
  }
}

// ------------------------------------------------------- bf16 tensor cores
constexpr int H_BM = 128, H_BN = 128, H_BK = 32, H_THREADS = 256;
constexpr int H_LDK = H_BK + 8;   // [row][k] tiles: conflict-free pair reads
constexpr int H_LDN = H_BN + 8;   // [k][n] tile (NN): conflict-free reads

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

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t): see
// csrc/flash_attention.cu.
template <bool TRANS_B>
__global__ void __launch_bounds__(H_THREADS)
hgemm_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 float* __restrict__ c32, bf16* __restrict__ c16, int M,
                 int N, int K, int vec_a, int vec_b) {
  __shared__ __align__(16) bf16 as[H_BM * H_LDK];
  // TRANS_B: [n][k] like A; NN: [k][n]
  __shared__ __align__(16) bf16 bs[TRANS_B ? H_BN * H_LDK : H_BK * H_LDN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += H_BK) {
    __syncthreads();  // the previous tile is consumed
    // 512 chunks of 8 per operand tile, 2 per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = tid + i * H_THREADS;
      const int r = ch >> 2, kc = (ch & 3) * 8;
      // the K edge: a chunk straddling K is loaded element by element
      *reinterpret_cast<uint4*>(&as[r * H_LDK + kc]) =
          load8(a, m0 + r, M, k0 + kc, K, vec_a);
      if constexpr (TRANS_B) {
        *reinterpret_cast<uint4*>(&bs[r * H_LDK + kc]) =
            load8(b, n0 + r, N, k0 + kc, K, vec_b);
      } else {
        const int kr = ch >> 4, nc = (ch & 15) * 8;
        *reinterpret_cast<uint4*>(&bs[kr * H_LDN + nc]) =
            load8(b, k0 + kr, K, n0 + nc, N, vec_b);
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < H_BK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* ap = &as[(wm + mt * 16 + g) * H_LDK + ks * 16 + 2 * t];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * H_LDK);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * H_LDK + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        if constexpr (TRANS_B) {
          const bf16* bp = &bs[(wn + nt * 8 + g) * H_LDK + ks * 16 + 2 * t];
          b0 = *reinterpret_cast<const uint32_t*>(bp);
          b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
        } else {
          const bf16* bp = &bs[(ks * 16 + 2 * t) * H_LDN + wn + nt * 8 + g];
          b0 = pack_bf16(bp[0], bp[H_LDN]);
          b1 = pack_bf16(bp[8 * H_LDN], bp[9 * H_LDN]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + mt * 16 + g + (e < 2 ? 0 : 8);
        const int c = n0 + wn + nt * 8 + 2 * t + (e & 1);
        if (r >= M || c >= N) continue;
        if (c32) c32[(int64_t)r * N + c] = acc[mt][nt][e];
        if (c16) c16[(int64_t)r * N + c] = __float2bfloat16(acc[mt][nt][e]);
      }
    }
  }
}

}  // namespace

cudaError_t matmul_launch(const void* a, const void* b, void* c32, void* c16,
                          int M, int N, int K, int trans_b, int dtype,
                          cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || (!c32 && !c16)) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  float* o32 = static_cast<float*>(c32);
  bf16* o16 = static_cast<bf16*>(c16);
  if (dtype == kF32) {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    if (trans_b)
      sgemm_kernel<true><<<grid, F_THREADS, 0, stream>>>(fa, fb, o32, o16, M, N, K);
    else
      sgemm_kernel<false><<<grid, F_THREADS, 0, stream>>>(fa, fb, o32, o16, M, N, K);
  } else if (dtype == kBF16) {
    const dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const bf16* ha = static_cast<const bf16*>(a);
    const bf16* hb = static_cast<const bf16*>(b);
    // 16-byte loads need 16-byte aligned rows: the wrapper aligns the
    // base, so rows are aligned when their length is a multiple of 8
    const int vec_a = K % 8 == 0;
    if (trans_b)
      hgemm_mma_kernel<true><<<grid, H_THREADS, 0, stream>>>(
          ha, hb, o32, o16, M, N, K, vec_a, K % 8 == 0);
    else
      hgemm_mma_kernel<false><<<grid, H_THREADS, 0, stream>>>(
          ha, hb, o32, o16, M, N, K, vec_a, N % 8 == 0);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace tk
