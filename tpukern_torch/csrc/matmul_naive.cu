// The naive rung of the GEMM ladder: C[M,N] = A[M,K] · B[K,N], f32
// accumulation, written in the input dtype (f32 or bf16), any M, N, K.
//
// Replaces tpukern/ops/matmul.py:384 `kernel` (matmul_naive :372), the
// "whole-K-resident naive tier": one jnp.dot per output block on the
// matrix unit, no K pipeline. Its naive trait is the missing pipeline,
// not a missing matrix unit, so this kernel keeps the tensor cores and
// drops only the pipeline.
//
// What bounds it: at 4096^3 a 128 x 128 tile does 128·128·K multiply-adds
// per 2·128·K elements loaded, so the function is bound by operations
// (139 µs in bf16 at 989 TFLOP/s, 2.05 ms in f32 at 67).
//
// bf16: a block of two warpgroups owns a 128 x 128 tile of C and walks K
// in slabs of 64 with one stage, as the TPU kernel has no K pipeline:
// load the slab, wait, four wgmma m64n128k16 per warpgroup, wait for
// them, next slab. The slab's A (128 x 64, K-major) and B (64 x 128,
// row-major, read with wgmma's transpose-B bit) land in 128B-swizzled
// shared memory (csrc/hopper.cuh) by one of two load paths per operand,
// a template flag each:
// - TMA (cp.async.bulk.tensor.2d, one thread, an mbarrier armed with the
//   slab's bytes): the operand's base is 16-byte aligned and its rows are
//   a multiple of 16 bytes (K % 8 == 0 for A, N % 8 == 0 for B); boxes
//   past the edges arrive as zeros (the K tail, M and N edges);
// - the block's threads otherwise: they copy the slab into the same
//   swizzled layout with element loads (its rows are no whole, aligned
//   16-byte chunks), zeros past the edges.
// The launcher picks each operand's path by that rule.
// At 33 KiB of shared memory and 256 threads, two blocks share an SM:
// one block's loads overlap the other's products. The epilogue rounds
// the f32 accumulators to bf16 and masks the M/N edges. A multi-stage
// ring and warp specialisation are csrc/matmul.cu's (hopper.cuh
// gemm_pipeline); #16 keeps the TPU kernel's missing pipeline.
//
// f32: no tensor-core route keeps the function (TF32 rounds the inputs
// to 10 mantissa bits; the reference is exact f32), so a block of 256
// threads runs common.cuh's sgemm_tile: 128 x 128 tiles staged through
// shared memory, an 8 x 8 register tile a thread, f32 FMAs.
#include "hopper.cuh"

namespace tk {
namespace {

constexpr int NV_BM = 128, NV_BN = 128, NV_BK = 64, NV_THREADS = 256;
constexpr int NV_A_BYTES = NV_BM * NV_BK * 2;  // 128 rows of 128 bytes
// B: two 64-column halves (TMA's 128-byte box width), 64 rows of 128 bytes
constexpr int NV_B_HALF = NV_BK * 64 * 2;
constexpr int NV_SMEM = NV_A_BYTES + 2 * NV_B_HALF + 1024;  // + alignment
// 16-byte chunks of a slab's operand (A, or B) a thread copies
constexpr int NV_CHUNKS = NV_A_BYTES / 16 / NV_THREADS;
static_assert(NV_CHUNKS * NV_THREADS * 16 == 2 * NV_B_HALF, "A and B alike");

template <bool TMA_A, bool TMA_B>
__global__ void __launch_bounds__(NV_THREADS, 2)
matmul_naive_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const bf16* __restrict__ a,
                         const bf16* __restrict__ b, bf16* __restrict__ c,
                         int M, int N, int K) {
  constexpr bool ANY_TMA = TMA_A || TMA_B;
  constexpr uint32_t TX = (TMA_A ? NV_A_BYTES : 0) + (TMA_B ? 2 * NV_B_HALF : 0);
  extern __shared__ unsigned char nv_smem[];
  __shared__ __align__(8) uint64_t bar;
  // the tiles at the first 1024-byte boundary (the swizzle's atom)
  const uint32_t raw = smem_u32(nv_smem);
  const uint32_t sa = (raw + 1023) & ~1023u, sb = sa + NV_A_BYTES;
  unsigned char* ta = nv_smem + (sa - raw);
  unsigned char* tb = ta + NV_A_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * NV_BM, n0 = blockIdx.x * NV_BN;
  const uint32_t mb = smem_u32(&bar);
  if (ANY_TMA && tid == 0) mbar_init(mb, 1);
  __syncthreads();

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t phase = 0;
  for (int k0 = 0; k0 < K; k0 += NV_BK) {
    if (ANY_TMA && tid == 0) {
      mbar_arrive_tx(mb, TX);
      if (TMA_A) tma_load_2d(sa, &map_a, mb, k0, m0);
      if (TMA_B) {
        tma_load_2d(sb, &map_b, mb, n0, k0);
        tma_load_2d(sb + NV_B_HALF, &map_b, mb, n0 + 64, k0);
      }
    }
    // the threads' copy: 4 chunks of each copied operand a thread, all
    // loaded before any is stored
    uint4 ca[NV_CHUNKS], cb[NV_CHUNKS];
#pragma unroll
    for (int i = 0; i < NV_CHUNKS; ++i) {
      const int ch = tid + i * NV_THREADS;
      if (!TMA_A)  // 128 rows x 8 chunks
        ca[i] = load8(a, m0 + (ch >> 3), M, k0 + (ch & 7) * 8, K, false);
      if (!TMA_B)  // 2 halves x 64 rows x 8 chunks
        cb[i] = load8(b, k0 + ((ch >> 3) & 63), K,
                      n0 + (ch >> 9) * 64 + (ch & 7) * 8, N, false);
    }
#pragma unroll
    for (int i = 0; i < NV_CHUNKS; ++i) {
      const int ch = tid + i * NV_THREADS;
      if (!TMA_A)
        *reinterpret_cast<uint4*>(ta + sw128_offset(ch >> 3, ch & 7)) = ca[i];
      if (!TMA_B)
        *reinterpret_cast<uint4*>(tb + (ch >> 9) * NV_B_HALF +
                                  sw128_offset((ch >> 3) & 63, ch & 7)) = cb[i];
    }
    if (!TMA_A || !TMA_B) {
      fence_proxy_async();
      __syncthreads();
    }
    if (ANY_TMA) {
      mbar_wait(mb, phase);
      phase ^= 1;
    }
    wgmma_fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NV_BK / 16; ++kk)
      wgmma_m64n128k16_bf16<0, 1>(
          d, wgmma_desc(sa + wg * 64 * 128 + kk * 32, 16, 1024),
          wgmma_desc(sb + kk * 16 * 128, NV_B_HALF, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_acc(d);
    __syncthreads();  // the slab is consumed before the next one lands
  }

  const int lane = tid & 31, w = (tid >> 5) & 3;
  const int r0 = m0 + wg * 64 + w * 16 + (lane >> 2);
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      bf16* out = c + (int64_t)r * N + col;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && col + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < N) out[0] = __float2bfloat16(v0);
        if (col + 1 < N) out[1] = __float2bfloat16(v1);
      }
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
matmul_naive_f32_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ c,
                        int M, int N, int K) {
  __shared__ __align__(16) float as[F_BK][F_BM];
  __shared__ __align__(16) float bs[F_BK][F_BN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  float acc[8][8];
  sgemm_tile(a, b, M, N, K, m0, n0, as, bs, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + sgemm_pos(i, ty);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + sgemm_pos(j, tx);
      if (col < N) c[(int64_t)r * N + col] = acc[i][j];
    }
  }
}

template <bool TMA_A, bool TMA_B>
void launch_bf16(const CUtensorMap& ma, const CUtensorMap& mb, const bf16* a,
                 const bf16* b, bf16* c, int M, int N, int K,
                 const dim3& grid, cudaStream_t stream) {
  matmul_naive_bf16_kernel<TMA_A, TMA_B>
      <<<grid, NV_THREADS, NV_SMEM, stream>>>(ma, mb, a, b, c, M, N, K);
}

}  // namespace

// bf16: an operand goes by TMA where its base is 16-byte aligned and its
// rows are a multiple of 16 bytes (ops/matmul.py tma_operands mirrors the
// rule to count the paths), else by the threads' copy
cudaError_t matmul_naive_launch(const void* a, const void* b, void* c, int M,
                                int N, int K, int dtype, cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || !a || !b || !c) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  if ((M + NV_BM - 1) / NV_BM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + NV_BN - 1) / NV_BN, (M + NV_BM - 1) / NV_BM);
  if (dtype == kF32) {
    matmul_naive_f32_kernel<<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), M, N, K);
    return cudaSuccess;
  }
  if (dtype != kBF16) return cudaErrorInvalidValue;
  const bool tma_a = K % 8 == 0 && aligned16(a);
  const bool tma_b = N % 8 == 0 && aligned16(b);
  CUtensorMap ma{}, mb{};
  // no slab to load at K = 0 (and no map of a zero extent)
  if (tma_a && K > 0) {
    const cudaError_t e = tma_map_bf16(&ma, a, K, M, (uint64_t)K * 2, NV_BK,
                                       NV_BM);
    if (e != cudaSuccess) return e;
  }
  if (tma_b && K > 0) {
    const cudaError_t e = tma_map_bf16(&mb, b, N, K, (uint64_t)N * 2, 64,
                                       NV_BK);
    if (e != cudaSuccess) return e;
  }
  const bf16* ha = static_cast<const bf16*>(a);
  const bf16* hb = static_cast<const bf16*>(b);
  bf16* hc = static_cast<bf16*>(c);
  if (tma_a && tma_b)
    launch_bf16<true, true>(ma, mb, ha, hb, hc, M, N, K, grid, stream);
  else if (tma_a)
    launch_bf16<true, false>(ma, mb, ha, hb, hc, M, N, K, grid, stream);
  else if (tma_b)
    launch_bf16<false, true>(ma, mb, ha, hb, hc, M, N, K, grid, stream);
  else
    launch_bf16<false, false>(ma, mb, ha, hb, hc, M, N, K, grid, stream);
  return cudaSuccess;
}

}  // namespace tk
