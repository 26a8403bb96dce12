// Weight-only int8 GEMM (w8a16): y[m, n] = (sum_k x[m, k] * q[k, n]) * s[n]
// for x (M, K) bf16 or f32, q (K, N) int8 and s (N,) f32, accumulated in
// f32 and written in bf16 or f32.
//
// Replaces tpukern/ops/matmul_w8a16.py:106 `kernel`, the Pallas body of
// `matmul_w8a16`. There a grid of (M, N, K) blocks walks K in order,
// upcasts each int8 block to x's dtype after the DMA, adds its dot into a
// VMEM f32 accumulator and multiplies by s[n] on the last K step. Here a
// block owns a 64 x 128 output tile and a slice of K:
//   - each K step of 32 stages x (16-byte loads) and q (16 int8 a thread,
//     one 16-byte load along N, so device memory sees int8 only) into
//     shared memory, q widened to x's type there (exact: |q| <= 127); the
//     next step's loads are in flight while the current one multiplies;
//   - bf16: mma.sync m16n8k16 with an f32 accumulator, 8 warps in a 2 x 4
//     grid of 32 x 32 sub-tiles (the products are JAX's; only the order
//     of the sum differs); f32: CUDA-core FMAs in full f32 (never TF32),
//     a 4 x 8 register tile a thread;
//   - the tile goes through shared memory to the epilogue, which scales it
//     once per output.
// What bounds it: at decode (M = 4 to 20 rows) the product does 2 M
// operations per weight byte, far below the card's ~295 bf16 operations a
// byte, so it is bound by reading the K x N weight bytes; and a decode
// shape has few output tiles (wk, 2048 x 1024: 8) for 132 SMs. So K is
// split across blocks until there are two waves of them (the wrapper's
// `splits`): each block writes its f32 partial tile to a workspace,
// takes a ticket from a per-tile counter, and the last block of a tile
// to arrive sums the partials in slice order 0, 1, ... and writes the
// output. No float atomics touch the output, so the result does not
// depend on which block finishes when, and the call is one launch. The
// last block resets its counter to 0 for the next launch.
// No cp.async ring, TMA or wgmma yet: making it fast is later work.
#include "common.cuh"

namespace tk {
namespace {

constexpr int W_BM = 64, W_BN = 128, W_BK = 32, W_THREADS = 256;
constexpr int W_LDX = W_BK + 8;   // bf16 x tile [m][k]: conflict-free A reads
constexpr int W_LDW = W_BN + 8;   // bf16 q tile [k][n]
constexpr int W_LDXT = W_BM + 4;  // f32 x tile [k][m]
constexpr int W_LDC = W_BN + 4;   // f32 output tile [m][n]
// one shared buffer, carved per phase: the operand tiles of the main loop,
// then the output tile (the largest)
constexpr int W_SMEM = W_BM * W_LDC * 4;

struct W8Args {
  const void* x;     // (M, K) bf16 or f32
  const int8_t* w;   // (K, N)
  const float* s;    // (N,)
  void* out;         // (M, N) bf16 or f32
  float* ws;         // (splits, M, N) f32 partial tiles; null for one split
  int* tickets;      // one counter per output tile, 0 between launches
  int M, N, K, splits, kt_per, out_f32, vec_x, vec_w;
};

// 16 int8 weights at row k, columns n .. n + 15, zeros past K or N; one
// 16-byte load where the chunk is whole and aligned
__device__ __forceinline__ uint4 load_w16(const int8_t* w, int k, int n,
                                          int K, int N, bool vec) {
  if (k >= K) return make_uint4(0, 0, 0, 0);
  const int8_t* row = w + (int64_t)k * N;
  if (vec && n + 16 <= N) return *reinterpret_cast<const uint4*>(row + n);
  union { uint4 u; int8_t b[16]; } v;
#pragma unroll
  for (int e = 0; e < 16; ++e) v.b[e] = n + e < N ? row[n + e] : 0;
  return v.u;
}

// 4 f32 of x at (r, k .. k + 3), zeros past M or K
__device__ __forceinline__ float4 load_x4(const float* x, int r, int M, int k,
                                          int K, bool vec) {
  if (r >= M) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* row = x + (int64_t)r * K;
  if (vec && k + 4 <= K) return *reinterpret_cast<const float4*>(row + k);
  return make_float4(k < K ? row[k] : 0.f, k + 1 < K ? row[k + 1] : 0.f,
                     k + 2 < K ? row[k + 2] : 0.f, k + 3 < K ? row[k + 3] : 0.f);
}

// The K slices [kt0, kt1) of this block's split.
__device__ __forceinline__ void k_slices(const W8Args& a, int& kt0, int& kt1) {
  const int nkt = (a.K + W_BK - 1) / W_BK;
  kt0 = blockIdx.z * a.kt_per;
  kt1 = min(kt0 + a.kt_per, nkt);
}

// The epilogue of a block whose f32 tile is in cs ([W_BM][W_LDC]): with one
// split, y = tile * s; else the tile is this split's partial, and the last
// block of the tile to arrive sums every split's partial in split order.
__device__ void finish_tile(const W8Args& a, const float* cs) {
  __shared__ int last_s;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * W_BM, n0 = blockIdx.x * W_BN;
  const int rows = min(W_BM, a.M - m0), cols = min(W_BN, a.N - n0);
  auto store = [&](int r, int c, float v) {
    const int64_t i = (int64_t)(m0 + r) * a.N + n0 + c;
    const float y = __fmul_rn(v, a.s[n0 + c]);
    if (a.out_f32)
      static_cast<float*>(a.out)[i] = y;
    else
      static_cast<bf16*>(a.out)[i] = __float2bfloat16(y);
  };
  __syncthreads();  // cs is written
  if (a.splits == 1) {
    for (int i = tid; i < rows * W_BN; i += W_THREADS) {
      const int r = i / W_BN, c = i % W_BN;
      if (c < cols) store(r, c, cs[r * W_LDC + c]);
    }
    return;
  }
  float* part = a.ws + ((int64_t)blockIdx.z * a.M + m0) * a.N + n0;
  for (int i = tid; i < rows * W_BN; i += W_THREADS) {
    const int r = i / W_BN, c = i % W_BN;
    if (c < cols) part[(int64_t)r * a.N + c] = cs[r * W_LDC + c];
  }
  __threadfence();  // the partial is visible to every block before the ticket
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last_s = atomicAdd(&a.tickets[tile], 1) == a.splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int i = tid; i < rows * W_BN; i += W_THREADS) {
    const int r = i / W_BN, c = i % W_BN;
    if (c >= cols) continue;
    const float* p = a.ws + (int64_t)(m0 + r) * a.N + n0 + c;
    float sum = 0.f;
    for (int z = 0; z < a.splits; ++z)  // L2 reads: other blocks wrote them
      sum += __ldcg(p + (int64_t)z * a.M * a.N);
    store(r, c, sum);
  }
  if (tid == 0) a.tickets[tile] = 0;
}

__global__ void __launch_bounds__(W_THREADS) w8a16_bf16_kernel(W8Args a) {
  __shared__ __align__(16) unsigned char smem[W_SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [W_BM][W_LDX]
  bf16* qs = xs + W_BM * W_LDX;              // [W_BK][W_LDW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * W_BM, n0 = blockIdx.x * W_BN;
  const bf16* x = static_cast<const bf16*>(a.x);
  // loaders: x row xr, columns xk .. xk + 7; q row qk, columns qn .. qn + 15
  const int xr = tid >> 2, xk = (tid & 3) * 8;
  const int qk = tid >> 3, qn = (tid & 7) * 16;
  int kt0, kt1;
  k_slices(a, kt0, kt1);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  uint4 px = make_uint4(0, 0, 0, 0), pq = px;
  auto fetch = [&](int kt) {
    const int k0 = kt * W_BK;
    px = load8(x, m0 + xr, a.M, k0 + xk, a.K, a.vec_x);
    pq = load_w16(a.w, k0 + qk, n0 + qn, a.K, a.N, a.vec_w);
  };
  if (kt0 < kt1) fetch(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // the previous slice is consumed
    *reinterpret_cast<uint4*>(&xs[xr * W_LDX + xk]) = px;
    {
      const int8_t* b = reinterpret_cast<const int8_t*>(&pq);
      union { uint4 u[2]; unsigned short h[16]; } c;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        c.h[e] = __bfloat16_as_ushort(__float2bfloat16(static_cast<float>(b[e])));
      *reinterpret_cast<uint4*>(&qs[qk * W_LDW + qn]) = c.u[0];
      *reinterpret_cast<uint4*>(&qs[qk * W_LDW + qn + 8]) = c.u[1];
    }
    __syncthreads();
    if (kt + 1 < kt1) fetch(kt + 1);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < W_BK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = &xs[(wm + mt * 16 + g) * W_LDX + ks * 16 + 2 * t];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * W_LDX);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * W_LDX + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* bp = &qs[(ks * 16 + 2 * t) * W_LDW + wn + nt * 8 + g];
        const uint32_t b0 = pack_bf16(bp[0], bp[W_LDW]);
        const uint32_t b1 = pack_bf16(bp[8 * W_LDW], bp[9 * W_LDW]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

  __syncthreads();  // the operand tiles are consumed: cs reuses their memory
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cs[(wm + mt * 16 + g + (e < 2 ? 0 : 8)) * W_LDC + wn + nt * 8 + 2 * t +
           (e & 1)] = acc[mt][nt][e];
  finish_tile(a, cs);
}

__global__ void __launch_bounds__(W_THREADS) w8a16_f32_kernel(W8Args a) {
  __shared__ __align__(16) unsigned char smem[W_SMEM];
  float* xs = reinterpret_cast<float*>(smem);  // [W_BK][W_LDXT], k-major
  float* qs = xs + W_BK * W_LDXT;              // [W_BK][W_BN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * W_BM, n0 = blockIdx.x * W_BN;
  const float* x = static_cast<const float*>(a.x);
  const int qk = tid >> 3, qn = (tid & 7) * 16;
  int kt0, kt1;
  k_slices(a, kt0, kt1);

  // rows ty * 4 + i; columns tx * 4 + j (j < 4) and 64 + tx * 4 + j - 4
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 px[2];
  uint4 pq = make_uint4(0, 0, 0, 0);
  auto fetch = [&](int kt) {
    const int k0 = kt * W_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 64 rows x 8 chunks of 4
      const int idx = tid + i * W_THREADS;
      px[i] = load_x4(x, m0 + (idx >> 3), a.M, k0 + (idx & 7) * 4, a.K, a.vec_x);
    }
    pq = load_w16(a.w, k0 + qk, n0 + qn, a.K, a.N, a.vec_w);
  };
  if (kt0 < kt1) fetch(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * W_THREADS, r = idx >> 3, kc = (idx & 7) * 4;
      xs[(kc + 0) * W_LDXT + r] = px[i].x;
      xs[(kc + 1) * W_LDXT + r] = px[i].y;
      xs[(kc + 2) * W_LDXT + r] = px[i].z;
      xs[(kc + 3) * W_LDXT + r] = px[i].w;
    }
    {
      const int8_t* b = reinterpret_cast<const int8_t*>(&pq);
#pragma unroll
      for (int e = 0; e < 16; e += 4)
        *reinterpret_cast<float4*>(&qs[qk * W_BN + qn + e]) =
            make_float4(b[e], b[e + 1], b[e + 2], b[e + 3]);
    }
    __syncthreads();
    if (kt + 1 < kt1) fetch(kt + 1);
#pragma unroll 8
    for (int kk = 0; kk < W_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[kk * W_LDXT + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&qs[kk * W_BN + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&qs[kk * W_BN + 64 + tx * 4]);
      const float ra[4] = {av.x, av.y, av.z, av.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
  }

  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cs[(ty * 4 + i) * W_LDC + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4)] = acc[i][j];
  finish_tile(a, cs);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

cudaError_t matmul_w8a16_launch(const void* x, const void* w, const float* s,
                                void* out, float* ws, int* tickets, int M,
                                int N, int K, int splits, int kt_per,
                                int dtype, int out_dtype, cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || !tickets || kt_per < 0 ||
      (dtype != kBF16 && dtype != kF32) || (out_dtype != kBF16 && out_dtype != kF32))
    return cudaErrorInvalidValue;
  // the splits cover the K slices, each at least one, and more than one
  // needs the workspace
  const int nkt = (K + W_BK - 1) / W_BK;
  if (splits < 1 || splits * kt_per < nkt ||
      (splits > 1 && (!ws || kt_per < 1 || (splits - 1) * kt_per >= nkt)))
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + W_BN - 1) / W_BN, (M + W_BM - 1) / W_BM, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const bool bf = dtype == kBF16;
  // 16-byte loads need whole, aligned chunks: rows of a multiple of 8 bf16,
  // 4 f32 or 16 int8 from a 16-byte aligned base
  const W8Args a{x, static_cast<const int8_t*>(w), s, out, ws, tickets, M, N,
                 K, splits, kt_per, out_dtype == kF32,
                 aligned16(x) && K % (bf ? 8 : 4) == 0,
                 aligned16(w) && N % 16 == 0};
  if (bf)
    w8a16_bf16_kernel<<<grid, W_THREADS, 0, stream>>>(a);
  else
    w8a16_f32_kernel<<<grid, W_THREADS, 0, stream>>>(a);
  return cudaSuccess;
}

}  // namespace tk
