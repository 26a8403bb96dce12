// Weight-only int8 GEMM (w8a16): y[m, n] = (sum_k x[m, k] * q[k, n]) * s[n]
// for x (M, K) bf16 or f32, q (K, N) int8 and s (N,) f32, accumulated in
// f32 and written in bf16 or f32.
//
// Replaces tpukern/ops/matmul_w8a16.py:106 `kernel`, the Pallas body of
// `matmul_w8a16`. There a grid of (M, N, K) blocks walks K in order,
// upcasts each int8 block to x's dtype after the DMA, adds its dot into a
// VMEM f32 accumulator and multiplies by s[n] on the last K step.
//
// What bounds it: at decode (M = 4 to 20 rows) the product does 2 M
// operations per weight byte, far below the card's ~295 bf16 operations a
// byte, so it is bound by reading the K x N weight bytes (the head, 2048 x
// 32768: 20 us at 3.35 TB/s); at M = 128 it nears the ridge (256
// operations a byte). A decode shape also has few output columns for 132
// SMs (wk, 2048 x 1024: 8 tiles of 128).
//
// bf16 (w8a16_mma_kernel): tokens are the MMA's N and weight columns its
// M. A block owns 128 weight columns (8 warps of 16, one m16 tile each),
// all tokens of its chunk of at most 128 (NT n8 tiles, NT = 1, 2, 4, 8 or
// 16 by M: at M = 4 half of each tile is padding, where a 64-row token
// tile wasted 15/16) and a slice of K:
//   - a ring of 4 stages of 64 K rows fed by cp.async: the int8 weights
//     as they lie (64 x 128 bytes, 16-byte chunks XOR-swizzled by row) and
//     x's rows (NT x 8 tokens x 64 bf16, swizzled likewise), zeros past M,
//     N and K; 3 stages (24 KB of weights) in flight while the fourth is
//     multiplied, one barrier a stage;
//   - a warp reads its 16 columns x 32 K of int8 with one ldmatrix.x4
//     .trans (each thread: 2 columns x 2 K of each 8-row matrix, exactly
//     the m16n8k16 A fragment with m-row g as column 2g and m-row g + 8 as
//     column 2g + 1) and widens them without conversion instructions
//     (widen_int8: a byte into the low mantissa of bf16 128 or 256, one
//     bf16x2 subtraction, exact for every int8), then reuses each A
//     fragment for all NT token tiles;
//   - NT = 1, 2, 4 (M <= 32): mma.sync m16n8k16 bf16, the B fragments
//     from x's rows by ldmatrix.x4; NT = 8, 16: register-A wgmma
//     m64n64k16 / m64n128k16 (a warpgroup's four A fragments are its 64
//     columns), the tensor cores reading x's rows, which are 128B-swizzle
//     atoms, in place: at 16 tiles the warps' own B reads took more
//     shared-memory bandwidth than the products. f32 accumulators: the
//     products are JAX's, only the order of the sum differs. The scale
//     multiplies each output once (__fmul_rn).
// K is split across blocks, at most two waves of them and 16 splits (8
// from 4 token tiles on: the wrapper's `splits`): each block writes its
// f32 partials to a workspace, takes a ticket from a per-tile counter,
// and the last block of a tile to arrive sums the partials in slice
// order 0, 1, ... (q_merge) and writes the output. No float atomics touch
// the output, so the result does not depend on which block finishes
// when, and the call is one launch. The last block resets its counter to
// 0 for the next launch.
// f32 (w8a16_f32_kernel, no main path): a block owns a 64 x 128 output
// tile and 32-row K slices, x and q (widened to f32) staged in shared
// memory, CUDA-core FMAs in full f32 (never TF32), a 4 x 8 register tile
// a thread, the tile through shared memory to the epilogue.
#include "hopper.cuh"

namespace tk {
namespace {

// the f32 tier's tile: 64 x 128 outputs, K slices of 32
constexpr int W_BM = 64, W_BN = 128, W_BK = 32, W_THREADS = 256;
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

// the bf16 tier: 128 weight columns (8 warps of 16) by up to 128 tokens a
// block, K stages of 64 rows in a ring of 4
constexpr int Q_BN = 128, Q_BK = 64, Q_TOKENS = 128, Q_STAGES = 4;
constexpr int Q_THREADS = 256;
constexpr int Q_W = Q_BK * Q_BN;  // a stage's weights: 8 KiB
template <int NT>
constexpr int Q_STAGE = Q_W + NT * 8 * Q_BK * 2;  // + x's rows
// blocks an SM holds: the register cap that __launch_bounds__ derives
// from it (64 a thread for NT <= 4, 128 for the wgmma instances) keeps
// the merge's loads from setting the main loop's occupancy, and the
// ring's shared memory fits that many blocks (at most 196 KiB)
template <int NT>
constexpr int Q_BLOCKS = NT <= 4 ? 4 : 2;

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

// The K slices [kt0, kt1) of BK rows of this block's split.
template <int BK>
__device__ __forceinline__ void k_slices(const W8Args& a, int& kt0, int& kt1) {
  const int nkt = (a.K + BK - 1) / BK;
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

// four 8 x 8 matrices of 16-bit elements, row addresses from lanes 8 i ..
// 8 i + 7 for matrix i; .trans hands each thread a column pair instead of
// a row pair
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// Bytes (b0, b2) and (b1, b3) of the int8 word w as two bf16x2 words,
// exactly: the low 7 bits of b go into the mantissa of bf16 128 (bits
// 0x4300 | (b & 0x7F): 128 + (b & 127)), the sign bit into that of 128 or
// 256 (0x4300 | (b & 0x80)), and their difference is b. One byte
// permutation, two logic operations and one bf16x2 subtraction for two
// weights; ops/matmul_w8a16.py widen_int8_ref computes the same bits.
__device__ __forceinline__ void widen_int8(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t e = __byte_perm(w, 0x43434343u, 0x6250);  // b0 43 b2 43
  const uint32_t o = __byte_perm(w, 0x43434343u, 0x7351);  // b1 43 b3 43
  uint32_t em = e & 0x437F437Fu, es = e & 0x43804380u;
  uint32_t om = o & 0x437F437Fu, os = o & 0x43804380u;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(em), "r"(es));
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(om), "r"(os));
}

// Stage `slot` of the ring gets K rows [k0, k0 + Q_BK) of the block's 128
// weight columns (row k's 16-byte chunk c at c ^ (k & 7)) and of its
// NT * 8 tokens of x (row r's chunk c, 8 values of K, at c ^ (r & 7));
// zeros past K, N and M. 16-byte cp.async where the chunk is whole and
// aligned (vec_w, vec_x), else the thread's own loads.
template <int NT>
__device__ __forceinline__ void q_load_stage(const W8Args& a, uint8_t* stage,
                                             int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  const bf16* x = static_cast<const bf16*>(a.x);
#pragma unroll
  for (int i = tid; i < Q_BK * 8; i += Q_THREADS) {
    const int k = i >> 3, c = i & 7, n = n0 + 16 * c;
    uint8_t* dst = stage + k * Q_BN + ((c ^ (k & 7)) << 4);
    const bool in = k0 + k < a.K && n < a.N;
    const int8_t* src = a.w + (int64_t)(k0 + k) * a.N + n;
    if (a.vec_w) {
      cp_async16(smem_u32(dst), in ? src : a.w, in);
    } else {
      union { uint4 u; int8_t b[16]; } v;
#pragma unroll
      for (int e = 0; e < 16; ++e) v.b[e] = in && n + e < a.N ? src[e] : 0;
      *reinterpret_cast<uint4*>(dst) = v.u;
    }
  }
  uint8_t* xs = stage + Q_W;
#pragma unroll
  for (int i = tid; i < NT * 8 * 8; i += Q_THREADS) {
    const int r = i >> 3, c = i & 7, k = k0 + 8 * c;
    uint8_t* dst = xs + r * (Q_BK * 2) + ((c ^ (r & 7)) << 4);
    const bool in = m0 + r < a.M && k < a.K;
    const bf16* src = x + (int64_t)(m0 + r) * a.K + k;
    if (a.vec_x)
      cp_async16(smem_u32(dst), in ? src : x, in);
    else
      *reinterpret_cast<uint4*>(dst) = load8(x, m0 + r, a.M, k, a.K, false);
  }
}

// The last block of a tile to arrive: y = (the sum over the splits, in
// split order, of their partials) * s for the tile's NT * 8 tokens and
// 128 columns, 4 columns a thread a step, NT steps a thread in passes of
// P. Other blocks wrote the partials: L2 reads (__ldcg), ZB splits of a
// pass's steps in flight before their adds (8 loads of 16 bytes), so the
// merge waits on NT / P * cdiv(splits, ZB) round trips to L2.
template <int NT>
__device__ __forceinline__ void q_merge(const W8Args& a, int m0, int n0) {
  constexpr int P = NT < 8 ? NT : 8, ZB = 8 / P;
  const int tid = threadIdx.x;
  const int64_t plane = (int64_t)a.M * a.N;
  const bool vec = a.N % 4 == 0;
#pragma unroll
  for (int it0 = 0; it0 < NT; it0 += P) {
    // step it0 + i: token m[i], columns n[i] .. + 3
    int m[P], n[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int e = 4 * (tid + (it0 + i) * Q_THREADS);
      m[i] = m0 + e / Q_BN;
      n[i] = n0 + e % Q_BN;
    }
    float4 acc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < a.splits; z0 += ZB) {
      float4 v[ZB][P];
#pragma unroll
      for (int j = 0; j < ZB; ++j)
#pragma unroll
        for (int i = 0; i < P; ++i) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (z0 + j < a.splits && m[i] < a.M && n[i] < a.N) {
            const float* p =
                a.ws + (z0 + j) * plane + (int64_t)m[i] * a.N + n[i];
            if (vec) {
              x = __ldcg(reinterpret_cast<const float4*>(p));
            } else {
              x.x = __ldcg(p);
              if (n[i] + 1 < a.N) x.y = __ldcg(p + 1);
              if (n[i] + 2 < a.N) x.z = __ldcg(p + 2);
              if (n[i] + 3 < a.N) x.w = __ldcg(p + 3);
            }
          }
          v[j][i] = x;
        }
#pragma unroll
      for (int j = 0; j < ZB; ++j)
#pragma unroll
        for (int i = 0; i < P; ++i) {
          acc[i].x += v[j][i].x;
          acc[i].y += v[j][i].y;
          acc[i].z += v[j][i].z;
          acc[i].w += v[j][i].w;
        }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (m[i] >= a.M) continue;
      const float y[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n[i] + e;
        if (col >= a.N) break;
        const float o = __fmul_rn(y[e], a.s[col]);
        const int64_t k = (int64_t)m[i] * a.N + col;
        if (a.out_f32) static_cast<float*>(a.out)[k] = o;
        else static_cast<bf16*>(a.out)[k] = __float2bfloat16(o);
      }
    }
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) = (128 weight columns, 128
// tokens, K split). Warp w owns columns n0 + 16 w .. + 15 as its m16
// tile and all NT token tiles. acc[nt] holds, for thread (g, t), column
// n0 + 16 w + 2 g (0: token 2 t, 1: token 2 t + 1) and the next column
// (2, 3) of token tile nt.
template <int NT>
__global__ void __launch_bounds__(Q_THREADS, Q_BLOCKS<NT>)
    w8a16_mma_kernel(W8Args a) {
  extern __shared__ __align__(128) uint8_t q_raw[];
  // the ring from a 1024-byte boundary: x's rows are wgmma's 128B-swizzle
  // atoms (the launch allocates 1 KiB more)
  uint8_t* q_smem = q_raw + ((1024 - (smem_u32(q_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * Q_BN, m0 = blockIdx.y * Q_TOKENS;
  int kt0, kt1;
  k_slices<Q_BK>(a, kt0, kt1);

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  auto stage = [&](int j) { return q_smem + j * Q_STAGE<NT>; };
#pragma unroll
  for (int j = 0; j < Q_STAGES - 1; ++j) {
    if (kt0 + j < kt1) q_load_stage<NT>(a, stage(j), m0, n0, (kt0 + j) * Q_BK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // this lane's ldmatrix rows: A row (K) 8 (lane >> 3) + (lane & 7) of a
  // 32-row half, chunk warp; B token (lane & 7) of a tile, chunk lane >> 3
  // of a 32-value half
  const int ak = 8 * (lane >> 3) + (lane & 7), br = lane & 7, bc = lane >> 3;
  for (int kt = kt0; kt < kt1; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(Q_STAGES - 2) : "memory");
    if (NT >= 8) fence_proxy_async();  // x's rows, for wgmma
    __syncthreads();  // stage kt is in; the slot of kt - 1 is consumed
    const int nxt = kt + Q_STAGES - 1;
    if (nxt < kt1)
      q_load_stage<NT>(a, stage((nxt - kt0) % Q_STAGES), m0, n0, nxt * Q_BK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint8_t* ws = stage((kt - kt0) % Q_STAGES);
    const uint8_t* xs = ws + Q_W;
#pragma unroll
    for (int h = 0; h < Q_BK / 32; ++h) {
      const int k = 32 * h + ak;
      uint32_t q4[4], af[2][4];
      ldmatrix_x4<true>(q4, smem_u32(ws + k * Q_BN + ((warp ^ (k & 7)) << 4)));
      // K rows 0-7 and 8-15 of step 0 (q4[0], q4[1]), of step 1 (q4[2],
      // q4[3]): a0 = column 2g at rows 2t, 2t + 1; a1 = column 2g + 1
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        widen_int8(q4[2 * s], af[s][0], af[s][1]);
        widen_int8(q4[2 * s + 1], af[s][2], af[s][3]);
      }
      if constexpr (NT >= 8) {
        // warpgroup warp / 4's 64 columns by all NT * 8 tokens: A from
        // these registers, x's rows (K-major, 128B swizzle) read by the
        // tensor cores; k16 step s starts 32 (2 h + s) bytes into them
        float (&d)[NT * 4] = *reinterpret_cast<float(*)[NT * 4]>(acc);
        const uint32_t xb = smem_u32(xs);
        wgmma_fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint64_t db = wgmma_desc(xb + 32 * (2 * h + s), 16, 1024);
          if constexpr (NT == 8) wgmma_m64n64k16_bf16_rs<0>(d, af[s], db);
          else wgmma_m64n128k16_bf16_rs<0>(d, af[s], db);
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_acc(d);
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int r = 8 * nt + br, c = 4 * h + bc;
          uint32_t b[4];
          ldmatrix_x4<false>(b, smem_u32(xs + r * (Q_BK * 2) +
                                          ((c ^ (r & 7)) << 4)));
          mma_16816(acc[nt], af[0], b[0], b[1]);
          mma_16816(acc[nt], af[1], b[2], b[3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the epilogue: thread (g, t) has columns n, n + 1 of tokens m, m + 1
  // of each token tile
  const int n = n0 + 16 * warp + 2 * g;
  const bool pair = a.N % 2 == 0 && n + 1 < a.N;
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = m0 + 8 * nt + 2 * t + u;
        if (m < a.M && n < a.N)
          fn((int64_t)m * a.N + n, acc[nt][u], acc[nt][u + 2]);
      }
  };
  auto store = [&](int64_t i, float v0, float v1) {
    const float y0 = __fmul_rn(v0, a.s[n]);
    const float y1 = n + 1 < a.N ? __fmul_rn(v1, a.s[n + 1]) : 0.f;
    if (a.out_f32) {
      float* o = static_cast<float*>(a.out) + i;
      if (pair) *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
      else { o[0] = y0; if (n + 1 < a.N) o[1] = y1; }
    } else {
      bf16* o = static_cast<bf16*>(a.out) + i;
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
      } else {
        o[0] = __float2bfloat16(y0);
        if (n + 1 < a.N) o[1] = __float2bfloat16(y1);
      }
    }
  };
  if (a.splits == 1) {
    each(store);
    return;
  }
  // this split's partials, then the tile's ticket; the last block sums
  // every split's partials in split order
  const int64_t plane = (int64_t)a.M * a.N;
  float* part = a.ws + blockIdx.z * plane;
  each([&](int64_t i, float v0, float v1) {
    if (pair) *reinterpret_cast<float2*>(part + i) = make_float2(v0, v1);
    else { part[i] = v0; if (n + 1 < a.N) part[i + 1] = v1; }
  });
  __shared__ int last_s;
  __threadfence();  // the partials reach every block before the ticket
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last_s = atomicAdd(&a.tickets[tile], 1) == a.splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  q_merge<NT>(a, m0, n0);
  if (tid == 0) a.tickets[tile] = 0;
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
  k_slices<W_BK>(a, kt0, kt1);

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

// the bf16 instance for NT token tiles: its shared memory (4 stages and
// the alignment, over the 48 KiB default from NT = 4 on) allowed once,
// then the launch
template <int NT>
cudaError_t launch_mma(const W8Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = Q_STAGES * Q_STAGE<NT> + 1024;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      w8a16_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (allowed != cudaSuccess) return allowed;
  w8a16_mma_kernel<NT><<<grid, Q_THREADS, bytes, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

cudaError_t matmul_w8a16_launch(const void* x, const void* w, const float* s,
                                void* out, float* ws, int* tickets, int M,
                                int N, int K, int splits, int kt_per,
                                int dtype, int out_dtype, cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || !tickets || kt_per < 0 ||
      (dtype != kBF16 && dtype != kF32) || (out_dtype != kBF16 && out_dtype != kF32))
    return cudaErrorInvalidValue;
  const bool bf = dtype == kBF16;
  // the splits cover the K slices (64 rows in bf16, 32 in f32), each at
  // least one, and more than one needs the workspace
  const int bk = bf ? Q_BK : W_BK;
  const int nkt = (K + bk - 1) / bk;
  if (splits < 1 || splits * kt_per < nkt ||
      (splits > 1 && (!ws || kt_per < 1 || (splits - 1) * kt_per >= nkt)))
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const int bm = bf ? Q_TOKENS : W_BM;
  const dim3 grid((N + W_BN - 1) / W_BN, (M + bm - 1) / bm, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  // 16-byte loads need whole, aligned chunks: rows of a multiple of 8 bf16,
  // 4 f32 or 16 int8 from a 16-byte aligned base
  const W8Args a{x, static_cast<const int8_t*>(w), s, out, ws, tickets, M, N,
                 K, splits, kt_per, out_dtype == kF32,
                 aligned16(x) && K % (bf ? 8 : 4) == 0,
                 aligned16(w) && N % 16 == 0};
  if (!bf) {
    w8a16_f32_kernel<<<grid, W_THREADS, 0, stream>>>(a);
    return cudaSuccess;
  }
  // the token tiles of a block: M's (at most 128) rounded up to a power
  // of two (ops/matmul_w8a16.py token_tiles)
  const int tiles = ((M < Q_TOKENS ? M : Q_TOKENS) + 7) / 8;
  if (tiles <= 1) return launch_mma<1>(a, grid, stream);
  if (tiles <= 2) return launch_mma<2>(a, grid, stream);
  if (tiles <= 4) return launch_mma<4>(a, grid, stream);
  if (tiles <= 8) return launch_mma<8>(a, grid, stream);
  return launch_mma<16>(a, grid, stream);
}

}  // namespace tk
