// Fused LM-head cross-entropy: per token n, loss = lse(x[n] · W) - (x[n] ·
// W)[target[n]], and its gradients, without the (N, V) logits ever
// reaching device memory. x is (N, D), W is (D, V), both row-major and of
// one dtype; targets < 0 are ignored (loss 0, gradient 0).
//
// Replaces tpukern/ops/cross_entropy.py:
//   `_ce_fwd_kernel` (:53)  -> f32: ce_fwd_kernel; bf16: ce_fwd_wgmma_kernel;
//                              then ce_combine_kernel (#13)
//   `_ce_dx_kernel` (:95)   -> f32: ce_dlog_tf32_kernel then ce_dx_tf32_kernel;
//                              bf16: ce_dlog_kernel then ce_dx_kernel (#14)
//   `_ce_dw_kernel` (:132)  -> f32: ce_dlog_tf32_kernel then ce_dw_tf32_kernel;
//                              bf16: ce_dlog_kernel then ce_dw_kernel (#15)
//
// f32 forward score tiles: 128 x 128 tiles S = x[n0..] · W[:, v0..] from
// common.cuh's sgemm_tile, on CUDA-core FMAs in full f32 (the JAX f32
// tier's Precision.HIGHEST), put into shared memory, where the reductions
// read them in a layout of their own. Columns past V are set to NEG_BIG
// after the arithmetic, never multiplied in: 0 * garbage would be NaN.
//
// Forward. The TPU kernel gives one grid row to each token block and walks
// all of V in order; at N = 2048 that is 16 blocks for 132 SMs. Here V is
// split too, and each split writes its rows' (max, sum of exp, target
// logit) as a partial; ce_combine_kernel then merges a row's partials
// (the lse merge of flash_attention_splitkv, tpukern/ops/attention.py:1162)
// into its loss and natural-log lse. The partials are (n_split, 3, N)
// floats.
// - f32 (ce_fwd_kernel): block (row tile, split) walks `tiles_per_split`
//   vocab tiles with an online (max, sum) per row, as the TPU kernel does;
//   n_split is bounded by the SM count (ops/cross_entropy.py splits).
// - bf16 (ce_fwd_wgmma_kernel): one hopper.cuh gemm_pipeline launch, the
//   operands of ce_dlog_kernel below (x K-major, W's columns MN-major with
//   row stride V): each block computes one 128 x 256 score tile and folds
//   it in the consumers' registers, where a quad of lanes holds a whole
//   256-column row (64 columns a lane): each lane's max and sum of exp over
//   its columns, merged by two quad shuffles, the target logit from the
//   lane that holds the target's column, and lane 0 of the quad writes the
//   row's partial. Nothing goes through shared memory; n_split = cdiv(V,
//   256), one partial a vocab tile (128 at V = 32768: 3 MB at N = 2048).
//
// Backward: three launches a vocab chunk [v0, v0 + vc), each one GEMM
// main loop of hopper.cuh (128 x 256 tiles in bf16, 128 x 128 in f32, a
// ring of TMA-fed stages, wgmma, a producer warpgroup and two consumers),
// with a scratch of dlog between them:
//   1. dlog: S = x · W[:, chunk]; in the consumers' registers each score
//      becomes dlog = g · (p - onehot), p recomputed from the saved lse, 0
//      past the chunk's columns and on ignored rows, and is stored;
//   2. dx: dx (+)= dlog · W[:, chunk]^T; the first chunk stores, each
//      later one adds its product to dx in its epilogue, chunk after
//      chunk;
//   3. dW: dW[:, chunk] = x^T · dlog, the tokens the contraction; each
//      chunk owns its columns and stores them once.
// No atomics and no pre-zeroed outputs: each output element has one
// writer a launch and the launches run in stream order, so a call gives
// the same bits from run to run.
// - bf16 (ce_dlog_kernel, ce_dx_kernel, ce_dw_kernel, on gemm_pipeline):
//   dlog rounded to bf16 as JAX's kernels round it (cross_entropy.py:127,
//   :157) into a scratch (N, ld), ld = vc rounded up to 8 (the padding
//   written as 0), which TMA reads; x and W's chunk are read where they
//   lie, x K-major in 1 and MN-major in 3 (as #29 tgmm reads x), W's
//   columns MN-major in 1 and its rows K-major in 2 (as #2's TN), the
//   scratch K-major in 2 and MN-major in 3. The chunk (ops/cross_entropy.py
//   bwd_vocab_chunk, from N, D and V alone) is the whole vocab where the
//   scratch of N · ld values fits in D · V (half the bytes of the f32 dW
//   the call returns; 134 MB at N = D = 2048, V = 32768), else the widest
//   multiple of 256 columns that fits. An operand whose rows TMA cannot
//   take (x where D % 8, W where V % 8) goes through the pipeline's copy
//   path, with W's row stride V apart from the chunk's width
//   (GemmOperand.ld).
// - f32 (ce_dlog_tf32_kernel, ce_dx_tf32_kernel, ce_dw_tf32_kernel, on
//   gemm_pipeline_tf32): split-TF32 products, three TF32 products a
//   product, the counterpart of the TPU's Precision.HIGHEST passes.
//   wgmma .tf32 reads both operands K-major only, so every operand comes
//   as hi and lo planes (csrc/split_tf32.cu) in the layout its product
//   needs: x as it is (1) and transposed (3), split once a call; W's chunk
//   transposed (1) and as it is (2), split once a chunk; dlog, split in
//   launch 1's epilogue, as it is (2) and transposed (3), in f32 (JAX's
//   f32 kernels round it to f32: a no-op). The scratch is about 16 (N +
//   D) bytes a chunk column (ops/cross_entropy.py bwd_vocab_chunk_f32: the
//   whole vocab where it fits in 2 D V values, twice the f32 dW, else the
//   widest multiple of 256 columns that does: 8192 columns, 537 MB, at N =
//   D = 2048, V = 32768). Its bound is 3 x 3 TF32 products of 2 N D V
//   (4997 µs at 495 TFLOP/s there, against 12308 on CUDA-core FMAs, above
//   the library's 11143: no FMA design can beat it); on the card its dx
//   and dW are held to at most twice the error of cuBLAS f32 (TF32 off)
//   against an f64 product (chip_smoke.py [train kernels]).
//
// The log2 tier (use_exp2, the bf16 default) scales the f32 score by
// log2(e) and uses exp2, as the TPU kernel does; the TPU kernel instead
// prescales x by log2(e) in x's dtype (rounding it to bf16) and folds ln 2
// into dW's cotangent. Scaling the f32 score computes the same function
// with one rounding less, and the outputs (loss, lse, dx, dW) are in
// natural units either way.
//
// What bounds it: 2·N·D·V flops a product (275 GFLOP at N = D = 2048, V =
// 32768), one in the forward and three in the backward, against N·D + D·V
// elements read (and in the backward the scratch, written once and read
// twice), so it is compute bound: the f32 forward on CUDA-core FMAs, the
// f32 backward on split-TF32 products, bf16 on the tensor cores (278 us at
// 989 TFLOP/s a product). The bf16 forward's epilogue adds two passes over
// the 128 accumulators (max, then exp2 and sum) and 12 bytes a row a vocab
// tile, under the next tile's loads.
//
// Registers (`-Xptxas -v`, nvcc 12.9, sm_90a; chip_smoke.py prints them
// from the build's nvcc.log) and dynamic shared memory per block, two
// blocks per SM:
//   ce_fwd_kernel      f32 128 registers, no spills; 77,824 B
//   ce_combine_kernel  32 registers, no shared memory
//   ce_fwd_wgmma_kernel 168 registers (the pipeline's launch bound, before
//                      its split), no spills with both operands by TMA;
//                      the copy-path instances spill 4-40 bytes
// The bf16 forward and backward kernels take gemm_pipeline's one block an
// SM (gemm_smem: 197,632 B with both operands by TMA, 203,776 B with a
// copy) and its register split (the producer warpgroup 40, the consumers
// 232); the f32 backward's gemm_pipeline_tf32's (197,632 B: 3 stages of
// 64 KiB).
#include "hopper.cuh"

namespace tk {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BN = 128;          // token rows of a score tile
constexpr int BV = 128;          // vocab columns of a score tile
constexpr int THREADS = 256;
constexpr int LDT = BV + 4;      // f32 score tile rows in shared memory
constexpr int TILE_BYTES = BN * LDT * 4;

static_assert(BN == F_BM && BV == F_BN && THREADS == F_THREADS,
              "tile shapes");

// shared memory of the score product's main loop
constexpr int STAGE_BYTES = 2 * F_BK * F_BM * 4;

// tile[r][c] = x[n0 + r] · W[:, v0 + c] in f32 (0 past N or V). Returns
// after a barrier, with the tile complete.
__device__ __forceinline__ void score_tile(const float* __restrict__ x,
                                           const float* __restrict__ w, int N,
                                           int D, int V, int n0, int v0,
                                           unsigned char* stage, float* tile) {
  const int tid = threadIdx.x;
  float acc[8][8];
  auto as = reinterpret_cast<float(*)[F_BM]>(stage);
  auto bs = reinterpret_cast<float(*)[F_BN]>(stage + F_BK * F_BM * 4);
  sgemm_tile<false>(x, w, N, V, D, n0, v0, as, bs, acc);
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = tile + sgemm_pos(i, ty) * LDT;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
}

// Block (blockIdx.x, blockIdx.y) = (row tile, vocab split). Each warp
// folds 16 rows of every score tile into the running (m, l, t) of those
// rows, a lane reading 4 columns of a row. m and l are in the tier's units
// (log2 for LOG2) and written as the natural max and the sum of
// exp(s - max); t is the raw target logit.
template <bool LOG2>
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const int* __restrict__ targets, float* __restrict__ part, int N,
              int D, int V, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);   // [BN][LDT]
  float* row_m = tile + BN * LDT;                 // [BN] running max
  float* row_l = row_m + BN;                      // [BN] running sum
  float* row_t = row_l + BN;                      // [BN] target logit
  int* row_tgt = reinterpret_cast<int*>(row_t + BN);
  unsigned char* stage = smem + TILE_BYTES + 4 * BN * 4;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, split = blockIdx.y;
  const int n_vt = (V + BV - 1) / BV;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, n_vt);
  if (tid < BN) {
    row_m[tid] = NEG_BIG;
    row_l[tid] = 0.f;
    row_t[tid] = 0.f;
    row_tgt[tid] = n0 + tid < N ? targets[n0 + tid] : -1;
  }

  const int c = lane * 4;
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * BV;
    __syncthreads();  // the previous tile is folded
    score_tile(x, w, N, D, V, n0, v0, stage, tile);
    for (int rr = 0; rr < BN / 8; ++rr) {
      const int r = warp * (BN / 8) + rr;
      const float4 v4 = *reinterpret_cast<const float4*>(&tile[r * LDT + c]);
      float s[4] = {v4.x, v4.y, v4.z, v4.w};
      const int tcol = row_tgt[r] - v0;
      float mx = NEG_BIG;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e == tcol) row_t[r] += s[e];  // one lane of one tile
        s[e] = v0 + c + e < V ? (LOG2 ? s[e] * LOG2E : s[e]) : NEG_BIG;
        mx = fmaxf(mx, s[e]);
      }
      mx = warp_max(mx);
      const float m_old = row_m[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum += LOG2 ? exp2f(s[e] - m_new) : expf(s[e] - m_new);
      sum = warp_sum(sum);  // every lane has read row_m[r] by now
      if (lane == 0) {
        const float alpha = LOG2 ? exp2f(m_old - m_new) : expf(m_old - m_new);
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < N) {
    float* p = part + (int64_t)split * 3 * N + n0 + tid;
    p[0] = LOG2 ? row_m[tid] * LN2 : row_m[tid];
    p[N] = row_l[tid];
    p[2 * N] = row_t[tid];
  }
}

// One thread per token: merge the row's n_split partials.
__global__ void ce_combine_kernel(const float* __restrict__ part,
                                  const int* __restrict__ targets,
                                  float* __restrict__ loss,
                                  float* __restrict__ lse, int N, int n_split) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = NEG_BIG;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part[(int64_t)s * 3 * N + n]);
  float l = 0.f, t = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* p = part + (int64_t)s * 3 * N + n;
    l += p[N] * expf(p[0] - m);
    t += p[2 * N];
  }
  const float z = m + logf(l);
  lse[n] = z;
  loss[n] = targets[n] < 0 ? 0.f : z - t;
}

// ------------------------------------------------------- bf16 backward
// gemm_pipeline's epilogue layout: a consumer thread's first row of the
// tile at m0 (its second lies 8 on) and its first column of the tile at
// n0 (pair j of its columns, j = 0..31, starts 8 j on). Pair j of row h
// (0, 1) holds d[4 j + 2 h] and d[4 j + 2 h + 1].
__device__ __forceinline__ int tile_row(int m0) {
  const int tid = threadIdx.x;
  return m0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
}
__device__ __forceinline__ int tile_col(int n0) {
  return n0 + 2 * (threadIdx.x & 3);
}

// The tile d (NA accumulators a thread: 2 NA columns) into rows m0.. < M
// and columns n0.. < cols of the f32 matrix c (row stride ldc): stored, or
// added to what c holds (add). Column
// pairs in one 8-byte access where ldc is even and c 8-byte aligned.
template <int NA>
__device__ __forceinline__ void store_f32(const float (&d)[NA], float* c,
                                          int64_t ldc, int M, int cols,
                                          int m0, int n0, bool add) {
  const int r0 = tile_row(m0), c0 = tile_col(n0);
  const bool pairs = ldc % 2 == 0 && reinterpret_cast<uintptr_t>(c) % 8 == 0;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = c0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M || col >= cols) continue;
      float* p = c + r * ldc + col;
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && col + 1 < cols) {
        if (add) {
          const float2 o = *reinterpret_cast<const float2*>(p);
          v0 = o.x + v0;
          v1 = o.y + v1;
        }
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = add ? p[0] + v0 : v0;
        if (col + 1 < cols) p[1] = add ? p[1] + v1 : v1;
      }
    }
  }
}

// Launch 1: the chunk's scores S = x · W[:, v0 .. v0 + vc), a 128 x 256
// tile a block, turned into dlog in the epilogue and stored as bf16 to
// dlog (N, ld), columns [vc, ld) as zeros.
template <bool TMA_X, bool TMA_W>
__global__ void __launch_bounds__(GP_THREADS, 1)
ce_dlog_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const bf16* __restrict__ x, const bf16* __restrict__ w,
               const int* __restrict__ targets,
               const float* __restrict__ lse, const float* __restrict__ g,
               bf16* __restrict__ dlog, int N, int D, int V, int v0, int vc,
               int ld, int log2) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * GP_BN;
  // x (N, D) K-major; the chunk's columns of W (D, V) MN-major, D its rows
  gemm_pipeline<false, true, TMA_X, TMA_W, false>(
      &map_x, &map_w, GemmOperand{x, N, D, m0},
      GemmOperand{w + v0, D, vc, n0, -1, 0, V}, 0, D,
      [&](const float (&d)[128]) {
        const int r0 = tile_row(m0), c0 = tile_col(n0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= N) continue;
          // the target's column in the chunk; an ignored row keeps no
          // gradient
          const int tgt = targets[r];
          const bool keep = tgt >= 0;
          const float gr = keep ? g[r] : 0.f;
          const float z = log2 ? lse[r] * LOG2E : lse[r];
          bf16* row = dlog + (int64_t)r * ld;
#pragma unroll
          for (int j = 0; j < GP_BN / 8; ++j) {
            const int c = c0 + 8 * j;  // even, and ld is even
            if (c >= ld) continue;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s = d[4 * j + 2 * h + e];
              const float p = log2 ? exp2f(s * LOG2E - z) : expf(s - z);
              const float one = v0 + c + e == tgt ? 1.f : 0.f;
              v[e] = keep && c + e < vc ? (p - one) * gr : 0.f;
            }
            *reinterpret_cast<__nv_bfloat162*>(row + c) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      });
}

// The bf16 forward: the scores S = x · W of the 128 x 256 tile (tm, tn),
// folded in the epilogue into each row's partial (m, l, t) of vocab tile
// tn: m the max in natural units, l the sum of exp(s - m) (exp2 of the
// scores scaled by log2 e in the log2 tier), t the raw target logit (0 if
// the target lies in another tile or is ignored). part is (cdiv(V, 256),
// 3, N).
template <bool TMA_X, bool TMA_W>
__global__ void __launch_bounds__(GP_THREADS, 1)
ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ targets, float* __restrict__ part,
                    int N, int D, int V, int log2) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * GP_BN;
  // x (N, D) K-major; W (D, V) MN-major, D its rows
  gemm_pipeline<false, true, TMA_X, TMA_W, false>(
      &map_x, &map_w, GemmOperand{x, N, D, m0},
      GemmOperand{w, D, V, n0, -1, 0, V}, 0, D,
      [&](const float (&d)[128]) {
        const int r0 = tile_row(m0), c0 = tile_col(n0);
        const float k = log2 ? LOG2E : 1.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // every lane of the quad takes part in the shuffles, rows past
          // N too; only the writes are masked
          const int r = r0 + 8 * h;
          const int tgt = r < N ? targets[r] : -1;
          float mx = NEG_BIG, t = 0.f;
#pragma unroll
          for (int j = 0; j < GP_BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + 8 * j + e;
              const float s = d[4 * j + 2 * h + e];
              if (c == tgt) t = s;
              mx = fmaxf(mx, c < V ? s * k : NEG_BIG);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // the tile's first column is < V, so mx is a score's
          float l = 0.f;
          auto fold = [&](auto ex) {
#pragma unroll
            for (int j = 0; j < GP_BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float u = c0 + 8 * j + e < V
                                    ? d[4 * j + 2 * h + e] * k : NEG_BIG;
                l += ex(u - mx);
              }
          };
          if (log2) fold([](float a) { return exp2f(a); });
          else fold([](float a) { return expf(a); });
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          t += __shfl_xor_sync(0xffffffffu, t, 1);
          t += __shfl_xor_sync(0xffffffffu, t, 2);
          if ((threadIdx.x & 3) == 0 && r < N) {
            float* p = part + (int64_t)tn * 3 * N + r;
            p[0] = log2 ? mx * LN2 : mx;
            p[N] = l;
            p[2 * N] = t;
          }
        }
      });
}

// Launch 2: dx (N, D) (+)= dlog (N, vc) · W[:, v0 .. v0 + vc)^T, a 128 x
// 256 tile of dx a block; add: this chunk's product joins the earlier
// chunks' sum.
template <bool TMA_W>
__global__ void __launch_bounds__(GP_THREADS, 1)
ce_dx_kernel(const __grid_constant__ CUtensorMap map_s,
             const __grid_constant__ CUtensorMap map_w,
             const bf16* __restrict__ dlog, const bf16* __restrict__ w,
             float* __restrict__ dx, int N, int D, int V, int v0, int vc,
             int ld, int add) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * GP_BN;
  // the scratch K-major (always by TMA); W's rows, the chunk's columns,
  // K-major
  gemm_pipeline<false, false, true, TMA_W, false>(
      &map_s, &map_w, GemmOperand{dlog, N, vc, m0, -1, 0, ld},
      GemmOperand{w + v0, D, vc, n0, -1, 0, V}, 0, vc,
      [&](const float (&d)[128]) { store_f32(d, dx, D, N, D, m0, n0, add); });
}

// Launch 3: dW[:, v0 .. v0 + vc) = x^T · dlog, a 128 x 256 tile of dW a
// block, over all N tokens.
template <bool TMA_X>
__global__ void __launch_bounds__(GP_THREADS, 1)
ce_dw_kernel(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_s,
             const bf16* __restrict__ x, const bf16* __restrict__ dlog,
             float* __restrict__ dw, int N, int D, int V, int v0, int vc,
             int ld) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * GP_BN;
  // x (N, D) and the scratch (N, vc) MN-major, the tokens their rows;
  // the maps end at row N, so the last slab's rows past it are zeros
  gemm_pipeline<true, true, TMA_X, true, false>(
      &map_x, &map_s, GemmOperand{x, N, D, m0},
      GemmOperand{dlog, N, vc, n0, -1, 0, ld}, 0, N,
      [&](const float (&d)[128]) {
        store_f32(d, dw + v0, V, D, vc, m0, n0, false);
      });
}

// ------------------------------------------------------- f32 backward
// Launch 1 of the f32 backward: the chunk's scores S = x · W[:, v0 .. v0
// + vc) on the split-TF32 pipeline (x's planes (N, D) and the chunk's
// transposed planes (vc, D), both K-major), turned in the epilogue into
// dlog = g · (p - onehot) in f32, p recomputed from the saved lse, 0 on
// ignored rows; split, and stored as the planes of dlog (N, ldv), V
// contiguous (launch 2's A), and of its transpose (vc, ldn), N contiguous
// (launch 3's B). Their padding columns are never read: the maps end at
// vc and N.
__global__ void __launch_bounds__(GP_THREADS, 1)
ce_dlog_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const int* __restrict__ targets,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ dl, float* __restrict__ dlt, int N,
                    int D, int v0, int vc, int ldv, int ldn, int log2) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * TF_BN;
  gemm_pipeline_tf32(
      &map_x, &map_w, m0, n0, 0, D, [&](const float (&d)[64]) {
        const int r0 = tile_row(m0), c0 = tile_col(n0);
        const int64_t pv = (int64_t)N * ldv, pt = (int64_t)vc * ldn;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= N) continue;
          // the target's column in the chunk; an ignored row keeps no
          // gradient
          const int tgt = targets[r];
          const bool keep = tgt >= 0;
          const float gr = keep ? g[r] : 0.f;
          const float z = log2 ? lse[r] * LOG2E : lse[r];
#pragma unroll
          for (int j = 0; j < TF_BN / 8; ++j) {
            const int c = c0 + 8 * j;  // even, and ldv is a multiple of 4
            if (c >= vc) continue;
            float hi[2], lo[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s = d[4 * j + 2 * h + e];
              const float p = log2 ? exp2f(s * LOG2E - z) : expf(s - z);
              const float one = v0 + c + e == tgt ? 1.f : 0.f;
              split_tf32(keep && c + e < vc ? (p - one) * gr : 0.f, hi[e],
                         lo[e]);
            }
            float* row = dl + (int64_t)r * ldv + c;
            *reinterpret_cast<float2*>(row) = make_float2(hi[0], hi[1]);
            *reinterpret_cast<float2*>(row + pv) = make_float2(lo[0], lo[1]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (c + e >= vc) break;
              dlt[(int64_t)(c + e) * ldn + r] = hi[e];
              dlt[pt + (int64_t)(c + e) * ldn + r] = lo[e];
            }
          }
        }
      });
}

// Launch 2: dx (N, D) (+)= dlog (N, vc) · W[:, v0 .. v0 + vc)^T, a 128 x
// 128 tile of dx a block: dlog's planes K-major, the chunk's planes (D,
// vc) K-major (W's rows); add: this chunk's product joins the earlier
// chunks' sum.
__global__ void __launch_bounds__(GP_THREADS, 1)
ce_dx_tf32_kernel(const __grid_constant__ CUtensorMap map_s,
                  const __grid_constant__ CUtensorMap map_w,
                  float* __restrict__ dx, int N, int D, int vc, int add) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * TF_BN;
  gemm_pipeline_tf32(
      &map_s, &map_w, m0, n0, 0, vc, [&](const float (&d)[64]) {
        store_f32(d, dx, D, N, D, m0, n0, add);
      });
}

// Launch 3: dW[:, v0 .. v0 + vc) = x^T · dlog, a 128 x 128 tile of dW a
// block, over all N tokens: x's transposed planes (D, N) and dlog's (vc,
// N), both K-major.
__global__ void __launch_bounds__(GP_THREADS, 1)
ce_dw_tf32_kernel(const __grid_constant__ CUtensorMap map_xt,
                  const __grid_constant__ CUtensorMap map_st,
                  float* __restrict__ dw, int N, int D, int V, int vc) {
  int tm, tn;
  gemm_tile_order(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y, gridDim.x,
                  tm, tn);
  const int m0 = tm * GP_BM, n0 = tn * TF_BN;
  gemm_pipeline_tf32(
      &map_xt, &map_st, m0, n0, 0, N, [&](const float (&d)[64]) {
        store_f32(d, dw, V, D, vc, m0, n0, false);
      });
}

// the f32 kernels' launch: gemm_pipeline_tf32's shared memory
template <typename Kernel, typename... Args>
cudaError_t launch_tf32(Kernel kernel, dim3 grid, cudaStream_t stream,
                        Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TF_SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, GP_THREADS, TF_SMEM, stream>>>(args...);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch_gp(Kernel kernel, bool copy, dim3 grid, cudaStream_t stream,
                      Args... args) {
  const int smem = gemm_smem(copy);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, GP_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool LOG2>
cudaError_t fwd_f32(const float* x, const float* w, const int* targets,
                    float* part, int N, int D, int V, int n_split,
                    int tiles_per_split, cudaStream_t stream) {
  constexpr int bytes = TILE_BYTES + 4 * BN * 4 + STAGE_BYTES;
  auto kernel = ce_fwd_kernel<LOG2>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, n_split);
  kernel<<<grid, THREADS, bytes, stream>>>(x, w, targets, part, N, D, V,
                                           tiles_per_split);
  return cudaSuccess;
}

// the bf16 forward: one partial a 256-column vocab tile
cudaError_t fwd_bf16(const bf16* x, const bf16* w, const int* targets,
                     float* part, int N, int D, int V, int log2,
                     cudaStream_t stream) {
  const dim3 grid((V + GP_BN - 1) / GP_BN, (N + GP_BM - 1) / GP_BM);
  if (grid.y > 65535 || !aligned16(x) || !aligned16(w))
    return cudaErrorInvalidValue;
  // each operand by TMA where its rows are whole 16-byte chunks, else by
  // the producer's copy
  const bool tma_x = D % 8 == 0, tma_w = V % 8 == 0;
  CUtensorMap xk{}, wm{};
  cudaError_t e = cudaSuccess;
  if (tma_x) e = tma_map_bf16(&xk, x, D, N, D * 2, GP_BK, GP_BM);
  if (e == cudaSuccess && tma_w)
    e = tma_map_bf16(&wm, w, V, D, (int64_t)V * 2, 64, GP_BK);
  if (e != cudaSuccess) return e;
  if (tma_x && tma_w)
    return launch_gp(ce_fwd_wgmma_kernel<true, true>, false, grid, stream, xk,
                     wm, x, w, targets, part, N, D, V, log2);
  if (tma_x)
    return launch_gp(ce_fwd_wgmma_kernel<true, false>, true, grid, stream, xk,
                     wm, x, w, targets, part, N, D, V, log2);
  if (tma_w)
    return launch_gp(ce_fwd_wgmma_kernel<false, true>, true, grid, stream, xk,
                     wm, x, w, targets, part, N, D, V, log2);
  return launch_gp(ce_fwd_wgmma_kernel<false, false>, true, grid, stream, xk,
                   wm, x, w, targets, part, N, D, V, log2);
}

}  // namespace

cudaError_t ce_fwd_launch(const void* x, const void* w, const int* targets,
                          float* part, int N, int D, int V, int n_split,
                          int tiles_per_split, int log2, int dtype,
                          cudaStream_t stream) {
  // the vocab tiles of a split: f32 BV columns, bf16 GP_BN
  const int n_vt = (V + (dtype == kBF16 ? GP_BN : BV) - 1) /
                   (dtype == kBF16 ? GP_BN : BV);
  if (N < 0 || D <= 0 || V <= 0 || n_split <= 0 || tiles_per_split <= 0 ||
      (n_split - 1) * tiles_per_split >= n_vt ||
      n_split * tiles_per_split < n_vt || n_split > 65535)
    return cudaErrorInvalidValue;  // every split needs a tile, every tile a split
  if (dtype == kBF16 && tiles_per_split != 1)
    return cudaErrorInvalidValue;  // bf16: one split a vocab tile
  if (N == 0) return cudaSuccess;
  const float* fx = static_cast<const float*>(x);
  const float* fw = static_cast<const float*>(w);
  if (dtype == kF32)
    return log2 ? fwd_f32<true>(fx, fw, targets, part, N, D, V, n_split,
                                tiles_per_split, stream)
                : fwd_f32<false>(fx, fw, targets, part, N, D, V, n_split,
                                 tiles_per_split, stream);
  if (dtype == kBF16)
    return fwd_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                    targets, part, N, D, V, log2, stream);
  return cudaErrorInvalidValue;
}

cudaError_t ce_combine_launch(const float* part, const int* targets,
                              float* loss, float* lse, int N, int n_split,
                              cudaStream_t stream) {
  if (N < 0 || n_split <= 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, targets, loss,
                                                         lse, N, n_split);
  return cudaSuccess;
}

cudaError_t ce_bwd_launch(const float* x, const float* w, const int* targets,
                          const float* lse, const float* g, float* dx,
                          float* dw, float* xs, float* ws, float* ds, int N,
                          int D, int V, int v0, int vc, int add, int split_x,
                          int log2, int* passes, cudaStream_t stream) {
  const dim3 g1((vc + TF_BN - 1) / TF_BN, (N + GP_BM - 1) / GP_BM);
  const dim3 g2((D + TF_BN - 1) / TF_BN, (N + GP_BM - 1) / GP_BM);
  const dim3 g3((vc + TF_BN - 1) / TF_BN, (D + GP_BM - 1) / GP_BM);
  if (N <= 0 || D <= 0 || vc <= 0 || v0 < 0 || v0 + vc > V || g1.y > 65535 ||
      g3.y > 65535 || !aligned16(xs) || !aligned16(ws) || !aligned16(ds))
    return cudaErrorInvalidValue;
  auto r4 = [](int n) { return (int64_t)(n + 3) / 4 * 4; };
  const int64_t d4 = r4(D), n4 = r4(N), c4 = r4(vc);
  float* xk = xs;                 // x's planes (2, N, d4)
  float* xt = xk + 2 * N * d4;    // x^T's (2, D, n4)
  float* wt = ws;                 // W[:, chunk]^T's (2, vc, d4)
  float* wk = wt + 2 * vc * d4;   // W[:, chunk]'s (2, D, c4)
  float* dl = ds;                 // dlog's (2, N, c4)
  float* dlt = dl + 2 * N * c4;   // dlog^T's (2, vc, n4)
  cudaError_t e = cudaSuccess;
  if (split_x)
    e = split_tf32_launch(x, N, D, D, xk, d4, xt, n4, passes, stream);
  if (e == cudaSuccess)
    e = split_tf32_launch(w + v0, D, vc, V, wk, c4, wt, d4, passes, stream);
  CUtensorMap mx{}, mw{}, ms{}, mwk{}, mxt{}, mst{};
  auto map = [&](CUtensorMap* m, const float* p, int K, int rows, int64_t ld,
                 int box) {
    if (e == cudaSuccess) e = tma_map_planes(m, p, K, rows, ld, box);
  };
  map(&mx, xk, D, N, d4, GP_BM);     // launch 1's A
  map(&mw, wt, D, vc, d4, TF_BN);    // launch 1's B
  map(&ms, dl, vc, N, c4, GP_BM);    // launch 2's A
  map(&mwk, wk, vc, D, c4, TF_BN);   // launch 2's B
  map(&mxt, xt, N, D, n4, GP_BM);    // launch 3's A
  map(&mst, dlt, N, vc, n4, TF_BN);  // launch 3's B
  if (e != cudaSuccess) return e;
  e = launch_tf32(ce_dlog_tf32_kernel, g1, stream, mx, mw, targets, lse, g,
                  dl, dlt, N, D, v0, vc, (int)c4, (int)n4, log2);
  if (e != cudaSuccess) return e;
  e = launch_tf32(ce_dx_tf32_kernel, g2, stream, ms, mwk, dx, N, D, vc, add);
  if (e != cudaSuccess) return e;
  return launch_tf32(ce_dw_tf32_kernel, g3, stream, mxt, mst, dw + v0, N, D,
                     V, vc);
}

cudaError_t ce_bwd_chunk_launch(const void* x, const void* w,
                                const int* targets, const float* lse,
                                const float* g, float* dx, float* dw,
                                void* dlog, int N, int D, int V, int v0,
                                int vc, int add, int log2,
                                cudaStream_t stream) {
  const int ld = (vc + 7) / 8 * 8;
  const dim3 g1((vc + GP_BN - 1) / GP_BN, (N + GP_BM - 1) / GP_BM);
  const dim3 g2((D + GP_BN - 1) / GP_BN, (N + GP_BM - 1) / GP_BM);
  const dim3 g3((vc + GP_BN - 1) / GP_BN, (D + GP_BM - 1) / GP_BM);
  // a chunk starts on a 16-byte boundary of W's rows
  if (N <= 0 || D <= 0 || vc <= 0 || v0 < 0 || v0 % 8 || v0 + vc > V ||
      g1.y > 65535 || g3.y > 65535 || !aligned16(x) || !aligned16(w) ||
      !aligned16(dlog))
    return cudaErrorInvalidValue;
  const bf16* hx = static_cast<const bf16*>(x);
  const bf16* hw = static_cast<const bf16*>(w);
  const bf16* hc = hw + v0;  // the chunk's first column
  const bf16* hs = static_cast<const bf16*>(dlog);
  // x by TMA where its rows are whole 16-byte chunks, W's likewise (the
  // chunk's base is aligned), else by the producer's copy; the scratch's
  // rows always are
  const bool tma_x = D % 8 == 0, tma_w = V % 8 == 0;
  CUtensorMap xk{}, xm{}, wm{}, wk{}, sk{}, sm{};
  cudaError_t e = cudaSuccess;
  auto map = [&](CUtensorMap* m, const bf16* p, int inner, int outer,
                 int64_t row, uint32_t bi, uint32_t bo) {
    if (e == cudaSuccess) e = tma_map_bf16(m, p, inner, outer, row * 2, bi, bo);
  };
  if (tma_x) {
    map(&xk, hx, D, N, D, GP_BK, GP_BM);  // K-major A of launch 1
    map(&xm, hx, D, N, D, 64, GP_BK);     // MN-major A of launch 3
  }
  if (tma_w) {
    map(&wm, hc, vc, D, V, 64, GP_BK);     // MN-major B of launch 1
    map(&wk, hc, vc, D, V, GP_BK, GP_BN);  // K-major B of launch 2
  }
  map(&sk, hs, vc, N, ld, GP_BK, GP_BM);  // K-major A of launch 2
  map(&sm, hs, vc, N, ld, 64, GP_BK);     // MN-major B of launch 3
  if (e != cudaSuccess) return e;
  bf16* s = static_cast<bf16*>(dlog);
  if (tma_x && tma_w)
    e = launch_gp(ce_dlog_kernel<true, true>, false, g1, stream, xk, wm, hx,
                  hw, targets, lse, g, s, N, D, V, v0, vc, ld, log2);
  else if (tma_x)
    e = launch_gp(ce_dlog_kernel<true, false>, true, g1, stream, xk, wm, hx,
                  hw, targets, lse, g, s, N, D, V, v0, vc, ld, log2);
  else if (tma_w)
    e = launch_gp(ce_dlog_kernel<false, true>, true, g1, stream, xk, wm, hx,
                  hw, targets, lse, g, s, N, D, V, v0, vc, ld, log2);
  else
    e = launch_gp(ce_dlog_kernel<false, false>, true, g1, stream, xk, wm, hx,
                  hw, targets, lse, g, s, N, D, V, v0, vc, ld, log2);
  if (e != cudaSuccess) return e;
  e = tma_w ? launch_gp(ce_dx_kernel<true>, false, g2, stream, sk, wk, hs,
                        hw, dx, N, D, V, v0, vc, ld, add)
            : launch_gp(ce_dx_kernel<false>, true, g2, stream, sk, wk, hs,
                        hw, dx, N, D, V, v0, vc, ld, add);
  if (e != cudaSuccess) return e;
  return tma_x ? launch_gp(ce_dw_kernel<true>, false, g3, stream, xm, sm, hx,
                           hs, dw, N, D, V, v0, vc, ld)
               : launch_gp(ce_dw_kernel<false>, true, g3, stream, xm, sm, hx,
                           hs, dw, N, D, V, v0, vc, ld);
}

}  // namespace tk
