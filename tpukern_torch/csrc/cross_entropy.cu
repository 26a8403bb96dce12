// Fused LM-head cross-entropy: per token n, loss = lse(x[n] · W) - (x[n] ·
// W)[target[n]], and its gradients, without the (N, V) logits ever
// reaching device memory. x is (N, D), W is (D, V), both row-major and of
// one dtype; targets < 0 are ignored (loss 0, gradient 0).
//
// Replaces tpukern/ops/cross_entropy.py:
//   `_ce_fwd_kernel` (:53)  -> ce_fwd_kernel + ce_combine_kernel (#13)
//   `_ce_dx_kernel` (:95)   -> ce_bwd_fma_kernel (f32), ce_bwd_mma_kernel
//                              (bf16) (#14)
//   `_ce_dw_kernel` (:132)  -> the same backward kernels (#15)
//
// Score tiles. Every kernel forms 128 x 128 tiles S = x[n0..] · W[:, v0..]
// with common.cuh's GEMM main loops (f32 inputs on CUDA-core FMAs in full
// f32, as the JAX f32 tier's Precision.HIGHEST; bf16 inputs on mma.sync
// with f32 accumulation). The forward and the f32 backward put each tile
// into shared memory as f32, where the reductions read it in a layout of
// their own; the bf16 backward forms dlog from the accumulators. Columns
// past V are set to NEG_BIG (forward) or their gradient to 0 (backward)
// after the arithmetic, never multiplied in: 0 * garbage would be NaN.
//
// Forward. The TPU kernel gives one grid row to each token block and walks
// all of V in order; at N = 2048 that is 16 blocks for 132 SMs. Here V is
// split too: block (row tile, split) walks `tiles_per_split` vocab tiles
// with an online (max, sum) per row, as the TPU kernel does, plus the
// target logit, and writes the three as a partial. ce_combine_kernel then
// merges a row's partials (the lse merge of flash_attention_splitkv,
// tpukern/ops/attention.py:1162) into its loss and natural-log lse. The
// partials are (n_split, 3, N) floats, n_split bounded by the SM count.
//
// Backward, design (b): one block per (row tile, vocab tile) recomputes
// the score tile once, forms dlog = g · (softmax - onehot) in shared
// memory from the saved lse, and adds both of its contributions with f32
// atomicAdd into zeroed f32 outputs: dx[n0.., :] += dlog · W[:, v0..]^T and
// dW[:, v0..] += x[n0.., :]^T · dlog. On the TPU each output block is
// resident in VMEM across the other axis; here a 128-row dx block is 1 MiB,
// beyond a block's shared memory, and giving each output tile an owner
// would recompute the score tile once per 128-wide D chunk. So #14 and
// #15 share one recompute: 3 D-deep products per tile instead of 4, and no
// buffer that grows with N·V. The atomics make the summation order vary
// from run to run; the tests compare with the plain version at a
// tolerance, never two kernel runs bit for bit. Each block starts its D
// loop at a chunk of its own, so the blocks of one row tile (or one vocab
// tile) that run together add into different addresses.
//
// The log2 tier (use_exp2, the bf16 default) scales the f32 score by
// log2(e) and uses exp2, as the TPU kernel does; the TPU kernel instead
// prescales x by log2(e) in x's dtype (rounding it to bf16) and folds ln 2
// into dW's cotangent. Scaling the f32 score computes the same function
// with one rounding less, and the outputs (loss, lse, dx, dW) are in
// natural units either way.
//
// What bounds it: 2·N·D·V flops per score tile pass (275 GFLOP at N = D =
// 2048, V = 32768) against N·D + D·V elements read, so it is compute
// bound. f32 runs on CUDA-core FMAs, bf16 on the tensor cores, the
// backward's dx and dW products included (dlog rounded to bf16 as the TPU
// kernels round it). cp.async/TMA/wgmma are a later PR's work.
//
// Registers (`-Xptxas -v`, nvcc 12.9, sm_90a; chip_smoke.py prints them
// from the build's nvcc.log) and dynamic shared memory per block, two
// blocks per SM:
//   ce_fwd_kernel      f32 128, bf16 123 registers, no spills;
//                      77,824 B (f32), 88,576 B (bf16)
//   ce_combine_kernel  32 registers, no shared memory
//   ce_bwd_fma_kernel  128 registers, a 360 B stack frame (448 B spill
//                      stores, 1,288 B spill loads); 77,824 B
//   ce_bwd_mma_kernel  128 registers, no spills; 71,168 B
#include <type_traits>

#include "common.cuh"

namespace tk {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BN = 128;          // token rows of a score tile
constexpr int BV = 128;          // vocab columns of a score tile
constexpr int THREADS = 256;
constexpr int LDT = BV + 4;      // f32 score tile rows in shared memory
constexpr int TILE_BYTES = BN * LDT * 4;

static_assert(BN == F_BM && BV == F_BN && BN == H_BM && BV == H_BN &&
              THREADS == F_THREADS && THREADS == H_THREADS, "tile shapes");

// shared memory of the score product's main loop
template <typename T>
constexpr int stage_bytes() {
  return std::is_same<T, float>::value ? 2 * F_BK * F_BM * 4
                                       : (H_BM * H_LDK + H_BK * H_LDN) * 2;
}

// tile[r][c] = x[n0 + r] · W[:, v0 + c] in f32 (0 past N or V). Returns
// after a barrier, with the tile complete.
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ x,
                                           const T* __restrict__ w, int N,
                                           int D, int V, int n0, int v0,
                                           unsigned char* stage, float* tile) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
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
  } else {
    float acc[4][4][4];
    bf16* as = reinterpret_cast<bf16*>(stage);
    bf16* bs = as + H_BM * H_LDK;
    hgemm_tile<false>(x, w, N, V, D, n0, v0, D % 8 == 0, V % 8 == 0, as, bs,
                      acc);
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile[hgemm_row(warp, mt, lane >> 2, e) * LDT +
               hgemm_col(warp, nt, lane & 3, e)] = acc[mt][nt][e];
  }
  __syncthreads();
}

// Block (blockIdx.x, blockIdx.y) = (row tile, vocab split). Each warp
// folds 16 rows of every score tile into the running (m, l, t) of those
// rows, a lane reading 4 columns of a row. m and l are in the tier's units
// (log2 for LOG2) and written as the natural max and the sum of
// exp(s - max); t is the raw target logit.
template <typename T, bool LOG2>
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
    score_tile<T>(x, w, N, D, V, n0, v0, stage, tile);
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

// The backward's per-row state: the saved lse in the tier's units, the
// cotangent (0 where the target is ignored or the row is past N), and
// the target.
__device__ __forceinline__ void load_rows(const int* __restrict__ targets,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ g, int N,
                                          int n0, bool log2, float* row_lse,
                                          float* row_g, int* row_tgt) {
  const int tid = threadIdx.x;
  if (tid < BN) {
    const int n = n0 + tid;
    const int tg = n < N ? targets[n] : -1;
    row_tgt[tid] = tg;
    row_lse[tid] = n < N ? (log2 ? lse[n] * LOG2E : lse[n]) : 0.f;
    row_g[tid] = tg >= 0 ? g[n] : 0.f;
  }
}

// dlog = g · (p - onehot) of score s at tile row r, vocab column v, p
// recomputed from the saved lse. Padded rows have g = 0 and finite p;
// columns past V are zeroed after the arithmetic.
template <bool LOG2>
__device__ __forceinline__ float dlog_of(float s, int r, int v, int V,
                                         const float* row_lse,
                                         const float* row_g,
                                         const int* row_tgt) {
  const float p = LOG2 ? exp2f(s * LOG2E - row_lse[r]) : expf(s - row_lse[r]);
  const float d = (p - (v == row_tgt[r] ? 1.f : 0.f)) * row_g[r];
  return v < V ? d : 0.f;
}

// row[col..col+3] += v for the columns < cols: one 16-byte reduction
// where all four are in and `vec` (cols % 4 == 0: the address is aligned)
__device__ __forceinline__ void atomic_add4(float* row, int col, int cols,
                                            bool vec, float4 v) {
  if (vec && col + 4 <= cols) {
    atomicAdd(reinterpret_cast<float4*>(row + col), v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (col + k < cols) atomicAdd(row + col + k, e[k]);
}

// the same for two columns (cols % 2 == 0 for the 8-byte reduction)
__device__ __forceinline__ void atomic_add2(float* row, int col, int cols,
                                            bool vec, float a, float b) {
  if (vec && col + 2 <= cols) {
    atomicAdd(reinterpret_cast<float2*>(row + col), make_float2(a, b));
    return;
  }
  if (col < cols) atomicAdd(row + col, a);
  if (col + 1 < cols) atomicAdd(row + col + 1, b);
}

// Block (blockIdx.x, blockIdx.y) = (row tile, vocab tile): design (b)
// above, f32 inputs, every product on CUDA-core FMAs. dx and dW are
// zeroed f32 (N, D) and (D, V) accumulators.
template <bool LOG2>
__global__ void __launch_bounds__(THREADS, 2)
ce_bwd_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ targets,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  float* __restrict__ dx, float* __restrict__ dw, int N, int D,
                  int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);  // [BN][LDT]: S, then dlog
  float* row_lse = tile + BN * LDT;              // [BN], the tier's units
  float* row_g = row_lse + BN;                   // [BN], 0 where ignored
  int* row_tgt = reinterpret_cast<int*>(row_g + BN);
  unsigned char* stage = smem + TILE_BYTES + 4 * BN * 4;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * BN, v0 = blockIdx.y * BV;
  load_rows(targets, lse, g, N, n0, LOG2, row_lse, row_g, row_tgt);
  score_tile<float>(x, w, N, D, V, n0, v0, stage, tile);

  for (int i = tid; i < BN * BV; i += THREADS) {
    const int r = i / BV, c = i % BV;
    float* s = &tile[r * LDT + c];
    *s = dlog_of<LOG2>(*s, r, v0 + c, V, row_lse, row_g, row_tgt);
  }
  __syncthreads();

  const int n_dc = (D + F_BM - 1) / F_BM;
  float acc[8][8];

  // dx[n0 + m, d0 + j] += sum_k dlog[m][k] · W[d0 + j, v0 + k]: A from the
  // dlog tile read down a column (scalar, conflict-free: the 8 rows a warp
  // reads lie 4 rows apart), B = W's chunk staged [k][d]
  {
    float(*bs)[F_BN] = reinterpret_cast<float(*)[F_BN]>(stage);
    const int lr = tid >> 1, lk = (tid & 1) * 4;  // d row, 4 vocab columns
    float pb[4];
    for (int dc = 0; dc < n_dc; ++dc) {
      const int d0 = (dc + blockIdx.y) % n_dc * F_BM;
      auto fetch = [&](int k0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = d0 + lr, v = v0 + k0 + lk + e;
          pb[e] = d < D && v < V ? w[(int64_t)d * V + v] : 0.f;
        }
      };
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      fetch(0);
      for (int k0 = 0; k0 < BV; k0 += F_BK) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bs[lk + e][lr] = pb[e];
        __syncthreads();
        if (k0 + F_BK < BV) fetch(k0 + F_BK);
#pragma unroll
        for (int kk = 0; kk < F_BK; ++kk) {
          const float* a = tile + k0 + kk;
          fma_8x8(acc,
                  make_float4(a[(ty * 4) * LDT], a[(ty * 4 + 1) * LDT],
                              a[(ty * 4 + 2) * LDT], a[(ty * 4 + 3) * LDT]),
                  make_float4(a[(64 + ty * 4) * LDT], a[(65 + ty * 4) * LDT],
                              a[(66 + ty * 4) * LDT], a[(67 + ty * 4) * LDT]),
                  *reinterpret_cast<const float4*>(&bs[kk][tx * 4]),
                  *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]));
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + sgemm_pos(i, ty);
        if (n >= N) continue;
#pragma unroll
        for (int h = 0; h < 8; h += 4)  // columns sgemm_pos(h.., tx) adjoin
          atomic_add4(dx + (int64_t)n * D, d0 + sgemm_pos(h, tx), D,
                      D % 4 == 0,
                      make_float4(acc[i][h], acc[i][h + 1], acc[i][h + 2],
                                  acc[i][h + 3]));
      }
    }
  }

  // dW[d0 + m, v0 + j] += sum_k x[n0 + k, d0 + m] · dlog[k][j]: A = x's
  // chunk staged [k][d], B read from the dlog tile as float4
  {
    float(*as)[F_BM] = reinterpret_cast<float(*)[F_BM]>(stage);
    const int bk = tid >> 5, bc = (tid & 31) * 4;  // token row, 4 d columns
    float pa[4];
    for (int dc = 0; dc < n_dc; ++dc) {
      const int d0 = (dc + blockIdx.x) % n_dc * F_BM;
      auto fetch = [&](int k0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + k0 + bk, d = d0 + bc + e;
          pa[e] = n < N && d < D ? x[(int64_t)n * D + d] : 0.f;
        }
      };
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      fetch(0);
      for (int k0 = 0; k0 < BN; k0 += F_BK) {
#pragma unroll
        for (int e = 0; e < 4; ++e) as[bk][bc + e] = pa[e];
        __syncthreads();
        if (k0 + F_BK < BN) fetch(k0 + F_BK);
#pragma unroll
        for (int kk = 0; kk < F_BK; ++kk) {
          const float* b = tile + (k0 + kk) * LDT;
          fma_8x8(acc, *reinterpret_cast<const float4*>(&as[kk][ty * 4]),
                  *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]),
                  *reinterpret_cast<const float4*>(b + tx * 4),
                  *reinterpret_cast<const float4*>(b + 64 + tx * 4));
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = d0 + sgemm_pos(i, ty);
        if (d >= D) continue;
#pragma unroll
        for (int h = 0; h < 8; h += 4)
          atomic_add4(dw + (int64_t)d * V, v0 + sgemm_pos(h, tx), V,
                      V % 4 == 0,
                      make_float4(acc[i][h], acc[i][h + 1], acc[i][h + 2],
                                  acc[i][h + 3]));
      }
    }
  }
}

// Block (blockIdx.x, blockIdx.y) = (row tile, vocab tile): design (b)
// above, bf16 inputs, every product on the tensor cores (mma.sync
// m16n8k16, f32 accumulation, hgemm_tile's warp layout). dlog is formed
// from the score accumulators in registers and rounded to bf16 into
// shared memory, as JAX's kernels round it before their products
// (cross_entropy.py:127, :157). Then, for each 128-wide D chunk, the
// chunk of W (dx) or of x (dW) is staged whole as bf16 [128][LDB]:
//   dx[n0 + m, d0 + j] += sum_k dlog[m][k] · W[d0 + j, v0 + k]
//     (A = dlog, row-major; B^T = W's rows d0.., as hgemm_tile's TRANS_B)
//   dW[d0 + m, v0 + j] += sum_k x[n0 + k, d0 + m] · dlog[k][j]
//     (A^T = x's rows n0..; B = dlog, as hgemm_tile's NN)
// Fragments are read with 32-bit loads along k where the layout allows
// and packed from two 16-bit loads where it does not; both patterns are
// free of bank conflicts at LDB = BV + 8. Results go out as 8-byte
// atomic pairs (c0/c1 and c2/c3 of a fragment are adjacent columns).
constexpr int LDB = BV + 8;
constexpr int BF_TILE_BYTES = BN * LDB * 2;

template <bool LOG2>
__global__ void __launch_bounds__(THREADS, 2)
ce_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int* __restrict__ targets,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  float* __restrict__ dx, float* __restrict__ dw, int N, int D,
                  int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* row_lse = reinterpret_cast<float*>(smem);
  float* row_g = row_lse + BN;
  int* row_tgt = reinterpret_cast<int*>(row_g + BN);
  bf16* dl = reinterpret_cast<bf16*>(smem + 3 * BN * 4);  // [BN][LDB]
  // the score product's main loop, then the D chunks [128][LDB]
  bf16* stage = reinterpret_cast<bf16*>(smem + 3 * BN * 4 + BF_TILE_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * BN, v0 = blockIdx.y * BV;
  const bool vec_x = D % 8 == 0, vec_w = V % 8 == 0;
  load_rows(targets, lse, g, N, n0, LOG2, row_lse, row_g, row_tgt);

  float acc[4][4][4];
  // hgemm_tile opens with a barrier, so the rows above are visible after
  hgemm_tile<false>(x, w, N, V, D, n0, v0, vec_x, vec_w, stage,
                    stage + H_BM * H_LDK, acc);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = hgemm_row(warp, mt, gq, e), c = hgemm_col(warp, nt, t, e);
        *reinterpret_cast<__nv_bfloat162*>(&dl[r * LDB + c]) =
            __floats2bfloat162_rn(
                dlog_of<LOG2>(acc[mt][nt][e], r, v0 + c, V, row_lse, row_g,
                              row_tgt),
                dlog_of<LOG2>(acc[mt][nt][e + 1], r, v0 + c + 1, V, row_lse,
                              row_g, row_tgt));
      }

  const int n_dc = (D + BN - 1) / BN;
  auto u32 = [](const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); };
  auto zero = [&] {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  };

  // dx: the chunk is W[d0 + j, v0 + k] as [j][k]
  for (int dc = 0; dc < n_dc; ++dc) {
    const int d0 = (dc + blockIdx.y) % n_dc * BN;
    __syncthreads();  // dlog is complete; the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = tid + i * THREADS, r = ch >> 4, kc = (ch & 15) * 8;
      *reinterpret_cast<uint4*>(&stage[r * LDB + kc]) =
          load8(w, d0 + r, D, v0 + kc, V, vec_w);
    }
    __syncthreads();
    zero();
#pragma unroll
    for (int ks = 0; ks < BV / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* ap = &dl[(wm + mt * 16 + gq) * LDB + ks * 16 + 2 * t];
        af[mt][0] = u32(ap);
        af[mt][1] = u32(ap + 8 * LDB);
        af[mt][2] = u32(ap + 8);
        af[mt][3] = u32(ap + 8 * LDB + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* bp = &stage[(wn + nt * 8 + gq) * LDB + ks * 16 + 2 * t];
        const uint32_t b0 = u32(bp), b1 = u32(bp + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int n = n0 + hgemm_row(warp, mt, gq, e);
          if (n < N)
            atomic_add2(dx + (int64_t)n * D, d0 + hgemm_col(warp, nt, t, e),
                        D, D % 2 == 0, acc[mt][nt][e], acc[mt][nt][e + 1]);
        }
  }

  // dW: the chunk is x[n0 + k, d0 + m] as [k][m]
  for (int dc = 0; dc < n_dc; ++dc) {
    const int d0 = (dc + blockIdx.x) % n_dc * BN;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = tid + i * THREADS, r = ch >> 4, mc = (ch & 15) * 8;
      *reinterpret_cast<uint4*>(&stage[r * LDB + mc]) =
          load8(x, n0 + r, N, d0 + mc, D, vec_x);
    }
    __syncthreads();
    zero();
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      const int k = ks * 16 + 2 * t;
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* ap = &stage[k * LDB + wm + mt * 16 + gq];
        af[mt][0] = pack_bf16(ap[0], ap[LDB]);
        af[mt][1] = pack_bf16(ap[8], ap[LDB + 8]);
        af[mt][2] = pack_bf16(ap[8 * LDB], ap[9 * LDB]);
        af[mt][3] = pack_bf16(ap[8 * LDB + 8], ap[9 * LDB + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* bp = &dl[k * LDB + wn + nt * 8 + gq];
        const uint32_t b0 = pack_bf16(bp[0], bp[LDB]);
        const uint32_t b1 = pack_bf16(bp[8 * LDB], bp[9 * LDB]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int d = d0 + hgemm_row(warp, mt, gq, e);
          if (d < D)
            atomic_add2(dw + (int64_t)d * V, v0 + hgemm_col(warp, nt, t, e),
                        V, V % 2 == 0, acc[mt][nt][e], acc[mt][nt][e + 1]);
        }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, bool LOG2>
cudaError_t fwd_t(const void* x, const void* w, const int* targets,
                  float* part, int N, int D, int V, int n_split,
                  int tiles_per_split, cudaStream_t stream) {
  constexpr int bytes = TILE_BYTES + 4 * BN * 4 + stage_bytes<T>();
  auto kernel = ce_fwd_kernel<T, LOG2>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, n_split);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), targets, part, N, D,
      V, tiles_per_split);
  return cudaSuccess;
}

template <typename T, bool LOG2>
cudaError_t bwd_t(const void* x, const void* w, const int* targets,
                  const float* lse, const float* g, float* dx, float* dw,
                  int N, int D, int V, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  static_assert(stage_bytes<bf16>() <= BF_TILE_BYTES, "stage fits a chunk");
  // f32: the score tile, the row state and the main loop's stage; bf16:
  // the row state, dlog, and the D chunk that reuses the stage
  constexpr int bytes = F32 ? TILE_BYTES + 4 * BN * 4 + stage_bytes<T>()
                            : 3 * BN * 4 + 2 * BF_TILE_BYTES;
  void (*kernel)(const T*, const T*, const int*, const float*, const float*,
                 float*, float*, int, int, int);
  if constexpr (F32) kernel = ce_bwd_fma_kernel<LOG2>;
  else kernel = ce_bwd_mma_kernel<LOG2>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (V + BV - 1) / BV);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), targets, lse, g, dx,
      dw, N, D, V);
  return cudaSuccess;
}

}  // namespace

cudaError_t ce_fwd_launch(const void* x, const void* w, const int* targets,
                          float* part, int N, int D, int V, int n_split,
                          int tiles_per_split, int log2, int dtype,
                          cudaStream_t stream) {
  const int n_vt = (V + BV - 1) / BV;
  if (N < 0 || D <= 0 || V <= 0 || n_split <= 0 || tiles_per_split <= 0 ||
      (n_split - 1) * tiles_per_split >= n_vt ||
      n_split * tiles_per_split < n_vt || n_split > 65535)
    return cudaErrorInvalidValue;  // every split needs a tile, every tile a split
  if (N == 0) return cudaSuccess;
  if (dtype == kF32)
    return log2 ? fwd_t<float, true>(x, w, targets, part, N, D, V, n_split,
                                     tiles_per_split, stream)
                : fwd_t<float, false>(x, w, targets, part, N, D, V, n_split,
                                      tiles_per_split, stream);
  if (dtype == kBF16)
    return log2 ? fwd_t<bf16, true>(x, w, targets, part, N, D, V, n_split,
                                    tiles_per_split, stream)
                : fwd_t<bf16, false>(x, w, targets, part, N, D, V, n_split,
                                     tiles_per_split, stream);
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

cudaError_t ce_bwd_launch(const void* x, const void* w, const int* targets,
                          const float* lse, const float* g, float* dx,
                          float* dw, int N, int D, int V, int log2, int dtype,
                          cudaStream_t stream) {
  if (N < 0 || D <= 0 || V <= 0 || (V + BV - 1) / BV > 65535)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  if (dtype == kF32)
    return log2 ? bwd_t<float, true>(x, w, targets, lse, g, dx, dw, N, D, V,
                                     stream)
                : bwd_t<float, false>(x, w, targets, lse, g, dx, dw, N, D, V,
                                      stream);
  if (dtype == kBF16)
    return log2 ? bwd_t<bf16, true>(x, w, targets, lse, g, dx, dw, N, D, V,
                                    stream)
                : bwd_t<bf16, false>(x, w, targets, lse, g, dx, dw, N, D, V,
                                     stream);
  return cudaErrorInvalidValue;
}

}  // namespace tk
