// Softmax along the last dim of a (rows, cols) array: four kernels, two
// designs of the per-token softmax and the two passes of the
// grid-streamed one.
//
// #33 softmax_row_kernel<kSafe> replaces tpukern/ops/softmax.py:49
//     `kernel` (softmax_per_token): the safe softmax with the whole row on
//     chip, the reference's per-token design (softmax.cu:429-581, SURVEY
//     §2.1): the row's max, then exp and sum, then normalize. x is read
//     from HBM once: the first phase copies each thread's 16-byte packs
//     into shared memory (rows up to ROW_STAGE_MAX bytes, common.cuh
//     read_row), and the other two read them back from there. A wider
//     row (the 131072-token logits of sampling are 512 KiB in f32) is
//     read from global memory again in each phase, inside the same
//     kernel, so any width gives the right result.
// #34 softmax_row_kernel<kOnline> replaces :85 `kernel`
//     (online_softmax_per_token): one pass keeps a running (m, d) for each
//     thread's packs (m from NEG_BIG, d *= exp(m - m_new) as in
//     softmax.py:98-100), the pairs merge across the warp and then the
//     block by the reference's rule (softmax.cu:315-346): m = max(ma, mb),
//     d = da exp(ma - m) + db exp(mb - m); a normalize pass reads x a
//     second time. It stages nothing, so it takes any width.
// #35 softmax_stats_kernel replaces :134 `stats_kernel`, and #36
//     softmax_norm_kernel replaces :172 `norm_kernel`
//     (online_softmax_grid). The TPU walks a row block's column blocks one
//     after another and carries (m, d) in VMEM scratch; blocks here run in
//     parallel and in no order. #35 gives every (row block, column block)
//     tile its own block, which writes each row's partial (m, d) of its
//     columns in f32 to (rows, n_col_blocks) arrays; #36, again one block a
//     tile, merges a row's partials by the rule above (lane k folds
//     partials k, k + 32, ... in order, then the warp's shuffle tree: the
//     same fixed order in every tile of the row, so they all normalize by
//     the same (m, d)) and writes exp(x - m) / d for its tile. The merged
//     pair is the sequential loop's (m, d) up to rounding: both are the
//     row's max and its sum of exp(x - m).
//
// Rows map to threads by width: a row of up to SM_WARP_ROW_MAX elements
// is one warp's (8 rows a block of 256 threads), a longer one a whole
// block's (128-1024 threads, about 4 packs a thread); the grid kernels
// give each warp of 8 the tile's rows w, w + 8, ...
//
// Shared rules: statistics in f32 whatever the input; f16 is storage-only
// (tpukern/core/config.py) and is read directly (widening is exact); the
// output is e / d, a true division, rounded once to the input's dtype;
// the accurate expf (no --use_fast_math). Each thread reads 16-byte packs
// (4 f32, 8 bf16 or f16) where the row is whole packs on an aligned base,
// else one element at a time. Every merge runs in a fixed order and no
// float atomic is used, so a call repeats bit for bit.
//
// Bound by memory bandwidth: each input element read once and each output
// written once (#35 writes, and #36 reads, 8 bytes a row and column
// block more); the f32 math is one expf, a max and an add or two an
// element (#34 and #35 one expf more a pack, #36 one more a partial).
#include "common.cuh"

namespace tk {
namespace {

enum SoftmaxMode { kSafe = 0, kOnline = 1 };

// the running max's start in #34 and #35 (tpukern/ops/softmax.py NEG_BIG)
constexpr float SM_NEG_BIG = -1e30f;
constexpr int SM_WARPS = 8;               // warps of a warp-a-row or tile block
constexpr int SM_WARP_ROW_MAX = 1024;     // longest row a warp takes

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[N]) {
  const Pack<T, N> q = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = to_f32(q.v[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_f32(T* p, const float (&v)[N]) {
  Pack<T, N> q;
#pragma unroll
  for (int j = 0; j < N; ++j) q.v[j] = from_f32<T>(v[j]);
  *reinterpret_cast<Pack<T, N>*>(p) = q;
}

// (m, d) <- the pair of (m, d) and (m2, d2). Rounded product by product
// (no FMA contraction), so a merge of a with b equals b with a bit for
// bit and both lanes of a shuffle step keep the same pair.
__device__ __forceinline__ void md_merge(float& m, float& d, float m2,
                                         float d2) {
  const float mn = fmaxf(m, m2);
  d = __fadd_rn(__fmul_rn(d, expf(m - mn)), __fmul_rn(d2, expf(m2 - mn)));
  m = mn;
}

__device__ __forceinline__ void warp_md(float& m, float& d) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float d2 = __shfl_xor_sync(0xffffffffu, d, o);
    md_merge(m, d, m2, d2);
  }
}

// The team's max, sum or (m, d), in every thread of the team (a warp, or
// with BLOCK the whole block): the warp's xor-shuffle tree, then every
// warp folds the warps' values from shared `red` by the same tree.
template <bool BLOCK>
__device__ __forceinline__ float team_max(float v, float* red) {
  v = warp_max(v);
  if constexpr (BLOCK) {
    const int lane = threadIdx.x & 31;
    __syncthreads();  // the last reader of red is done
    if (lane == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY);
  }
  return v;
}

template <bool BLOCK>
__device__ __forceinline__ float team_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (BLOCK) {
    const int lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
  }
  return v;
}

template <bool BLOCK>
__device__ __forceinline__ void team_md(float& m, float& d, float* red) {
  if constexpr (BLOCK)
    block_fold2(m, d, SM_NEG_BIG, 0.f, red,
                [](float& a, float& b) { warp_md(a, b); });
  else
    warp_md(m, d);
}

// one online step over a thread's pack v: JAX's chunk update
// (softmax.py:96-100) with the pack as the chunk
template <int N>
__device__ __forceinline__ void online_step(float& m, float& d,
                                            const float (&v)[N]) {
  float cm = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) cm = fmaxf(cm, v[j]);
  const float mn = fmaxf(m, cm);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) s += expf(v[j] - mn);
  d = d * expf(m - mn) + s;
  m = mn;
}

// y = exp(x - m) / d over a thread's share of [c0, c1) of a row
template <typename T, int N>
__device__ __forceinline__ void normalize(const T* src, T* yr, int64_t c0,
                                          int64_t c1, int t, int tsz,
                                          float m, float d) {
  for (int64_t c = c0 + (int64_t)t * N; c < c1; c += (int64_t)tsz * N) {
    float v[N];
    load_f32<T, N>(src + c, v);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = __fdiv_rn(expf(v[j] - m), d);
    store_f32<T, N>(yr + c, v);
  }
}

// #33 on one row: thread t of a team of tsz takes packs t, t + tsz, ...;
// st (or null) is the row's staging space in shared memory
template <typename T, int N, bool BLOCK>
__device__ __forceinline__ void safe_row(const T* xr, T* yr, T* st,
                                         int64_t cols, int t, int tsz,
                                         float* red) {
  float m = -INFINITY;
  read_row<T, N>(xr, st, cols, t, tsz, [&](const Pack<T, N>& q) {
#pragma unroll
    for (int j = 0; j < N; ++j) m = fmaxf(m, to_f32(q.v[j]));
  });
  m = team_max<BLOCK>(m, red);
  const T* src = st ? st : xr;
  float d = 0.f;
  for (int64_t c = (int64_t)t * N; c < cols; c += (int64_t)tsz * N) {
    float v[N];
    load_f32<T, N>(src + c, v);
#pragma unroll
    for (int j = 0; j < N; ++j) d += expf(v[j] - m);
  }
  d = team_sum<BLOCK>(d, red);
  normalize<T, N>(src, yr, 0, cols, t, tsz, m, d);
}

// #34 on one row
template <typename T, int N, bool BLOCK>
__device__ __forceinline__ void online_row(const T* xr, T* yr, int64_t cols,
                                           int t, int tsz, float* red) {
  float m = SM_NEG_BIG, d = 0.f;
  for (int64_t c = (int64_t)t * N; c < cols; c += (int64_t)tsz * N) {
    float v[N];
    load_f32<T, N>(xr + c, v);
    online_step<N>(m, d, v);
  }
  team_md<BLOCK>(m, d, red);
  normalize<T, N>(xr, yr, 0, cols, t, tsz, m, d);
}

// #33 / #34: a warp a row (BLOCK false: SM_WARPS rows a block) or a block
// a row. vec: the rows are whole 16-byte packs on an aligned base; stage
// (#33): the row is copied to dynamic shared memory.
template <typename T, bool BLOCK, int MODE>
__global__ void __launch_bounds__(BLOCK ? 1024 : SM_WARPS * 32)
softmax_row_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                   int64_t cols, int vec, int stage) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char sm_stage[];
  __shared__ float red[64];
  const int warp = threadIdx.x >> 5;
  const int64_t r = BLOCK ? (int64_t)blockIdx.x
                          : (int64_t)blockIdx.x * SM_WARPS + warp;
  if (r >= rows) return;  // a warp-a-row block's last warps (no barrier)
  const int t = BLOCK ? (int)threadIdx.x : (int)(threadIdx.x & 31);
  const int tsz = BLOCK ? (int)blockDim.x : 32;
  const T* xr = x + r * cols;
  T* yr = y + r * cols;
  if constexpr (MODE == kSafe) {
    T* st = stage ? reinterpret_cast<T*>(sm_stage) + (BLOCK ? 0 : warp * cols)
                  : nullptr;
    if (vec) safe_row<T, VEC, BLOCK>(xr, yr, st, cols, t, tsz, red);
    else safe_row<T, 1, BLOCK>(xr, yr, st, cols, t, tsz, red);
  } else {
    if (vec) online_row<T, VEC, BLOCK>(xr, yr, cols, t, tsz, red);
    else online_row<T, 1, BLOCK>(xr, yr, cols, t, tsz, red);
  }
}

// #35: tile (blockIdx.y row block of br rows, blockIdx.x column block of
// bc columns); warp w takes the tile's rows w, w + SM_WARPS, ...
template <typename T>
__global__ void __launch_bounds__(SM_WARPS * 32)
softmax_stats_kernel(const T* __restrict__ x, float* __restrict__ pm,
                     float* __restrict__ pd, int64_t rows, int64_t cols,
                     int br, int bc, int ncb, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int j = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r0 = (int64_t)blockIdx.y * br, c0 = (int64_t)j * bc;
  const int64_t c1 = c0 + bc < cols ? c0 + bc : cols;
  for (int rr = warp; rr < br && r0 + rr < rows; rr += SM_WARPS) {
    const int64_t r = r0 + rr;
    const T* xr = x + r * cols;
    float m = SM_NEG_BIG, d = 0.f;
    if (vec) {
      for (int64_t c = c0 + lane * VEC; c < c1; c += 32 * VEC) {
        float v[VEC];
        load_f32<T, VEC>(xr + c, v);
        online_step<VEC>(m, d, v);
      }
    } else {
      for (int64_t c = c0 + lane; c < c1; c += 32) {
        float v[1];
        load_f32<T, 1>(xr + c, v);
        online_step<1>(m, d, v);
      }
    }
    warp_md(m, d);
    if (lane == 0) {
      pm[r * ncb + j] = m;
      pd[r * ncb + j] = d;
    }
  }
}

// #36: the tiles of #35; each row's ncb partials merged in a fixed order
template <typename T>
__global__ void __launch_bounds__(SM_WARPS * 32)
softmax_norm_kernel(const T* __restrict__ x, const float* __restrict__ pm,
                    const float* __restrict__ pd, T* __restrict__ y,
                    int64_t rows, int64_t cols, int br, int bc, int ncb,
                    int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r0 = (int64_t)blockIdx.y * br;
  const int64_t c0 = (int64_t)blockIdx.x * bc;
  const int64_t c1 = c0 + bc < cols ? c0 + bc : cols;
  for (int rr = warp; rr < br && r0 + rr < rows; rr += SM_WARPS) {
    const int64_t r = r0 + rr;
    float m = SM_NEG_BIG, d = 0.f;
    for (int k = lane; k < ncb; k += 32)
      md_merge(m, d, pm[r * ncb + k], pd[r * ncb + k]);
    warp_md(m, d);
    const T* xr = x + r * cols;
    if (vec) normalize<T, VEC>(xr, y + r * cols, c0, c1, lane, 32, m, d);
    else normalize<T, 1>(xr, y + r * cols, c0, c1, lane, 32, m, d);
  }
}

// f(T()) with T the float type of the dtype code; false for another code
template <typename F>
bool by_dtype(int dtype, F&& f) {
  if (dtype == kF32) f(float());
  else if (dtype == kBF16) f(bf16());
  else if (dtype == kF16) f(f16());
  else return false;
  return true;
}

template <typename T, int MODE>
cudaError_t launch_rows(const void* x, void* y, int64_t rows, int64_t cols,
                        cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec = whole_packs<T>(cols, x, y);
  const int64_t bytes = cols * (int64_t)sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (cols <= SM_WARP_ROW_MAX) {
    // at most 8 x 1024 x 4 = 32 KiB of staging: under the default limit
    const int smem = MODE == kSafe ? (int)(SM_WARPS * bytes) : 0;
    softmax_row_kernel<T, false, MODE>
        <<<(unsigned)((rows + SM_WARPS - 1) / SM_WARPS), SM_WARPS * 32, smem,
           stream>>>(xt, yt, rows, cols, vec, MODE == kSafe);
    return cudaSuccess;
  }
  const int threads = row_threads(vec ? cols / VEC : cols, 128);
  auto kernel = softmax_row_kernel<T, true, MODE>;
  int smem = 0;
  if (MODE == kSafe) {
    const cudaError_t e = row_stage_smem(kernel, bytes, &smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)rows, threads, smem, stream>>>(xt, yt, rows, cols, vec,
                                                    smem > 0);
  return cudaSuccess;
}

// the grid of #35 and #36, or false if the shape makes none
bool tile_grid(int64_t rows, int64_t cols, int br, int bc, int ncb,
               dim3* grid) {
  if (rows < 0 || cols < 0 || br <= 0 || bc <= 0 ||
      ncb != (cols + bc - 1) / bc)
    return false;
  const int64_t row_blocks = (rows + br - 1) / br;
  if (row_blocks > 65535) return false;
  *grid = dim3((unsigned)ncb, (unsigned)row_blocks);
  return true;
}

}  // namespace

cudaError_t softmax_launch(const void* x, void* y, int64_t rows, int64_t cols,
                           int mode, int dtype, cudaStream_t stream) {
  if (!x || !y || rows < 0 || cols < 0 || rows > 0x7fffffff ||
      (mode != kSafe && mode != kOnline))
    return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  cudaError_t e = cudaSuccess;
  const bool ok = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    e = mode == kSafe ? launch_rows<T, kSafe>(x, y, rows, cols, stream)
                      : launch_rows<T, kOnline>(x, y, rows, cols, stream);
  });
  return ok ? e : cudaErrorInvalidValue;
}

// pm, pd: (rows, ncb) f32, ncb = ceil(cols / bc)
cudaError_t softmax_grid_stats_launch(const void* x, float* pm, float* pd,
                                      int64_t rows, int64_t cols, int br,
                                      int bc, int ncb, int dtype,
                                      cudaStream_t stream) {
  dim3 grid;
  if (!x || !pm || !pd || !tile_grid(rows, cols, br, bc, ncb, &grid))
    return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const bool ok = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const int vec = whole_packs<T>(cols, x, nullptr) &&
                    bc % (16 / (int)sizeof(T)) == 0;
    softmax_stats_kernel<T><<<grid, SM_WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), pm, pd, rows, cols, br, bc, ncb, vec);
  });
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t softmax_grid_norm_launch(const void* x, const float* pm,
                                     const float* pd, void* y, int64_t rows,
                                     int64_t cols, int br, int bc, int ncb,
                                     int dtype, cudaStream_t stream) {
  dim3 grid;
  if (!x || !pm || !pd || !y || !tile_grid(rows, cols, br, bc, ncb, &grid))
    return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const bool ok = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const int vec = whole_packs<T>(cols, x, y) &&
                    bc % (16 / (int)sizeof(T)) == 0;
    softmax_norm_kernel<T><<<grid, SM_WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), pm, pd, static_cast<T*>(y), rows, cols, br,
        bc, ncb, vec);
  });
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tk
