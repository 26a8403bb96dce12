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
// #35 + #36 as one cluster launch: softmax_grid_fused_kernel replaces
//     both (:134 and :172) wherever a row's column tiles fit one thread-
//     block cluster (ncb = ceil(cols / bc) <= 16, the non-portable size
//     above 8; a tile row of e, below, of at most SM_FUSED_ROW_BYTES_MAX,
//     SM_FUSED_ROW_BYTES_WIDE above 8 tiles). The two-launch design reads
//     x twice, 201 MB at f32 4096^2 against the function's 134, more than
//     the 50 MB L2 holds between the passes. Here a cluster of ncb blocks
//     (each of a warp a row, up to SM_WARPS) spans a row block of R rows:
//     block k (its rank) owns the column
//     tile k of bc columns, the knob that defines JAX's partials. For
//     each row block, each block
//       1. copies its R x bc tile into shared memory once (16-byte
//          cp.async where the rows are whole packs, else element loads),
//       2. computes each row's partial of its tile as #35 does: m (its
//          max, NEG_BIG at least), then e = exp(x - m) in f32, kept in
//          shared memory (over the tile for f32, beside it for 2-byte
//          dtypes), and d = sum(e),
//       3. stores (m, d) into every block of the cluster by st.async,
//          counted on that block's mbarrier (distributed shared memory),
//       4. waits on its own mbarrier, then merges the ncb partials in one
//          fixed order: M = max_k m_k, D = the sum over k = 0 ... ncb - 1
//          of d_k exp(m_k - M), so every block of the row holds the same
//          (M, D) bits,
//       5. writes its tile as e s, s = exp(m - M) / D: one exp an element
//          in all, and one division a row's tile.
//     The clusters are persistent: as many as fit on the card at once
//     (cudaOccupancyMaxActiveClusters; at 4096^2 on an H100 124 clusters
//     of 8 blocks in f32, 77 in bf16) walk the row blocks, each block with two tiles in shared
//     memory, the next row block's copies in flight while this one is
//     reduced, merged and written. R is the port's choice, as gmm ignores
//     block_m: SM_FUSED_TILE_BYTES of x a tile (4 f32 rows, 8 bf16 rows
//     of 512, the fastest of 2-16 rows on an H100), at most
//     SM_FUSED_ROWS_MAX; block_rows has no effect on this path. x is read
//     once and y written once. A shape whose row has more tiles than a
//     cluster holds (the sampling logits' 64 x 131072 at bc 512: 256
//     tiles) keeps #35 then #36; that is a shape rule (ops/softmax.py
//     grid_plan mirrors it), never a retry: a refused cluster launch
//     raises. The two paths agree to rounding, not bit for bit; each
//     repeats bit for bit.
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
// element (#34 and #35 one expf more a pack, #36 and the cluster kernel
// one more a partial).
#include <map>
#include <tuple>

#include "hopper.cuh"

namespace tk {
namespace {

enum SoftmaxMode { kSafe = 0, kOnline = 1 };

// the running max's start in #34 and #35 (tpukern/ops/softmax.py NEG_BIG)
constexpr float SM_NEG_BIG = -1e30f;
constexpr int SM_WARPS = 8;               // warps of a warp-a-row or tile block
constexpr int SM_WARP_ROW_MAX = 1024;     // longest row a warp takes
// the cluster kernel: a tile's budget (a block holds two) and its most
// rows; a tile row of at most SM_FUSED_ROW_BYTES_MAX; clusters of up to
// SM_CLUSTER_MAX blocks (above 8 only with the non-portable size allowed)
constexpr int SM_FUSED_TILE_BYTES = 8 * 1024;
constexpr int SM_FUSED_ROWS_MAX = 32;
constexpr int SM_FUSED_ROW_BYTES_MAX = 64 * 1024;
constexpr int SM_FUSED_ROW_BYTES_WIDE = 16 * 1024;  // in clusters above 8
constexpr int SM_CLUSTER_PORTABLE = 8;
constexpr int SM_CLUSTER_MAX = 16;

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

// ------------------------------------------------ the cluster kernel
// (m, d) into another block's shared memory at dst, its 8 bytes counted on
// that block's mbarrier bar (both cluster addresses)
__device__ __forceinline__ void st_async_md(uint32_t dst, float m, float d,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(m), "f"(d), "r"(bar)
      : "memory");
}

// mbar_wait with cluster-scope acquire: the bytes other blocks stored by
// st_async_md are seen once the phase completes (a phase still open after
// MBAR_TIMEOUT_NS traps)
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar,
                                                      uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  if (mbar_try_wait_cluster(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait_cluster(bar, parity))
    if (global_ns() - t0 > MBAR_TIMEOUT_NS) __trap();
}

// the two buffers' incoming partials ([2][ncb][R] (m, d) pairs) and their
// two mbarriers ahead of the tiles in shared memory (32-byte aligned: a
// thread's 8 f32 of e in a bf16 or f16 row)
__host__ __device__ constexpr int fused_head_bytes(int R, int ncb) {
  return (2 * ncb * R * 8 + 2 * 8 + 31) / 32 * 32;
}

// f32 e (N of them) to shared memory, 16 bytes at a time (N >= 4), or one
template <int N>
__device__ __forceinline__ void store_e(float* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}

// #35 + #36 in one launch: a cluster of ncb blocks, block k on column tile
// k, walks the row blocks c, c + clusters, ... of R rows (c the cluster's
// index), two tiles in shared memory: the next row block's copies are in
// flight while this one's are used. The block has a warp a row, up to
// SM_WARPS (nw warps); warp w takes the tile's rows w, w + nw, ... < R (at
// most SM_FUSED_ROWS_MAX / SM_WARPS a warp), lane t its packs t, t + 32,
// ... of each: the same thread copies, reads and
// normalises a pack, so a tile needs no barrier inside the block.
//
// A row's tile in two passes over shared memory: its max m (NEG_BIG at
// least, as #35's), then e = exp(x - m) in f32, kept in shared memory
// (over the tile for f32 inputs, beside it for 2-byte ones), and d =
// sum(e): #35's partial. The merge takes M = max_k m_k and D = the sum of
// d_k exp(m_k - M) over k = 0 ... ncb - 1 in that order, and the tile is
// written as e s with s = exp(m - M) / D (a true division, once a row's
// tile): one exp an element instead of #35's and #36's two, and no
// division an element (with those, bf16 4096^2 took 61.2 us on an H100,
// as long as f32's 71.2; this way 42.1).
//
// The partials travel by st.async: lane k of the warp that holds a row's
// partial stores it into block k's shared memory (in the slot of this
// block's rank, in the buffer of the row block's tile), counted on block
// k's mbarrier of that buffer, where thread 0 announced the row block's
// ncb x rows x 8 bytes; every thread waits on its own block's mbarrier,
// then reads the ncb partials locally. No cluster barrier a row block:
// barrier.cluster.arrive.release compiles to MEMBAR.ALL.GPU, which waits
// for the thread's stores of y and the next tile's copies. A block
// overwrites a buffer's slots in another block only after it has merged
// that block's partial of the row block between, which the other block
// sent after it had read those slots; a warp waits on a buffer's phase
// only in a row block where it holds a row, so it has sent its partials
// of every row block between and the buffer cannot run two phases ahead
// of it. A cluster barrier after the mbarriers' init, and a relaxed one
// before exit (every store to a block is waited for by that block).
template <typename T>
__global__ void __launch_bounds__(SM_WARPS * 32)
softmax_grid_fused_kernel(const T* __restrict__ x, T* __restrict__ y,
                          int64_t rows, int64_t cols, int R, int bc, int ncb,
                          int vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RW = SM_FUSED_ROWS_MAX / SM_WARPS;
  constexpr bool IN_PLACE = sizeof(T) == sizeof(float);  // e over the tile
  extern __shared__ __align__(16) unsigned char sm_fused[];
  float2* pmd = reinterpret_cast<float2*>(sm_fused);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(sm_fused + 2 * ncb * R * 8);
  T* tiles = reinterpret_cast<T*>(sm_fused + fused_head_bytes(R, ncb));
  float* es = reinterpret_cast<float*>(tiles + 2 * (int64_t)R * bc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const uint32_t rank = cluster_rank();
  const int64_t c0 = (int64_t)rank * bc;
  const int w = (int)((c0 + bc < cols ? c0 + bc : cols) - c0);
  const int64_t row_blocks = (rows + R - 1) / R;
  const int64_t clusters = gridDim.x / ncb;
  auto live = [&](int64_t rb, int j) {
    const int rr = warp + j * nw;
    return rr < R && rb * R + rr < rows;
  };
  auto row = [&](int buf, int j) {
    return tiles + ((int64_t)buf * R + warp + j * nw) * bc;
  };
  auto erow = [&](int buf, int j) {
    return IN_PLACE ? reinterpret_cast<float*>(row(buf, j))
                    : es + (int64_t)(warp + j * nw) * bc;
  };
  // 1. row block rb's tile into buffer buf, every copy in flight (one
  // commit group a row block, empty past the last)
  auto load = [&](int64_t rb, int buf) {
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      if (rb >= row_blocks || !live(rb, j)) continue;
      const T* xr = x + (rb * R + warp + j * nw) * cols + c0;
      T* st = row(buf, j);
      if (vec) {
        for (int c = lane * VEC; c < w; c += 32 * VEC)
          cp_async16(smem_u32(st + c), xr + c, true);
      } else {
        for (int c = lane; c < w; c += 32) st[c] = xr[c];
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&mbar[0]), 1);
    mbar_init(smem_u32(&mbar[1]), 1);
  }
  cluster_sync<true>();  // every block's mbarriers ready
  int64_t rb = blockIdx.x / ncb;
  load(rb, 0);
  for (uint32_t it = 0; rb < row_blocks; ++it, rb += clusters) {
    const int buf = (int)(it & 1);  // this row block's tile and partials
    load(rb + clusters, buf ^ 1);
    const uint32_t bar = smem_u32(&mbar[buf]);
    if (threadIdx.x == 0) {
      const int64_t left = rows - rb * R;
      mbar_arrive_tx(bar, (uint32_t)(ncb * (left < R ? left : R) * 8));
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    float2* slots = pmd + (int64_t)buf * ncb * R;  // [ncb][R]
    // 2. each row's partial (m, d) of this tile, to every block
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      if (!live(rb, j)) continue;
      const T* st = row(buf, j);
      float* e = erow(buf, j);
      float m = SM_NEG_BIG, d = 0.f;
      if (vec) {
        for (int c = lane * VEC; c < w; c += 32 * VEC) {
          float v[VEC];
          load_f32<T, VEC>(st + c, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) m = fmaxf(m, v[k]);
        }
        m = warp_max(m);
        for (int c = lane * VEC; c < w; c += 32 * VEC) {
          float v[VEC];
          load_f32<T, VEC>(st + c, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            v[k] = expf(v[k] - m);
            d += v[k];
          }
          store_e<VEC>(e + c, v);
        }
      } else {
        for (int c = lane; c < w; c += 32) m = fmaxf(m, to_f32(st[c]));
        m = warp_max(m);
        for (int c = lane; c < w; c += 32) {
          const float v = expf(to_f32(st[c]) - m);
          d += v;
          e[c] = v;
        }
      }
      d = warp_sum(d);
      if (lane < ncb)
        st_async_md(
            cluster_addr(&slots[rank * R + warp + j * nw], lane), m, d,
            cluster_addr(&mbar[buf], lane));
    }
    // 3. every block's partials of this row block in (for a warp with a
    // row here: a warp of none could fall two phases behind)
    if (live(rb, 0)) mbar_wait_cluster(bar, (it >> 1) & 1);
    // 4. each row's (M, D), the same bits in every lane and block; 5. the
    // tile as e s
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      if (!live(rb, j)) continue;
      const int rr = warp + j * nw;
      float mk = SM_NEG_BIG, dk = 0.f;
      if (lane < ncb) {
        const float2 p = slots[lane * R + rr];
        mk = p.x;
        dk = p.y;
      }
      const float M = warp_max(mk);
      const float t = lane < ncb ? dk * expf(mk - M) : 0.f;
      float D = __shfl_sync(0xffffffffu, t, 0);
      for (int k = 1; k < ncb; ++k) D += __shfl_sync(0xffffffffu, t, k);
      const float sc = __fdiv_rn(expf(slots[rank * R + rr].x - M), D);
      const float* e = erow(buf, j);
      T* yr = y + (rb * R + rr) * cols + c0;
      if (vec) {
        for (int c = lane * VEC; c < w; c += 32 * VEC) {
          float v[VEC];
          load_f32<float, VEC>(e + c, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] *= sc;
          store_f32<T, VEC>(yr + c, v);
        }
      } else {
        for (int c = lane; c < w; c += 32) yr[c] = from_f32<T>(e[c] * sc);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  cluster_sync<false>();  // no block leaves before the cluster is done
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


// the cluster kernel's rows a block, or 0 if the shape takes #35 then
// #36: ncb tiles of bc columns over cols, at most SM_CLUSTER_MAX of them,
// a tile row of e (f32, whatever the dtype) of at most
// SM_FUSED_ROW_BYTES_MAX, SM_FUSED_ROW_BYTES_WIDE in a cluster of more
// than 8 (so that a block's shared memory leaves room for 16 on a GPC);
// SM_FUSED_TILE_BYTES of x a tile
int fused_rows(int64_t rows, int64_t cols, int bc, int ncb, int size) {
  if (rows <= 0 || cols <= 0 || bc <= 0 || ncb != (cols + bc - 1) / bc ||
      ncb > SM_CLUSTER_MAX ||
      (int64_t)bc * 4 > (ncb > SM_CLUSTER_PORTABLE ? SM_FUSED_ROW_BYTES_WIDE
                                                   : SM_FUSED_ROW_BYTES_MAX))
    return 0;
  int R = SM_FUSED_TILE_BYTES / (bc * size);
  R = R < 1 ? 1 : R > SM_FUSED_ROWS_MAX ? SM_FUSED_ROWS_MAX : R;
  if (R > rows) R = (int)rows;
  if ((rows + R - 1) / R * ncb > 0x7fffffff) return 0;
  return R;
}

// The launch configuration of the cluster kernel over R-row blocks (attrs
// holds its one attribute, the cluster's shape), with the kernel's limits
// raised: as many clusters as fit on the card at once
// (cudaOccupancyMaxActiveClusters, kept per configuration), at most one a
// row block; *active the most that fit (0: none does, and the launch would
// be refused).
template <typename T>
cudaError_t fused_config(int64_t rows, int R, int bc, int ncb,
                         cudaStream_t stream,
                         cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attrs,
                         int* active) {
  static std::map<std::tuple<int, int, int>, int> fit;  // (R, bc, ncb)
  static int smem_limit = 48 * 1024;  // the kernel's, raised only
  auto kernel = softmax_grid_fused_kernel<T>;
  // two tiles, and e in f32 beside them for a 2-byte dtype
  const int smem = fused_head_bytes(R, ncb) + 2 * R * bc * (int)sizeof(T) +
                   (sizeof(T) < 4 ? R * bc * 4 : 0);
  const int64_t row_blocks = (rows + R - 1) / R;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(row_blocks * ncb));
  cfg->blockDim = dim3((R < SM_WARPS ? R : SM_WARPS) * 32);  // a warp a row
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = (unsigned)ncb;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg->attrs = attrs;
  cfg->numAttrs = 1;
  const auto key = std::make_tuple(R, bc, ncb);
  auto it = fit.find(key);
  if (it == fit.end()) {
    cudaError_t e = cudaSuccess;
    if (smem > smem_limit) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess) smem_limit = smem;
    }
    if (e == cudaSuccess && ncb > SM_CLUSTER_PORTABLE)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, cfg);
    if (e != cudaSuccess) return e;
    it = fit.emplace(key, n).first;
  }
  *active = it->second;
  const int64_t clusters = *active < row_blocks ? *active : row_blocks;
  cfg->gridDim = dim3((unsigned)((clusters > 0 ? clusters : 1) * ncb));
  return cudaSuccess;
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

// #35 + #36 in one cluster launch; cudaErrorInvalidValue for a shape the
// rule gives to #35 then #36 (fused_rows), cudaErrorInvalidConfiguration
// where no cluster of the configuration fits on the card
cudaError_t softmax_grid_fused_launch(const void* x, void* y, int64_t rows,
                                      int64_t cols, int bc, int ncb,
                                      int dtype, cudaStream_t stream) {
  if (!x || !y || rows < 0 || cols < 0) return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  cudaError_t e = cudaErrorInvalidValue;
  by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const int R = fused_rows(rows, cols, bc, ncb, (int)sizeof(T));
    if (!R) return;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attrs[1];
    int active = 0;
    e = fused_config<T>(rows, R, bc, ncb, stream, &cfg, attrs, &active);
    if (e != cudaSuccess) return;
    if (active == 0) {
      e = cudaErrorInvalidConfiguration;
      return;
    }
    const int vec = whole_packs<T>(cols, x, y) &&
                    bc % (16 / (int)sizeof(T)) == 0;
    e = cudaLaunchKernelEx(&cfg, softmax_grid_fused_kernel<T>,
                           static_cast<const T*>(x), static_cast<T*>(y),
                           rows, cols, R, bc, ncb, vec);
  });
  return e;
}

// the cluster kernel's plan for a shape: out[0] its rows a block (0: the
// shape takes #35 then #36), out[1] its shared memory a block, out[2]
// cudaOccupancyMaxActiveClusters at that configuration, out[3] the
// clusters a launch runs
cudaError_t softmax_grid_fused_plan(int64_t rows, int64_t cols, int bc,
                                    int ncb, int dtype, int* out) {
  if (!out) return cudaErrorInvalidValue;
  out[0] = out[1] = out[2] = out[3] = 0;
  cudaError_t e = cudaSuccess;
  const bool ok = by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    const int R = fused_rows(rows, cols, bc, ncb, (int)sizeof(T));
    if (!R) return;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attrs[1];
    e = fused_config<T>(rows, R, bc, ncb, nullptr, &cfg, attrs, &out[2]);
    if (e != cudaSuccess) return;
    out[0] = R;
    out[1] = (int)cfg.dynamicSmemBytes;
    out[3] = out[2] ? (int)(cfg.gridDim.x / ncb) : 0;
  });
  return ok ? e : cudaErrorInvalidValue;
}

}  // namespace tk
