// Transpose: out[j, i] = x[i, j] for an (M, N) matrix of f32 or bf16.
//
// #42 transpose_{f32,bf16}_kernel replace tpukern/ops/transpose.py:39
// `kernel` (transpose :27), whose grid walks (bm, bn) tiles of x in one of
// three orders and turns each tile in registers (`block.T`). The card is
// bound by memory bandwidth: M N elements read once and written once. A
// warp reads along a row of x and writes along a row of out, so both sides
// are coalesced, and the turn goes through a tile in shared memory:
// - f32: a 32 x 32 tile padded to 33 columns, so a warp's read down a
//   column (32 rows) hits 32 banks;
// - bf16: a 64 x 64 tile held as 32 4-byte words a row (two values a
//   word). A warp reads a 128-byte segment of a row of x as words and
//   writes one of a row of out as words; each output word pairs rows 2l
//   and 2l + 1 of the tile in one column. No pad spreads those reads: with
//   a row stride of W words, rows 2l sit W 2l apart, at most 16 banks. So
//   word w of row r is stored at column w ^ ((r / 2) % 32): rows 2l and
//   2l + 1 of one word column land in bank w ^ l, 32 banks for the 32
//   lanes, and a row's 32 words still fill 32 banks.
// The TPU block (bm, bn) is a super-tile, neither walked by one block nor
// an alias: the (bm / T)(bn / T) blocks of consecutive blockIdx (T the 32
// or 64 tile) each turn one of its tiles, in row-major order, and `order`
// maps the groups of blocks to super-tiles as transpose.py:43-56 maps grid
// steps to blocks: row (group I nJ + J takes super-tile (I, J)), col
// (group J nI + I) or diag (group i nJ + j takes ((i + j) % nI, j), a
// permutation for every nI). Blocks start roughly in blockIdx order, so
// the order decides which tiles of x and out are in flight together, as
// the TPU's grid order does. One block walking a 512 x 512 super-tile
// alone would leave 64 blocks for the 132 SMs at 4096 x 4096. Tiles past
// the edge exit; the ragged edge is masked on both sides.
#include "common.cuh"

namespace tk {
namespace {

constexpr int TR_ROWS = 8;  // a block is 32 x TR_ROWS threads

// super-tiles nI x nJ of ti x tj tiles each; order 0 row, 1 col, 2 diag
struct TrGrid {
  int64_t nI, nJ;
  int ti, tj, order;
};

// the tile (row, column of tiles) that block b turns
__device__ __forceinline__ void tr_tile(const TrGrid& g, int64_t b,
                                        int64_t& rt, int64_t& ct) {
  const int64_t per = (int64_t)g.ti * g.tj;
  const int64_t s = b / per;
  const int t = (int)(b - s * per);
  int64_t I, J;
  if (g.order == 1) {
    J = s / g.nI;
    I = s - J * g.nI;
  } else {
    const int64_t i = s / g.nJ;
    J = s - i * g.nJ;
    I = g.order == 2 ? (i + J) % g.nI : i;
  }
  rt = I * g.ti + t / g.tj;
  ct = J * g.tj + t % g.tj;
}

__global__ void __launch_bounds__(32 * TR_ROWS)
transpose_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int64_t M, int64_t N, TrGrid g) {
  __shared__ float t[32][33];
  int64_t rt, ct;
  tr_tile(g, blockIdx.x, rt, ct);
  const int64_t r0 = rt * 32, c0 = ct * 32;
  if (r0 >= M || c0 >= N) return;
  const int lx = threadIdx.x, ly = threadIdx.y;
#pragma unroll
  for (int k = 0; k < 32; k += TR_ROWS) {
    const int64_t r = r0 + ly + k, c = c0 + lx;
    if (r < M && c < N) t[ly + k][lx] = x[r * N + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 32; k += TR_ROWS) {
    const int64_t j = c0 + ly + k, i = r0 + lx;
    if (j < N && i < M) out[j * M + i] = t[lx][ly + k];
  }
}

// x and out as 16-bit words; vec_in: rows of x are whole 4-byte words
// (N even, base aligned), vec_out: rows of out (M even)
__global__ void __launch_bounds__(32 * TR_ROWS)
transpose_bf16_kernel(const uint16_t* __restrict__ x,
                      uint16_t* __restrict__ out, int64_t M, int64_t N,
                      TrGrid g, int vec_in, int vec_out) {
  __shared__ uint32_t t[64 * 32];
  int64_t rt, ct;
  tr_tile(g, blockIdx.x, rt, ct);
  const int64_t r0 = rt * 64, c0 = ct * 64;
  if (r0 >= M || c0 >= N) return;
  const int lane = threadIdx.x, ly = threadIdx.y;
#pragma unroll
  for (int k = 0; k < 64; k += TR_ROWS) {
    const int rr = ly + k;
    const int64_t r = r0 + rr, c = c0 + 2 * lane;
    uint32_t w = 0;
    if (r < M) {
      const uint16_t* p = x + r * N + c;
      if (vec_in && c + 1 < N) {
        w = *reinterpret_cast<const uint32_t*>(p);
      } else {
        const uint32_t lo = c < N ? p[0] : 0, hi = c + 1 < N ? p[1] : 0;
        w = lo | hi << 16;
      }
    }
    t[rr * 32 + (lane ^ ((rr >> 1) & 31))] = w;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 64; k += TR_ROWS) {
    const int jj = ly + k;
    const int64_t j = c0 + jj, i = r0 + 2 * lane;
    if (j >= N || i >= M) continue;
    const int w = (jj >> 1) ^ lane, sh = (jj & 1) * 16;
    const uint32_t lo = (t[(2 * lane) * 32 + w] >> sh) & 0xffffu;
    const uint32_t hi = (t[(2 * lane + 1) * 32 + w] >> sh) & 0xffffu;
    uint16_t* p = out + j * M + i;
    if (vec_out && i + 1 < M) {
      *reinterpret_cast<uint32_t*>(p) = lo | hi << 16;
    } else {
      p[0] = (uint16_t)lo;
      if (i + 1 < M) p[1] = (uint16_t)hi;
    }
  }
}

}  // namespace

cudaError_t transpose_launch(const void* x, void* out, int64_t M, int64_t N,
                             int bm, int bn, int order, int dtype,
                             cudaStream_t stream) {
  if (M < 0 || N < 0 || bm <= 0 || bn <= 0 || bm % 64 || bn % 64 ||
      order < 0 || order > 2 || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;  // empty tensors: null pointers
  if (!x || !out) return cudaErrorInvalidValue;
  const int T = dtype == kF32 ? 32 : 64;
  TrGrid g{(M + bm - 1) / bm, (N + bn - 1) / bn, bm / T, bn / T, order};
  const int64_t blocks = g.nI * g.nJ * g.ti * g.tj;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 threads(32, TR_ROWS);
  if (dtype == kF32) {
    transpose_f32_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(out), M, N, g);
  } else {
    const int vec_in = N % 2 == 0 && (uintptr_t)x % 4 == 0;
    const int vec_out = M % 2 == 0 && (uintptr_t)out % 4 == 0;
    transpose_bf16_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), M, N,
        g, vec_in, vec_out);
  }
  return cudaSuccess;
}

}  // namespace tk
