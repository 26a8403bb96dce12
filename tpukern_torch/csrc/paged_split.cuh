// The split-KV pieces that the paged kernels with query-row tiles share
// (csrc/paged_prefill.cu's float prefix kernels and csrc/paged_quant.cu's
// quantized decode and prefix kernel): the rows of a block, a launch's
// split, the workspace of the splits' partials and their merge by ticket.
#pragma once

#include "common.cuh"

namespace tk {
namespace {

// The rows of one block: (b, kv head hk) and rows [row0, row0 + BQ) of the
// t-major flattening; row r is token r / group of query head
// hk * group + r % group.
struct PrefixRows {
  int64_t b, hk;
  int Hq, T, group, R;  // R = T * group rows in all
  int base;             // the position of token 0: lengths[b] - T
  int kv_end;           // one past the last position any row of the block sees
  int q_first;          // the first row's position

  __device__ PrefixRows(const int* lengths, int Hq_, int Hkv, int T_, int S,
                        int row0, int BQ, bool ring)
      : b(blockIdx.z), hk(blockIdx.y), Hq(Hq_), T(T_), group(Hq_ / Hkv),
        R(T_ * (Hq_ / Hkv)) {
    base = lengths[b] - T;
    const int last = min(row0 + BQ, R) - 1;
    q_first = base + row0 / group;
    // a ring's slots hold positions in no order: every written one
    kv_end = max(0, min(S, ring ? base + T : base + last / group + 1));
  }
  // the query head of row r (rows past R take the last row's)
  __device__ int head(int r) const { return hk * group + min(r, R - 1) % group; }
  // offset of row r in q or o (B, Hq, T, D)
  __device__ int64_t offset(int r, int D) const {
    return ((b * Hq + hk * group + r % group) * T + r / group) * (int64_t)D;
  }
  // the position of row r (rows past R take the last row's)
  __device__ int pos(int r) const { return base + min(r, R - 1) / group; }
};

// A launch's split: slots a split (a multiple of the kernel's KV tile), and with more
// than one split the workspace and the ticket counters.
struct Split {
  int chunk;
  float* ws;
  int* tickets;
};

// The workspace of a launch with n_split > 1: for each (b, hk, tile)
// triple pt = (b Hkv + hk) n_tiles + tile, split z and row i of the tile
// (i < tq = min(BQ, R)), the partial o (D floats) at index (pt n_split +
// z) tq + i; then all the m, then all the l.
struct SplitWs {
  float* o;
  float* m;
  float* l;
  int64_t pt;  // this block's triple
  int tq;
  __device__ SplitWs(float* ws, int n_split, int BQ, int R, int D) {
    const int n_tiles = gridDim.x / n_split;
    tq = min(BQ, R);
    pt = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * n_tiles +
         blockIdx.x / n_split;
    const int64_t rows = (int64_t)gridDim.z * gridDim.y * n_tiles * n_split * tq;
    o = ws;
    m = ws + rows * D;
    l = m + rows;
  }
  // the index of row i of split z
  __device__ int64_t at(int z, int n_split, int i) const {
    return (pt * n_split + z) * tq + i;
  }
};

// 4 output values of row r from column d on: 16 bytes (f32) or 8 (bf16)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_f32(v.x, v.y),
                                            pack_f32(v.z, v.w));
}

// splits whose partials a merging thread loads at once
constexpr int MERGE_Z = 8;

// After every thread has written its rows' partials: the last block of
// the triple to take a ticket merges the n_split partials of each of its
// rows [row0, row0 + nrows) in split order, in f32 (M = the largest m; o
// = sum exp(m_z - M) o_z / sum exp(m_z - M) l_z, 0 where that sum is 0),
// writes them to o and resets the counter (csrc/paged_attention.cu's
// merge). A row's M and sum come first, a thread a row; then each thread
// sums 4 columns of a row at a time. Both loops load MERGE_Z splits'
// partials before they use any (a loop whose every step waits for its
// own loads ran one L2 round trip a split and an output: 30-70 us of a
// 64-row tile's merge, PERF.md). m_s, l_s: nrows floats of shared memory.
template <typename T>
__device__ void merge_splits(const PrefixRows& rows, int row0, int nrows,
                             const SplitWs& w, int n_split, int D,
                             int* tickets, T* o, float* m_s, float* l_s,
                             bool* last_s) {
  const int tid = threadIdx.x;
  __threadfence();  // the partials are visible to every block before the ticket
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(&tickets[w.pt], 1) == n_split - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // (reads through L2 only: other blocks wrote the partials)
  for (int i = tid; i < nrows; i += blockDim.x) {
    float M = NEG_BIG, L = 0.f;
    for (int z0 = 0; z0 < n_split; z0 += MERGE_Z) {
      float mz[MERGE_Z];
#pragma unroll
      for (int j = 0; j < MERGE_Z; ++j)
        mz[j] = z0 + j < n_split ? __ldcg(w.m + w.at(z0 + j, n_split, i))
                                 : NEG_BIG;
#pragma unroll
      for (int j = 0; j < MERGE_Z; ++j) M = fmaxf(M, mz[j]);
    }
    for (int z0 = 0; z0 < n_split; z0 += MERGE_Z) {
      float mz[MERGE_Z], lz[MERGE_Z];
#pragma unroll
      for (int j = 0; j < MERGE_Z; ++j) {
        const bool in = z0 + j < n_split;
        const int64_t h = w.at(in ? z0 + j : 0, n_split, i);
        mz[j] = in ? __ldcg(w.m + h) : NEG_BIG;
        lz[j] = in ? __ldcg(w.l + h) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < MERGE_Z; ++j) L = fmaf(expf(mz[j] - M), lz[j], L);
    }
    m_s[i] = M;
    l_s[i] = L;
  }
  __syncthreads();
  const int D4 = D / 4;
  for (int i = tid; i < nrows * D4; i += blockDim.x) {
    const int r = i / D4, d = (i % D4) * 4;
    const float M = m_s[r], L = l_s[r];
    float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < n_split; z0 += MERGE_Z) {
      float mz[MERGE_Z];
      float4 oz[MERGE_Z];
#pragma unroll
      for (int j = 0; j < MERGE_Z; ++j) {
        const bool in = z0 + j < n_split;
        const int64_t h = w.at(in ? z0 + j : 0, n_split, r);
        mz[j] = in ? __ldcg(w.m + h) : NEG_BIG;
        oz[j] = in ? __ldcg(reinterpret_cast<const float4*>(w.o + h * D + d))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < MERGE_Z; ++j) {
        const float a = expf(mz[j] - M);
        O.x = fmaf(a, oz[j].x, O.x);
        O.y = fmaf(a, oz[j].y, O.y);
        O.z = fmaf(a, oz[j].z, O.z);
        O.w = fmaf(a, oz[j].w, O.w);
      }
    }
    store4(o + rows.offset(row0 + r, D) + d,
           L == 0.f ? make_float4(0.f, 0.f, 0.f, 0.f)
                    : make_float4(O.x / L, O.y / L, O.z / L, O.w / L));
  }
  if (tid == 0) tickets[w.pt] = 0;
}
}  // namespace
}  // namespace tk
