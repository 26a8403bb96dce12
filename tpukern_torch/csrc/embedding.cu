// Embedding: out[s] = weight[idx[s]], a row gather from a (V, D) table,
// in three designs, one for each of the TPU's three gather mechanisms.
//
// #38 embedding_row_kernel replaces tpukern/ops/embedding.py:39 `kernel`
//     (embedding_prefetch :29), which gets one weight row a grid step
//     from the scalar-prefetched index: one block a token (the
//     reference's embedding.cu:16-69 design), its threads copying the row
//     with 16-byte loads and stores where the row is whole 16-byte chunks
//     on aligned bases, element by element otherwise.
// #39 embedding_dma_kernel replaces :71 `kernel` (embedding_dma :61),
//     which starts one async copy a token of its block and then waits for
//     all of them (:191-201 of the design): one block a block_tokens
//     tokens issues every row's 16-byte `cp.async` copies into shared
//     memory before it waits for any, with one `cp.async.wait_all`, then
//     stores the rows out. `cp.async` rather than `cp.async.bulk`: the
//     copy is spread over all the block's threads, as the rows are, and
//     needs no mbarrier and no transaction count; a row wider than the
//     shared buffer is copied a column chunk at a time, each chunk's
//     copies all in flight together. A row that is not whole 16-byte
//     chunks on aligned bases takes an element-wise path in the same
//     kernel.
// #40 embedding_onehot_{bf16,f32}_kernel replace :108 `kernel`
//     (embedding_onehot :101), a GEMM onehot(idx) . W: each block owns a
//     128 x 128 tile of (tokens, columns) and walks V in chunks; for each
//     chunk it builds the tile's one-hot A in shared memory from idx and
//     multiplies it against the same rows of W, accumulating in f32. bf16
//     runs on mma.sync m16n8k16 (common.cuh's fragment layouts); f32 on
//     CUDA-core FMAs in full f32 (common.cuh's 8 x 8 register tile), never
//     TF32, which would round W to 10 mantissa bits. Both are exact: each
//     output has one nonzero term, 1 x w. Its cost is 2 S V D operations,
//     the design's (for small vocabularies).
//
// Indices outside [0, V) never read outside the table. #38 and #39 take
// the TPU kernels' rule (JAX's interpret mode): a negative index counts
// from the end, then the index is clamped to [0, V - 1]; #40 gives a zero
// row, as its one-hot product does. #38 and #39 are bound by memory
// bandwidth (S rows read, S rows written, the indices); #40 by its
// operations.
#include "common.cuh"

namespace tk {
namespace {

// #39's shared buffer and its block_tokens at most: with the rows' table
// (4 KiB) under the 48 KiB a block has without opting in
constexpr int DMA_BUF = 40 * 1024;
constexpr int DMA_MAX_TOKENS = 1024;

// the row #38 and #39 read for index i of a V-row table
__device__ __forceinline__ int clamp_row(int i, int V) {
  if (i < 0) i += V;
  return i < 0 ? 0 : (i >= V ? V - 1 : i);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// E: an unsigned integer of the element's size (a gather only copies)
template <typename E>
__global__ void __launch_bounds__(256)
embedding_row_kernel(const int* __restrict__ idx, const E* __restrict__ w,
                     E* __restrict__ out, int V, int64_t D, int vec) {
  const int64_t s = blockIdx.x;
  const E* src = w + (int64_t)clamp_row(idx[s], V) * D;
  E* dst = out + s * D;
  if (vec) {
    const int64_t n = D * (int64_t)sizeof(E) / 16;
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int64_t i = threadIdx.x; i < D; i += blockDim.x) dst[i] = src[i];
  }
}

// the tokens [blockIdx.x * bt, + bt); chunk: 16-byte chunks of a row a
// pass (vec only)
template <typename E>
__global__ void __launch_bounds__(256)
embedding_dma_kernel(const int* __restrict__ idx, const E* __restrict__ w,
                     E* __restrict__ out, int V, int64_t D, int bt,
                     int64_t chunk, int vec) {
  extern __shared__ __align__(16) unsigned char dma_buf[];
  __shared__ int rows[DMA_MAX_TOKENS];
  const int64_t t0 = (int64_t)blockIdx.x * bt;
  for (int t = threadIdx.x; t < bt; t += blockDim.x)
    rows[t] = clamp_row(idx[t0 + t], V);
  __syncthreads();
  if (!vec) {
    for (int t = 0; t < bt; ++t)
      for (int64_t i = threadIdx.x; i < D; i += blockDim.x)
        out[(t0 + t) * D + i] = w[(int64_t)rows[t] * D + i];
    return;
  }
  uint4* buf = reinterpret_cast<uint4*>(dma_buf);
  const int64_t P = D * (int64_t)sizeof(E) / 16;
  for (int64_t p0 = 0; p0 < P; p0 += chunk) {
    const int64_t pc = P - p0 < chunk ? P - p0 : chunk;
    const int64_t n = bt * pc;
    // every row's copies in flight before the block waits for any
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      const int64_t t = i / pc, p = p0 + i - t * pc;
      cp_async16(&buf[i],
                 reinterpret_cast<const uint4*>(w + (int64_t)rows[t] * D) + p);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      const int64_t t = i / pc, p = p0 + i - t * pc;
      reinterpret_cast<uint4*>(out + (t0 + t) * D)[p] = buf[i];
    }
    __syncthreads();  // the buffer is free for the next chunk
  }
}

// idx of the tile's rows from m0, -1 past S or outside [0, V) (a zero
// one-hot row)
__device__ __forceinline__ void tile_ids(int* ids, const int* idx, int m0,
                                         int S, int V, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int i = m0 + r < S ? idx[m0 + r] : -1;
    ids[r] = i >= 0 && i < V ? i : -1;
  }
}

// bf16: 8 warps in a 2 x 4 grid, each a 64 x 32 sub-tile of 4 x 4
// m16n8k16 products, V in chunks of H_BK
__global__ void __launch_bounds__(H_THREADS)
embedding_onehot_bf16_kernel(const int* __restrict__ idx,
                             const bf16* __restrict__ w,
                             bf16* __restrict__ out, int S, int V, int D,
                             int vec_w) {
  __shared__ __align__(16) bf16 as[H_BM * H_LDK];
  __shared__ __align__(16) bf16 bs[H_BK * H_LDN];
  __shared__ int ids[H_BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;
  tile_ids(ids, idx, m0, S, V, H_BM);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < V; k0 += H_BK) {
    __syncthreads();  // ids are written; the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = tid + i * H_THREADS;
      // A: row r's 8 one-hot entries at k0 + kc: a 1.0 (0x3F80) where
      // the row's index falls
      const int r = ch >> 2, kc = (ch & 3) * 8, c = k0 + kc;
      const int id = ids[r];
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = (id == c + 2 * e ? 0x3F80u : 0u) |
               (id == c + 2 * e + 1 ? 0x3F800000u : 0u);
      *reinterpret_cast<uint4*>(&as[r * H_LDK + kc]) =
          make_uint4(a[0], a[1], a[2], a[3]);
      // B: W's rows k0 + kr, columns n0 + nc; zeros past V and D
      const int kr = ch >> 4, nc = (ch & 15) * 8;
      *reinterpret_cast<uint4*>(&bs[kr * H_LDN + nc]) =
          load8(w, k0 + kr, V, n0 + nc, D, vec_w);
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
        const bf16* bp = &bs[(ks * 16 + 2 * t) * H_LDN + wn + nt * 8 + g];
        const uint32_t b0 = pack_bf16(bp[0], bp[H_LDN]);
        const uint32_t b1 = pack_bf16(bp[8 * H_LDN], bp[9 * H_LDN]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + hgemm_row(warp, mt, g, e);
        const int c = n0 + hgemm_col(warp, nt, t, e);
        if (r < S && c < D)
          out[(int64_t)r * D + c] = __float2bfloat16(acc[mt][nt][e]);
      }
}

// f32: thread (tid % 16, tid / 16) holds the 8 x 8 outputs at
// sgemm_pos; V in chunks of F_BK
__global__ void __launch_bounds__(F_THREADS)
embedding_onehot_f32_kernel(const int* __restrict__ idx,
                            const float* __restrict__ w,
                            float* __restrict__ out, int S, int V, int D) {
  __shared__ __align__(16) float as[F_BK][F_BM];
  __shared__ __align__(16) float bs[F_BK][F_BN];
  __shared__ int ids[F_BM];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  // loader: chunk row tid / 32, tile rows (A) or columns (B) (tid % 32) * 4
  const int lk = tid >> 5, lc = (tid & 31) * 4;
  tile_ids(ids, idx, m0, S, V, F_BM);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < V; k0 += F_BK) {
    __syncthreads();
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      as[lk][lc + i] = ids[lc + i] == k ? 1.f : 0.f;
      const int n = n0 + lc + i;
      bs[lk][lc + i] = k < V && n < D ? w[(int64_t)k * D + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk)
      fma_8x8(acc, *reinterpret_cast<const float4*>(&as[kk][ty * 4]),
              *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]),
              *reinterpret_cast<const float4*>(&bs[kk][tx * 4]),
              *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = m0 + sgemm_pos(i, ty), c = n0 + sgemm_pos(j, tx);
      if (r < S && c < D) out[(int64_t)r * D + c] = acc[i][j];
    }
}

// f(E()) with E the unsigned integer of the (f32, bf16 or f16) dtype's size
template <typename F>
void by_size(int dtype, F&& f) {
  if (dtype == kF32) f(uint32_t());
  else f(uint16_t());
}

bool whole_chunks(int64_t D, int64_t size, const void* a, const void* b) {
  return (D * size) % 16 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
}

}  // namespace

// mode 0: #38 (one block a token), 1: #39 (block_tokens a block)
cudaError_t embedding_gather_launch(const int* idx, const void* w, void* out,
                                    int64_t S, int V, int64_t D,
                                    int block_tokens, int mode, int dtype,
                                    cudaStream_t stream) {
  if (S < 0 || V <= 0 || D < 0 || S > 0x7fffffff || (mode != 0 && mode != 1) ||
      (mode == 1 && (block_tokens <= 0 || block_tokens > DMA_MAX_TOKENS ||
                     S % block_tokens != 0)) ||
      (dtype != kF32 && dtype != kBF16 && dtype != kF16))
    return cudaErrorInvalidValue;
  if (S == 0 || D == 0) return cudaSuccess;  // empty tensors: null pointers
  if (!idx || !w || !out) return cudaErrorInvalidValue;
  by_size(dtype, [&](auto tag) {
    using E = decltype(tag);
    const E* wt = static_cast<const E*>(w);
    E* ot = static_cast<E*>(out);
    const int vec = whole_chunks(D, sizeof(E), w, out);
    const int64_t P = D * (int64_t)sizeof(E) / 16;
    if (mode == 0) {
      const int64_t want = vec ? P : D;
      int threads = 32;
      while (threads < 256 && threads < want) threads *= 2;
      embedding_row_kernel<E><<<(unsigned)S, threads, 0, stream>>>(
          idx, wt, ot, V, D, vec);
      return;
    }
    // a pass holds `chunk` 16-byte chunks of each of the block's rows
    const int64_t cap = DMA_BUF / 16 / block_tokens;
    const int64_t chunk = vec ? (P < cap ? P : cap) : 1;
    const int64_t n = vec ? block_tokens * chunk : D;
    int threads = 32;
    while (threads < 256 && threads < n) threads *= 2;
    const int smem = vec ? (int)(block_tokens * chunk * 16) : 0;
    embedding_dma_kernel<E><<<(unsigned)(S / block_tokens), threads, smem,
                              stream>>>(idx, wt, ot, V, D, block_tokens,
                                        chunk, vec);
  });
  return cudaSuccess;
}

// #40: out (S, D) of w's dtype (f32 or bf16)
cudaError_t embedding_onehot_launch(const int* idx, const void* w, void* out,
                                    int S, int V, int D, int dtype,
                                    cudaStream_t stream) {
  if (S < 0 || V <= 0 || D < 0 || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  if (S == 0 || D == 0) return cudaSuccess;  // empty tensors: null pointers
  if (!idx || !w || !out) return cudaErrorInvalidValue;
  if ((S + H_BM - 1) / H_BM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((D + H_BN - 1) / H_BN, (S + H_BM - 1) / H_BM);
  if (dtype == kBF16) {
    const int vec_w = whole_chunks(D, 2, w, w);
    embedding_onehot_bf16_kernel<<<grid, H_THREADS, 0, stream>>>(
        idx, static_cast<const bf16*>(w), static_cast<bf16*>(out), S, V, D,
        vec_w);
  } else {
    embedding_onehot_f32_kernel<<<grid, F_THREADS, 0, stream>>>(
        idx, static_cast<const float*>(w), static_cast<float*>(out), S, V,
        D);
  }
  return cudaSuccess;
}

}  // namespace tk
