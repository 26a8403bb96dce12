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
// #40 embedding_select_kernel replaces :108 `kernel` (embedding_onehot
//     :101), which computes the gather as onehot(idx) . W on the matrix
//     unit because the TPU gathers slowly and holds the table in VMEM.
//     Each one-hot row has one nonzero term, so the product selects a
//     row: on the H100, whose gather is native, the kernel selects it.
//     A block takes 16 tokens, loads their indices into shared memory,
//     and its 256 threads move the rows as 16-byte units (elements where
//     the rows are not whole 16-byte chunks on aligned bases), four
//     loads in flight a thread before their stores. No product is left,
//     so no tensor core runs, and the time no longer grows with V.
//
// Indices outside [0, V) never read outside the table. #38 and #39 take
// the TPU kernels' rule (JAX's interpret mode): a negative index counts
// from the end, then the index is clamped to [0, V - 1]; #40 gives a zero
// row, as its one-hot product does (on a finite table its result is the
// product's; a -0.0 entry stays -0.0 where the product's sum gives +0.0).
// All three are bound by memory bandwidth: each distinct row read once
// (a repeated row comes from the L2), S rows written, the indices.
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

// #40: a block of SEL_THREADS threads selects the rows of SEL_TOKENS
// tokens, SEL_UNROLL loads in flight a thread before their stores
constexpr int SEL_TOKENS = 16, SEL_THREADS = 256, SEL_UNROLL = 4;

// the block's nt rows of P units (16-byte chunks, or elements) each, from
// table w into out (the block's first output row), dealt to the threads
// in turn; a row of -1 (an index outside [0, V)) reads nothing and
// writes zeros
template <typename U>
__device__ __forceinline__ void select_rows(const int* rows,
                                            const U* __restrict__ w,
                                            U* __restrict__ out, int nt,
                                            int64_t P) {
  const int64_t n = nt * P;
  for (int64_t i0 = threadIdx.x; i0 < n; i0 += SEL_UNROLL * SEL_THREADS) {
    U v[SEL_UNROLL];
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u) {
      const int64_t i = i0 + u * SEL_THREADS;
      if (i < n) {
        const int64_t t = i / P;
        const int r = rows[t];
        v[u] = r >= 0 ? w[r * P + (i - t * P)] : U{};
      }
    }
#pragma unroll
    for (int u = 0; u < SEL_UNROLL; ++u) {
      const int64_t i = i0 + u * SEL_THREADS;
      if (i < n) out[i] = v[u];
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(SEL_THREADS)
embedding_select_kernel(const int* __restrict__ idx, const E* __restrict__ w,
                        E* __restrict__ out, int S, int V, int64_t D,
                        int vec) {
  __shared__ int rows[SEL_TOKENS];
  const int64_t t0 = (int64_t)blockIdx.x * SEL_TOKENS;
  const int nt = S - t0 < SEL_TOKENS ? (int)(S - t0) : SEL_TOKENS;
  if ((int)threadIdx.x < nt) {
    const int i = idx[t0 + threadIdx.x];
    rows[threadIdx.x] = i >= 0 && i < V ? i : -1;
  }
  __syncthreads();
  if (vec)
    select_rows(rows, reinterpret_cast<const uint4*>(w),
                reinterpret_cast<uint4*>(out + t0 * D), nt,
                D * (int64_t)sizeof(E) / 16);
  else
    select_rows(rows, w, out + t0 * D, nt, D);
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
  const unsigned blocks = (unsigned)((S + SEL_TOKENS - 1) / SEL_TOKENS);
  by_size(dtype, [&](auto tag) {
    using E = decltype(tag);
    embedding_select_kernel<E><<<blocks, SEL_THREADS, 0, stream>>>(
        idx, static_cast<const E*>(w), static_cast<E*>(out), S, V, D,
        whole_chunks(D, sizeof(E), w, out));
  });
  return cudaSuccess;
}

}  // namespace tk
