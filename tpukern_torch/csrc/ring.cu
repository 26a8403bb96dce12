// Ring all-gather (#45) and ring reduce-scatter (#46) over the ranks of a
// mesh that share one card.
//
// #45 ring_all_gather_kernel replaces tpukern/parallel/ring_kernels.py:28
// `_ag_kernel` (ring_all_gather :49): rank r ends with every rank's chunk,
// chunk j at [j c, (j + 1) c) of its output, after n - 1 hops to the right
// neighbour. #46 ring_reduce_scatter_kernel replaces :73 `_rs_kernel`
// (ring_reduce_scatter :105): rank r ends with sum_j x[j][r c, (r + 1) c),
// added in the TPU kernel's ring order: chunk c starts at rank c + 1 with
// its own slice, each later rank adds its slice to the partial sum it
// received, and rank c adds last, every add rounded in x's dtype (f32,
// bf16 or f16; the 2-byte types add in f32 and round once, which is the
// rounding of one add in that type). No reassociation: the result equals
// ring_kernels.py's plain walk bit for bit.
//
// The TPU kernels DMA into the right neighbour's VMEM slot and wait on DMA
// semaphores. Here the n ranks' buffers all lie in this card's memory, one
// cooperative launch runs every rank (grid (B, n): blockIdx.y is the rank,
// block b of each rank owns a fixed slice of every chunk), and a message is
// plain stores into the right neighbour's buffer followed by a flag in
// device memory. Each rank writes only its own buffers and its right
// neighbour's; the device code reads the ranks' addresses from a table
// (RingPtrs), so a launch with peer pointers across GPUs would run it as it
// stands.
//
// What bounds them: device memory. #46 reads n R elements and writes R / n
// a rank (R the per-rank operand); #45 writes n c a rank. A ring moves more:
// #45 copies each chunk n - 1 times (2 n - 1 chunk reads and writes a rank),
// and #46's partial sums hop through the slots (L2-sized, below). #46
// reads a rank's own slice for a hop before it waits for the partial sum,
// so the read from device memory overlaps the flag's round trip. The
// design answers:
// - Co-residency. Block b of rank r waits on block b of rank r - 1 (data)
//   and of rank r + 1 (credits), around the whole ring. So every block
//   must be resident at once: the launch is cudaLaunchCooperativeKernel,
//   which fails instead of deadlocking when the grid does not fit, and the
//   grid is sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor times
//   the SMs (and the scratch's capacity). One launch, never one per rank on
//   separate streams.
// - Ordering. The writer: every thread stores, __syncthreads(), then one
//   thread __threadfence()s and stores the flag with st.release.gpu. The
//   reader: one thread spins with ld.acquire.gpu, __syncthreads(), then
//   every thread reads the data with __ldcg (L2, never a stale L1 line).
//   A #46 hop waits and posts twice (data, then credit; done, then data):
//   one wait and one post for both measured no faster on an H100 (more
//   registers, fewer resident blocks).
// - Slot reuse. #45 writes straight into the neighbour's output at the
//   chunk's own position: every position is written once, no slot is
//   reused. #46 gives each (rank, block) a double buffer of one 16 KiB
//   tile in the receiver's scratch; the receiver posts a `done` count in
//   its own memory once it has read a message, and the sender reads it
//   (a read of the neighbour's memory, never a write) before it refills
//   that tile. The scratch is 2 tiles a block whatever R: at most 1056
//   blocks (132 SMs x 8 blocks of 256 threads), 33 MiB, which L2 holds.
// - Flags across calls. Flags are 64-bit and carry absolute values: a call
//   posts base + m + 1 for its message m, where base is an epoch that the
//   wrapper advances each call past every value the call can post. A flag
//   left over from an earlier call (or from another grid shape) is below
//   every target of the next call, so no reset launch is needed. The
//   wrapper keeps one flag buffer a stream, so two calls in flight never
//   share one.
// - A hang fails the run. A wait that lasts RING_SPIN_NS (10 s; a whole
//   call at the timed size takes tens of ms) __trap()s, which ends the
//   launch with an error that the next synchronisation raises.
#include "common.cuh"

namespace tk {
namespace {

constexpr int RING_THREADS = 256;
constexpr int RING_UNITS = 4;  // 16-byte units a thread moves per #46 tile
constexpr int RING_TILE_BYTES = RING_THREADS * RING_UNITS * 16;  // 16 KiB
constexpr int RING_MAX_RANKS = 64;
constexpr unsigned long long RING_SPIN_NS = 10ull * 1000 * 1000 * 1000;

using u64 = unsigned long long;

// each rank's buffers: its operand, its output, its #46 receive slots, its
// data flags (posted by its left neighbour) and its done counts (posted by
// itself, read by its left neighbour); for block b, full[r] + b, done[r] + b
struct RingPtrs {
  const char* in[RING_MAX_RANKS];
  char* out[RING_MAX_RANKS];
  char* slot[RING_MAX_RANKS];
  u64* full[RING_MAX_RANKS];
  u64* done[RING_MAX_RANKS];
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// every thread of the block returns once *flag >= target
__device__ __forceinline__ void wait_flag(const u64* flag, u64 target) {
  if (threadIdx.x == 0 && ld_acquire(flag) < target) {
    const u64 t0 = global_ns();
    while (ld_acquire(flag) < target) {
      __nanosleep(64);
      if (global_ns() - t0 > RING_SPIN_NS) __trap();
    }
  }
  __syncthreads();
}

// after every thread's stores (or loads): post value to flag
__device__ __forceinline__ void post_flag(u64* flag, u64 value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, value);
  }
}

// ---------------------------------------------------------------- #45

// dst[i] = src[i] for the units i of this block (i / RING_THREADS = b mod
// gridDim.x): the same units in every rank, so block b only ever reads what
// block b of its left neighbour wrote. cg: src was written in this launch.
template <typename U, bool CG>
__device__ __forceinline__ void ag_copy(const U* src, U* dst, U* dst2,
                                        int64_t units) {
  const int64_t stride = (int64_t)gridDim.x * RING_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * RING_THREADS + threadIdx.x;
       i < units; i += 4 * stride) {
    U v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = i + k * stride;
      if (j < units) v[k] = CG ? __ldcg(src + j) : src[j];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = i + k * stride;
      if (j < units) {
        dst[j] = v[k];
        if (dst2) dst2[j] = v[k];
      }
    }
  }
}

// U: the copy unit, 16 bytes where every address and the chunk allow it
template <typename U>
__global__ void __launch_bounds__(RING_THREADS)
ring_all_gather_kernel(RingPtrs p, int n, int64_t chunk, u64 base) {
  const int r = blockIdx.y, right = (r + 1) % n;
  const U* local = reinterpret_cast<const U*>(p.in[r]);
  U* mine = reinterpret_cast<U*>(p.out[r]);
  U* theirs = reinterpret_cast<U*>(p.out[right]);
  // hop 0: my chunk into my output and my right neighbour's
  ag_copy<U, false>(local, mine + r * chunk,
                    n > 1 ? theirs + r * chunk : nullptr, chunk);
  if (n == 1) return;
  post_flag(p.full[right] + blockIdx.x, base + 1);
  // hop s: forward the chunk my left neighbour delivered at hop s - 1
  for (int s = 1; s < n - 1; ++s) {
    wait_flag(p.full[r] + blockIdx.x, base + s);
    const int64_t at = (int64_t)((r - s + n) % n) * chunk;
    ag_copy<U, true>(mine + at, theirs + at, nullptr, chunk);
    post_flag(p.full[right] + blockIdx.x, base + s + 1);
  }
}

// ---------------------------------------------------------------- #46

// 1 (a scalar unit) or the elements of a 16-byte unit
template <typename T, bool VEC>
struct RsUnit {
  static constexpr int E = VEC ? 16 / (int)sizeof(T) : 1;
};

template <typename T>
__device__ __forceinline__ T ldcg1(const T* p);
template <>
__device__ __forceinline__ float ldcg1<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ bf16 ldcg1<bf16>(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}
template <>
__device__ __forceinline__ f16 ldcg1<f16>(const f16* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// v = the E elements at p (widened to f32)
template <typename T, int E, bool CG>
__device__ __forceinline__ void load_unit(const T* p, float* v) {
  if constexpr (E == 1) {
    v[0] = to_f32(CG ? ldcg1(p) : p[0]);
  } else {
    Pack<T, E> pk;
    const uint4* q = reinterpret_cast<const uint4*>(p);
    *reinterpret_cast<uint4*>(&pk) = CG ? __ldcg(q) : *q;
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = to_f32(pk.v[i]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_unit(T* p, const float* v) {
  Pack<T, E> pk;
#pragma unroll
  for (int i = 0; i < E; ++i) pk.v[i] = from_f32<T>(v[i]);
  if constexpr (E == 1) {
    p[0] = pk.v[0];
  } else {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&pk);
  }
}

// A tile is RING_THREADS * RING_UNITS units; thread t owns units
// k * RING_THREADS + t. acc holds values of T widened to f32; mine the
// rank's own slice, fetched before the wait for the partial sum.
template <typename T, int E>
struct RsTile {
  static constexpr int64_t ELEMS = (int64_t)RING_THREADS * RING_UNITS * E;
  float acc[RING_UNITS][E];
  Pack<T, E> mine[RING_UNITS];

  // unit k's offset in the tile (inside the chunk while < valid)
  __device__ __forceinline__ static int64_t off(int k) {
    return ((int64_t)k * RING_THREADS + threadIdx.x) * E;
  }

  template <bool CG>
  __device__ __forceinline__ void load(const T* p, int64_t valid) {
#pragma unroll
    for (int k = 0; k < RING_UNITS; ++k)
      if (off(k) < valid) load_unit<T, E, CG>(p + off(k), acc[k]);
  }

  __device__ __forceinline__ void fetch(const T* p, int64_t valid) {
#pragma unroll
    for (int k = 0; k < RING_UNITS; ++k) {
      if (off(k) >= valid) continue;
      if constexpr (E == 1) {
        mine[k].v[0] = p[off(k)];
      } else {
        *reinterpret_cast<uint4*>(&mine[k]) =
            *reinterpret_cast<const uint4*>(p + off(k));
      }
    }
  }

  // acc = round_T(acc + mine), element by element
  __device__ __forceinline__ void add_mine(int64_t valid) {
#pragma unroll
    for (int k = 0; k < RING_UNITS; ++k) {
      if (off(k) >= valid) continue;
#pragma unroll
      for (int i = 0; i < E; ++i)
        acc[k][i] = to_f32(from_f32<T>(acc[k][i] + to_f32(mine[k].v[i])));
    }
  }

  __device__ __forceinline__ void store(T* p, int64_t valid) const {
#pragma unroll
    for (int k = 0; k < RING_UNITS; ++k)
      if (off(k) < valid) store_unit<T, E>(p + off(k), acc[k]);
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(RING_THREADS)
ring_reduce_scatter_kernel(RingPtrs p, int n, int64_t chunk, u64 base) {
  constexpr int E = RsUnit<T, VEC>::E;
  constexpr int SLOT = RING_TILE_BYTES / (int)sizeof(T);  // elements a slot
  using Tile = RsTile<T, E>;
  const int r = blockIdx.y, b = blockIdx.x, right = (r + 1) % n;
  const T* x = reinterpret_cast<const T*>(p.in[r]);
  T* out = reinterpret_cast<T*>(p.out[r]);
  const T* inbox = reinterpret_cast<const T*>(
      p.slot[r] + (size_t)b * 2 * RING_TILE_BYTES);
  T* outbox = reinterpret_cast<T*>(
      p.slot[right] + (size_t)b * 2 * RING_TILE_BYTES);
  u64 *my_full = p.full[r] + b, *right_full = p.full[right] + b;
  u64 *my_done = p.done[r] + b, *right_done = p.done[right] + b;
  const int64_t ntiles = (chunk + Tile::ELEMS - 1) / Tile::ELEMS;
  u64 sent = 0, received = 0;
  Tile tile;

  auto send = [&](int64_t valid) {
    // the slot's previous message (sent - 2) must have been read
    if (sent >= 2) wait_flag(right_done, base + sent - 1);
    tile.store(outbox + (sent & 1) * SLOT, valid);
    post_flag(right_full, base + sent + 1);
    ++sent;
  };

  for (int64_t t = b; t < ntiles; t += gridDim.x) {
    const int64_t e0 = t * Tile::ELEMS, valid = chunk - e0;
    if (n == 1) {  // the sum of one operand
      tile.template load<false>(x + e0, valid);
      tile.store(out + e0, valid);
      continue;
    }
    // hop 0: my slice of my left neighbour's chunk
    tile.template load<false>(x + (int64_t)((r + n - 1) % n) * chunk + e0,
                              valid);
    send(valid);
    for (int s = 0; s < n - 1; ++s) {
      // my slice of chunk (r - 2 - s) mod n, read while the partial sum
      // of that chunk is on its way
      tile.fetch(x + (int64_t)((r + n - 2 - s) % n) * chunk + e0, valid);
      wait_flag(my_full, base + received + 1);
      tile.template load<true>(inbox + (received & 1) * SLOT, valid);
      // the add consumes the slot's loads before the slot is handed back
      tile.add_mine(valid);
      post_flag(my_done, base + received + 1);
      ++received;
      if (s < n - 2)
        send(valid);
      else
        tile.store(out + e0, valid);  // chunk r, summed
    }
  }
}

// B blocks a rank: as many as can be resident with n ranks (and the
// scratch holds), at most `work` (tiles or copy units per block's stride)
template <typename K>
cudaError_t ring_blocks(K kernel, int n, int64_t work, int max_blocks,
                        int* B) {
  int dev, sms, occ, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                      RING_THREADS, 0);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const int64_t resident = (int64_t)occ * sms;
  const int64_t cap = resident < max_blocks ? resident : max_blocks;
  int64_t b = cap / n;
  if (b < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (work < b) b = work < 1 ? 1 : work;
  *B = (int)b;
  return cudaSuccess;
}

template <typename K>
cudaError_t ring_launch(K kernel, int B, int n, RingPtrs& p, int64_t chunk,
                        u64 base, cudaStream_t stream) {
  void* args[] = {&p, &n, &chunk, &base};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(B, n), dim3(RING_THREADS), args, 0,
                                     stream);
}

template <typename U>
cudaError_t ag_launch(RingPtrs& p, int n, int64_t chunk_bytes, u64 base,
                      int max_blocks, cudaStream_t stream) {
  const int64_t units = chunk_bytes / (int64_t)sizeof(U);
  int B;
  cudaError_t e = ring_blocks(ring_all_gather_kernel<U>, n,
                              (units + RING_THREADS - 1) / RING_THREADS,
                              max_blocks, &B);
  if (e != cudaSuccess) return e;
  for (int r = 0; r < n; ++r) {
    p.full[r] += (size_t)r * B;
  }
  return ring_launch(ring_all_gather_kernel<U>, B, n, p, units, base, stream);
}

template <typename T, bool VEC>
cudaError_t rs_launch(RingPtrs& p, int n, int64_t chunk, u64 base,
                      int max_blocks, cudaStream_t stream) {
  constexpr int64_t TILE = RsTile<T, RsUnit<T, VEC>::E>::ELEMS;
  int B;
  cudaError_t e = ring_blocks(ring_reduce_scatter_kernel<T, VEC>, n,
                              (chunk + TILE - 1) / TILE, max_blocks, &B);
  if (e != cudaSuccess) return e;
  for (int r = 0; r < n; ++r) {
    p.slot[r] += (size_t)r * B * 2 * RING_TILE_BYTES;
    p.full[r] += (size_t)r * B;
    p.done[r] += (size_t)r * B;
  }
  return ring_launch(ring_reduce_scatter_kernel<T, VEC>, B, n, p, chunk, base,
                     stream);
}

}  // namespace

// x: n operands of n chunk_bytes (rank r's local chunk at x + r chunk_bytes);
// out: n outputs of n chunk_bytes; flags: max_blocks data flags
cudaError_t ring_all_gather_launch(const void* x, void* out, u64* flags,
                                   int n, int64_t chunk_bytes, u64 base,
                                   int max_blocks, cudaStream_t stream) {
  if (n < 1 || n > RING_MAX_RANKS || chunk_bytes < 0 || max_blocks < 1)
    return cudaErrorInvalidValue;
  if (chunk_bytes == 0) return cudaSuccess;
  if (!x || !out || !flags) return cudaErrorInvalidValue;
  RingPtrs p{};
  for (int r = 0; r < n; ++r) {
    p.in[r] = static_cast<const char*>(x) + (size_t)r * chunk_bytes;
    p.out[r] = static_cast<char*>(out) + (size_t)r * n * chunk_bytes;
    p.full[r] = flags;  // + r B, once B is known
  }
  // the widest unit that divides the chunk and both base addresses
  const uint64_t a = (uint64_t)chunk_bytes | (uintptr_t)x | (uintptr_t)out;
  if (a % 16 == 0) return ag_launch<uint4>(p, n, chunk_bytes, base, max_blocks, stream);
  if (a % 8 == 0) return ag_launch<uint2>(p, n, chunk_bytes, base, max_blocks, stream);
  if (a % 4 == 0) return ag_launch<unsigned>(p, n, chunk_bytes, base, max_blocks, stream);
  if (a % 2 == 0)
    return ag_launch<unsigned short>(p, n, chunk_bytes, base, max_blocks, stream);
  return ag_launch<unsigned char>(p, n, chunk_bytes, base, max_blocks, stream);
}

// x: n operands of n chunk elements; out: n outputs of chunk elements;
// slots: max_blocks x 2 tiles; flags: max_blocks data flags, then
// max_blocks done counts
cudaError_t ring_reduce_scatter_launch(const void* x, void* out, void* slots,
                                       u64* flags, int n, int64_t chunk,
                                       int dtype, u64 base, int max_blocks,
                                       cudaStream_t stream) {
  if (n < 1 || n > RING_MAX_RANKS || chunk < 0 || max_blocks < 1 ||
      (dtype != kF32 && dtype != kBF16 && dtype != kF16))
    return cudaErrorInvalidValue;
  if (chunk == 0) return cudaSuccess;
  if (!x || !out || !slots || !flags) return cudaErrorInvalidValue;
  const int64_t es = dtype == kF32 ? 4 : 2;
  RingPtrs p{};
  for (int r = 0; r < n; ++r) {
    p.in[r] = static_cast<const char*>(x) + (size_t)r * n * chunk * es;
    p.out[r] = static_cast<char*>(out) + (size_t)r * chunk * es;
    p.slot[r] = static_cast<char*>(slots);  // + r B tiles, once B is known
    p.full[r] = flags;
    p.done[r] = flags + max_blocks;
  }
  const bool vec = ((uint64_t)(chunk * es) | (uintptr_t)x | (uintptr_t)out |
                    (uintptr_t)slots) % 16 == 0;
  if (dtype == kF32)
    return vec ? rs_launch<float, true>(p, n, chunk, base, max_blocks, stream)
               : rs_launch<float, false>(p, n, chunk, base, max_blocks, stream);
  if (dtype == kBF16)
    return vec ? rs_launch<bf16, true>(p, n, chunk, base, max_blocks, stream)
               : rs_launch<bf16, false>(p, n, chunk, base, max_blocks, stream);
  return vec ? rs_launch<f16, true>(p, n, chunk, base, max_blocks, stream)
             : rs_launch<f16, false>(p, n, chunk, base, max_blocks, stream);
}

}  // namespace tk
