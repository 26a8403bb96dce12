// Hopper (sm_90a) building blocks in raw PTX: TMA tensor maps and tile
// loads, mbarriers, and wgmma's shared-memory descriptors, product and
// sync; and on them the GEMM main loop (gemm_pipeline) of csrc/matmul.cu
// (#1-#3, #17), csrc/grouped_matmul.cu's gmm (#28) and tgmm (#29), and
// csrc/cross_entropy.cu's bf16 forward (#13) and backward (#14/#15); and
// its f32 form on split-TF32 products (gemm_pipeline_tf32) of the f32
// #1-#3, #17, #13-#15, #28 and #29.
// csrc/matmul_naive.cu (#16) uses the blocks with one stage of its own,
// csrc/flash_attention.cu's bf16 forward (#6) with a ring of its own and
// the register-A products (P from registers).
//
// The layout they all assume is the one TMA's 128-byte swizzle writes and
// wgmma's 128B-swizzle descriptors read. A tile is a stack of 128-byte
// rows in shared memory whose base is 1024-byte aligned; the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) of that row (sw128_offset).
// Eight rows, 1024 bytes, make one swizzle atom. For bf16:
// - a K-major operand (wgmma's A, or a non-transposed B) keeps 64 values
//   of K in a row, one row per M (or N) index: a 64-row operand is 8
//   atoms down at 1024 bytes (the descriptor's SBO; LBO is unused), and
//   its k16 step kk starts 32 kk bytes into the rows;
// - an MN-major operand (a row-major (K, N) B, read with wgmma's
//   transpose-B bit, or a row-major (K, M) A, read with the transpose-A
//   bit) keeps 64 values of N (or M) in a row, one row per k: the next 8
//   rows of K lie SBO = 1024 bytes on, the next 64 columns of N LBO bytes
//   on (a separate 64-column box), and the k16 step kk starts 2048 kk
//   bytes in.
// A tile written by threads instead of TMA uses sw128_offset and a
// fence_proxy_async() before the barrier that precedes the wgmma.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; no link to libcuda

#include "common.cuh"

namespace tk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0-7) of row r in a 128B-swizzled tile
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// ------------------------------------------------ thread-block clusters
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier: arrive (.release, or .relaxed: no memory order),
// then wait (.acquire)
template <bool RELEASE>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (RELEASE)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p (this block's shared memory) as the address of the same bytes in the
// cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// loads from another block's shared memory (a cluster address)
__device__ __forceinline__ uint32_t dsmem_ld_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

// atomic adds into another block's shared memory (a cluster address);
// seen by that block after a cluster barrier
__device__ __forceinline__ void dsmem_add_u32(uint32_t a, uint32_t v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;\n"
               ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ void dsmem_add_u64(uint32_t a,
                                              unsigned long long v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u64 [%0], %1;\n"
               ::"r"(a), "l"(v)
               : "memory");
}

// ------------------------------------------------------------- mbarrier
// One thread inits the barrier with its arrival count; the init fence
// and a __syncthreads() publish it. A phase completes when every arrival
// is in and every byte announced by expect_tx has landed; mbar_wait(bar,
// p) returns once the phase of parity p has completed, so a loop that
// uses the barrier once a step flips p each step.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and announce `bytes` more to land in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A phase that has not completed after MBAR_TIMEOUT_NS is a fault (a
// count or a byte total that can never be met): the thread traps, and
// the launch fails with an error instead of holding the card.
constexpr uint64_t MBAR_TIMEOUT_NS = 4000000000ull;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > MBAR_TIMEOUT_NS) __trap();
}

// arrive once (release: this thread's earlier writes are seen by whoever
// waits on the phase)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// announce `bytes` more to land in the current phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// ------------------------------------------------------------------ TMA
// A 2-D box of `map` at element coordinates (c0 inner, c1 outer) into
// shared memory at dst, completing its bytes on the mbarrier bar. The
// map lives in kernel parameter space (a __grid_constant__ argument).
// Box elements past the tensor's edge arrive as zeros and still count
// toward the barrier's bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same from a 3-D map: coordinates (c0 inner, c1, c2 outer).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// generic-proxy stores to shared memory (threads copying a tile) made
// visible to the async proxy (wgmma, TMA); each writer fences, then the
// block synchronises
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the `count` threads (whole warps) that call it with barrier `id` (1-15;
// 0 is __syncthreads's) wait for one another
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive on barrier `id` without waiting: the writes before it are seen
// by the threads that wait there with named_barrier_sync (count: the
// arriving and the waiting threads together)
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// host: a 2-D tensor map with the 128-byte swizzle over a row-major
// (outer, inner) matrix at base, rows row_bytes apart (a multiple of 16,
// base 16-byte aligned), boxes of box_inner (64: 128 bytes) x box_outer;
// with depth > 0, a 3-D map over `depth` such matrices one after another
// (row_bytes * outer apart), its boxes one matrix deep, so that no box
// reaches into the next matrix: rows past `outer` arrive as zeros.
// cuTensorMapEncodeTiled is a driver call: it is fetched once through
// the runtime, so the library needs no libcuda at link time.
inline cudaError_t tma_map(CUtensorMapDataType type, CUtensorMap* map,
                           const void* base, uint64_t inner, uint64_t outer,
                           uint64_t row_bytes, uint32_t box_inner,
                           uint32_t box_outer, uint64_t depth) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                   cudaEnableDefault, &q) == cudaSuccess &&
                   q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {inner, outer, depth};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * outer};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, depth > 0 ? 3 : 2,
      const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t tma_map_bf16(CUtensorMap* map, const void* base,
                                uint64_t inner, uint64_t outer,
                                uint64_t row_bytes, uint32_t box_inner,
                                uint32_t box_outer, uint64_t depth = 0) {
  return tma_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, map, base, inner, outer,
                 row_bytes, box_inner, box_outer, depth);
}

// the same over f32 elements (box_inner 32: 128 bytes)
inline cudaError_t tma_map_f32(CUtensorMap* map, const void* base,
                               uint64_t inner, uint64_t outer,
                               uint64_t row_bytes, uint32_t box_inner,
                               uint32_t box_outer, uint64_t depth = 0) {
  return tma_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, map, base, inner, outer,
                 row_bytes, box_inner, box_outer, depth);
}

// ---------------------------------------------------------------- wgmma
// A 128B-swizzle shared-memory descriptor: start address, LBO and SBO in
// bytes (encoded in 16-byte units), layout type 1 (128B swizzle), base
// offset 0 (the tile is 1024-byte aligned).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the accumulators pinned in place across the asynchronous products: no
// read or write of them moves over a fence or a wait
template <int N>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// before a warpgroup's first wgmma of a step (after the accumulators or
// the operands' shared memory were last written)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128), bf16 operands from
// shared memory: A K-major (TA 0) or MN-major (TA 1, the transpose-A
// bit), B K-major (TB 0) or MN-major (TB 1, the transpose-B bit). Thread
// t of the warpgroup (warp w = t / 32, lane 4g + q) holds d[4j + e] at
// row 16w + g + 8 (e / 2) and column 8j + 2q + e % 2 (j = 0..15).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256, f32) += A (64 x 16) . B (16 x 256), as the m64n128k16
// above with 256 columns: d[4j + e] at row 16w + g + 8 (e / 2) and column
// 8j + 2q + e % 2 (j = 0..31).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) += A (64 x 16) . B (16 x 64), as the m64n128k16 above
// with 64 columns: d[4j + e] at row 16w + g + 8 (e / 2) and column
// 8j + 2q + e % 2 (j = 0..7).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The same products with A from registers (the register-A form, no
// transpose-A bit): a[0..3] of warp w hold rows 16w.. of A as mma.sync
// m16n8k16's A fragment does (lane 4g + q: a0 = A[g][2q..2q+1], a1 =
// A[g+8][2q..], a2 = A[g][2q+8..], a3 = A[g+8][2q+8..]). That is the
// layout in which the accumulators of a product hold columns 16kk..
// 16kk+15 (d[8kk + 2i], d[8kk + 2i + 1] -> a[i]), so a tile of scores
// becomes the A operand of the next product without leaving registers.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32],
                                                        const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64],
                                                        const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d (64 x 128, f32) (+)= A (64 x 8) . B (8 x 128), TF32 operands from
// shared memory, both K-major (.tf32 has no transpose bit): each reads
// an f32 element as its truncation to TF32 (the low 13 bits ignored).
// scale_d 0 starts d afresh (d = A . B). d's layout is the m64n128k16
// one above.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same at 32 columns (d as the m64n32k16 layout, 16 accumulators),
// and with A from registers (the _rs forms, widths 32, 64 and 128): a[0..3]
// of thread 4g + q of warp w hold A[16w + g][q], A[16w + g + 8][q],
// A[16w + g][q + 4] and A[16w + g + 8][q + 4] as TF32 bit patterns (the
// tensor core reads each as its truncation), the layout of mma.sync
// m16n8k8's tf32 A fragment. An accumulator holds columns 2q and 2q + 1 of
// each 8-wide slab, not q and q + 4: a tile of scores becomes the A
// operand of the next product with its contraction index permuted within
// each slab of 8 (fa_tf32_frag, csrc/flash_attention_tf32.cu), and B's
// K-major rows carry the same permutation.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ------------------------------------------ split-TF32 attention tiles
// csrc/flash_attention_tf32.cu and csrc/flash_attention_bwd.cu keep
// each f32 operand a .tf32 wgmma reads from shared memory as two planes,
// hi and lo (common.cuh split_tf32_finite), each K-major: R rows of the
// operand's M (or N) index, its contraction in boxes of 32 values (one
// 128-byte swizzled row), box after box R rows apart, as a 3-D tensor map
// of boxes 32 wide lays out an f32 tile of R rows. tf_off is the byte offset of
// element (r, c) in such a plane, tf_desc the descriptor of its k8 step kk.
__device__ __forceinline__ int tf_off(int R, int r, int c) {
  return (c >> 5) * R * 128 + sw128_offset(r, (c & 31) >> 2) + (c & 3) * 4;
}
__device__ __forceinline__ uint64_t tf_desc(uint32_t plane, int R, int kk) {
  return wgmma_desc(plane + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}

// the four f32 values at p (shared memory) split into hi, in place, and
// lo at q: a plane split where TMA loaded it (the two planes alike)
__device__ __forceinline__ void tf_split4(unsigned char* p, unsigned char* q) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  float4 h, l;
  split_tf32_finite(x.x, h.x, l.x);
  split_tf32_finite(x.y, h.y, l.y);
  split_tf32_finite(x.z, h.z, l.z);
  split_tf32_finite(x.w, h.w, l.w);
  *reinterpret_cast<float4*>(p) = h;
  *reinterpret_cast<float4*>(q) = l;
}

// The column that key c of a tile takes in a K-major B operand whose A
// comes from an accumulator (tf_frag): within each slab of 8, keys 0, 2,
// 4, 6 go to columns 0-3 and keys 1, 3, 5, 7 to columns 4-7.
__host__ __device__ __forceinline__ int tf_perm(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}

// The register-A fragments (hi, lo) of an accumulator of N/2 values (its
// 64 x N tile in the m64nN layout), for the k8 steps over its N columns:
// step j takes columns 8j + 2q (as A's column q) and 8j + 2q + 1 (as
// q + 4), so B's rows follow tf_perm.
template <int NA>
__device__ __forceinline__ void tf_frag(const float (&s)[NA],
                                        uint32_t (&h)[NA / 4][4],
                                        uint32_t (&l)[NA / 4][4]) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hi, lo;  // A's registers: (g, q), (g + 8, q), (g, q + 4), ...
      split_tf32_finite(s[4 * j + (i & 1) * 2 + (i >> 1)], hi, lo);
      h[j][i] = __float_as_uint(hi);
      l[j][i] = __float_as_uint(lo);
    }
  }
}

// the fragments' registers held until the products that read them
// asynchronously are done
template <int K>
__device__ __forceinline__ void tf_fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// The split-TF32 products of the attention backward kernels
// (csrc/flash_attention_bwd.cu's #8, csrc/flash_attention_featured_tf32.cu's
// #9 and #10): a warpgroup's 64 x N
// product with A's k8 fragments (hi, lo) in registers and B's hi and lo
// planes in shared memory, each 32 values of the contraction into a
// fresh accumulator, its small products first, added in f32.

// d (+)= A B at width N, A from registers
template <int N>
__device__ __forceinline__ void tb_mma(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k8_tf32_rs(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k8_tf32_rs(d, a, db, scale_d);
  else wgmma_m64n128k8_tf32_rs(d, a, db, scale_d);
}

// One slab (KS k8 steps from kk0) of a split product into a fresh d: A's
// fragments by frag(kk, hi, lo), B's planes b_hi and b_lo of b_rows rows;
// the 2 KS small products first; committed, not waited for.
template <int N, int KS, typename Frag>
__device__ __forceinline__ void tb_slab(float (&d)[N / 2],
                                        uint32_t (&h)[KS][4],
                                        uint32_t (&l)[KS][4], int kk0,
                                        Frag& frag, uint32_t b_hi,
                                        uint32_t b_lo, int b_rows) {
#pragma unroll
  for (int i = 0; i < KS; ++i) frag(kk0 + i, h[i], l[i]);
  wgmma_fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    tb_mma<N>(d, l[i], tf_desc(b_hi, b_rows, kk0 + i), i > 0);
    tb_mma<N>(d, h[i], tf_desc(b_lo, b_rows, kk0 + i), 1);
  }
#pragma unroll
  for (int i = 0; i < KS; ++i)
    tb_mma<N>(d, h[i], tf_desc(b_hi, b_rows, kk0 + i), 1);
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void tb_add(float (&s)[N], float (&d)[N],
                                       bool first) {
  wgmma_fence_acc(d);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = first ? d[i] : s[i] + d[i];
}

// out = A B (first) or out += A B over K contraction values: slab after
// slab of SK values (32, 16 or 8; K a multiple of SK), each into a fresh
// accumulator, two in turns, added in f32 into out. Every thread of the
// warpgroup calls it. wgmma rounds its accumulator after every k8
// product, and not to nearest: a narrower slab chains fewer roundings.
template <int N, int K, int SK = 32, typename Frag>
__device__ __forceinline__ void tb_product(float (&out)[N / 2], bool first,
                                           Frag&& frag, uint32_t b_hi,
                                           uint32_t b_lo, int b_rows) {
  constexpr int KS = SK / 8, NS = K / SK;
  float d0[N / 2], d1[N / 2];
  uint32_t h0[KS][4], l0[KS][4], h1[KS][4], l1[KS][4];
  tb_slab<N, KS>(d0, h0, l0, 0, frag, b_hi, b_lo, b_rows);
#pragma unroll
  for (int sb = 1; sb < NS; ++sb) {
    if (sb & 1) {
      tb_slab<N, KS>(d1, h1, l1, KS * sb, frag, b_hi, b_lo, b_rows);
      wgmma_wait<1>();
      tf_fence_frag(h0);
      tf_fence_frag(l0);
      tb_add(out, d0, first && sb == 1);
    } else {
      tb_slab<N, KS>(d0, h0, l0, KS * sb, frag, b_hi, b_lo, b_rows);
      wgmma_wait<1>();
      tf_fence_frag(h1);
      tf_fence_frag(l1);
      tb_add(out, d1, false);
    }
  }
  wgmma_wait<0>();
  if constexpr ((NS - 1) & 1) {
    tf_fence_frag(h1);
    tf_fence_frag(l1);
    tb_add(out, d1, false);
  } else {
    tf_fence_frag(h0);
    tf_fence_frag(l0);
    tb_add(out, d0, first && NS == 1);
  }
}

// A's k8 fragment at (rows r, r + 8; columns c, c + 4) of an f32 tile in
// shared memory, split: at(row, col) is the tile's byte offset of an
// element, `in` whether the row holds data (else zeros)
template <typename At>
__device__ __forceinline__ void tb_frag(const unsigned char* tile, At&& at,
                                        int r, int c, bool in,
                                        uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = in ? *reinterpret_cast<const float*>(
                             tile + at(r + 8 * (i & 1), c + 4 * (i >> 1)))
                       : 0.f;
    float hi, lo;
    split_tf32_finite(x, hi, lo);
    h[i] = __float_as_uint(hi);
    l[i] = __float_as_uint(lo);
  }
}

// a warpgroup's register budget: lowered by the producer, raised by the
// consumers, all four warps together
template <int N>
__device__ __forceinline__ void warpgroup_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void warpgroup_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// host: whether TMA can take p as a base (16-byte aligned)
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------------------------------------------ the GEMM main loop
// A block of GP_THREADS computes one GP_BM x GP_BN f32 tile D = A . B,
// walking the contraction in slabs of GP_BK through a ring of stages
// of shared memory (A 16 KiB and B 32 KiB a stage, both in the
// 128B-swizzled layout above). Warpgroups 0 and 1 consume, each its 64
// rows of D: wait for a stage's `full` barrier, issue the slab's four
// k16 wgmmas (m64n256k16), commit, wait until at most one group is in
// flight and only then release the previous slab's stage on its `empty`
// barrier. Warpgroup 2 produces: it waits for a stage's `empty` barrier
// and fills the stage, each operand by one of two paths:
// - TMA: one elected thread announces the boxes' bytes on `full` and
//   issues them (boxes past the matrix arrive as zeros);
// - the threads' copy: the 128 threads stage the slab's aligned 16-byte
//   words by cp.async, shift them into the swizzled layout (zeros past
//   rows x cols) and fence it for the async proxy. An operand whose rows
//   TMA cannot take (not whole 16-byte chunks, or a base off 16 bytes)
//   always goes this way; such a kernel keeps 3 stages and a staging
//   area of 54 KiB (gemm_smem).
// Every slab, all 128 producer threads arrive on `full` (its count), the
// elected one after announcing the TMA bytes, whatever the paths: a count
// that changed from slab to slab would race. Each consumer warp's lane 0
// arrives on `empty` (count 8). A stage's barriers flip parity on each
// wrap of the ring.
// TAIL_ZERO (both operands MN-major, rows the contraction): a last slab
// shorter than GP_BK (k_end - k < GP_BK) loads as any other, and the
// consumers zero its rows at and past k_end in both operands before
// their wgmmas (in the swizzled layout a box's rows from n on are one
// run of bytes), then meet on a named barrier: no row at or past k_end
// enters the sum even where the matrix goes on (the next group's rows
// in tgmm, or NaN). The producer's threads could copy that slab with
// zeros instead, but the copy code in the producer's branch made ptxas
// spill the kernel and slowed every slab of tgmm (PERF.md, PR 16).
//
// The tile is 128 x 256, not 128 x 128: the SMs read a slab's operands
// from L2 at (128 + 256) 64 2 bytes per 2 128 256 64 operations, 85
// operations a byte against 64 for 128 x 128, which ran slower on an
// H100 at every stage count tried (PERF.md, PR 16).
constexpr int GP_BM = 128, GP_BN = 256, GP_BK = 64;
constexpr int GP_THREADS = 384;                 // 2 consumers, 1 producer
constexpr int GP_BOX = 64 * GP_BK * 2;          // a 64 x 64 box: 8 KiB
constexpr int GP_A = GP_BM * GP_BK * 2;         // A of a slab: 16 KiB
constexpr int GP_B = GP_BN * GP_BK * 2;         // B of a slab: 32 KiB
constexpr int GP_STAGE = GP_A + GP_B;
constexpr int GP_SEG = 9 * 16;  // a staged row segment of the copy
// stages of the ring: 4 (192 KiB), or 3 beside the copy's staging area
// of GP_BM + GP_BN segments; and the dynamic shared memory with them
// (+ 1 KiB for the alignment)
__host__ __device__ constexpr int gemm_stages(bool copy) {
  return copy ? 3 : 4;
}
__host__ __device__ constexpr int gemm_smem(bool copy) {
  return gemm_stages(copy) * GP_STAGE +
         (copy ? (GP_BM + GP_BN) * GP_SEG : 0) + 1024;
}
// tile rows (of D) a group of launch-order blocks walks column by column
constexpr int GP_GROUP = 8;

// One operand as a row-major bf16 matrix (rows, cols), its row stride
// ld elements (0: cols), starting `off` elements (0-7) past p, which is
// 16-byte aligned.
// K-major (wgmma reads it without transposing): rows are M (or N) and a
// slab is W rows from `tile` by GP_BK columns from its k. MN-major (read
// transposed): rows are the contraction and a slab is GP_BK rows from
// its k by W columns from `tile`, as W / 64 boxes of 64 columns GP_BOX
// apart. rows, cols and off bound the threads' copy; TMA loads from a
// 2-D map, or from matrix z of a 3-D one (z >= 0).
struct GemmOperand {
  const bf16* p;
  int rows, cols, tile;
  int z = -1;
  int off = 0;
  int ld = 0;
  __device__ int64_t stride() const { return ld ? ld : cols; }
};

__device__ __forceinline__ void gemm_tma_box(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int c0, int c1,
                                             int z) {
  if (z < 0) tma_load_2d(dst, map, bar, c0, c1);
  else tma_load_3d(dst, map, bar, c0, c1, z);
}

template <bool MN, int W>
__device__ __forceinline__ void gemm_tma_slab(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar,
                                              const GemmOperand& o, int k) {
  if (MN) {
#pragma unroll
    for (int h = 0; h < W / 64; ++h)
      gemm_tma_box(dst + h * GP_BOX, map, bar, o.tile + 64 * h, k, o.z);
  } else {
    gemm_tma_box(dst, map, bar, k, o.tile, o.z);
  }
}

// The threads' copy of a slab operand whose rows TMA cannot take. Its
// 8 W 16-byte chunks form W row segments of 64 elements (K-major: row
// tile + g from column k; MN-major: row k + g % 64 from column tile + 64
// (g / 64)); chunk ch is chunk ch % 8 of segment ch / 8. A segment that
// starts sh elements into an aligned 16-byte word spans 9 such words.
// Pass 1 (gemm_stage_words): cp.async brings each segment's 9 words to
// `stg` (144 bytes a segment), zeros for a word that holds none of the
// row's elements (or a row past `rows`); no register holds them, so all
// of a slab's loads are in flight together. Pass 2 (gemm_shift_slab):
// each chunk from its two staged words, shifted by sh with funnel shifts
// and selects (no runtime-indexed registers), masked past the row's end,
// stored swizzled. p is 16-byte aligned (the wrappers align the bases; a
// matrix inside one, as gmm's W[e], starts off elements past its p).

template <bool MN>
__device__ __forceinline__ void gemm_segment(const GemmOperand& o, int k,
                                             int g, int& r, int& c0) {
  r = MN ? k + (g & 63) : o.tile + g;
  c0 = MN ? o.tile + (g >> 6) * 64 : k;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool load) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(load ? 16 : 0)
               : "memory");
}

template <bool MN, int W>
__device__ __forceinline__ void gemm_stage_words(uint32_t stg,
                                                 const GemmOperand& o, int k,
                                                 int t) {
  for (int q = t; q < 9 * W; q += 128) {
    const int g = q / 9, i = q - 9 * g;
    int r, c0;
    gemm_segment<MN>(o, k, g, r, c0);
    const int64_t row0 = o.off + r * o.stride();
    const int64_t w = ((row0 + c0) & ~int64_t{7}) + 8 * i;
    const bool load = r < o.rows && w < row0 + o.cols;
    cp_async16(stg + q * 16, o.p + (load ? w : 0), load);
  }
}

template <bool MN, int W>
__device__ __forceinline__ void gemm_shift_slab(unsigned char* dst,
                                                const unsigned char* stg,
                                                const GemmOperand& o, int k,
                                                int t) {
#pragma unroll 2
  for (int ch = t; ch < 8 * W; ch += 128) {
    const int g = ch >> 3, c = ch & 7;
    int r, c0;
    gemm_segment<MN>(o, k, g, r, c0);
    const int sh = (int)((o.off + r * o.stride() + c0) & 7);
    const uint4 q0 = *reinterpret_cast<const uint4*>(stg + g * GP_SEG + c * 16);
    const uint4 q1 =
        *reinterpret_cast<const uint4*>(stg + g * GP_SEG + c * 16 + 16);
    const uint32_t w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    uint32_t v[6], u[5], out[4];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = sh & 4 ? w[i + 2] : w[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) u[i] = sh & 2 ? v[i + 1] : v[i];
    const int valid = r < o.rows ? max(min(o.cols - c0 - 8 * c, 8), 0) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = sh & 1 ? __funnelshift_r(u[i], u[i + 1], 16) : u[i];
      if (2 * i >= valid) out[i] = 0;
      else if (2 * i + 1 >= valid) out[i] &= 0xFFFFu;
    }
    const int off = MN ? (ch >> 9) * GP_BOX + sw128_offset((ch >> 3) & 63, c)
                       : sw128_offset(ch >> 3, c);
    *reinterpret_cast<uint4*>(dst + off) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// the descriptors of consumer warpgroup wg's A (its 64 rows) and of B at
// k16 step kk of the slab at addr
template <bool MN>
__device__ __forceinline__ uint64_t gemm_desc_a(uint32_t addr, int wg,
                                                int kk) {
  return MN ? wgmma_desc(addr + wg * GP_BOX + kk * 2048, GP_BOX, 1024)
            : wgmma_desc(addr + wg * 64 * 128 + kk * 32, 16, 1024);
}
template <bool MN>
__device__ __forceinline__ uint64_t gemm_desc_b(uint32_t addr, int kk) {
  return MN ? wgmma_desc(addr + kk * 2048, GP_BOX, 1024)
            : wgmma_desc(addr + kk * 32, 16, 1024);
}

// The tile (tm, tn) of the block `lin`-th in launch order over a tiles_m
// x tiles_n grid: groups of GP_GROUP tile rows, each walked column by
// column, so that the blocks in flight together share a few rows of A
// and columns of B in L2 (a row of tiles at a time would read all of B
// each wave).
__device__ __forceinline__ void gemm_tile_order(int lin, int tiles_m,
                                                int tiles_n, int& tm,
                                                int& tn) {
  const int per = GP_GROUP * tiles_n, first = lin / per * GP_GROUP;
  const int rows = min(tiles_m - first, GP_GROUP), i = lin % per;
  tm = first + i % rows;
  tn = i / rows;
}

// D over the slabs k = k_begin, k_begin + GP_BK, ... < k_end of A and B
// (A_MN, B_MN: each operand's major order; TMA_A, TMA_B: each operand
// by TMA, its map valid; else by the threads' copy), then epi(d) in each
// consumer thread with its 128 accumulators (wgmma's layout above, rows
// 64 wg on). No slab (k_end <= k_begin): epi gets zeros. Every thread of
// the block calls it, as the kernel's last statement: the warpgroups
// split here and never meet again.
template <bool A_MN, bool B_MN, bool TMA_A, bool TMA_B, bool TAIL_ZERO,
          typename Epi>
__device__ __forceinline__ void gemm_pipeline(const CUtensorMap* map_a,
                                              const CUtensorMap* map_b,
                                              const GemmOperand& a,
                                              const GemmOperand& b,
                                              int k_begin, int k_end,
                                              Epi&& epi) {
  static_assert(!TAIL_ZERO || (A_MN && B_MN), "tail rows are MN-major rows");
  constexpr bool MAY_COPY = !TMA_A || !TMA_B;
  constexpr int STAGES = gemm_stages(MAY_COPY);
  // the producer's registers: 40 (it issues TMA, or stages and shifts a
  // chunk at a time); the consumers take what it gives up (of the 168 a
  // thread of a 384-thread block starts with) for their 128 accumulators
  constexpr int P_REGS = 40, C_REGS = 232;
  static_assert(128 * (168 - P_REGS) >= 256 * (C_REGS - 168), "budget");
  extern __shared__ unsigned char gp_smem[];
  __shared__ __align__(8) uint64_t gp_bar[2 * STAGES];  // full, empty
  const uint32_t raw = smem_u32(gp_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t stg = base + STAGES * GP_STAGE;  // the copy's staging
  const uint32_t full = smem_u32(gp_bar), empty = full + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int slabs = k_end > k_begin ? (k_end - k_begin + GP_BK - 1) / GP_BK : 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, 8);
    }
  }
  __syncthreads();

  if (wg == 2) {
    warpgroup_regs_dec<P_REGS>();
    const int t = tid - 256;
    for (int j = 0, s = 0, ph = 0; j < slabs; ++j) {
      const int k = k_begin + j * GP_BK;
      const uint32_t sa = base + s * GP_STAGE, sb = sa + GP_A;
      mbar_wait(empty + 8 * s, ph ^ 1);  // the first round passes
      constexpr bool ca = !TMA_A, cb = !TMA_B;
      if (t == 0 && !(ca && cb)) {
        mbar_expect_tx(full + 8 * s, (ca ? 0 : GP_A) + (cb ? 0 : GP_B));
        if (!ca) gemm_tma_slab<A_MN, GP_BM>(sa, map_a, full + 8 * s, a, k);
        if (!cb) gemm_tma_slab<B_MN, GP_BN>(sb, map_b, full + 8 * s, b, k);
      }
      if (MAY_COPY) {
        // the staging is free (the last slab's shifts are done), then
        // filled by every thread's cp.async, then shifted into the stage
        named_barrier_sync(2, 128);
        if (ca) gemm_stage_words<A_MN, GP_BM>(stg, a, k, t);
        if (cb) gemm_stage_words<B_MN, GP_BN>(stg + (ca ? GP_BM * GP_SEG : 0),
                                              b, k, t);
        asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                         "memory");
        named_barrier_sync(2, 128);
        unsigned char* p = gp_smem + (sa - raw);
        const unsigned char* q = gp_smem + (stg - raw);
        if (ca) gemm_shift_slab<A_MN, GP_BM>(p, q, a, k, t);
        if (cb)
          gemm_shift_slab<B_MN, GP_BN>(p + GP_A, q + (ca ? GP_BM * GP_SEG : 0),
                                       b, k, t);
        fence_proxy_async();
      }
      mbar_arrive(full + 8 * s);
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  } else {
    warpgroup_regs_inc<C_REGS>();
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    const bool signal = (tid & 31) == 0;
    for (int j = 0, s = 0, ph = 0, prev = 0; j < slabs; ++j) {
      const uint32_t sa = base + s * GP_STAGE, sb = sa + GP_A;
      mbar_wait(full + 8 * s, ph);
      if (TAIL_ZERO && k_end - k_begin - j * GP_BK < GP_BK) {
        // the slab's A and B are 6 boxes of 64 rows of 128 bytes, one
        // after another: zero rows n to 63 of each
        const int n = k_end - k_begin - j * GP_BK;
        unsigned char* p = gp_smem + (sa - raw);
        for (int o = tid * 16; o < 6 * (GP_BOX - n * 128); o += 256 * 16) {
          const int box = o / (GP_BOX - n * 128);
          *reinterpret_cast<uint4*>(p + box * GP_BOX + n * 128 + o -
                                    box * (GP_BOX - n * 128)) =
              make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_barrier_sync(1, 256);  // both consumers' zeros are in
      }
      wgmma_fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GP_BK / 16; ++kk)
        wgmma_m64n256k16_bf16<A_MN, B_MN>(d, gemm_desc_a<A_MN>(sa, wg, kk),
                                          gemm_desc_b<B_MN>(sb, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous slab's products are done
      wgmma_fence_acc(d);
      if (j > 0 && signal) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    wgmma_fence_acc(d);
    epi(d);
  }
}

// ------------------------------------------- the split-TF32 GEMM main loop
// f32 products on the tensor cores at f32 accuracy (CUTLASS calls it
// 3xTF32; the TPU kernels' f32 tier is Precision.HIGHEST, bf16 passes on
// the matrix unit): each operand x is split (common.cuh split_tf32) into
// hi, x rounded to TF32, and lo = x - hi, and D = A_lo . B_hi + A_hi .
// B_lo + A_hi . B_hi on wgmma .tf32, the small terms first. The tensor
// core reads lo as its truncation (off by less than 2^-10 |lo| <= 2^-21
// |x|) and lo . lo is dropped (at most 2^-22 |a b|): a product errs by
// less than (1.25 + 2^-11) 2^-20 |a b| (ops/split_tf32.py SPLIT_REL),
// against 2^-24 for one f32 rounding. It costs 3 TF32 products a
// product: at 495 TFLOP/s, 165 of f32 work, 2.5x the 67 of the CUDA
// cores' FMAs.
//
// The sums. wgmma rounds its accumulator after every product of 8 terms,
// not to nearest: three products a k8 step chained over K = 2048 (768
// roundings) left a result 7.5x further from the f64 product than cuBLAS
// f32's (8.7e-5 against 1.2e-5 at 2048 x 8192 x 2048 on an H100; PERF.md
// §6). So each slab's 12 products start a fresh wgmma accumulator d
// (scale-d 0) and are then added, rounded to nearest, into f32 registers
// (acc): the tensor core's roundings stay within a slab's partial sum, 32
// terms. A slab's 8 small products go first: while d holds only them its
// roundings are 2^-11 of the large sum's, so that sum is rounded 4 times
// a slab, not 12. (A sum of the small terms apart took a third set of 64
// registers, and the kernel spilled: ptxas gives a 384-thread block 168
// registers a thread, whatever setmaxnreg grants at run time.) The two
// sets of 64 fit only the 128 x 128 tile (a 128 x 256 tile's d alone
// takes 128); it also ran faster than 128 x 256 before the promotion (3
// stages against 2). A consumer waits for its slab's products before
// it adds them, so its next slab waits too; the other consumer warpgroup's
// products keep the tensor cores busy meanwhile.
//
// wgmma .tf32 is m64nNk8 and reads both operands K-major (no transpose
// bit), so each operand arrives as the planes (hi, then lo) of a K-major
// matrix that split_tf32_kernel wrote, rows K long at a row stride padded
// to whole 16-byte chunks; one 3-D tensor map of depth 2 covers both
// planes, and the maps end at K and at the rows, so TMA fills zeros past
// them. A slab is TF_BK = 32 values of K, one 128-byte swizzled row, so
// a k8 step starts 32 bytes into the rows: the bf16 K-major descriptors.
// The tile is GP_BM x TF_BN = 128 x 128, a stage 2 x (16 + 16) KiB, 3
// stages. Warpgroup 2 produces: its first thread waits for a stage's
// `empty` barrier, announces the stage's bytes on `full` (its one
// arrival) and issues the four boxes; the others leave. Warpgroups 0 and
// 1 consume, each its 64 rows. B's map may hold several operands' planes
// one after another (csrc/grouped_matmul.cu: (E, 2, N, K4), depth 2E):
// plane_b names the hi plane of the one to read, its lo plane follows.
// With TAIL_ZERO, k_begin may be any column: the slabs start at k_begin
// rounded down to a multiple of 4 (a box's inner coordinate must fall on
// 16 bytes: at 37 the card raised an illegal instruction), and a slab
// that holds columns outside [k_begin, k_end) (the first one's up to 3
// before k_begin, the last one's past k_end: another group's values, or
// NaN) has them zeroed in all four planes by the consumers before the
// products, as gemm_pipeline's TAIL_ZERO does for rows.
constexpr int TF_BK = 32, TF_BN = 128;
constexpr int TF_A = GP_BM * TF_BK * 4;  // one plane of A's slab: 16 KiB
constexpr int TF_B = TF_BN * TF_BK * 4;  // one plane of B's slab: 16 KiB
constexpr int TF_STAGE = 2 * (TF_A + TF_B);
constexpr int TF_STAGES = 3;
constexpr int TF_SMEM = TF_STAGES * TF_STAGE + 1024;  // + the alignment
// a stage: the four planes, 4 GP_BM rows of 128 bytes (TAIL_ZERO's walk)
static_assert(TF_A == TF_B && TF_STAGE == 4 * GP_BM * 128, "stage");

// host: one map over both planes (2, rows, ld) of a split operand at p,
// rows K values long, boxes of TF_BK x box_rows
inline cudaError_t tma_map_planes(CUtensorMap* map, const float* p, int K,
                                  int rows, int64_t ld, int box_rows) {
  return tma_map_f32(map, p, K, rows, (uint64_t)ld * 4, TF_BK, box_rows, 2);
}

// D of the tile (m0, n0) over the columns [k_begin, k_end) of A's and
// B's planes (maps over K-major planes with boxes of TF_BK x GP_BM and
// TF_BK x TF_BN, B's hi plane at depth plane_b, A's at 0), then epi(acc)
// in each consumer thread with its 64 sums (wgmma's m64n128 layout, rows
// 64 wg on). No column: epi gets zeros. Without TAIL_ZERO, k_begin is a
// multiple of TF_BK and the columns past k_end are zeros. Every thread of
// the block calls it, as the kernel's last statement.
template <bool TAIL_ZERO = false, typename Epi>
__device__ __forceinline__ void gemm_pipeline_tf32(const CUtensorMap* map_a,
                                                   const CUtensorMap* map_b,
                                                   int m0, int n0,
                                                   int k_begin, int k_end,
                                                   Epi&& epi,
                                                   int plane_b = 0) {
  constexpr int P_REGS = 40, C_REGS = 232;
  static_assert(128 * (168 - P_REGS) >= 256 * (C_REGS - 168), "budget");
  extern __shared__ unsigned char gp_smem[];
  __shared__ __align__(8) uint64_t tf_bar[2 * TF_STAGES];  // full, empty
  const uint32_t base = (smem_u32(gp_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(tf_bar), empty = full + 8 * TF_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int k0 = TAIL_ZERO ? k_begin & ~3 : k_begin;  // the first slab's
  const int slabs = k_end > k_begin ? (k_end - k0 + TF_BK - 1) / TF_BK : 0;
  if (tid == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
  }
  __syncthreads();

  if (wg == 2) {
    warpgroup_regs_dec<P_REGS>();
    if (tid != 256) return;
    for (int j = 0, s = 0, ph = 0; j < slabs; ++j) {
      const int k = k0 + j * TF_BK;
      const uint32_t sa = base + s * TF_STAGE, sb = sa + 2 * TF_A;
      const uint32_t f = full + 8 * s;
      mbar_wait(empty + 8 * s, ph ^ 1);  // the first round passes
      mbar_arrive_tx(f, TF_STAGE);
      tma_load_3d(sa, map_a, f, k, m0, 0);
      tma_load_3d(sa + TF_A, map_a, f, k, m0, 1);
      tma_load_3d(sb, map_b, f, k, n0, plane_b);
      tma_load_3d(sb + TF_B, map_b, f, k, n0, plane_b + 1);
      if (++s == TF_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  } else {
    warpgroup_regs_inc<C_REGS>();
    float acc[64], d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
    const bool signal = (tid & 31) == 0;
    for (int j = 0, s = 0, ph = 0; j < slabs; ++j) {
      // this warpgroup's 64 rows of A's planes, and B's planes
      const uint32_t a_hi = base + s * TF_STAGE + wg * 64 * 128;
      const uint32_t a_lo = a_hi + TF_A;
      const uint32_t b_hi = base + s * TF_STAGE + 2 * TF_A;
      const uint32_t b_lo = b_hi + TF_B;
      mbar_wait(full + 8 * s, ph);
      // the slab's columns [lo, hi) lie in [k_begin, k_end)
      const int lo = k_begin - k0 - j * TF_BK, hi = k_end - k0 - j * TF_BK;
      if (TAIL_ZERO && (lo > 0 || hi < TF_BK)) {
        // the stage's four planes are 512 rows of 128 bytes, 128B-swizzled:
        // value c of row r at word 4 ((c / 4) ^ (r % 8)) + c % 4; zero
        // every value c outside [lo, hi) of each row, a 16-byte chunk a
        // step
        float* p = reinterpret_cast<float*>(
            gp_smem + (base + s * TF_STAGE - smem_u32(gp_smem)));
        for (int i = tid; i < 4 * GP_BM * 8; i += 256) {
          const int r = i >> 3, c = i & 7;
          if (4 * c >= lo && 4 * c + 4 <= hi) continue;
          float* q = p + r * 32 + 4 * (c ^ (r & 7));
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (4 * c + v < lo || 4 * c + v >= hi) q[v] = 0.f;
        }
        fence_proxy_async();
        named_barrier_sync(1, 256);  // both consumers' zeros are in
      }
      wgmma_fence_acc(d);
      wgmma_fence();
      // the slab's sum afresh, its 8 small terms first, then the 4 large
#pragma unroll
      for (int kk = 0; kk < TF_BK / 8; ++kk) {
        const uint64_t bh = wgmma_desc(b_hi + kk * 32, 16, 1024);
        wgmma_m64n128k8_tf32(d, wgmma_desc(a_lo + kk * 32, 16, 1024), bh,
                             kk > 0);
        wgmma_m64n128k8_tf32(d, wgmma_desc(a_hi + kk * 32, 16, 1024),
                             wgmma_desc(b_lo + kk * 32, 16, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < TF_BK / 8; ++kk)
        wgmma_m64n128k8_tf32(d, wgmma_desc(a_hi + kk * 32, 16, 1024),
                             wgmma_desc(b_hi + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_acc(d);
      if (signal) mbar_arrive(empty + 8 * s);  // the stage is read
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
      if (++s == TF_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    epi(acc);
  }
}

// Split-K: the 256 consumer threads of split z (of `splits`) of tile
// `tile` post their partial sums d to ws ((tiles, splits, 64, 256) floats,
// each thread's i-th sum 256 floats after its (i-1)-th), then thread 0
// takes a ticket (tickets: a zeroed counter a tile). The last split of the
// tile to arrive resets its counter to 0 for the next launch, sums every
// split's partials in split order into d (the same bits whichever split
// is last) and returns true; the others return false.
__device__ __forceinline__ bool split_k_merge(float (&d)[64], float* ws,
                                              int* tickets, int tile, int z,
                                              int splits) {
  __shared__ int last;
  const int t = threadIdx.x;
  float* part = ws + (int64_t)tile * splits * 64 * 256;
#pragma unroll
  for (int i = 0; i < 64; ++i) part[((int64_t)z * 64 + i) * 256 + t] = d[i];
  __threadfence();
  named_barrier_sync(1, 256);
  if (t == 0) {
    last = atomicAdd(tickets + tile, 1) == splits - 1;
    if (last) tickets[tile] = 0;
  }
  named_barrier_sync(1, 256);
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = __ldcg(part + i * 256 + t);
  for (int s = 1; s < splits; ++s) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      d[i] += __ldcg(part + ((int64_t)s * 64 + i) * 256 + t);
  }
  return true;
}

// Consumer warpgroup wg's tile d (gemm_pipeline's layout, NA accumulators:
// 2 NA columns) into rows m0 + 64 wg on and columns n0 on of the
// row-major (M, N) outputs c32 (f32) and c16 (bf16), either null: pairs
// of columns in one store where N is even, masks at the N edge and
// outside the row window [r_lo, M).
template <int NA>
__device__ __forceinline__ void gemm_store(const float (&d)[NA], float* c32,
                                           bf16* c16, int M, int N, int m0,
                                           int n0, int r_lo = 0) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = m0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < r_lo || r >= M) continue;
      const int64_t o = (int64_t)r * N + col;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs && col < N) {
        if (c32) *reinterpret_cast<float2*>(c32 + o) = make_float2(v0, v1);
        if (c16)
          *reinterpret_cast<__nv_bfloat162*>(c16 + o) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < N) {
          if (c32) c32[o] = v0;
          if (c16) c16[o] = __float2bfloat16(v0);
        }
        if (col + 1 < N) {
          if (c32) c32[o + 1] = v1;
          if (c16) c16[o + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace tk
