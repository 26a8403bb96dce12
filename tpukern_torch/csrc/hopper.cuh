// Hopper (sm_90a) building blocks in raw PTX: TMA tensor maps and tile
// loads, mbarriers, and wgmma's shared-memory descriptors, product and
// sync. csrc/matmul_naive.cu is their first user; the GEMM kernels are to
// reuse them.
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
//   transpose-B bit) keeps 64 values of N in a row, one row per k: the
//   next 8 rows of K lie SBO = 1024 bytes on, the next 64 columns of N
//   LBO bytes on (a separate 64-column box), and the k16 step kk starts
//   2048 kk bytes in.
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
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

// generic-proxy stores to shared memory (threads copying a tile) made
// visible to the async proxy (wgmma, TMA); each writer fences, then the
// block synchronises
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// host: a 2-D bf16 tensor map with the 128-byte swizzle over a row-major
// (outer, inner) matrix at base, rows row_bytes apart (a multiple of 16,
// base 16-byte aligned), boxes of box_inner (64: 128 bytes) x box_outer.
// cuTensorMapEncodeTiled is a driver call: it is fetched once through
// the runtime, so the library needs no libcuda at link time.
inline cudaError_t tma_map_bf16(CUtensorMap* map, const void* base,
                                uint64_t inner, uint64_t outer,
                                uint64_t row_bytes, uint32_t box_inner,
                                uint32_t box_outer) {
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
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// d (64 x 128, f32) += A (64 x 16, K-major) . B (16 x 128, MN-major: the
// transpose-B bit), bf16 operands from shared memory. Thread t of the
// warpgroup (warp w = t / 32, lane 4g + q) holds d[4j + e] at row
// 16w + g + 8 (e / 2) and column 8j + 2q + e % 2 (j = 0..15).
__device__ __forceinline__ void wgmma_m64n128k16_bf16_tb(float (&d)[64],
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
      "%64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace tk
