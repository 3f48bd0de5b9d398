// Hopper's warpgroup tensor-core path for sm_90a, as inline PTX: `wgmma`
// (m64nNk16, bf16 x bf16 -> f32, A and B from shared memory), its
// shared-memory matrix descriptors, `mbarrier`s with transaction counts,
// TMA tile loads and stores (`cp.async.bulk.tensor.2d`, bulk groups),
// the proxy fence between threads' shared-memory writes and the tensor
// cores' or TMA's reads, a named barrier for the warps of some
// warpgroups, and on the host the TMA
// tensor maps, encoded through the runtime's driver entry point (the
// library is not linked against libcuda).
//
// The 128-byte swizzle.  A tile row of 128 bytes (64 bf16 values) is
// eight 16-byte chunks; in every 1024-byte aligned group of 8 rows, chunk
// c of row r lives at chunk c ^ r (`sw128`: address bits 4-6 XOR bits
// 7-9).  TMA's CU_TENSOR_MAP_SWIZZLE_128B writes this layout, `wgmma`'s
// 128-byte swizzle mode reads it, and the threads that stage a tile
// themselves (`sw128`) write it, so tiles must start 1024-byte aligned.
//
// Operands of `mma<N>` (D[64, N] += A[64, 16] . B[16, N]):
//  * A, K-major (row-major x: depth contiguous): rows of 128 bytes (64
//    depth values), groups of 8 rows 1024 bytes apart (`desc_k_major`).
//    The depth step of 16 values is +32 bytes on the start address: the
//    hardware swizzles the address it forms, so the step stays inside
//    each row's 128 bytes.
//  * B, MN-major (row-major w [K, N]: columns contiguous), read with the
//    instruction's transpose-B flag: boxes of [depth][64 columns], 128
//    bytes a depth row, groups of 8 depth rows 1024 bytes apart (the
//    stride byte offset) and neighbouring 64-column boxes `box_bytes`
//    apart (the leading byte offset; `desc_mn_major`).  The depth step of
//    16 rows is +2048 bytes.  In the K-major form the leading offset is
//    unused; in this one it is the column step, so the two forms'
//    offsets must not be swapped (`csrc/wgmma_check.cu` holds this form
//    exactly against a host product on the card).
//  * D, f32 in registers, the warpgroup's 128 threads holding 64 x N:
//    thread 32w + 4g + q (warp w, g = lane / 4, q = lane % 4) holds
//    d[4j + 2h + e] = D[16w + g + 8h][8j + 2q + e] (j < N / 8, h, e < 2),
//    the fragment of `mma.sync`'s C repeated over the n8 tiles.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ptt {
namespace wgmma {

// ---- shared memory -------------------------------------------------------
__host__ __device__ __forceinline__ uint32_t sw128(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- descriptors ---------------------------------------------------------
// bits 0-13 start address >> 4, 16-29 leading byte offset >> 4, 32-45
// stride byte offset >> 4, 62-63 the swizzle mode (1: 128 bytes)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t box_bytes) {
  return make_desc(addr, box_bytes, 1024);
}

// ---- wgmma ---------------------------------------------------------------
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (+)= a . b for N columns: A K-major, B MN-major (transpose-B), both
// 128-byte swizzled; scale_d 0 ignores d's old value
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t desc_a,
                                    uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- mbarriers -----------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// arrive, and expect `bytes` more of TMA traffic before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- TMA and the proxy fence ---------------------------------------------
// the box at (c0 innermost, c1) of `map` into shared `dst`; the bytes
// count against `bar`'s transaction count; outside the tensor, zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// order this thread's shared-memory writes (generic proxy) before later
// reads by the tensor cores or TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// shared `src` into the box at (c0 innermost, c1) of `map` (TMA store;
// what falls outside the tensor is not written), in this thread's
// current bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until all of this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- named barriers ------------------------------------------------------
// a barrier of `count` threads (whole warps) on hardware barrier `id`
// (0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- host: tensor maps ---------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime has loaded
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Can TMA describe a row-major matrix of `cols` elements of `esize`
// bytes a row at `base`?  A 16-byte aligned base and row stride.
inline bool tma_ok(const void* base, long long cols, int esize) {
  return cols > 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0 &&
         (cols * esize) % 16 == 0;
}

// A map of the row-major [rows, cols] matrix at `base` that loads boxes
// of [box_rows, box_cols], 128-byte swizzled or not; false if the driver
// refuses it.
inline bool make_tmap_2d(CUtensorMap* map, const void* base,
                         CUtensorMapDataType type, int esize,
                         unsigned long long rows, unsigned long long cols,
                         unsigned box_rows, unsigned box_cols,
                         bool swizzle128) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * static_cast<cuuint64_t>(esize)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgmma
}  // namespace ptt
