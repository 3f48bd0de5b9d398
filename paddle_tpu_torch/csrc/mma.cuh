// Warp-level tensor-core building blocks for sm_80+ (used on sm_90a):
// `mma.sync` m16n8k16 bf16 -> f32, `ldmatrix` (plain and .trans) and
// `cp.async` with zero fill, as inline PTX, plus the swizzled shared-memory
// layout they read and the fragment addresses of each operand.
//
// Fragments of mma.sync.m16n8k16.row.col (lane = 4 * g + t, g = lane / 4,
// t = lane % 4; two 16-bit values per 32-bit register, the lower column
// in the lower half):
//   A (16 x 16, rows x depth): a0 (g, 2t..2t+1), a1 (g + 8, 2t..),
//                              a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
//   B (16 x 8, depth x cols):  b0 (2t..2t+1, g), b1 (2t + 8.., g)
//   C (16 x 8, f32):           c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..)
// So the C fragments of two neighbouring n8 tiles (columns 16j..16j+15)
// are, packed to bf16 in pairs, the A fragment of the next product over
// those 16 columns as depth: a softmax's P goes from one product into the
// next without leaving registers (`pack_bf16`).
//
// Tiles in shared memory are row-major, kW bf16 values a row (kW a
// multiple of 64), cut into 16-byte chunks of 8 values; chunk c of row r
// lives at chunk c ^ (r % 8).  An `ldmatrix` 8x8 matrix is 8 consecutive
// rows of one logical chunk: those land on 8 different chunk positions
// of an aligned group of 8, 4 banks each, so every read is free of bank
// conflicts, and so are the 16-byte `cp.async` writes of 8 neighbouring
// chunks of a row.  Narrow tiles (kW 16 or 32: 2 or 4 chunks a row, so
// 4 or 2 rows a 128-byte line) XOR the chunk with the row's line number
// instead, which spreads any 8 consecutive rows of one chunk over the
// same 8 distinct positions.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace ptt {
namespace mma {

// element offset of (row r, chunk c) in a swizzled tile of kW columns
template <int kW>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(kW % 64 == 0 || kW == 16 || kW == 32,
                "swizzled tiles are 16, 32 or a multiple of 64 values wide");
  if constexpr (kW % 64 == 0) {
    return r * kW + ((c ^ (r & 7)) << 3);
  } else {
    constexpr int kChunks = kW / 8;  // chunks a row: 2 or 4
    return r * kW + ((c ^ ((r / (8 / kChunks)) & (kChunks - 1))) << 3);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), `lo` in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of C tiles 2j and 2j + 1 (see the note above).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes from global to shared memory, asynchronously; the last
// 16 - src_bytes bytes are written as zeros (src_bytes 0: nothing is
// read, the chunk is zero).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes, the same way (4-byte aligned)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory element offsets (in a swizzled tile of kW columns) that
// lane `lane` hands to one ldmatrix_x4 for:
//  * the A fragment of rows row0..row0+15 at depth chunk pair kk
//    (depth 16kk..16kk+15) of a tile stored [row][depth];
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + (lane & 8);
}
template <int kW>
__device__ __forceinline__ int frag_a(int row0, int kk, int lane) {
  return swz<kW>(row0 + a_row(lane), 2 * kk + (lane >> 4));
}
//  * the B fragments (b0, b1 of n8 tile 0, then of n8 tile 1) of columns
//    n0..n0+15 at depth 16kk.. of a tile stored [column][depth] (K for
//    Q.K^T): registers {b0, b1} of columns n0.., then of n0 + 8..;
template <int kW>
__device__ __forceinline__ int frag_b(int n0, int kk, int lane) {
  return swz<kW>(n0 + (lane & 7) + ((lane >> 4) << 3),
                 2 * kk + ((lane >> 3) & 1));
}
//  * the same for a tile stored [depth][column] (V for P.V), read with
//    ldmatrix_x4_trans: depth k0..k0+15, columns 16dj..16dj+15.
template <int kW>
__device__ __forceinline__ int frag_bt(int k0, int dj, int lane) {
  return swz<kW>(k0 + a_row(lane), 2 * dj + (lane >> 4));
}
//  * the A fragment of rows m0..m0+15 (m0 a multiple of 8) at depth
//    d0..d0+15 of a tile stored [depth][row] (x^T of a row-major x),
//    read with ldmatrix_x4_trans.
template <int kW>
__device__ __forceinline__ int frag_at(int d0, int m0, int lane) {
  return swz<kW>(d0 + (lane & 7) + ((lane >> 4) << 3),
                 (m0 >> 3) + ((lane >> 3) & 1));
}

}  // namespace mma
}  // namespace ptt
