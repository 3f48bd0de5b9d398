// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its element type as a template parameter and is
// instantiated for float (dtype code 0) and __nv_bfloat16 (dtype code 1);
// arithmetic is always in float.  The int8 serving kernels also read
// int8_t codes (weights, KV pools), widened to float exactly.  Each C
// entry point returns cudaGetLastError() right after its launch so the
// Python wrapper can raise on a refused launch (too many threads, too
// much shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define PTT_DTYPE_F32 0
#define PTT_DTYPE_BF16 1

namespace ptt {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the whole block, returned to every thread.  `red` is a
// 32-float shared scratch; blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // a previous call may still be reading `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(v);
}

// out[c] = sum over p < nparts of partial[p * n + c], summed in order of p
// and cast to T: the second pass of a column sum whose first pass left one
// f32 row of partial sums per block.  The order is fixed, so the result is
// the same on every run (float atomics would not be).  One thread per
// column; neighbouring threads read neighbouring addresses.
template <typename T>
__global__ void __launch_bounds__(256)
    column_sum_kernel(const float* __restrict__ partial, T* __restrict__ out,
                      int nparts, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[static_cast<size_t>(p) * n + c];
  out[c] = from_float<T>(s);
}

// The activation codes of the reference's ACTIVATIONS (pallas_fused.py:47)
// and the forward activation of its `_act_f32` (:55), formulas and
// constants op for op, in f32.
constexpr int kActNone = 0;
constexpr int kActRelu = 1;
constexpr int kActGelu = 2;
constexpr int kActGeluTanh = 3;
constexpr int kActSilu = 4;

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case kActRelu:
      return fmaxf(z, 0.f);
    case kActGelu:
      return 0.5f * z * (1.f + erff(z / 1.4142135623730951f));
    case kActGeluTanh: {
      const float t =
          tanhf(0.7978845608028654f * (z + 0.044715f * z * z * z));
      return 0.5f * z * (1.f + t);
    }
    case kActSilu:
      return z * (1.f / (1.f + expf(-z)));
    default:
      return z;
  }
}

// Stage rows x cols of a row-major bf16 matrix (leading dimension
// `ld_src`, `rows_total` x `cols_total`) at (row0, col0) into shared
// memory, eight values (16 bytes) per copy where they are in bounds and
// `vec` says the rows are 16-byte aligned; element by element, with zero
// fill, at the ragged edge.
template <int kRows, int kCols>
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16* __restrict__ dst, int ld_dst,
    const __nv_bfloat16* __restrict__ src, int ld_src, int row0, int col0,
    int rows_total, int cols_total, bool vec) {
  constexpr int kChunks = kCols / 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kRows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const int gr = row0 + r, gc = col0 + c;
    __nv_bfloat16* d = dst + r * ld_dst + c;
    const __nv_bfloat16* s = src + static_cast<size_t>(gr) * ld_src + gc;
    if (vec && gr < rows_total && gc + 8 <= cols_total) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (gr < rows_total && gc + j < cols_total) ? s[j] : zero;
    }
  }
}

}  // namespace ptt
