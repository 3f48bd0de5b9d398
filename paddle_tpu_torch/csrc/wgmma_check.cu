// A card test of wgmma.cuh apart from any kernel: one warpgroup
// multiplies a [64, 64] bf16 tile by a [64, 128] one with the same
// descriptors, swizzle and `wgmma` form (transpose-B: w as stored, [K, N]
// row-major) that the matmul epilogue's forward uses, so a fault in the
// descriptors' byte offsets shows here exactly before it shows as a
// wrong epilogue.  Not a kernel of any model path.
//
//   c[0] = a . b   with a and b brought by TMA (128-byte swizzle; b as two
//                  [64][64] boxes) and the mbarrier's transaction count
//   c[1] = a . b   with a and b staged by the threads through `sw128`
//                  (the element-wise route's layout) and the proxy fence
//
// a: [64][64] bf16, b: [64][128] bf16, both row-major; c: 2 x [64][128]
// f32 row-major.  With small integer inputs every value is exact in f32,
// so the test holds each against torch.mm bit for bit.
#include <cstring>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptt::wgmma;

constexpr int kABytes = 64 * 64 * 2;
constexpr int kBoxBytes = 64 * 64 * 2;
constexpr int kSmem = kABytes + 2 * kBoxBytes + 64 + 1024;

__device__ __forceinline__ void product(float (&acc)[64], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
  fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma<128>(acc, desc_k_major(a + kk * 32),
             desc_mn_major(b + kk * 16 * 128, kBoxBytes), 1);
  commit();
  wait<0>();
#pragma unroll
  for (int r = 0; r < 64; ++r) fence_operand(acc[r]);
}

__device__ __forceinline__ void store(const float (&acc)[64], float* c) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[(16 * w + g + 8 * h) * 128 + 8 * j + 2 * q + e] =
            acc[4 * j + 2 * h + e];
}

__global__ void __launch_bounds__(128)
    wgmma_check_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const bf16* __restrict__ a, const bf16* __restrict__ b,
                       float* __restrict__ c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* a_tile = smem;
  uint8_t* b_tile = smem + kABytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_tile + 2 * kBoxBytes);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_arrive_expect_tx(bar, kABytes + 2 * kBoxBytes);
    tma_load_2d(a_tile, &tm_a, bar, 0, 0);
    tma_load_2d(b_tile, &tm_b, bar, 0, 0);
    tma_load_2d(b_tile + kBoxBytes, &tm_b, bar, 64, 0);
  }
  mbar_wait(bar, 0);
  float acc[64];
  product(acc, smem_u32(a_tile), smem_u32(b_tile));
  store(acc, c);
  __syncthreads();
  // the same product, staged by the threads: 16 bytes (8 values) a store
  for (int e = t; e < 64 * 8; e += 128) {
    const int r = e >> 3, ch = e & 7;
    *reinterpret_cast<uint4*>(a_tile + sw128(r * 128 + ch * 16)) =
        *reinterpret_cast<const uint4*>(a + r * 64 + ch * 8);
  }
  for (int e = t; e < 64 * 16; e += 128) {
    const int k = e >> 4, ch = e & 15;
    *reinterpret_cast<uint4*>(b_tile + (ch / 8) * kBoxBytes +
                              sw128(k * 128 + (ch % 8) * 16)) =
        *reinterpret_cast<const uint4*>(b + k * 128 + ch * 8);
  }
  fence_proxy_async();
  __syncthreads();
  product(acc, smem_u32(a_tile), smem_u32(b_tile));
  store(acc, c + 64 * 128);
}

}  // namespace

extern "C" int ptt_wgmma_check(const void* a, const void* b, void* c,
                               int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  CUtensorMap ta, tb;
  std::memset(&ta, 0, sizeof(ta));
  std::memset(&tb, 0, sizeof(tb));
  if (!make_tmap_2d(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, 64, 64,
                    64, true) ||
      !make_tmap_2d(&tb, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, 128, 64,
                    64, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      wgmma_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_check_kernel<<<1, 128, kSmem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
