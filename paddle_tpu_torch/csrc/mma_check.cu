// A card test of mma.cuh's fragment layouts, apart from any kernel: one
// warp multiplies 16 x 16 bf16 tiles through the same swizzled staging,
// ldmatrix addresses and mma.sync wrapper that the flash attention
// kernels use, so a fault in the layouts shows here before it shows as a
// wrong softmax.  Not a kernel of any model path.
//
//   c[0]  = a . b   with b staged [depth][col] and read by ldmatrix.trans
//                   (the P.V operand of the flash forward)
//   c[1]  = a . b   with b^T staged [col][depth] and read by ldmatrix
//                   (the K operand of Q.K^T)
//   c[2]  = c[0] . b, c[0] going back into the tensor cores as an A
//                   fragment in registers (`c_to_a`: P into P.V)
//
// a, b: [16][16] bf16 row-major; c: 3 x [16][16] f32 row-major.  With
// small integer inputs every value is exact in f32, so the test holds
// each against torch.mm bit for bit.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptt::mma;
constexpr int kW = 64;  // the narrowest swizzled tile: 16 columns used

__global__ void __launch_bounds__(32)
    mma_check_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                     float* __restrict__ c) {
  __shared__ uint4 tiles[3][16 * kW / 8];
  bf16* aS = reinterpret_cast<bf16*>(tiles[0]);
  bf16* bS = reinterpret_cast<bf16*>(tiles[1]);
  bf16* btS = reinterpret_cast<bf16*>(tiles[2]);
  const int lane = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = lane; e < 16 * kW; e += 32) {
    const int r = e / kW, col = e % kW;
    const int at = swz<kW>(r, col / 8) + col % 8;
    aS[at] = col < 16 ? a[r * 16 + col] : zero;
    bS[at] = col < 16 ? b[r * 16 + col] : zero;
    btS[at] = col < 16 ? b[col * 16 + r] : zero;
  }
  __syncwarp();
  uint32_t fa[4], fb[4], fbt[4];
  ldmatrix_x4(fa, aS + frag_a<kW>(0, 0, lane));
  ldmatrix_x4_trans(fb, bS + frag_bt<kW>(0, 0, lane));
  ldmatrix_x4(fbt, btS + frag_b<kW>(0, 0, lane));
  float c0[2][4] = {}, c1[2][4] = {}, c2[2][4] = {};
  mma_bf16(c0[0], fa, fb[0], fb[1]);
  mma_bf16(c0[1], fa, fb[2], fb[3]);
  mma_bf16(c1[0], fa, fbt[0], fbt[1]);
  mma_bf16(c1[1], fa, fbt[2], fbt[3]);
  uint32_t fp[4];
  c_to_a(fp, c0[0], c0[1]);
  mma_bf16(c2[0], fp, fb[0], fb[1]);
  mma_bf16(c2[1], fp, fb[2], fb[3]);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (g + 8 * (e >> 1)) * 16 + 8 * n + 2 * t + (e & 1);
      c[at] = c0[n][e];
      c[256 + at] = c1[n][e];
      c[512 + at] = c2[n][e];
    }
}

}  // namespace

extern "C" int ptt_mma_check(const void* a, const void* b, void* c,
                             int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  mma_check_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
