// A CPU stand-in for the parts of the CUDA runtime and device language
// that the port's flash attention kernels and `csrc/mma.cuh` use, so that
// their CUDA source compiles with g++ and runs on the CPU at tiny shapes
// (tests/test_torch_flash_emulated.py).  One std::thread per CUDA thread;
// __syncthreads is a block barrier and every warp-wide operation
// (shuffles, ldmatrix, mma.sync) a warp barrier around an exchange area.
// Blocks run one after another.  cp.async copies synchronously, so the
// emulation checks layouts and arithmetic, not the asynchronous schedule.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3v {
  unsigned x, y, z;
};
extern thread_local uint3v threadIdx;
extern uint3v blockIdx, blockDim, gridDim;
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};

// per-warp exchange area of the warp-wide operations
struct WarpX {
  uint64_t v[32][8];
  const void* addr[32];
};
struct Emu {
  std::barrier<>* block_bar = nullptr;
  std::barrier<>* warp_bar[32] = {};
  WarpX wx[32];
  alignas(16) unsigned char dyn[232448];  // dynamic shared memory
};
extern Emu emu;

inline int emu_lane() { return threadIdx.x & 31; }
inline int emu_warp() { return threadIdx.x >> 5; }
inline void emu_warp_sync() { emu.warp_bar[emu_warp()]->arrive_and_wait(); }
inline void __syncthreads() { emu.block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_sync(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  WarpX& x = emu.wx[emu_warp()];
  const int l = emu_lane();
  std::memcpy(&x.v[l][0], &v, 4);
  emu_warp_sync();
  float r;
  std::memcpy(&r, &x.v[l ^ mask][0], 4);
  emu_warp_sync();
  return r;
}
inline size_t __cvta_generic_to_shared(const void*) { return 0; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
extern cudaError_t emu_error;  // set by a launch the stand-in refuses
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int bytes) {
  return bytes <= static_cast<int>(sizeof(emu.dyn)) ? cudaSuccess
                                                    : cudaErrorInvalidValue;
}

inline float expf(float x) { return std::exp(x); }
inline float logf(float x) { return std::log(x); }
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float erff(float x) { return std::erf(x); }
inline float tanhf(float x) { return std::tanh(x); }

// kernel<<<grid, block, smem, stream>>>(args) is rewritten as
// emu_launch(grid, block, smem, stream, [&] { kernel(args); })
void emu_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> f);
inline void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                       std::function<void()> f) {
  emu_launch(grid, block, smem, f);
}
