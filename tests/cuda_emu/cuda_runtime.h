// A CPU stand-in for the parts of the CUDA runtime and device language
// that the port's tensor-core kernels, `csrc/mma.cuh`, `csrc/wgmma.cuh`
// and `csrc/layer_norm.cu` use, so that their CUDA source compiles with
// g++ and runs on the CPU at tiny shapes (tests/test_torch_flash_emulated.py
// and the tests that import its source rewriting).  One std::thread per
// CUDA thread;
// __syncthreads is a block barrier and every warp-wide operation
// (shuffles, ldmatrix, mma.sync) a warp barrier around an exchange area;
// mbarriers (wgmma_emu.h) are counted under one lock.  Blocks run one
// after another, in order or in a seeded random order
// (`emu_set_block_order`).  cp.async, TMA and wgmma act synchronously, so
// the emulation checks layouts, barrier counts and arithmetic, not the
// asynchronous schedule.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <mutex>
#include <unordered_map>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
// static shared memory of a kernel in a header (the .cu sources are
// rewritten instead: `_emulated_source`)
#define __shared__ static
#define __grid_constant__

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
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

// per-warp exchange area of the warp-wide operations
struct WarpX {
  uint64_t v[32][8];
  const void* addr[32];
};
struct Emu {
  std::barrier<>* block_bar = nullptr;
  std::barrier<>* warp_bar[32] = {};
  WarpX wx[32];
  alignas(1024) unsigned char dyn[232448];  // dynamic shared memory
};
extern Emu emu;
// the block's mbarriers by shared address and its named barriers by id
// (cleared for every block)
struct EmuMbar {
  long long expected = 0, pending = 0, tx = 0;
  unsigned phase = 0;
};
struct EmuMbars {
  std::mutex mu;
  std::condition_variable cv;
  std::unordered_map<uint32_t, EmuMbar> bars;
  std::unordered_map<int, std::unique_ptr<std::barrier<>>> named;
};
extern EmuMbars emu_mbars;

inline int emu_lane() { return threadIdx.x & 31; }
inline int emu_warp() { return threadIdx.x >> 5; }
inline void emu_warp_sync() { emu.warp_bar[emu_warp()]->arrive_and_wait(); }
inline void __syncthreads() { emu.block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_sync(); }
// cross-block hand-offs (a ticket taken by the block that arrives last):
// one block runs at a time, so a fence orders nothing the stand-in needs
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
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
// a pointer into dynamic shared memory as its shared-space address (its
// offset); anything else as 0
inline size_t __cvta_generic_to_shared(const void* p) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  return c >= emu.dyn && c < emu.dyn + sizeof(emu.dyn) ? size_t(c - emu.dyn)
                                                       : 0;
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
extern cudaError_t emu_error;  // set by a launch the stand-in refuses
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
// the stand-in's devices: device 0 has as many SMs as an H100, device d > 0
// has d (so that a test picks a grid-dependent launch by the device index)
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int d) {
  *v = d > 0 ? d : 132;
  return cudaSuccess;
}
// the stand-in holds one block of any kernel an SM (a persistent grid is
// then as many blocks as the device index's SMs)
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int bytes) {
  return bytes <= static_cast<int>(sizeof(emu.dyn)) ? cudaSuccess
                                                    : cudaErrorInvalidValue;
}

// the driver entry point the kernels ask the runtime for (wgmma_emu.h)
typedef int cudaDriverEntryPointQueryResult;
enum { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound };
enum { cudaEnableDefault = 0 };
cudaError_t cudaGetDriverEntryPoint(const char* symbol, void** fn,
                                    unsigned long long flags,
                                    cudaDriverEntryPointQueryResult* found);

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
// byte i of the result is byte (s >> 4i) & 7 of the eight bytes of (x, y)
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = uint64_t(x) | (uint64_t(y) << 32);
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= uint32_t((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float expf(float x) { return std::exp(x); }
inline float logf(float x) { return std::log(x); }
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float erff(float x) { return std::erf(x); }
inline float tanhf(float x) { return std::tanh(x); }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }

// The order the stand-in runs a launch's blocks in: 0, in order of
// blockIdx (x fastest); otherwise a permutation drawn from this seed, so
// that a test can check that a result does not depend on the order in
// which blocks finish.  Set through `emu_set_block_order` (emu.cpp).
extern unsigned emu_block_order;

// kernel<<<grid, block, smem, stream>>>(args) is rewritten as
// emu_launch(grid, block, smem, stream, [&] { kernel(args); })
void emu_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> f);
inline void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                       std::function<void()> f) {
  emu_launch(grid, block, smem, f);
}
