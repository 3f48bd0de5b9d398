// The CPU stand-in's launch: blocks one after another, one std::thread
// per CUDA thread of the block; and the driver entry point of TMA's maps.
#include <memory>
#include <random>
#include <thread>
#include <vector>

#include "cuda.h"
#include "cuda_runtime.h"

thread_local uint3v threadIdx;
uint3v blockIdx, blockDim, gridDim;
Emu emu;
EmuMbars emu_mbars;
cudaError_t emu_error = cudaSuccess;
unsigned emu_block_order = 0;

extern "C" void emu_set_block_order(unsigned seed) { emu_block_order = seed; }

void emu_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> f) {
  if (smem > sizeof(emu.dyn) || block.x % 32 != 0 || block.x > 1024) {
    emu_error = cudaErrorInvalidValue;
    return;
  }
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {block.x, 1, 1};
  const int nt = static_cast<int>(block.x);
  std::vector<uint3v> order;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) order.push_back({bx, by, bz});
  if (emu_block_order != 0) {
    std::mt19937 rng(emu_block_order);
    std::shuffle(order.begin(), order.end(), rng);
  }
  for (const uint3v& idx : order) {
    blockIdx = idx;
    std::memset(emu.dyn, 0xAB, sizeof(emu.dyn));  // stale, not zeros
    emu_mbars.bars.clear();
    emu_mbars.named.clear();
    std::barrier<> bar(nt);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < nt / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      emu.warp_bar[w] = warps.back().get();
    }
    emu.block_bar = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back([t, &f] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        f();
      });
    for (auto& t : threads) t.join();
  }
}

// cuTensorMapEncodeTiled's stand-in: the checks the driver makes on a 2-D
// tiled map, then its fields kept as an EmuTensorMap
static CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                                 cuuint32_t rank, void* base,
                                 const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box,
                                 const cuuint32_t* elem_strides,
                                 CUtensorMapInterleave,
                                 CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  const uint32_t esize = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 1;
  const bool swz = swizzle == CU_TENSOR_MAP_SWIZZLE_128B;
  if (rank != 2 || (reinterpret_cast<uintptr_t>(base) & 15) != 0 ||
      dims[0] == 0 || dims[1] == 0 || strides[0] % 16 != 0 || box[0] == 0 ||
      box[1] == 0 || box[0] > 256 || box[1] > 256 ||
      (box[0] * esize) % 16 != 0 || (swz && box[0] * esize > 128) ||
      elem_strides[0] != 1 || elem_strides[1] != 1)
    return CUDA_ERROR_INVALID_VALUE;
  EmuTensorMap m{base, dims[0], dims[1], strides[0], box[0], box[1], esize,
                 swz ? 1u : 0u};
  static_assert(sizeof(EmuTensorMap) <= sizeof(CUtensorMap));
  std::memcpy(map, &m, sizeof(m));
  return CUDA_SUCCESS;
}

cudaError_t cudaGetDriverEntryPoint(const char* symbol, void** fn,
                                    unsigned long long,
                                    cudaDriverEntryPointQueryResult* found) {
  const bool ok = std::strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = ok ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  if (found != nullptr)
    *found = ok ? cudaDriverEntryPointSuccess
                : cudaDriverEntryPointSymbolNotFound;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}
