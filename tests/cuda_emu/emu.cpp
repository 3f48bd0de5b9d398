// The CPU stand-in's launch: blocks one after another, one std::thread
// per CUDA thread of the block.
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local uint3v threadIdx;
uint3v blockIdx, blockDim, gridDim;
Emu emu;
cudaError_t emu_error = cudaSuccess;

void emu_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> f) {
  if (smem > sizeof(emu.dyn) || block.x % 32 != 0 || block.x > 1024) {
    emu_error = cudaErrorInvalidValue;
    return;
  }
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {block.x, 1, 1};
  const int nt = static_cast<int>(block.x);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = {bx, by, bz};
        std::memset(emu.dyn, 0xAB, sizeof(emu.dyn));  // stale, not zeros
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
