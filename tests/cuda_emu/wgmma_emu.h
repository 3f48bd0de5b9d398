// The stand-ins for the inline PTX of `csrc/wgmma.cuh` on the CPU
// (cuda_runtime.h): mbarriers with arrival and transaction counts and
// phases, TMA 2-D tile loads with zero fill and stores that leave out
// what falls outside the tensor, both with the 128-byte swizzle, and
// `wgmma` m64nNk16 reading its operands through decoded descriptors.
//
// Shared addresses are offsets into the stand-in's dynamic shared memory
// (`__cvta_generic_to_shared`).  The 128-byte swizzle is applied to those
// offsets (chunk bits 4-6 XOR row bits 7-9), by TMA and by the
// descriptors alike, as the hardware applies it to shared addresses.  The
// descriptor's fields are read as the kernels encode them: start address,
// leading byte offset (the step between 64-column boxes of an MN-major
// operand) and stride byte offset (between groups of 8 rows); which
// offset the hardware reads for which step is what `csrc/wgmma_check.cu`
// settles on the card, not this file.  TMA, wgmma and the fences act
// synchronously: barrier counts and phases are checked, not the
// asynchronous schedule.
#pragma once

#include <chrono>
#include <cstdio>
#include <cstdlib>

#include "cuda.h"
#include "cuda_runtime.h"

inline uint32_t emu_smem_off(const void* p) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if (c < emu.dyn || c >= emu.dyn + sizeof(emu.dyn)) {
    std::fprintf(stderr, "cuda_emu: %p is not in shared memory\n", p);
    std::abort();
  }
  return static_cast<uint32_t>(c - emu.dyn);
}

inline uint32_t emu_sw128(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

// a phase ends when every expected arrival has come and the transaction
// count is back to 0; the next one expects the same arrivals
inline void emu_mbar_settle(EmuMbar& b) {
  if (b.pending < 0) {
    std::fprintf(stderr, "cuda_emu: more arrivals than an mbarrier expects\n");
    std::abort();
  }
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.expected;
    emu_mbars.cv.notify_all();
  }
}

inline EmuMbar& emu_mbar_at(uint32_t off) {
  auto it = emu_mbars.bars.find(off);
  if (it == emu_mbars.bars.end()) {
    std::fprintf(stderr, "cuda_emu: mbarrier at %u used before init\n", off);
    std::abort();
  }
  return it->second;
}

inline void emu_mbar_init(void* bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(emu_mbars.mu);
  EmuMbar& b = emu_mbars.bars[emu_smem_off(bar)];
  b.expected = b.pending = count;
  b.tx = 0;
  b.phase = 0;
}

// one arrival, expecting `bytes` more of transactions
inline void emu_mbar_arrive(void* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu_mbars.mu);
  EmuMbar& b = emu_mbar_at(emu_smem_off(bar));
  b.tx += bytes;
  b.pending -= 1;
  emu_mbar_settle(b);
}

inline void emu_mbar_complete_tx(void* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu_mbars.mu);
  EmuMbar& b = emu_mbar_at(emu_smem_off(bar));
  b.tx -= bytes;
  emu_mbar_settle(b);
}

// blocks until the phase of parity `parity` has completed (the current
// phase's parity differs); a minute without progress is a deadlock
inline bool emu_mbar_wait(void* bar, uint32_t parity) {
  const uint32_t off = emu_smem_off(bar);
  std::unique_lock<std::mutex> lock(emu_mbars.mu);
  const bool done = emu_mbars.cv.wait_for(
      lock, std::chrono::seconds(60),
      [&] { return emu_mbar_at(off).phase != (parity & 1); });
  if (!done) {
    std::fprintf(stderr,
                 "cuda_emu: thread %u of block (%u, %u, %u) waited a minute "
                 "on the mbarrier at %u for parity %u\n",
                 threadIdx.x, blockIdx.x, blockIdx.y, blockIdx.z, off,
                 parity);
    std::abort();
  }
  return true;
}

// the box at (c0, c1) of `map`: zero outside the tensor, 128-byte
// swizzled where the map says so; its bytes complete on `bar`
inline void emu_tma_load_2d(void* dst, const CUtensorMap* map, void* bar,
                            int c0, int c1) {
  EmuTensorMap m;
  std::memcpy(&m, map, sizeof(m));
  const uint32_t base = emu_smem_off(dst);
  if ((base & 15) != 0 || (m.swizzle128 && (base & 1023) != 0) ||
      (m.swizzle128 && m.box0 * m.esize != 128)) {
    std::fprintf(stderr, "cuda_emu: TMA destination %u misaligned\n", base);
    std::abort();
  }
  for (uint32_t r = 0; r < m.box1; ++r)
    for (uint32_t c = 0; c < m.box0; ++c) {
      const long long gx = static_cast<long long>(c0) + c;
      const long long gy = static_cast<long long>(c1) + r;
      const bool in = gx >= 0 && gy >= 0 && uint64_t(gx) < m.dim0 &&
                      uint64_t(gy) < m.dim1;
      uint32_t off = base + (r * m.box0 + c) * m.esize;
      if (m.swizzle128) off = emu_sw128(off);
      if (in)
        std::memcpy(emu.dyn + off,
                    static_cast<const unsigned char*>(m.base) +
                        gy * m.stride1 + gx * m.esize,
                    m.esize);
      else
        std::memset(emu.dyn + off, 0, m.esize);
    }
  emu_mbar_complete_tx(bar, m.box0 * m.box1 * m.esize);
}

// shared `src` into the box at (c0, c1) of `map`, leaving out what falls
// outside the tensor; synchronous (bulk groups complete at once)
inline void emu_tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                             int c1) {
  EmuTensorMap m;
  std::memcpy(&m, map, sizeof(m));
  const uint32_t base = emu_smem_off(src);
  if ((base & 15) != 0 || (m.swizzle128 && (base & 1023) != 0)) {
    std::fprintf(stderr, "cuda_emu: TMA store source %u misaligned\n", base);
    std::abort();
  }
  for (uint32_t r = 0; r < m.box1; ++r)
    for (uint32_t c = 0; c < m.box0; ++c) {
      const long long gx = static_cast<long long>(c0) + c;
      const long long gy = static_cast<long long>(c1) + r;
      if (gx < 0 || gy < 0 || uint64_t(gx) >= m.dim0 ||
          uint64_t(gy) >= m.dim1)
        continue;
      uint32_t off = base + (r * m.box0 + c) * m.esize;
      if (m.swizzle128) off = emu_sw128(off);
      std::memcpy(const_cast<unsigned char*>(
                      static_cast<const unsigned char*>(m.base)) +
                      gy * m.stride1 + gx * m.esize,
                  emu.dyn + off, m.esize);
    }
}

inline float emu_smem_bf16(uint32_t off) {
  uint16_t h;
  std::memcpy(&h, emu.dyn + off, 2);
  const uint32_t u = uint32_t(h) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N] for the warpgroup; this thread
// computes its own accumulator fragment.  A: K-major; B: MN-major (the
// transpose-B form); both in 128-byte swizzle mode.
template <int N>
inline void emu_wgmma(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                      int scale_d) {
  auto field = [](uint64_t desc, int lo) {
    return static_cast<uint32_t>((desc >> lo) & 0x3FFFu) << 4;
  };
  if ((desc_a >> 62) != 1 || (desc_b >> 62) != 1) {
    std::fprintf(stderr, "cuda_emu: a wgmma operand is not 128B-swizzled\n");
    std::abort();
  }
  const uint32_t a0 = field(desc_a, 0), a_sbo = field(desc_a, 32);
  const uint32_t b0 = field(desc_b, 0), b_lbo = field(desc_b, 16),
                 b_sbo = field(desc_b, 32);
  const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + g + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * q + (i & 1);
    double s = 0;
    for (int k = 0; k < 16; ++k) {
      const float av = emu_smem_bf16(
          emu_sw128(a0 + (row / 8) * a_sbo + (row % 8) * 128 + 2 * k));
      const float bv = emu_smem_bf16(
          emu_sw128(b0 + (col / 64) * b_lbo + (k / 8) * b_sbo +
                    (k % 8) * 128 + 2 * (col % 64)));
      s += double(av) * double(bv);
    }
    d[i] = float((scale_d ? double(d[i]) : 0.0) + s);
  }
}

// `bar.sync id, count`: a barrier of `count` threads, made at first use
// in the block
inline void emu_named_barrier(int id, int count) {
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(emu_mbars.mu);
    auto& slot = emu_mbars.named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(count);
    bar = slot.get();
  }
  bar->arrive_and_wait();
}
