// bf16 for the CPU stand-in (cuda_runtime.h): storage, round-to-nearest-
// even conversion, and the warp primitives that replace the inline PTX of
// `csrc/mma.cuh` (ldmatrix, mma.sync m16n8k16, cp.async), each following
// the PTX ISA's fragment layouts.
#pragma once

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  unsigned short x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = uint32_t(v.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

// ldmatrix .x4: lane l gives the row address of matrix l / 8; plain, lane
// l receives row l / 4, values 2(l % 4) and 2(l % 4) + 1 of each matrix;
// .trans, column l / 4, rows 2(l % 4) and 2(l % 4) + 1
inline void emu_ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  WarpX& x = emu.wx[emu_warp()];
  const int l = emu_lane();
  x.addr[l] = p;
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) {
    uint16_t h[2];
    for (int j = 0; j < 2; ++j) {
      const int src = trans ? 8 * i + 2 * (l % 4) + j : 8 * i + l / 4;
      const int col = trans ? l / 4 : 2 * (l % 4) + j;
      h[j] = static_cast<const uint16_t*>(x.addr[src])[col];
    }
    r[i] = uint32_t(h[0]) | (uint32_t(h[1]) << 16);
  }
  emu_warp_sync();
}

inline float emu_half(uint64_t reg, int hi) {
  const uint32_t w = static_cast<uint32_t>(reg);
  const uint32_t u = hi ? (w & 0xffff0000u) : (w << 16);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// d += a . b over a 16 x 16 x 8 tile; products exact, summed in double
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                    uint32_t b1) {
  WarpX& x = emu.wx[emu_warp()];
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) x.v[l][i] = a[i];
  x.v[l][4] = b0;
  x.v[l][5] = b1;
  emu_warp_sync();
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double s = 0;
    for (int k = 0; k < 16; ++k) {
      const int kl = k % 8, hi = k / 8;
      const float av = emu_half(x.v[4 * (row % 8) + kl / 2][row / 8 + 2 * hi],
                                kl % 2);
      const float bv = emu_half(x.v[4 * col + kl / 2][4 + hi], kl % 2);
      s += double(av) * double(bv);
    }
    d[e] = float(double(d[e]) + s);
  }
  emu_warp_sync();
}

inline void emu_cp_async(void* dst, const void* src, int src_bytes,
                         int size) {
  std::memset(dst, 0, size);
  if (src_bytes) std::memcpy(dst, src, src_bytes);
}
