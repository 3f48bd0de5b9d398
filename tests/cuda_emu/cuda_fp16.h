// f16 for the CPU stand-in (cuda_runtime.h): storage and the
// round-to-nearest-even conversions, through g++'s _Float16, as
// cuda_bf16.h gives bf16.  The kernels take f16 only on their CUDA-core
// routes, so no tensor-core stand-in is needed here.
#pragma once

#include "cuda_runtime.h"

struct __half {
  unsigned short x;
};
struct __half2 {
  __half x, y;
};
inline float __half2float(__half v) {
  _Float16 h;
  std::memcpy(&h, &v.x, 2);
  return static_cast<float>(h);
}
inline __half __float2half_rn(float f) {
  const _Float16 h = static_cast<_Float16>(f);
  __half v;
  std::memcpy(&v.x, &h, 2);
  return v;
}
inline __half __float2half(float f) { return __float2half_rn(f); }
inline __half2 __floats2half2_rn(float a, float b) {
  return {__float2half_rn(a), __float2half_rn(b)};
}
