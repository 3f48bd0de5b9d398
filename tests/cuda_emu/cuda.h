// The driver-API types of TMA tensor maps, for the CPU stand-in
// (cuda_runtime.h): `ptt::wgmma::make_tmap_2d` encodes a map through
// `cudaGetDriverEntryPoint("cuTensorMapEncodeTiled")`, which the stand-in
// answers with `emu_encode_tiled` (emu.cpp); the map's 128 bytes then
// hold an `EmuTensorMap`, which `emu_tma_load_2d` (wgmma_emu.h) reads.
#pragma once

#include <cstdint>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
struct alignas(64) CUtensorMap {
  unsigned long long opaque[16];
};
enum CUtensorMapDataType {
  CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
};
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_128B = 3
};
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

// a 2-D map: [dim1 rows][dim0 elements], rows stride1 bytes apart, boxes
// of [box1][box0], 128-byte swizzled or not
struct EmuTensorMap {
  const void* base;
  uint64_t dim0, dim1, stride1;
  uint32_t box0, box1, esize, swizzle128;
};
