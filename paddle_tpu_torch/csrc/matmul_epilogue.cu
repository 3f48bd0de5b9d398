// Matmul with a fused bias + activation epilogue: out = act(x @ w + b).
//
// Replaces: paddle_tpu/ops/pallas_fused.py `_me_fwd_kernel` (:266, called
// at :315), the Pallas matmul-epilogue forward that keeps the bias add and
// the activation out of device memory and optionally saves the
// pre-activation z for the backward.
//
// x is [M, K], w is [K, N] (Paddle's [in, out] layout), b is [N]; all
// three share one type.  z is written only when its pointer is not null:
// serving runs without gradients and passes none.
//
// What bounds it on the H100: operations, by a hair.  At the main path's
// fc1 shape (M = 368 tokens, K = 2048, N = 8192, bf16) the product is
// 12.35 GFLOP against 41 MB of traffic (the 33.5 MB weight dominates),
// about 301 flops per byte: just above the ~295 at which the tensor
// cores, not the memory, become the limit.  Both bounds are ~12.4 us.
//
// Design, kept simple and right first (TMA and wgmma come later):
//  * bf16: one block of four warps per 64x64 output tile.  The block
//    stages a 64x32 slice of x and a 32x64 slice of w in shared memory
//    with 16-byte copies, and each warp multiplies its 32x32 quarter on the tensor cores with
//    WMMA 16x16x16 bf16 fragments, accumulating in f32.  Shared rows are
//    padded (40, 72, 68 elements) to spread banks while keeping every
//    fragment pointer 32-byte aligned.
//  * f32: the tensor cores would round the operands to TF32, so the f32
//    path multiplies on the CUDA cores: 256 threads per 64x64 tile, each
//    accumulating a 4x4 micro-tile in registers from 16-deep shared
//    slices, with fmaf in f32.
//  * epilogue, both: the accumulator plus the bias goes through the
//    activation in f32 (the formulas and constants of the TPU kernel's
//    `_act_f32`, pallas_fused.py:55) and is cast once to the output type.
// Edges in M, N and K are zero-filled on load and masked on store, so any
// shape is legal.
//
// Split-K: when the M x N tiles are too few to fill the card (a serving
// step's 368 rows against N = 2048 give 192 tiles for 132 SMs), the
// caller splits K into `splits` chunks of whole 32-deep slices: block
// (bx, by, bz) sums its tile over chunk bz and writes the f32 partial to
// `partial` [splits, M, N]; `splitk_epilogue_kernel` then adds the chunks
// in order (no atomics: the same sums every run) and applies the same
// epilogue.  With one chunk the tile's own epilogue runs, as before.
//
// int8 weights: out = act((x @ w_q) * scale + b).
//
// Replaces: paddle_tpu/ops/pallas_fused.py `_me_int8_fwd_kernel` (:406,
// called at :444 by `fused_linear_act_int8` :516), the weight-only int8
// forward: w_q is [K, N] int8 codes, scale [N] f32, one per output
// channel.  x stays float (bf16 or f32): it is never quantized.  b is [N]
// in x's type or f32.  z is not written (serving passes none).
//
// What bounds it on the H100: operations.  At the serving step's fc1
// shape (M = 368, K = 2048, N = 8192, bf16 x) the 12.35 GFLOP take 12.5
// us at 989 TFLOP/s, while x, the 16.8 MB of codes and the output take
// 7.3 us at 3.35 TB/s: int8 codes halve the weight bytes, not the bound.
//
// Design: the float kernels with the weight slice staged as int8.
//  * bf16 x: the same 64x64 tiles, four warps and WMMA 16x16x16 bf16
//    fragments with f32 accumulators.  The 32x64 w_q slice is read with
//    16-byte loads (16 codes each, one per thread) and widened to bf16 in
//    shared memory.  The widening is exact (|code| <= 127 fits bf16's
//    8-bit significand), so every product is the reference's, which
//    widens the codes to f32; only the order of the sum differs.
//  * f32 x: the CUDA-core f32 tiles, with the codes widened to f32 as
//    they are staged (TF32 would round x).
//  * epilogue, both: the scale multiplies the f32 accumulator AFTER the
//    dot, then the bias is added, as the reference orders it
//    (pallas_fused.py:413-414), each rounded on its own (no fused
//    multiply-add), then the activation in f32 and one cast.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

using ptt::apply_act;
using ptt::kActGelu;
using ptt::kActGeluTanh;
using ptt::kActNone;
using ptt::kActRelu;
using ptt::kActSilu;
using ptt::stage_tile;

// z = acc (* scale, int8 weights) + b; out = act(z).  The scale's product
// is rounded before the bias is added (__fmul_rn is never fused into an
// fma), as the reference computes `z * s + b`.
template <typename T, typename TB>
__device__ __forceinline__ void store_epilogue(float acc, const float* scale,
                                               const TB* b, T* out, T* z,
                                               int gm, int gn, int N,
                                               int act) {
  const float zs = scale != nullptr ? __fmul_rn(acc, scale[gn]) : acc;
  const float zf = zs + ptt::to_float(b[gn]);
  const size_t idx = static_cast<size_t>(gm) * N + gn;
  if (z != nullptr) z[idx] = ptt::from_float<T>(zf);
  out[idx] = ptt::from_float<T>(apply_act(zf, act));
}

// A tile's value at (gm, gn): its epilogue, or under split-K (`partial`
// not null) the f32 partial sum of this block's K chunk, blockIdx.z.
template <typename T, typename TB>
__device__ __forceinline__ void store_or_split(float acc, float* partial,
                                               const float* scale,
                                               const TB* b, T* out, T* z,
                                               int gm, int gn, int M, int N,
                                               int act) {
  if (partial != nullptr)
    partial[(static_cast<size_t>(blockIdx.z) * M + gm) * N + gn] = acc;
  else
    store_epilogue(acc, scale, b, out, z, gm, gn, N, act);
}

// ---- bf16: WMMA tensor-core tiles ---------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 32;

// `ptt::stage_tile` (common.cuh) for an int8 source, widened to bf16
// (exactly) on the way into shared memory: sixteen codes (16 bytes) per
// copy where they are in bounds and `vec` says the rows are 16-byte
// aligned.
template <int kRows, int kCols>
__device__ __forceinline__ void stage_tile(bf16* __restrict__ dst,
                                           int ld_dst,
                                           const int8_t* __restrict__ src,
                                           int ld_src, int row0, int col0,
                                           int rows_total, int cols_total,
                                           bool vec) {
  constexpr int kChunks = kCols / 16;
  for (int e = threadIdx.x; e < kRows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 16;
    const int gr = row0 + r, gc = col0 + c;
    const int8_t* s = src + static_cast<size_t>(gr) * ld_src + gc;
    alignas(16) int8_t v[16];
    if (vec && gr < rows_total && gc + 16 <= cols_total) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = (gr < rows_total && gc + j < cols_total) ? s[j] : 0;
    }
    alignas(16) __nv_bfloat162 w2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w2[j] = __floats2bfloat162_rn(static_cast<float>(v[2 * j]),
                                    static_cast<float>(v[2 * j + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + r * ld_dst + c);
    d[0] = *reinterpret_cast<const uint4*>(&w2[0]);
    d[1] = *reinterpret_cast<const uint4*>(&w2[4]);
  }
}
constexpr int kALd = kBK + 8;  // 80-byte rows
constexpr int kBLd = kBN + 8;  // 144-byte rows
constexpr int kCLd = kBN + 4;  // 272-byte rows

// TW: the weight's type (bf16, or int8 codes with a per-column `scale`);
// TB: the bias's (bf16, or f32 for int8 weights).
template <typename TW, typename TB>
__global__ void __launch_bounds__(128)
    me_fwd_wmma_bf16(const bf16* __restrict__ x, const TW* __restrict__ w,
                     const float* __restrict__ scale,
                     const TB* __restrict__ b, bf16* __restrict__ out,
                     bf16* __restrict__ z, float* __restrict__ partial,
                     int M, int K, int N, int kchunk, int act) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[kBM * kALd];
  __shared__ __align__(128) bf16 Bs[kBK * kBLd];
  __shared__ __align__(128) float Cs[kBM * kCLd];

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;  // this warp's 32x32 quarter
  const int wn = (warp & 1) * 32;
  // 16-byte copies need 16-byte aligned rows
  const bool x_vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w_vec = N % (16 / sizeof(TW)) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // this block's K chunk (all of K without split-K)
  const int k_end = min(K, static_cast<int>(blockIdx.z + 1) * kchunk);
  for (int k0 = blockIdx.z * kchunk; k0 < k_end; k0 += kBK) {
    stage_tile<kBM, kBK>(As, kALd, x, K, m0, k0, M, k_end, x_vec);
    stage_tile<kBK, kBN>(Bs, kBLd, w, N, k0, n0, k_end, N, w_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kBLd + wn + 16 * j, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kCLd + wn + 16 * j,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBN; e += blockDim.x) {
    const int r = e / kBN, c = e % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      store_or_split(Cs[r * kCLd + c], partial, scale, b, out, z, gm, gn, M,
                     N, act);
  }
}

// ---- f32: CUDA-core register tiles --------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <typename T, typename TW, typename TB>
__global__ void __launch_bounds__(256)
    me_fwd_fma(const T* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ scale, const TB* __restrict__ b,
               T* __restrict__ out, T* __restrict__ z,
               float* __restrict__ partial, int M, int K, int N, int kchunk,
               int act) {
  __shared__ float As[kFK][kFM + 4];  // As[k][m]
  __shared__ float Bs[kFK][kFN + 4];  // Bs[k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kFM;
  const int n0 = blockIdx.x * kFN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // this block's K chunk (all of K without split-K)
  const int k_end = min(K, static_cast<int>(blockIdx.z + 1) * kchunk);
  for (int k0 = blockIdx.z * kchunk; k0 < k_end; k0 += kFK) {
    for (int e = threadIdx.x; e < kFM * kFK; e += blockDim.x) {
      const int r = e / kFK, c = e % kFK;  // x tile: row r, depth c
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < k_end)
                     ? ptt::to_float(x[static_cast<size_t>(gm) * K + gk])
                     : 0.f;
      const int kr = e / kFN, nc = e % kFN;  // w tile: depth kr, col nc
      const int gk2 = k0 + kr, gn = n0 + nc;
      Bs[kr][nc] = (gk2 < k_end && gn < N)
                       ? ptt::to_float(w[static_cast<size_t>(gk2) * N + gn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gm < M && gn < N)
        store_or_split(acc[i][j], partial, scale, b, out, z, gm, gn, M, N,
                       act);
    }
}

// The second pass of split-K: out[m, n] = epilogue(sum over the chunks of
// partial[s, m, n]), the chunks added in order.  One thread per output.
template <typename T, typename TB>
__global__ void __launch_bounds__(256)
    splitk_epilogue_kernel(const float* __restrict__ partial, int splits,
                           const float* __restrict__ scale,
                           const TB* __restrict__ b, T* __restrict__ out,
                           T* __restrict__ z, int M, int N, int act) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= total) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[s * total + idx];
  store_epilogue(acc, scale, b, out, z, static_cast<int>(idx / N),
                 static_cast<int>(idx % N), N, act);
}

// ---- backward of the epilogue --------------------------------------------
// Replaces: paddle_tpu/ops/pallas_fused.py `_me_bwd_kernel` (:278, called
// at :345 by `_matmul_epilogue_2d_bwd`): dz = g * act'(z) from the saved
// pre-activation z, written in z's type, and db = the column sums of the
// f32 dz (before that cast).  dx = dz @ w^T and dw = x^T @ dz stay plain
// GEMMs outside the kernel, as the reference leaves them to XLA.
//
// What bounds it on the H100: bytes (z and g read, dz written; ~20 flops
// per element for the GELUs).
//
// Design: the TPU grid walks row blocks of one column block in order and
// accumulates db into a revisited block; here block (bx, by) owns 256
// columns and the by-th chunk of `rows_per_chunk` rows.  Each thread walks
// its one column down the chunk, so a warp reads 32 neighbouring values
// per row, and keeps its column's db partial in a register; the chunk's
// partials land in row `by` of `partial` [nchunks, N], and
// `column_sum_kernel` adds them in a fixed order (no float atomics).
__device__ __forceinline__ float act_grad(float z, int act) {
  // the reference's `_act_grad_f32` (pallas_fused.py:70-87), op for op
  switch (act) {
    case kActRelu:
      return z > 0.f ? 1.f : 0.f;
    case kActGelu: {
      const float phi = 0.3989422804014327f * expf(-0.5f * z * z);
      return 0.5f * (1.f + erff(z / 1.4142135623730951f)) + z * phi;
    }
    case kActGeluTanh: {
      const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      const float t = tanhf(u);
      const float du = 0.7978845608028654f * (1.f + 3.f * 0.044715f * z * z);
      return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
    }
    case kActSilu: {
      const float s = 1.f / (1.f + expf(-z));
      return s * (1.f + z * (1.f - s));
    }
    default:
      return 1.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    me_bwd_kernel(const T* __restrict__ z, const T* __restrict__ g,
                  T* __restrict__ dz, float* __restrict__ partial, int M,
                  int N, int rows_per_chunk, int act) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float db = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t idx = static_cast<size_t>(r) * N + col;
    const float d = ptt::to_float(g[idx]) * act_grad(ptt::to_float(z[idx]), act);
    dz[idx] = ptt::from_float<T>(d);
    db += d;
  }
  partial[static_cast<size_t>(blockIdx.y) * N + col] = db;
}

template <typename T>
cudaError_t me_bwd(const void* z, const void* g, void* dz, void* db,
                   void* partial, int M, int N, int nchunks, int act,
                   cudaStream_t s) {
  const int rows_per_chunk = (M + nchunks - 1) / nchunks;
  const dim3 grid((N + 255) / 256, nchunks);
  float* part = static_cast<float*>(partial);
  me_bwd_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(g), static_cast<T*>(dz),
      part, M, N, rows_per_chunk, act);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ptt::column_sum_kernel<T><<<(N + 255) / 256, 256, 0, s>>>(
      part, static_cast<T*>(db), nchunks, N);
  return cudaGetLastError();
}

}  // namespace

// dz has z's shape and type; db is [N] of z's type; partial is f32 scratch
// of nchunks * N floats, 1 <= nchunks <= M.
extern "C" int ptt_matmul_epilogue_bwd(const void* z, const void* g, void* dz,
                                       void* db, void* partial, int M, int N,
                                       int nchunks, int act, int dtype,
                                       int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (act < kActNone || act > kActSilu || nchunks < 1 || nchunks > M ||
      nchunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == PTT_DTYPE_BF16) {
    e = me_bwd<bf16>(z, g, dz, db, partial, M, N, nchunks, act, s);
  } else if (dtype == PTT_DTYPE_F32) {
    e = me_bwd<float>(z, g, dz, db, partial, M, N, nchunks, act, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

namespace {

// The forward over a (N/64, M/64, chunks) grid and, under split-K
// (splits > 1, `partial` [splits, M, N] f32 scratch), the second pass.
// K is cut into chunks of whole 32-deep slices, so only the last chunk is
// ragged; `chunks` (at most `splits`) is how many that gives.
template <typename T, typename TW, typename TB>
cudaError_t me_fwd(const void* x, const void* w, const float* scale,
                   const void* b, void* out, void* z, void* partial,
                   int splits, int M, int K, int N, int act,
                   cudaStream_t s) {
  const int kchunk =
      splits > 1 ? ((K + splits - 1) / splits + kBK - 1) / kBK * kBK : K;
  const int chunks = splits > 1 ? (K + kchunk - 1) / kchunk : 1;
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const T* xt = static_cast<const T*>(x);
  const TW* wt = static_cast<const TW*>(w);
  const TB* bt = static_cast<const TB*>(b);
  T* o = static_cast<T*>(out);
  T* zt = static_cast<T*>(z);
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, chunks);
    me_fwd_wmma_bf16<TW, TB><<<grid, 128, 0, s>>>(xt, wt, scale, bt, o, zt,
                                                  part, M, K, N, kchunk, act);
  } else {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM, chunks);
    me_fwd_fma<T, TW, TB><<<grid, 256, 0, s>>>(xt, wt, scale, bt, o, zt,
                                               part, M, K, N, kchunk, act);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return e;
  const size_t total = static_cast<size_t>(M) * N;
  splitk_epilogue_kernel<T, TB><<<(total + 255) / 256, 256, 0, s>>>(
      part, chunks, scale, bt, o, zt, M, N, act);
  return cudaGetLastError();
}

bool bad_split(int splits, const void* partial) {
  return splits < 1 || splits > 65535 || (splits > 1 && partial == nullptr);
}

}  // namespace

// x [M, K], w [K, N], b [N], out and z (z may be null) [M, N], all of
// `dtype`; `partial` f32 [splits, M, N] when splits > 1 (split-K).
extern "C" int ptt_matmul_epilogue_fwd(const void* x, const void* w,
                                       const void* b, void* out, void* z,
                                       void* partial, int M, int K, int N,
                                       int splits, int act, int dtype,
                                       int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < kActNone || act > kActSilu || bad_split(splits, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == PTT_DTYPE_BF16)
    e = me_fwd<bf16, bf16, bf16>(x, w, nullptr, b, out, z, partial, splits,
                                 M, K, N, act, s);
  else if (dtype == PTT_DTYPE_F32)
    e = me_fwd<float, float, float>(x, w, nullptr, b, out, z, partial,
                                    splits, M, K, N, act, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// x [M, K] of `dtype`; w_q [K, N] int8; scale [N] f32; b [N] of
// `bias_dtype`; out [M, N] of `dtype`; `partial` as above.
extern "C" int ptt_matmul_epilogue_int8_fwd(const void* x, const void* w_q,
                                            const void* scale, const void* b,
                                            void* out, void* partial, int M,
                                            int K, int N, int splits,
                                            int act, int dtype,
                                            int bias_dtype, int device,
                                            void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < kActNone || act > kActSilu || bad_split(splits, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  const bool b_f32 = bias_dtype == PTT_DTYPE_F32;
  if (!b_f32 && bias_dtype != PTT_DTYPE_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == PTT_DTYPE_BF16)
    e = b_f32 ? me_fwd<bf16, int8_t, float>(x, w_q, sc, b, out, nullptr,
                                            partial, splits, M, K, N, act, s)
              : me_fwd<bf16, int8_t, bf16>(x, w_q, sc, b, out, nullptr,
                                           partial, splits, M, K, N, act, s);
  else if (dtype == PTT_DTYPE_F32)
    e = b_f32 ? me_fwd<float, int8_t, float>(x, w_q, sc, b, out, nullptr,
                                             partial, splits, M, K, N, act,
                                             s)
              : me_fwd<float, int8_t, bf16>(x, w_q, sc, b, out, nullptr,
                                            partial, splits, M, K, N, act,
                                            s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
