// Grouped-expert matmul: out = act(x_blk @ w[gid[i]] + b[gid[i]]) over a
// block-aligned grouped buffer, and its weight gradient.
//
// Replaces: paddle_tpu/ops/pallas_grouped.py `_gmm_fwd_kernel` (:85, called
// from `_gmm_call` :99) and `_gmm_dw_kernel` (:133, called from
// `_gmm_dw_call` :161), the dropless MoE's expert GEMMs.
//
// Layout.  x is [R, K] with R = nb * bm: block i (rows [i*bm, (i+1)*bm))
// belongs wholly to expert gid[i], and gid[i] == E marks a null block (all
// rows padding).  w is the stacked expert weights, b [E, N] the biases (or
// null: no bias).  All float operands share one type (f32 or bf16); gid is
// int32.
//
// Forward (`ptt_grouped_matmul_fwd`).  w[e] is [K, N] (`trans` 0) or, for
// the backward's dx = dz @ w[e]^T, the weight as stored, [N, K] (`trans`
// 1): the kernel reads w[e] transposed in place, so the caller copies no
// weights.  The reference appends a zero null expert and pads N on every
// call (`_stacked_pad`, :188-196) and materialises swapaxes(w) for dx
// (:225-227); here a null block writes zeros to out and z (act(0) = 0 for
// every activation) and computes nothing.  z, the f32 pre-activation cast
// to the input type, is written when its pointer is not null, as
// pallas_grouped.py:93-95 saves it.
//
// What bounds it on the H100.  At the MoE serving step (R = 1280 rows of
// 736 assignments, K = 2048, N = 8192, bf16) the assignments' 24.7 GFLOP
// take 0.025 ms at 989 TFLOP/s while the weights of the experts in use
// (33.5 MB each), x and out take ~0.04-0.05 ms at 3.35 TB/s: bytes.  At the
// training shape (16384 assignments, K = 768, N = 3072, f32 on the CUDA
// cores) the 77 GFLOP take 1.15 ms at 67 TFLOP/s: operations.
//
// Design: row 3's tiled loop (matmul_epilogue.cu) with the weight and bias
// pointers chosen per row tile from gid.
//  * A thread block owns TM rows x 64 columns, TM the largest of 64, 32,
//    16 or 8 that divides bm: every row tile then lies in one block, so in
//    one expert, and that expert's weight tile is staged in shared memory
//    for all TM rows.
//  * bf16: four warps, each owning 16 output columns and all TM rows, WMMA
//    16x16x16 bf16 fragments with f32 accumulators; the 32-deep x and w
//    slices are staged with 16-byte copies.  The transposed weight is
//    staged as stored ([n][k]) and read as a column-major B fragment.
//  * f32: the tensor cores would round to TF32, so the CUDA cores multiply
//    in f32: 16 x min(TM, 16) threads, each a (TM / 16 or 1) x 4 register
//    micro-tile, 16-deep shared slices, fmaf.
//  * epilogue: the f32 sum plus the bias through the activation in f32
//    (`ptt::apply_act`, the reference's `_act_f32`) and one cast.
//
// Weight gradient (`ptt_grouped_matmul_dw`): dw[e] = sum over the blocks of
// expert e of x_blk^T @ dz_blk, summed in f32 and cast once to the type of
// x (= w's).  The TPU kernel walks the blocks in grid order and accumulates
// into a revisited output block; here one thread block per (expert, 64-row
// K tile, 64-column N tile) finds its expert's run of blocks in gid (gid is
// nondecreasing, see the wrapper) by binary search and loops over its rows
// 32 (bf16) or 16 (f32) at a time, the 64x64 sum in registers: f32 partials
// in a fixed order, no atomics, the same sums every run.  An expert that
// owns no block writes exact zeros (the reference's mask at :234-239).
// Bound: operations at the training shape (as the forward), bytes when the
// rows are few.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGN = 64;  // output columns of a forward tile

// ---- forward, bf16: WMMA tensor-core tiles --------------------------------
constexpr int kGK = 32;          // K depth of a staged slice
constexpr int kXLd = kGK + 8;    // x slice rows: 80 bytes
constexpr int kWLd = kGN + 8;    // w slice rows, [K, N]: 144 bytes
constexpr int kWtLd = kGK + 8;   // w slice rows, transposed [N, K]: 80 bytes
constexpr int kCLd = kGN + 4;    // f32 output tile rows: 272 bytes

// Zeros for a null block's rows (no expert: act(0 + 0) = 0).
template <typename T>
__device__ __forceinline__ void zero_tile(T* out, T* z, int m0, int rows,
                                          int n0, int N) {
  const T zero = ptt::from_float<T>(0.f);
  for (int e = threadIdx.x; e < rows * kGN; e += blockDim.x) {
    const int gn = n0 + e % kGN;
    if (gn >= N) continue;
    const size_t idx = static_cast<size_t>(m0 + e / kGN) * N + gn;
    out[idx] = zero;
    if (z != nullptr) z[idx] = zero;
  }
}

template <typename T>
__device__ __forceinline__ void store_out(float acc, const T* be, T* out,
                                          T* z, int gm, int gn, int N,
                                          int act) {
  const float zf = be != nullptr ? acc + ptt::to_float(be[gn]) : acc;
  const size_t idx = static_cast<size_t>(gm) * N + gn;
  if (z != nullptr) z[idx] = ptt::from_float<T>(zf);
  out[idx] = ptt::from_float<T>(ptt::apply_act(zf, act));
}

template <int TM, bool kTrans>
__global__ void __launch_bounds__(128)
    gmm_fwd_wmma_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ b,
                      const int* __restrict__ gid, bf16* __restrict__ out,
                      bf16* __restrict__ z, int K, int N, int E, int bm,
                      int act) {
  using namespace nvcuda;
  constexpr int kFr = TM / 16;  // row fragments of a warp
  __shared__ __align__(128) bf16 Xs[TM * kXLd];
  __shared__ __align__(128) bf16 Ws[kTrans ? kGN * kWtLd : kGK * kWLd];
  __shared__ __align__(128) float Cs[TM * kCLd];

  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * kGN;
  const int e = gid[m0 / bm];
  if (e < 0 || e >= E) {  // a null block (any id outside the experts)
    zero_tile(out, z, m0, TM, n0, N);
    return;
  }
  const bf16* we = w + static_cast<size_t>(e) * K * N;
  const bf16* be = b != nullptr ? b + static_cast<size_t>(e) * N : nullptr;
  const int warp = threadIdx.x >> 5;  // owns columns [16 warp, 16 warp + 16)
  // 16-byte copies need 16-byte aligned rows
  const bool x_vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w_vec = (kTrans ? K : N) % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(we) & 15) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFr];
#pragma unroll
  for (int i = 0; i < kFr; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int k0 = 0; k0 < K; k0 += kGK) {
    ptt::stage_tile<TM, kGK>(Xs, kXLd, x, K, m0, k0, m0 + TM, K, x_vec);
    if constexpr (kTrans)
      ptt::stage_tile<kGN, kGK>(Ws, kWtLd, we, K, n0, k0, N, K, w_vec);
    else
      ptt::stage_tile<kGK, kGN>(Ws, kWLd, we, N, k0, n0, K, N, w_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      using BLayout = typename std::conditional<kTrans, wmma::col_major,
                                                wmma::row_major>::type;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
      if constexpr (kTrans)
        wmma::load_matrix_sync(fb, Ws + 16 * warp * kWtLd + kk, kWtLd);
      else
        wmma::load_matrix_sync(fb, Ws + kk * kWLd + 16 * warp, kWLd);
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Xs + 16 * i * kXLd + kk, kXLd);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFr; ++i)
    wmma::store_matrix_sync(Cs + 16 * i * kCLd + 16 * warp, acc[i], kCLd,
                            wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * kGN; idx += blockDim.x) {
    const int r = idx / kGN, c = idx % kGN;
    const int gn = n0 + c;
    if (gn < N) store_out(Cs[r * kCLd + c], be, out, z, m0 + r, gn, N, act);
  }
}

// ---- forward, f32: CUDA-core register tiles -------------------------------
constexpr int kFK = 16;  // K depth of a staged slice

template <int TM, bool kTrans>
__global__ void __launch_bounds__(256)
    gmm_fwd_fma(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, const int* __restrict__ gid,
                float* __restrict__ out, float* __restrict__ z, int K, int N,
                int E, int bm, int act) {
  constexpr int kTY = TM < 16 ? TM : 16;  // thread rows (blockDim 16 kTY)
  constexpr int kMR = TM / kTY;           // output rows of a thread
  __shared__ float Xs[kFK][TM + 4];       // Xs[k][m]
  __shared__ float Ws[kFK][kGN + 4];      // Ws[k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * kGN;
  const int e = gid[m0 / bm];
  if (e < 0 || e >= E) {  // a null block (any id outside the experts)
    zero_tile(out, z, m0, TM, n0, N);
    return;
  }
  const float* we = w + static_cast<size_t>(e) * K * N;
  const float* be = b != nullptr ? b + static_cast<size_t>(e) * N : nullptr;
  float acc[kMR][4];
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int idx = threadIdx.x; idx < TM * kFK; idx += blockDim.x) {
      const int r = idx / kFK, c = idx % kFK;  // x: row r, depth c
      const int gk = k0 + c;
      Xs[c][r] = gk < K ? x[static_cast<size_t>(m0 + r) * K + gk] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kFK * kGN; idx += blockDim.x) {
      // neighbouring threads read neighbouring addresses of w as stored
      const int kr = kTrans ? idx % kFK : idx / kGN;
      const int nc = kTrans ? idx / kFK : idx % kGN;
      const int gk = k0 + kr, gn = n0 + nc;
      float v = 0.f;
      if (gk < K && gn < N)
        v = kTrans ? we[static_cast<size_t>(gn) * K + gk]
                   : we[static_cast<size_t>(gk) * N + gn];
      Ws[kr][nc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[kMR], bb[4];
#pragma unroll
      for (int i = 0; i < kMR; ++i) a[i] = Xs[kk][ty * kMR + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N)
        store_out(acc[i][j], be, out, z, m0 + ty * kMR + i, gn, N, act);
    }
}

template <int TM, bool kTrans>
cudaError_t launch_fwd(const void* x, const void* w, const void* b,
                       const int* gid, void* out, void* z, int R, int K,
                       int N, int E, int bm, int act, bool bf,
                       cudaStream_t s) {
  const dim3 grid((N + kGN - 1) / kGN, R / TM);
  if constexpr (TM >= 16) {
    if (bf) {
      gmm_fwd_wmma_bf16<TM, kTrans><<<grid, 128, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const bf16*>(b), gid, static_cast<bf16*>(out),
          static_cast<bf16*>(z), K, N, E, bm, act);
      return cudaGetLastError();
    }
  } else {
    if (bf) return cudaErrorInvalidValue;  // bf16 blocks are 16-row multiples
  }
  constexpr int threads = 16 * (TM < 16 ? TM : 16);
  gmm_fwd_fma<TM, kTrans><<<grid, threads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), gid, static_cast<float*>(out),
      static_cast<float*>(z), K, N, E, bm, act);
  return cudaGetLastError();
}

template <bool kTrans>
cudaError_t fwd_rows(int tm, const void* x, const void* w, const void* b,
                     const int* gid, void* out, void* z, int R, int K, int N,
                     int E, int bm, int act, bool bf, cudaStream_t s) {
  switch (tm) {
    case 64:
      return launch_fwd<64, kTrans>(x, w, b, gid, out, z, R, K, N, E, bm, act,
                                    bf, s);
    case 32:
      return launch_fwd<32, kTrans>(x, w, b, gid, out, z, R, K, N, E, bm, act,
                                    bf, s);
    case 16:
      return launch_fwd<16, kTrans>(x, w, b, gid, out, z, R, K, N, E, bm, act,
                                    bf, s);
    default:
      return launch_fwd<8, kTrans>(x, w, b, gid, out, z, R, K, N, E, bm, act,
                                   bf, s);
  }
}

// ---- weight gradient ------------------------------------------------------
constexpr int kDT = 64;  // K and N extent of a dw tile

// First index i of the nondecreasing gid[0, n) with gid[i] >= v.
__device__ __forceinline__ int lower_bound(const int* gid, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (gid[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

constexpr int kDR = 32;          // rows of a staged bf16 slice
constexpr int kDLd = kDT + 8;    // 144-byte rows

__global__ void __launch_bounds__(128)
    gmm_dw_wmma_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                     const int* __restrict__ gid, bf16* __restrict__ dw,
                     int nb, int bm, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 Xs[kDR * kDLd];  // Xs[r][k]
  __shared__ __align__(128) bf16 Ds[kDR * kDLd];  // Ds[r][n]
  __shared__ __align__(128) float Cs[kDT * kCLd];
  const int n0 = blockIdx.x * kDT;
  const int k0 = blockIdx.y * kDT;
  const int e = blockIdx.z;
  const int r_begin = lower_bound(gid, nb, e) * bm;
  const int r_end = lower_bound(gid, nb, e + 1) * bm;
  const int warp = threadIdx.x >> 5;
  const int wk = (warp >> 1) * 32;  // this warp's 32x32 quarter of the tile
  const int wn = (warp & 1) * 32;
  const bool x_vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool d_vec = N % 8 == 0 && (reinterpret_cast<uintptr_t>(dz) & 15) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int r0 = r_begin; r0 < r_end; r0 += kDR) {
    ptt::stage_tile<kDR, kDT>(Xs, kDLd, x, K, r0, k0, r_end, K, x_vec);
    ptt::stage_tile<kDR, kDT>(Ds, kDLd, dz, N, r0, n0, r_end, N, d_vec);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kDR; rr += 16) {
      // A = x^T: element (k, r) at Xs[r][k], a column-major fragment
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Xs + rr * kDLd + wk + 16 * i, kDLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ds + rr * kDLd + wn + 16 * j, kDLd);
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
      wmma::store_matrix_sync(Cs + (wk + 16 * i) * kCLd + wn + 16 * j,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  bf16* dwe = dw + static_cast<size_t>(e) * K * N;
  for (int idx = threadIdx.x; idx < kDT * kDT; idx += blockDim.x) {
    const int r = idx / kDT, c = idx % kDT;
    const int gk = k0 + r, gn = n0 + c;
    if (gk < K && gn < N)
      dwe[static_cast<size_t>(gk) * N + gn] =
          __float2bfloat16(Cs[r * kCLd + c]);
  }
}

__global__ void __launch_bounds__(256)
    gmm_dw_fma(const float* __restrict__ x, const float* __restrict__ dz,
               const int* __restrict__ gid, float* __restrict__ dw, int nb,
               int bm, int K, int N) {
  __shared__ float Xs[kFK][kDT + 4];  // Xs[r][k]
  __shared__ float Ds[kFK][kDT + 4];  // Ds[r][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kDT;
  const int k0 = blockIdx.y * kDT;
  const int e = blockIdx.z;
  const int r_begin = lower_bound(gid, nb, e) * bm;
  const int r_end = lower_bound(gid, nb, e + 1) * bm;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kFK) {
    for (int idx = threadIdx.x; idx < kFK * kDT; idx += blockDim.x) {
      const int r = idx / kDT, c = idx % kDT;
      const int gr = r0 + r;
      const int gk = k0 + c, gn = n0 + c;
      Xs[r][c] = (gr < r_end && gk < K) ? x[static_cast<size_t>(gr) * K + gk]
                                        : 0.f;
      Ds[r][c] = (gr < r_end && gn < N)
                     ? dz[static_cast<size_t>(gr) * N + gn]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kFK; ++rr) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ds[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dwe = dw + static_cast<size_t>(e) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gk < K && gn < N) dwe[static_cast<size_t>(gk) * N + gn] = acc[i][j];
    }
}

// Rows of a forward tile: the largest of 64, 32, 16, 8 that divides bm.
int row_tile(int bm) {
  for (int tm = 64; tm >= 8; tm >>= 1)
    if (bm % tm == 0) return tm;
  return 0;
}

}  // namespace

// x [R, K]; w [E, K, N] (trans 0) or [E, N, K] (trans 1); b [E, N] or null;
// gid [R / bm] int32, each in [0, E] (E: a null block; the forward does not
// need gid sorted); out and z (z may be null) [R, N]; all floats of `dtype`.
extern "C" int ptt_grouped_matmul_fwd(const void* x, const void* w,
                                      const void* b, const void* gid,
                                      void* out, void* z, int R, int K, int N,
                                      int E, int bm, int trans, int act,
                                      int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int tm = row_tile(bm);
  const bool bf = dtype == PTT_DTYPE_BF16;
  if (act < ptt::kActNone || act > ptt::kActSilu || tm == 0 || R % bm != 0 ||
      R / tm > 65535 || (!bf && dtype != PTT_DTYPE_F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gid);
  const cudaError_t e =
      trans
          ? fwd_rows<true>(tm, x, w, b, g, out, z, R, K, N, E, bm, act, bf, s)
          : fwd_rows<false>(tm, x, w, b, g, out, z, R, K, N, E, bm, act, bf,
                            s);
  return static_cast<int>(e);
}

// x [R, K] and dz [R, N] of `dtype`; gid [R / bm] int32, nondecreasing, each
// in [0, E]; dw [E, K, N] of `dtype`, every element written.
extern "C" int ptt_grouped_matmul_dw(const void* x, const void* dz,
                                     const void* gid, void* dw, int R, int K,
                                     int N, int E, int bm, int dtype,
                                     int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (bm < 1 || R % bm != 0 || E < 1 || E > 65535 ||
      (K + kDT - 1) / kDT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = R / bm;
  const int* g = static_cast<const int*>(gid);
  const dim3 grid((N + kDT - 1) / kDT, (K + kDT - 1) / kDT, E);
  if (dtype == PTT_DTYPE_BF16) {
    gmm_dw_wmma_bf16<<<grid, 128, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dz), g,
        static_cast<bf16*>(dw), nb, bm, K, N);
  } else if (dtype == PTT_DTYPE_F32) {
    gmm_dw_fma<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dz), g,
        static_cast<float*>(dw), nb, bm, K, N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
