// Layer norm forward over the last dimension, with saved statistics; the
// fused residual add + layer norm forward; the layer-norm backward.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_ln_fwd_kernel` (:522,
// called at :575), the row-blocked Pallas layer norm that keeps its
// statistics in f32 and saves mu/rstd for the backward.
//
// What bounds it on the H100: bytes.  Each value is read once and written
// once and costs about eight flops, far below the ~295 flops per byte the
// card needs before its arithmetic matters.  At the serving step's 368
// rows of 2048 (1.5 MB each way) the bytes take under a microsecond, so
// the launch and one round trip to device memory bound it: what counts is
// how few dependent steps stand between the loads and the stores.
//
// Design, the vector route (`ln_fwd_vec_kernel`): a row is held in
// registers.  W warps share a row (W a power of two, the fewest whose
// lanes hold it at `kFwdLaneVectors`, two 16-byte vectors of 8 bf16 or 4
// f32 values, a lane: at 2048 four warps in bf16 and eight in f32), and a
// lane issues all of its loads at once, neighbouring lanes on neighbouring
// vectors.  The mean,
// then the mean of squared deviations (the TPU kernel's two-pass order,
// so the statistics agree with it), come from those registers with warp
// shuffles; the W warp sums meet through one small shared-memory
// exchange, added in warp order.  The block stays resident and walks its
// rows (a persistent grid: the card's SMs times the blocks one SM holds),
// so each lane loads its gamma and beta vectors once, not once a row, and
// loads its next row before it reduces this one, so that the round trip
// to memory overlaps the barriers.  The output leaves in 16-byte stores;
// mu and rstd are written in f32, one value per row, for the backward.
// More vectors a lane (fewer warps a row) cost registers and occupancy;
// fewer gained nothing (`scripts/torch_layer_norm_sweep.py`).
//
// The scalar route (`layer_norm_fwd_kernel`) takes the rest: rows off 16
// bytes (a width whose bytes are not a multiple of 16, or a misaligned
// pointer) and rows wider than `kMaxVectorWidth`, which would not fit the
// registers.  One block of 256 threads a row, threads striding the row
// 256 apart with scalar loads, two block reductions and three passes over
// the row (the re-reads hit L1).
#include <stdint.h>

#include "common.cuh"

namespace {

// The register budget of the vector routes (forward, backward, residual
// forward): 16-byte vectors of a row a lane holds at most (the warps a row
// takes follow from it), and the threads of a block
// (`scripts/torch_layer_norm_sweep.py` times others).
constexpr int kFwdLaneVectors = 2;
constexpr int kFwdThreads = 128;
constexpr int kBwdLaneVectors = 4;
constexpr int kBwdThreads = 128;
constexpr int kResLaneVectors = 3;
constexpr int kResThreads = 128;

using ptt::aligned16;
using ptt::block_rows;
using ptt::block_threads;
using ptt::kMaxVectorWidth;
using ptt::load_row;
using ptt::row_sum;
using ptt::row_warps;
using ptt::sm_count;
using ptt::Vec16;
using ptt::vector_route;

// ---- forward, the vector route ----------------------------------------
template <typename T, int W>
__global__ void __launch_bounds__(block_threads(W, kFwdThreads))
    ln_fwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ out,
                      float* __restrict__ mu_out,
                      float* __restrict__ rstd_out, int rows, int n,
                      float eps) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kC = kFwdLaneVectors;
  constexpr int kRows = block_rows(W, kFwdThreads);
  // [0]: the sums, [1]: the squared deviations.  Two slots need no
  // double buffer: a slot is rewritten only after the barrier of the other
  // one, which every reader of the first has passed.
  __shared__ float red[2][kRows][W];
  const int warp = threadIdx.x >> 5;
  const int grp = warp / W, wr = warp % W;
  const int t = wr * 32 + (threadIdx.x & 31);  // lane within the row
  const int nv = n / kVec;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* gv = reinterpret_cast<const V*>(gamma);
  const V* bv = reinterpret_cast<const V*>(beta);
  V g[kC], b[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int v = c * 32 * W + t;
    if (v < nv) {
      g[c] = gv[v];
      b[c] = bv[v];
    }
  }
  const size_t step = static_cast<size_t>(gridDim.x) * kRows;
  V a[kC];
  load_row<W>(a, xv, static_cast<size_t>(blockIdx.x) * kRows + grp, rows,
              nv, t);
  // every thread runs the same iterations (the row sums' barriers); each
  // loads its group's next row before it reduces this one
  for (size_t r0 = static_cast<size_t>(blockIdx.x) * kRows;
       r0 < static_cast<size_t>(rows); r0 += step) {
    const size_t row = r0 + grp;
    const bool live = row < static_cast<size_t>(rows);
    V next[kC];
    load_row<W>(next, xv, row + step, rows, nv, t);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (live && c * 32 * W + t < nv) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) s += ptt::to_float(a[c].v[j]);
      }
    }
    const float mu = row_sum<W>(s, red[0][grp], wr) / n;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (live && c * 32 * W + t < nv) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = ptt::to_float(a[c].v[j]) - mu;
          q += d * d;
        }
      }
    }
    const float rstd = rsqrtf(row_sum<W>(q, red[1][grp], wr) / n + eps);
    if (live) {
      V* yr = reinterpret_cast<V*>(out + row * n);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int v = c * 32 * W + t;
        if (v < nv) {
          V o;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float xhat = (ptt::to_float(a[c].v[j]) - mu) * rstd;
            o.v[j] = ptt::from_float<T>(xhat * ptt::to_float(g[c].v[j]) +
                                        ptt::to_float(b[c].v[j]));
          }
          yr[v] = o;
        }
      }
      if (t == 0) {
        mu_out[row] = mu;
        rstd_out[row] = rstd;
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) a[c] = next[c];
  }
}

// ---- forward, the scalar route ------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
    layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                          const T* __restrict__ beta, T* __restrict__ out,
                          float* __restrict__ mu_out,
                          float* __restrict__ rstd_out, int n, float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* yr = out + row * n;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += ptt::to_float(xr[i]);
  const float mu = ptt::block_sum(s, red) / n;

  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = ptt::to_float(xr[i]) - mu;
    v += d * d;
  }
  const float var = ptt::block_sum(v, red) / n;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xhat = (ptt::to_float(xr[i]) - mu) * rstd;
    yr[i] = ptt::from_float<T>(xhat * ptt::to_float(gamma[i]) +
                               ptt::to_float(beta[i]));
  }
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, int W>
cudaError_t ln_fwd_vec(const void* x, const void* gamma, const void* beta,
                       void* out, void* mu, void* rstd, int rows, int n,
                       float eps, int device, cudaStream_t s) {
  constexpr int kThreads = block_threads(W, kFwdThreads);
  constexpr int kRows = block_rows(W, kFwdThreads);
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, ln_fwd_vec_kernel<T, W>, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  const long long want = (static_cast<long long>(rows) + kRows - 1) / kRows;
  const long long cap = static_cast<long long>(sm_count(device)) * per_sm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  ln_fwd_vec_kernel<T, W><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out),
      static_cast<float*>(mu), static_cast<float*>(rstd), rows, n, eps);
  return cudaGetLastError();
}

// The vector launch for W warps a row: W, 2W, ... up to the most a row of
// kMaxVectorWidth takes at `kFwdLaneVectors` a lane.
template <typename T, int W>
cudaError_t ln_fwd_vec_any(int w, const void* x, const void* gamma,
                           const void* beta, void* out, void* mu, void* rstd,
                           int rows, int n, float eps, int device,
                           cudaStream_t s) {
  if (w == W)
    return ln_fwd_vec<T, W>(x, gamma, beta, out, mu, rstd, rows, n, eps,
                            device, s);
  if constexpr (32 * W * kFwdLaneVectors * Vec16<T>::kN < kMaxVectorWidth)
    return ln_fwd_vec_any<T, 2 * W>(w, x, gamma, beta, out, mu, rstd, rows,
                                    n, eps, device, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t layer_norm_fwd(const void* x, const void* gamma,
                           const void* beta, void* out, void* mu, void* rstd,
                           int rows, int n, float eps, int device,
                           cudaStream_t s) {
  if (vector_route(n, sizeof(T), x, gamma, beta, out))
    return ln_fwd_vec_any<T, 1>(
        row_warps(n, kFwdLaneVectors * Vec16<T>::kN), x, gamma, beta, out, mu,
        rstd, rows, n, eps, device, s);
  layer_norm_fwd_kernel<T><<<rows, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out),
      static_cast<float*>(mu), static_cast<float*>(rstd), n, eps);
  return cudaGetLastError();
}

// ---- residual add + layer norm, forward ---------------------------------
// Replaces: paddle_tpu/ops/pallas_fused.py `_ln_res_fwd_kernel` (:101,
// driven by `_fused_ln_residual_2d_fwd` :126), the post-norm sublayer
// epilogue of BERT and ERNIE: s = x + r added in f32 and stored in x's
// type; out = (s - mean) * rstd * gamma + beta from the f32 sum, cast
// once; mean and rstd saved in f32.  Its backward is the layer-norm
// backward below run on the saved s (pallas_fused.py:160-195).
//
// What bounds it on the H100: bytes.  Four [rows, N] streams (x and r
// read, out and s written) at ~10 flops per element.  At BERT's 768 a row
// is 1.5 KB a stream in bf16, so what stands between a row's loads and
// its stores (two reductions) has to overlap other rows' loads.
//
// Design, the vector route (`ln_res_fwd_vec_kernel`): the forward's vector
// route with two input streams.  W warps share a row, a lane holding
// `kResLaneVectors` 16-byte vectors of x and of r (three: at 768 one warp
// a row in bf16 and two in f32, every lane busy).  A lane adds its x and r
// in f32 as soon as they arrive, stores s in 16-byte stores at once and
// keeps the f32 sum in registers: the statistics and the output come from
// it, never from the stored s that a bf16 input rounds.  Its x and r
// registers are then free, so it loads its next row into them before this
// row's two reductions (the mean, then the mean of squared deviations:
// the TPU kernel's two-pass order, from registers; warp shuffles and one
// shared-memory exchange, added in warp order).  A persistent grid (the
// SMs times the blocks one holds), gamma and beta loaded once a lane.
// One to six vectors a lane and blocks of 256 threads were no faster
// (`scripts/torch_norm_sweep.py`).
//
// The scalar route (`layer_norm_residual_fwd_kernel`) takes rows off 16
// bytes and rows wider than kMaxVectorWidth: one block of 256 threads per
// row with scalar loads, neighbouring threads on neighbouring addresses.
// The first pass adds x and r in f32, writes s and sums it; the second and
// third passes re-read x and r (from L1) and add them again.
template <typename T, int W>
__global__ void __launch_bounds__(block_threads(W, kResThreads))
    ln_res_fwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ r,
                          const T* __restrict__ gamma,
                          const T* __restrict__ beta, T* __restrict__ out,
                          T* __restrict__ s_out, float* __restrict__ mu_out,
                          float* __restrict__ rstd_out, int rows, int n,
                          float eps) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kC = kResLaneVectors;
  constexpr int kRows = block_rows(W, kResThreads);
  // [0]: the sums, [1]: the squared deviations (one slot each suffices, as
  // in ln_fwd_vec_kernel)
  __shared__ float red[2][kRows][W];
  const int warp = threadIdx.x >> 5;
  const int grp = warp / W, wr = warp % W;
  const int t = wr * 32 + (threadIdx.x & 31);  // lane within the row
  const int nv = n / kVec;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* rv = reinterpret_cast<const V*>(r);
  const V* gv = reinterpret_cast<const V*>(gamma);
  const V* bv = reinterpret_cast<const V*>(beta);
  V g[kC], b[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int v = c * 32 * W + t;
    if (v < nv) {
      g[c] = gv[v];
      b[c] = bv[v];
    }
  }
  const size_t step = static_cast<size_t>(gridDim.x) * kRows;
  size_t row = static_cast<size_t>(blockIdx.x) * kRows + grp;
  V a[kC], e[kC];  // this row's x and r, then the next row's
  load_row<W>(a, xv, row, rows, nv, t);
  load_row<W>(e, rv, row, rows, nv, t);
  // every thread runs the same iterations (the row sums' barriers)
  for (size_t r0 = row - grp; r0 < static_cast<size_t>(rows);
       r0 += step, row += step) {
    const bool live = row < static_cast<size_t>(rows);
    float sf[kC][kVec];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int v = c * 32 * W + t;
      if (live && v < nv) {
        V o;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          sf[c][j] = ptt::to_float(a[c].v[j]) + ptt::to_float(e[c].v[j]);
          o.v[j] = ptt::from_float<T>(sf[c][j]);
          sum += sf[c][j];
        }
        reinterpret_cast<V*>(s_out + row * n)[v] = o;
      }
    }
    load_row<W>(a, xv, row + step, rows, nv, t);
    load_row<W>(e, rv, row + step, rows, nv, t);
    const float mu = row_sum<W>(sum, red[0][grp], wr) / n;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (live && c * 32 * W + t < nv) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = sf[c][j] - mu;
          q += d * d;
        }
      }
    }
    const float rstd = rsqrtf(row_sum<W>(q, red[1][grp], wr) / n + eps);
    if (live) {
      V* yr = reinterpret_cast<V*>(out + row * n);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int v = c * 32 * W + t;
        if (v < nv) {
          V o;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float shat = (sf[c][j] - mu) * rstd;
            o.v[j] = ptt::from_float<T>(shat * ptt::to_float(g[c].v[j]) +
                                        ptt::to_float(b[c].v[j]));
          }
          yr[v] = o;
        }
      }
      if (t == 0) {
        mu_out[row] = mu;
        rstd_out[row] = rstd;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    layer_norm_residual_fwd_kernel(
        const T* __restrict__ x, const T* __restrict__ r,
        const T* __restrict__ gamma, const T* __restrict__ beta,
        T* __restrict__ out, T* __restrict__ s_out,
        float* __restrict__ mu_out, float* __restrict__ rstd_out, int n,
        float eps) {
  __shared__ float red[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const T* xr = x + off;
  const T* rr = r + off;

  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float s = ptt::to_float(xr[i]) + ptt::to_float(rr[i]);
    s_out[off + i] = ptt::from_float<T>(s);
    sum += s;
  }
  const float mu = ptt::block_sum(sum, red) / n;

  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = ptt::to_float(xr[i]) + ptt::to_float(rr[i]) - mu;
    v += d * d;
  }
  const float var = ptt::block_sum(v, red) / n;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float shat =
        (ptt::to_float(xr[i]) + ptt::to_float(rr[i]) - mu) * rstd;
    out[off + i] = ptt::from_float<T>(shat * ptt::to_float(gamma[i]) +
                                      ptt::to_float(beta[i]));
  }
  if (threadIdx.x == 0) {
    mu_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
}

// Whether the residual forward takes the vector route: the rule of
// `vector_route` over its six pointers.
bool residual_vector_route(int n, int isz, const void* x, const void* r,
                           const void* gamma, const void* beta,
                           const void* out, const void* s) {
  return vector_route(n, isz, x, r, gamma, beta) && aligned16(out) &&
         aligned16(s);
}

template <typename T, int W>
cudaError_t ln_res_fwd_vec(const void* x, const void* r, const void* gamma,
                           const void* beta, void* out, void* s, void* mu,
                           void* rstd, int rows, int n, float eps,
                           int device, cudaStream_t stream) {
  constexpr int kThreads = block_threads(W, kResThreads);
  constexpr int kRows = block_rows(W, kResThreads);
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, ln_res_fwd_vec_kernel<T, W>, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  const long long want = (static_cast<long long>(rows) + kRows - 1) / kRows;
  const long long cap = static_cast<long long>(sm_count(device)) * per_sm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  ln_res_fwd_vec_kernel<T, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(out), static_cast<T*>(s), static_cast<float*>(mu),
      static_cast<float*>(rstd), rows, n, eps);
  return cudaGetLastError();
}

// The vector launch for W warps a row, as ln_fwd_vec_any.
template <typename T, int W>
cudaError_t ln_res_fwd_vec_any(int w, const void* x, const void* r,
                               const void* gamma, const void* beta, void* out,
                               void* s, void* mu, void* rstd, int rows, int n,
                               float eps, int device, cudaStream_t stream) {
  if (w == W)
    return ln_res_fwd_vec<T, W>(x, r, gamma, beta, out, s, mu, rstd, rows, n,
                                eps, device, stream);
  if constexpr (32 * W * kResLaneVectors * Vec16<T>::kN < kMaxVectorWidth)
    return ln_res_fwd_vec_any<T, 2 * W>(w, x, r, gamma, beta, out, s, mu,
                                        rstd, rows, n, eps, device, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t layer_norm_residual_fwd(const void* x, const void* r,
                                    const void* gamma, const void* beta,
                                    void* out, void* s, void* mu, void* rstd,
                                    int rows, int n, float eps, int device,
                                    cudaStream_t stream) {
  if (residual_vector_route(n, sizeof(T), x, r, gamma, beta, out, s))
    return ln_res_fwd_vec_any<T, 1>(
        row_warps(n, kResLaneVectors * Vec16<T>::kN), x, r, gamma, beta, out,
        s, mu, rstd, rows, n, eps, device, stream);
  layer_norm_residual_fwd_kernel<T><<<rows, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(out), static_cast<T*>(s), static_cast<float*>(mu),
      static_cast<float*>(rstd), n, eps);
  return cudaGetLastError();
}

// ---- backward -----------------------------------------------------------
// Replaces: paddle_tpu/ops/pallas_kernels.py `_ln_bwd_kernel` (:536, called
// at :608 by `_fused_layer_norm_2d_bwd`).  From the forward's saved f32
// mu/rstd:
//   xhat = (x - mu) * rstd,  dxhat = do * gamma,
//   dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd,
//   dgamma = sum over rows of do * xhat,  dbeta = sum over rows of do,
// all in f32; dx is written in x's type, dgamma/dbeta in gamma's.
//
// What bounds it on the H100: bytes (x and do read, dx written; ~12 flops
// per element).  dgamma and dbeta are sums over every row: the TPU kernel
// accumulates them into one output block that its sequential grid
// revisits, but CUDA blocks run in no order, and float atomics would make
// the sums differ from run to run.  So they go in two passes, and the
// partial sums between the passes are extra bytes to keep small.
//
// Design, the vector route (`ln_bwd_vec_kernel`): a persistent grid of as
// many blocks as the SMs hold at once (by their registers, 3 an SM in f32
// and 2 in bf16 at 2048), each walking its rows.  W warps share a row
// (the fewest whose lanes hold it at `kBwdLaneVectors`, four 16-byte
// vectors, a lane: at 2048 two warps in bf16 and four in f32, at BERT's 768
// one and two).  A lane issues all of its 16-byte
// loads of x and do at once and keeps them in registers from the two row
// means to dx, so x and do are read from device memory once; the means
// take one shuffle reduction each and one shared-memory exchange for both.
// It loads its next row (x, do, mu, rstd) before it reduces this one.  dx
// leaves in 16-byte stores; gamma is loaded once per lane.  Each lane adds
// its columns' do * xhat and do into f32 accumulators in registers across
// its rows; at the end the row groups of a block add theirs in group order
// through shared memory, and the block writes one row of `partial` [2,
// grid, n]: ~400 rows at 2048 in f32, not 512, and no shared-memory
// read-modify-write a value.  The second pass
// (`ptt::column_sum_sliced_kernel`, one launch for dgamma and dbeta)
// splits each column's sum over 16 slices of threads and adds the slices
// in order, in blocks of 16 columns: 256 blocks at 2048, where the first
// design's two `ptt::column_sum_kernel` launches (one thread a column) ran
// 8 blocks each.
// Every sum has a fixed order, so the results are the same on every run.
//
// The scalar route (`layer_norm_bwd_kernel`) takes rows off 16 bytes and
// rows wider than kMaxVectorWidth (up to 2n floats of shared memory, 227
// KB): `nblk` blocks of 256 threads, block b taking rows b, b + nblk, ...,
// two block reductions a row and a second read of the row (from L1/L2) to
// write dx, dgamma/dbeta accumulated in shared memory, thread t owning
// columns t, t + 256, ..., then the same second pass.
template <typename T, int W>
__global__ void __launch_bounds__(block_threads(W, kBwdThreads))
    ln_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const float* __restrict__ mu,
                      const float* __restrict__ rstd,
                      const T* __restrict__ dout, T* __restrict__ dx,
                      float* __restrict__ partial, int rows, int n) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kC = kBwdLaneVectors;
  constexpr int kRows = block_rows(W, kBwdThreads);
  extern __shared__ float4 acc4[];  // kRows > 1: [n / 4] dgamma, [n / 4] dbeta
  // the two row sums of each warp; double-buffered by the row's parity, as
  // the next row's sums are written before its one barrier
  __shared__ float red[2][kRows][W][2];
  const int warp = threadIdx.x >> 5;
  const int grp = warp / W, wr = warp % W;
  const int t = wr * 32 + (threadIdx.x & 31);
  const int nv = n / kVec;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* dv = reinterpret_cast<const V*>(dout);
  const V* gv = reinterpret_cast<const V*>(gamma);
  V g[kC];
  float dg[kC][kVec], db[kC][kVec];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int v = c * 32 * W + t;
    if (v < nv) g[c] = gv[v];
#pragma unroll
    for (int j = 0; j < kVec; ++j) dg[c][j] = db[c][j] = 0.f;
  }
  const size_t step = static_cast<size_t>(gridDim.x) * kRows;
  size_t row = static_cast<size_t>(blockIdx.x) * kRows + grp;
  V a[kC], d[kC];
  load_row<W>(a, xv, row, rows, nv, t);
  load_row<W>(d, dv, row, rows, nv, t);
  float m = row < static_cast<size_t>(rows) ? mu[row] : 0.f;
  float r = row < static_cast<size_t>(rows) ? rstd[row] : 0.f;
  int parity = 0;
  // every thread runs the same iterations (the row sums' barrier); each
  // loads its group's next row before it reduces this one
  for (size_t r0 = row - grp; r0 < static_cast<size_t>(rows);
       r0 += step, row += step, parity ^= 1) {
    const bool live = row < static_cast<size_t>(rows);
    const size_t nrow = row + step;
    V na[kC], nd[kC];
    load_row<W>(na, xv, nrow, rows, nv, t);
    load_row<W>(nd, dv, nrow, rows, nv, t);
    const float nm = nrow < static_cast<size_t>(rows) ? mu[nrow] : 0.f;
    const float nr = nrow < static_cast<size_t>(rows) ? rstd[nrow] : 0.f;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (live && c * 32 * W + t < nv) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xhat = (ptt::to_float(a[c].v[j]) - m) * r;
          const float dy = ptt::to_float(d[c].v[j]);
          const float dxhat = dy * ptt::to_float(g[c].v[j]);
          s1 += dxhat;
          s2 += dxhat * xhat;
          dg[c][j] += dy * xhat;
          db[c][j] += dy;
        }
      }
    }
    s1 = ptt::warp_sum(s1);
    s2 = ptt::warp_sum(s2);
    if constexpr (W > 1) {
      float* slot = red[parity][grp][0];
      if ((threadIdx.x & 31) == 0) {
        slot[2 * wr] = s1;
        slot[2 * wr + 1] = s2;
      }
      __syncthreads();
      s1 = s2 = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        s1 += slot[2 * i];
        s2 += slot[2 * i + 1];
      }
    }
    if (live) {
      const float m1 = s1 / n, m2 = s2 / n;
      V* out = reinterpret_cast<V*>(dx + row * n);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int v = c * 32 * W + t;
        if (v < nv) {
          V o;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float xhat = (ptt::to_float(a[c].v[j]) - m) * r;
            const float dxhat =
                ptt::to_float(d[c].v[j]) * ptt::to_float(g[c].v[j]);
            o.v[j] = ptt::from_float<T>((dxhat - m1 - xhat * m2) * r);
          }
          out[v] = o;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      a[c] = na[c];
      d[c] = nd[c];
    }
    m = nm;
    r = nr;
  }
  // the block's row of partial sums: its row groups' accumulators added in
  // group order (group k adds its own to the sum of groups 0..k-1)
  constexpr int kQ = kVec / 4;  // float4s of a vector's columns
  const int nq = n / 4;
#pragma unroll 1
  for (int k = 0; k + 1 < kRows; ++k) {
    if (grp == k) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int v = c * 32 * W + t;
        if (v < nv) {
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            float4 sg = make_float4(dg[c][4 * q], dg[c][4 * q + 1],
                                    dg[c][4 * q + 2], dg[c][4 * q + 3]);
            float4 sb = make_float4(db[c][4 * q], db[c][4 * q + 1],
                                    db[c][4 * q + 2], db[c][4 * q + 3]);
            if (k > 0) {
              const float4 pg = acc4[v * kQ + q], pb = acc4[nq + v * kQ + q];
              sg = make_float4(pg.x + sg.x, pg.y + sg.y, pg.z + sg.z,
                               pg.w + sg.w);
              sb = make_float4(pb.x + sb.x, pb.y + sb.y, pb.z + sb.z,
                               pb.w + sb.w);
            }
            acc4[v * kQ + q] = sg;
            acc4[nq + v * kQ + q] = sb;
          }
        }
      }
    }
    __syncthreads();
  }
  if (grp == kRows - 1) {
    float4* pg = reinterpret_cast<float4*>(partial) +
                 static_cast<size_t>(blockIdx.x) * nq;
    float4* pb = reinterpret_cast<float4*>(partial) +
                 (static_cast<size_t>(gridDim.x) + blockIdx.x) * nq;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int v = c * 32 * W + t;
      if (v < nv) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          float4 sg = make_float4(dg[c][4 * q], dg[c][4 * q + 1],
                                  dg[c][4 * q + 2], dg[c][4 * q + 3]);
          float4 sb = make_float4(db[c][4 * q], db[c][4 * q + 1],
                                  db[c][4 * q + 2], db[c][4 * q + 3]);
          if (kRows > 1) {
            const float4 ag = acc4[v * kQ + q], ab = acc4[nq + v * kQ + q];
            sg = make_float4(ag.x + sg.x, ag.y + sg.y, ag.z + sg.z,
                             ag.w + sg.w);
            sb = make_float4(ab.x + sb.x, ab.y + sb.y, ab.z + sb.z,
                             ab.w + sb.w);
          }
          pg[v * kQ + q] = sg;
          pb[v * kQ + q] = sb;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                          const float* __restrict__ mu,
                          const float* __restrict__ rstd,
                          const T* __restrict__ dout, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int n) {
  extern __shared__ float acc[];  // [0, n): dgamma, [n, 2n): dbeta
  __shared__ float red[32];
  float* dg = acc;
  float* db = acc + n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();  // dbeta's words were zeroed by other threads when
                    // n is not a multiple of the block

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * n;
    const T* xr = x + off;
    const T* dr = dout + off;
    const float m = mu[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float xhat = (ptt::to_float(xr[i]) - m) * r;
      const float d = ptt::to_float(dr[i]);
      const float dxhat = d * ptt::to_float(gamma[i]);
      s1 += dxhat;
      s2 += dxhat * xhat;
      dg[i] += d * xhat;
      db[i] += d;
    }
    const float m1 = ptt::block_sum(s1, red) / n;
    const float m2 = ptt::block_sum(s2, red) / n;
    T* out = dx + off;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float xhat = (ptt::to_float(xr[i]) - m) * r;
      const float dxhat = ptt::to_float(dr[i]) * ptt::to_float(gamma[i]);
      out[i] = ptt::from_float<T>((dxhat - m1 - xhat * m2) * r);
    }
  }
  const size_t nblk = gridDim.x;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    partial[blockIdx.x * static_cast<size_t>(n) + i] = dg[i];
    partial[(nblk + blockIdx.x) * n + i] = db[i];
  }
}

// The second pass: dgamma and dbeta, each column the sum of its `nparts`
// rows of partial [2, nparts, n] (`ptt::column_sum_sliced_kernel`).
template <typename T>
cudaError_t ln_bwd_sum(const float* partial, void* dgamma, void* dbeta,
                       int nparts, int n, cudaStream_t s) {
  const dim3 grid((n + ptt::kSumCols - 1) / ptt::kSumCols, 2);
  constexpr int kThreads = ptt::kSumCols * ptt::kSumSlices;
  ptt::column_sum_sliced_kernel<T><<<grid, kThreads, 0, s>>>(
      partial, static_cast<T*>(dgamma), static_cast<T*>(dbeta), nparts, n);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t ln_bwd_vec(const void* x, const void* gamma, const void* mu,
                       const void* rstd, const void* dout, void* dx,
                       void* dgamma, void* dbeta, void* partial, int rows,
                       int n, int nblk, int device, cudaStream_t s) {
  constexpr int kThreads = block_threads(W, kBwdThreads);
  constexpr int kRows = block_rows(W, kBwdThreads);
  // the row groups' sums, for the widest row of W warps
  constexpr size_t kMaxSmem =
      kRows > 1 ? 2 * sizeof(float) * 32 * W * kBwdLaneVectors * Vec16<T>::kN
                : 0;
  static_assert(kMaxSmem <= 48 * 1024, "the row groups' sums must fit the "
                                       "default shared-memory limit");
  const size_t smem =
      kRows > 1 ? 2 * static_cast<size_t>(n) * sizeof(float) : 0;
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, ln_bwd_vec_kernel<T, W>, kThreads, kMaxSmem);
    return b > 0 ? b : 1;
  }();
  // as many blocks as the SMs hold at once, at most nblk (the scratch's
  // rows) and one a row group
  int grid = (rows + kRows - 1) / kRows;
  if (grid > nblk) grid = nblk;
  if (grid > sm_count(device) * per_sm) grid = sm_count(device) * per_sm;
  float* part = static_cast<float*>(partial);
  ln_bwd_vec_kernel<T, W><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dout), static_cast<T*>(dx), part, rows, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return ln_bwd_sum<T>(part, dgamma, dbeta, grid, n, s);
}

// The vector launch for W warps a row, as ln_fwd_vec_any.
template <typename T, int W>
cudaError_t ln_bwd_vec_any(int w, const void* x, const void* gamma,
                           const void* mu, const void* rstd, const void* dout,
                           void* dx, void* dgamma, void* dbeta, void* partial,
                           int rows, int n, int nblk, int device,
                           cudaStream_t s) {
  if (w == W)
    return ln_bwd_vec<T, W>(x, gamma, mu, rstd, dout, dx, dgamma, dbeta,
                            partial, rows, n, nblk, device, s);
  if constexpr (32 * W * kBwdLaneVectors * Vec16<T>::kN < kMaxVectorWidth)
    return ln_bwd_vec_any<T, 2 * W>(w, x, gamma, mu, rstd, dout, dx, dgamma,
                                    dbeta, partial, rows, n, nblk, device, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t layer_norm_bwd(const void* x, const void* gamma, const void* mu,
                           const void* rstd, const void* dout, void* dx,
                           void* dgamma, void* dbeta, void* partial, int rows,
                           int n, int nblk, int device, cudaStream_t s) {
  if (vector_route(n, sizeof(T), x, gamma, dout, dx))
    return ln_bwd_vec_any<T, 1>(
        row_warps(n, kBwdLaneVectors * Vec16<T>::kN), x, gamma, mu, rstd,
        dout, dx, dgamma, dbeta, partial, rows, n, nblk, device, s);
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  float* part = static_cast<float*>(partial);
  layer_norm_bwd_kernel<T><<<nblk, 256, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dout), static_cast<T*>(dx), part, rows, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return ln_bwd_sum<T>(part, dgamma, dbeta, nblk, n, s);
}

}  // namespace

extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* out, void* mu,
                                  void* rstd, int rows, int n, float eps,
                                  int dtype, int device,
                                  void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == PTT_DTYPE_F32) {
    e = layer_norm_fwd<float>(x, gamma, beta, out, mu, rstd, rows, n, eps,
                              device, s);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = layer_norm_fwd<__nv_bfloat16>(x, gamma, beta, out, mu, rstd, rows, n,
                                      eps, device, s);
  } else if (dtype == PTT_DTYPE_F16) {
    e = layer_norm_fwd<__half>(x, gamma, beta, out, mu, rstd, rows, n, eps,
                               device, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// x, r, out, s: [rows, n] of one dtype; gamma, beta: [n]; mu, rstd: f32
// [rows].
extern "C" int ptt_layer_norm_residual_fwd(const void* x, const void* r,
                                           const void* gamma,
                                           const void* beta, void* out,
                                           void* s, void* mu, void* rstd,
                                           int rows, int n, float eps,
                                           int dtype, int device,
                                           void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == PTT_DTYPE_F32) {
    e = layer_norm_residual_fwd<float>(x, r, gamma, beta, out, s, mu, rstd,
                                       rows, n, eps, device, st);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = layer_norm_residual_fwd<__nv_bfloat16>(x, r, gamma, beta, out, s,
                                               mu, rstd, rows, n, eps, device,
                                               st);
  } else if (dtype == PTT_DTYPE_F16) {
    e = layer_norm_residual_fwd<__half>(x, r, gamma, beta, out, s, mu, rstd,
                                        rows, n, eps, device, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// partial: f32 scratch of 2 * nblk * n floats, 1 <= nblk <= rows.  The
// scalar route runs nblk blocks, the vector route as many as the SMs hold
// at once, at most nblk and one a row group.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* gamma,
                                  const void* mu, const void* rstd,
                                  const void* dout, void* dx, void* dgamma,
                                  void* dbeta, void* partial, int rows, int n,
                                  int nblk, int dtype, int device,
                                  void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (nblk < 1 || nblk > rows || 2 * static_cast<size_t>(n) * sizeof(float) >
                                     227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == PTT_DTYPE_F32) {
    e = layer_norm_bwd<float>(x, gamma, mu, rstd, dout, dx, dgamma, dbeta,
                              partial, rows, n, nblk, device, s);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = layer_norm_bwd<__nv_bfloat16>(x, gamma, mu, rstd, dout, dx, dgamma,
                                      dbeta, partial, rows, n, nblk, device,
                                      s);
  } else if (dtype == PTT_DTYPE_F16) {
    e = layer_norm_bwd<__half>(x, gamma, mu, rstd, dout, dx, dgamma, dbeta,
                               partial, rows, n, nblk, device, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// 1 when rows of n values of `isz` bytes at these pointers (forward: x,
// gamma, beta, out; backward: x, gamma, do, dx) take the vector route,
// else 0 (the scalar route).
extern "C" int ptt_layer_norm_vector_route(const void* a, const void* b,
                                           const void* c, const void* d,
                                           int n, int isz) {
  return vector_route(n, isz, a, b, c, d) ? 1 : 0;
}

// 1 when the residual forward on rows of n values of `isz` bytes at these
// pointers takes the vector route, else 0 (the scalar route).
extern "C" int ptt_layer_norm_residual_vector_route(
    const void* x, const void* r, const void* gamma, const void* beta,
    const void* out, const void* s, int n, int isz) {
  return residual_vector_route(n, isz, x, r, gamma, beta, out, s) ? 1 : 0;
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
