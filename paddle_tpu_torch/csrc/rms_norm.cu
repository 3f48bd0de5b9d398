// RMSNorm over the last dimension: the forward, with the saved f32 rstd,
// and the backward (below).
//
// Forward.  Replaces: paddle_tpu/ops/pallas_kernels.py `_rms_fwd_kernel`
// (:648, called at :690 by `_fused_rms_norm_2d_fwd`), the row-blocked
// Pallas RMS norm: in f32, ms = mean(x * x), rstd = rsqrt(ms + eps), out =
// x * rstd * gamma rounded once to x's type, and rstd saved (f32, one per
// row) for the backward.
//
// What bounds it on the H100: bytes.  Each value is read once and written
// once and costs about four flops, far below the ~295 flops per byte the
// card needs before its arithmetic matters.  At a few rows (a decode step,
// 4 rows of 4096) there are too few blocks to fill the card and the launch
// itself bounds it.
//
// Design: one block per row, up to 256 threads, each moving 16 bytes a load
// (8 bf16 or 4 f32 values) when the row length and the pointers allow it,
// else one value.  Neighbouring threads read neighbouring vectors.  The
// block reduces the sum of squares with warp shuffles, then re-reads the
// row to scale it: a row of 4096 bf16 is 8 KB, so the re-read hits L1 and
// device memory still sees one read.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

// VEC values of T moved as one aligned access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                        T* __restrict__ out, float* __restrict__ rstd_out,
                        int n, float eps) {
  using V = Vec<T, VEC>;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const int nv = n / VEC;
  const V* xr = reinterpret_cast<const V*>(x + row * n);
  const V* gv = reinterpret_cast<const V*>(gamma);
  V* yr = reinterpret_cast<V*>(out + row * n);

  float s = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const V a = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = ptt::to_float(a.v[j]);
      s += f * f;
    }
  }
  const float rstd = rsqrtf(ptt::block_sum(s, red) / n + eps);

  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const V a = xr[i];
    const V g = gv[i];
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = ptt::from_float<T>(ptt::to_float(a.v[j]) * rstd *
                                  ptt::to_float(g.v[j]));
    yr[i] = o;
  }
  if (threadIdx.x == 0) rstd_out[row] = rstd;
}

// ---- backward -----------------------------------------------------------
// Replaces: paddle_tpu/ops/pallas_kernels.py `_rms_bwd_kernel` (:658,
// called at :720 by `_fused_rms_norm_2d_bwd`).  From the forward's saved
// f32 rstd, all in f32:
//   xhat = x * rstd,  dxhat = do * gamma,
//   dx = (dxhat - xhat * mean(dxhat * xhat)) * rstd,
//   dgamma = sum over rows of do * xhat,
// dx written in x's type, dgamma in gamma's.
//
// What bounds it on the H100: bytes (x and do read, dx written; ~8 flops
// per element).  dgamma is a sum over every row: the TPU kernel adds it
// into one output block that its sequential grid revisits, but CUDA blocks
// run in no order and float atomics would make the sum differ from run to
// run, so it goes in two passes, and the partial sums between them are
// extra bytes to keep few.
//
// Design, the vector route (`rms_bwd_vec_kernel`), row 6's
// (`ln_bwd_vec_kernel` in layer_norm.cu) with one row sum: W warps share a
// row, the fewest whose lanes hold it at `kBwdLaneValues` (16) values a
// lane: four 16-byte vectors in f32, two in bf16 (four bf16 vectors and
// their f32 dgamma sums spill at the 128 registers the grid allows: on an
// H100 at 700 W the bf16 backward at [8192, 1024] took 0.084 ms with four,
// 0.032 with two).  At 1024 two warps a row in both.  A lane issues all
// its 16-byte loads of x and do at once and keeps them in registers from
// the mean to dx, so neither is read twice; the mean takes one warp
// butterfly and, for W > 1, one shared-memory exchange added in warp
// order.  The grid is persistent,
// `kBwdSmThreads` threads an SM (the launch bounds hold each thread to the
// registers that many allow), so each lane loads gamma once and loads its
// next row (x, do, rstd) before it reduces this one.  Each lane adds its
// columns' do * xhat in f32 registers across its rows; at the end the
// block's row groups add theirs in group order through shared memory and
// the block writes one row of `partial` [grid, n]: 264 rows at the LLaMA
// drive's 1024 (blocks of 256 threads, two an SM), where the first design
// wrote 512 and read-modified-wrote shared memory a value.  The second
// pass, `ptt::column_sum_sliced_kernel`, splits each column over 16 slices
// of threads in blocks of 16 columns (64 blocks at 1024; the first
// design's `column_sum_kernel` ran 4, one thread a column adding 512 rows
// in sequence).  Every sum has a fixed order: the results are the same on
// every run.  `scripts/torch_norm_sweep.py` times other budgets: more
// threads an SM (fewer registers) spill or lose, fewer gain nothing.
//
// The scalar route (`rms_norm_bwd_kernel`, the first design) takes rows
// off 16 bytes, misaligned pointers and rows wider than kMaxVectorWidth:
// `nblk` blocks, block b taking rows b, b + nblk, ...; per row one block
// reduction (the mean) and a second read of the row (from L1/L2) to write
// dx.  Each thread owns the same vectors of every row (16-byte ones where
// the row allows) and adds its columns' do * xhat into the block's f32
// accumulator in shared memory, laid out [VEC][n / VEC] so that a warp's
// 32 threads hit 32 banks; the block writes it as its row of `partial`
// for the same second pass.

using ptt::block_rows;
using ptt::kMaxVectorWidth;
using ptt::load_row;
using ptt::Vec16;

// The vector route's budget: values of a row a lane holds at most, in
// 16-byte vectors (four f32 or two bf16 ones; the warps a row takes follow
// from it), threads a block, and threads an SM of the persistent grid
// (`scripts/torch_norm_sweep.py` times others).
constexpr int kBwdLaneValues = 16;
constexpr int kBwdThreads = 256;
constexpr int kBwdSmThreads = 512;

// 16-byte vectors of `vec` values each that a lane holds.
__host__ __device__ constexpr int bwd_lane_vectors(int vec) {
  return kBwdLaneValues / vec > 0 ? kBwdLaneValues / vec : 1;
}
// Blocks of the scalar route (`ptt_rms_norm_bwd` takes nblk of them).
constexpr int kScalarBlocks = 512;

// Blocks an SM of the vector route for W warps a row.
__host__ __device__ constexpr int bwd_blocks_per_sm(int w) {
  return kBwdSmThreads / ptt::block_threads(w, kBwdThreads) > 0
             ? kBwdSmThreads / ptt::block_threads(w, kBwdThreads)
             : 1;
}

template <typename T, int W>
__global__ void __launch_bounds__(ptt::block_threads(W, kBwdThreads),
                                  bwd_blocks_per_sm(W))
    rms_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dout, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int n) {
  using V = Vec16<T>;
  constexpr int kVec = V::kN;
  constexpr int kC = bwd_lane_vectors(Vec16<T>::kN);
  constexpr int kRows = block_rows(W, kBwdThreads);
  extern __shared__ float4 acc4[];  // kRows > 1: [n / 4] the groups' dgamma
  // each warp's row sum, double-buffered by the row's parity: the next
  // row's sums are written before its one barrier
  __shared__ float red[2][kRows][W];
  const int warp = threadIdx.x >> 5;
  const int grp = warp / W, wr = warp % W;
  const int t = wr * 32 + (threadIdx.x & 31);
  const int nv = n / kVec;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* dv = reinterpret_cast<const V*>(dout);
  const V* gv = reinterpret_cast<const V*>(gamma);
  V g[kC];
  float dg[kC][kVec];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int v = c * 32 * W + t;
    if (v < nv) g[c] = gv[v];
#pragma unroll
    for (int j = 0; j < kVec; ++j) dg[c][j] = 0.f;
  }
  const size_t step = static_cast<size_t>(gridDim.x) * kRows;
  size_t row = static_cast<size_t>(blockIdx.x) * kRows + grp;
  V a[kC], d[kC];
  load_row<W>(a, xv, row, rows, nv, t);
  load_row<W>(d, dv, row, rows, nv, t);
  float r = row < static_cast<size_t>(rows) ? rstd[row] : 0.f;
  int parity = 0;
  // every thread runs the same iterations (the row sum's barrier); each
  // loads its group's next row before it reduces this one
  for (size_t r0 = row - grp; r0 < static_cast<size_t>(rows);
       r0 += step, row += step, parity ^= 1) {
    const bool live = row < static_cast<size_t>(rows);
    const size_t nrow = row + step;
    V na[kC], nd[kC];
    load_row<W>(na, xv, nrow, rows, nv, t);
    load_row<W>(nd, dv, nrow, rows, nv, t);
    const float nr = nrow < static_cast<size_t>(rows) ? rstd[nrow] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (live && c * 32 * W + t < nv) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xhat = ptt::to_float(a[c].v[j]) * r;
          const float dy = ptt::to_float(d[c].v[j]);
          s += dy * ptt::to_float(g[c].v[j]) * xhat;
          dg[c][j] += dy * xhat;
        }
      }
    }
    s = ptt::warp_sum(s);
    if constexpr (W > 1) {
      float* slot = red[parity][grp];
      if ((threadIdx.x & 31) == 0) slot[wr] = s;
      __syncthreads();
      s = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) s += slot[i];
    }
    if (live) {
      const float m = s / n;
      V* out = reinterpret_cast<V*>(dx + row * n);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int v = c * 32 * W + t;
        if (v < nv) {
          V o;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float xhat = ptt::to_float(a[c].v[j]) * r;
            const float dxhat =
                ptt::to_float(d[c].v[j]) * ptt::to_float(g[c].v[j]);
            o.v[j] = ptt::from_float<T>((dxhat - xhat * m) * r);
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
    r = nr;
  }
  // the block's row of partial sums: its row groups' accumulators added in
  // group order (group k adds its own to the sum of groups 0..k-1)
  constexpr int kQ = kVec / 4;  // float4s of a vector's columns
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
            if (k > 0) {
              const float4 pg = acc4[v * kQ + q];
              sg = make_float4(pg.x + sg.x, pg.y + sg.y, pg.z + sg.z,
                               pg.w + sg.w);
            }
            acc4[v * kQ + q] = sg;
          }
        }
      }
    }
    __syncthreads();
  }
  if (grp == kRows - 1) {
    float4* pg = reinterpret_cast<float4*>(partial) +
                 static_cast<size_t>(blockIdx.x) * (n / 4);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int v = c * 32 * W + t;
      if (v < nv) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          float4 sg = make_float4(dg[c][4 * q], dg[c][4 * q + 1],
                                  dg[c][4 * q + 2], dg[c][4 * q + 3]);
          if (kRows > 1) {
            const float4 ag = acc4[v * kQ + q];
            sg = make_float4(ag.x + sg.x, ag.y + sg.y, ag.z + sg.z,
                             ag.w + sg.w);
          }
          pg[v * kQ + q] = sg;
        }
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                        const float* __restrict__ rstd,
                        const T* __restrict__ dout, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int n) {
  using V = Vec<T, VEC>;
  extern __shared__ float dg[];  // [VEC][nv]
  __shared__ float red[32];
  const int nv = n / VEC;
  const V* gv = reinterpret_cast<const V*>(gamma);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dg[j * nv + i] = 0.f;
  }

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * n;
    const V* xr = reinterpret_cast<const V*>(x + off);
    const V* dr = reinterpret_cast<const V*>(dout + off);
    const float r = rstd[row];
    float s = 0.f;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const V a = xr[i];
      const V d = dr[i];
      const V g = gv[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = ptt::to_float(a.v[j]) * r;
        const float dof = ptt::to_float(d.v[j]);
        s += dof * ptt::to_float(g.v[j]) * xhat;
        dg[j * nv + i] += dof * xhat;
      }
    }
    const float m = ptt::block_sum(s, red) / n;
    V* out = reinterpret_cast<V*>(dx + off);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const V a = xr[i];
      const V d = dr[i];
      const V g = gv[i];
      V o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = ptt::to_float(a.v[j]) * r;
        const float dxhat = ptt::to_float(d.v[j]) * ptt::to_float(g.v[j]);
        o.v[j] = ptt::from_float<T>((dxhat - xhat * m) * r);
      }
      out[i] = o;
    }
  }
  float* prow = partial + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) prow[i * VEC + j] = dg[j * nv + i];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Threads of a block that walks nv vectors: one warp at least, 256 at
// most, a multiple of 32 (block_sum needs whole warps).
int block_threads(int nv) {
  const int t = (nv + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

template <typename T, int VEC>
cudaError_t rms_fwd(const void* x, const void* gamma, void* out, void* rstd,
                    int rows, int n, float eps, cudaStream_t s) {
  rms_norm_fwd_kernel<T, VEC><<<rows, block_threads(n / VEC), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<T*>(out), static_cast<float*>(rstd), n, eps);
  return cudaGetLastError();
}

// The second pass: dgamma, each column the sum of its `nparts` rows of
// partial [nparts, n] (`ptt::column_sum_sliced_kernel`, one sum).
template <typename T>
cudaError_t dgamma_sum(const float* partial, void* dgamma, int nparts, int n,
                       cudaStream_t s) {
  const dim3 grid((n + ptt::kSumCols - 1) / ptt::kSumCols, 1);
  constexpr int kThreads = ptt::kSumCols * ptt::kSumSlices;
  ptt::column_sum_sliced_kernel<T><<<grid, kThreads, 0, s>>>(
      partial, static_cast<T*>(dgamma), static_cast<T*>(dgamma), nparts, n);
  return cudaGetLastError();
}

// The backward's first-pass blocks, each one row of `partial`: on the
// vector route its persistent grid (bwd_blocks_per_sm an SM, one a row
// group at most), on the scalar route kScalarBlocks (one a row at most).
int bwd_blocks(int rows, int n, int isz, bool vector, int device) {
  if (!vector) return rows < kScalarBlocks ? rows : kScalarBlocks;
  const int vec = 16 / isz;
  const int w = ptt::row_warps(n, bwd_lane_vectors(vec) * vec);
  const int group = ptt::block_rows(w, kBwdThreads);
  const long long want = (static_cast<long long>(rows) + group - 1) / group;
  const long long cap =
      static_cast<long long>(ptt::sm_count(device)) * bwd_blocks_per_sm(w);
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T, int W>
cudaError_t rms_bwd_vec(const void* x, const void* gamma, const void* rstd,
                        const void* dout, void* dx, void* dgamma,
                        void* partial, int rows, int n, int nblk, int device,
                        cudaStream_t s) {
  constexpr int kThreads = ptt::block_threads(W, kBwdThreads);
  constexpr int kRows = block_rows(W, kBwdThreads);
  // the row groups' sums, for the widest row of W warps
  constexpr int kVec = Vec16<T>::kN;
  static_assert(kRows == 1 || sizeof(float) * 32 * W *
                                      bwd_lane_vectors(kVec) * kVec <=
                                  48 * 1024,
                "the row groups' sums must fit the default shared-memory "
                "limit");
  const size_t smem = kRows > 1 ? static_cast<size_t>(n) * sizeof(float) : 0;
  int grid = bwd_blocks(rows, n, sizeof(T), true, device);
  if (grid > nblk) grid = nblk;  // the scratch's rows
  float* part = static_cast<float*>(partial);
  rms_bwd_vec_kernel<T, W><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const float*>(rstd), static_cast<const T*>(dout),
      static_cast<T*>(dx), part, rows, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return dgamma_sum<T>(part, dgamma, grid, n, s);
}

// The vector launch for W warps a row: W, 2W, ... up to the most a row of
// kMaxVectorWidth takes at `bwd_lane_vectors` a lane.
template <typename T, int W>
cudaError_t rms_bwd_vec_any(int w, const void* x, const void* gamma,
                            const void* rstd, const void* dout, void* dx,
                            void* dgamma, void* partial, int rows, int n,
                            int nblk, int device, cudaStream_t s) {
  if (w == W)
    return rms_bwd_vec<T, W>(x, gamma, rstd, dout, dx, dgamma, partial, rows,
                             n, nblk, device, s);
  if constexpr (32 * W * bwd_lane_vectors(Vec16<T>::kN) * Vec16<T>::kN <
                kMaxVectorWidth)
    return rms_bwd_vec_any<T, 2 * W>(w, x, gamma, rstd, dout, dx, dgamma,
                                     partial, rows, n, nblk, device, s);
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t rms_bwd(const void* x, const void* gamma, const void* rstd,
                    const void* dout, void* dx, void* dgamma, void* partial,
                    int rows, int n, int nblk, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rms_norm_bwd_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  float* part = static_cast<float*>(partial);
  rms_norm_bwd_kernel<T, VEC><<<nblk, block_threads(n / VEC), smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const float*>(rstd), static_cast<const T*>(dout),
      static_cast<T*>(dx), part, rows, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return dgamma_sum<T>(part, dgamma, nblk, n, s);
}

// 16-byte accesses when every row starts on a 16-byte boundary, else one
// value at a time.
template <typename T>
bool use_vectors(int n, std::initializer_list<const void*> ptrs) {
  if (n % (16 / sizeof(T)) != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

template <typename T>
cudaError_t rms_fwd_any(const void* x, const void* gamma, void* out,
                        void* rstd, int rows, int n, float eps,
                        cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (use_vectors<T>(n, {x, gamma, out}))
    return rms_fwd<T, kVec>(x, gamma, out, rstd, rows, n, eps, s);
  return rms_fwd<T, 1>(x, gamma, out, rstd, rows, n, eps, s);
}

template <typename T>
cudaError_t rms_bwd_any(const void* x, const void* gamma, const void* rstd,
                        const void* dout, void* dx, void* dgamma,
                        void* partial, int rows, int n, int nblk, int device,
                        cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (ptt::vector_route(n, sizeof(T), x, gamma, dout, dx))
    return rms_bwd_vec_any<T, 1>(
        ptt::row_warps(n, bwd_lane_vectors(kVec) * kVec), x, gamma, rstd,
        dout, dx, dgamma, partial, rows, n, nblk, device, s);
  if (use_vectors<T>(n, {x, gamma, dout, dx}))  // wider than the registers
    return rms_bwd<T, kVec>(x, gamma, rstd, dout, dx, dgamma, partial, rows,
                            n, nblk, s);
  return rms_bwd<T, 1>(x, gamma, rstd, dout, dx, dgamma, partial, rows, n,
                       nblk, s);
}

}  // namespace

extern "C" int ptt_rms_norm_fwd(const void* x, const void* gamma, void* out,
                                void* rstd, int rows, int n, float eps,
                                int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == PTT_DTYPE_F32) {
    e = rms_fwd_any<float>(x, gamma, out, rstd, rows, n, eps, s);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = rms_fwd_any<__nv_bfloat16>(x, gamma, out, rstd, rows, n, eps, s);
  } else if (dtype == PTT_DTYPE_F16) {
    e = rms_fwd_any<__half>(x, gamma, out, rstd, rows, n, eps, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// partial: f32 scratch of nblk * n floats, 1 <= nblk <= rows.  The scalar
// route runs nblk blocks, the vector route its persistent grid, at most
// nblk (`ptt_rms_norm_bwd_blocks` says how many rows each route fills).
extern "C" int ptt_rms_norm_bwd(const void* x, const void* gamma,
                                const void* rstd, const void* dout, void* dx,
                                void* dgamma, void* partial, int rows, int n,
                                int nblk, int dtype, int device,
                                void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (nblk < 1 || nblk > rows ||
      static_cast<size_t>(n) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == PTT_DTYPE_F32) {
    e = rms_bwd_any<float>(x, gamma, rstd, dout, dx, dgamma, partial, rows,
                           n, nblk, device, s);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = rms_bwd_any<__nv_bfloat16>(x, gamma, rstd, dout, dx, dgamma, partial,
                                   rows, n, nblk, device, s);
  } else if (dtype == PTT_DTYPE_F16) {
    e = rms_bwd_any<__half>(x, gamma, rstd, dout, dx, dgamma, partial, rows,
                            n, nblk, device, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// 1 when the backward on rows of n values of `isz` bytes at x, gamma, do
// and dx takes the vector route, else 0 (the scalar route).
extern "C" int ptt_rms_norm_vector_route(const void* x, const void* gamma,
                                         const void* dout, const void* dx,
                                         int n, int isz) {
  return ptt::vector_route(n, isz, x, gamma, dout, dx) ? 1 : 0;
}

// The backward's first-pass blocks on `device` for rows of n values of
// `isz` bytes on the vector route (vector 1) or the scalar route (0): the
// rows of `partial` it fills when nblk allows them.
extern "C" int ptt_rms_norm_bwd_blocks(int rows, int n, int isz, int vector,
                                       int device) {
  if (rows < 1 || n < 1 || (isz != 4 && isz != 2)) return 1;
  return bwd_blocks(rows, n, isz, vector != 0, device);
}
