// RMSNorm forward over the last dimension, with the saved f32 rstd.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_rms_fwd_kernel` (:648,
// called at :690 by `_fused_rms_norm_2d_fwd`), the row-blocked Pallas RMS
// norm: in f32, ms = mean(x * x), rstd = rsqrt(ms + eps), out = x * rstd *
// gamma rounded once to x's type, and rstd saved (f32, one per row) for the
// backward.
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
// per element).
//
// Design: the TPU kernel adds dgamma into one output block that its
// sequential grid revisits; CUDA blocks run in no order, so the sum goes in
// two passes without atomics, as in layer_norm.cu.  Pass 1: `nblk` blocks,
// block b taking rows b, b + nblk, ...; per row one block reduction (the
// mean) and a second read of the row (from L1/L2) to write dx.  Each thread
// owns the same vectors of every row, so it adds its columns' do * xhat
// into the block's f32 accumulator in shared memory with no other thread
// touching them.  The accumulator is laid out [VEC][n / VEC] (value j of
// vector i at j * nv + i), so a warp's 32 threads hit 32 banks.  At the end
// the block writes it as its row of `partial` [nblk, n].  Pass 2
// (`ptt::column_sum_kernel`) adds the nblk rows of each column in a fixed
// order, so dgamma is the same on every run.
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
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ptt::column_sum_kernel<T><<<(n + 255) / 256, 256, 0, s>>>(
      part, static_cast<T*>(dgamma), nblk, n);
  return cudaGetLastError();
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
                        void* partial, int rows, int n, int nblk,
                        cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (use_vectors<T>(n, {x, gamma, dout, dx}))
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
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// partial: f32 scratch of nblk * n floats, 1 <= nblk <= rows.
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
                           n, nblk, s);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = rms_bwd_any<__nv_bfloat16>(x, gamma, rstd, dout, dx, dgamma, partial,
                                   rows, n, nblk, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
