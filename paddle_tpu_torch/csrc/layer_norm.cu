// Layer norm forward over the last dimension, with saved statistics; the
// fused residual add + layer norm forward; the layer-norm backward.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_ln_fwd_kernel` (:522,
// called at :575), the row-blocked Pallas layer norm that keeps its
// statistics in f32 and saves mu/rstd for the backward.
//
// What bounds it on the H100: bytes.  Each value is read once and written
// once and costs about eight flops, far below the ~295 flops per byte the
// card needs before its arithmetic matters.
//
// Design: one block of 256 threads per row.  Threads stride the row 256
// apart, so neighbouring threads touch neighbouring addresses.  The block
// reduces the sum with warp shuffles, then the squared deviations from
// the mean in a second pass (the TPU kernel's two-pass order, so the
// statistics agree with it), then normalises in f32 and casts to the
// input's type.  The second and third passes re-read the row: at the
// main path's width (2048) a row is 4-8 KB and the re-reads hit L1, so
// device memory still sees one read.  mu and rstd are written in f32,
// one value per row, for the training slice's backward.
#include "common.cuh"

namespace {

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

// ---- residual add + layer norm, forward ---------------------------------
// Replaces: paddle_tpu/ops/pallas_fused.py `_ln_res_fwd_kernel` (:101,
// driven by `_fused_ln_residual_2d_fwd` :126), the post-norm sublayer
// epilogue of BERT and ERNIE: s = x + r added in f32 and stored in x's
// type; out = (s - mean) * rstd * gamma + beta from the f32 sum, cast
// once; mean and rstd saved in f32.  Its backward is the layer-norm
// backward below run on the saved s (pallas_fused.py:160-195).
//
// What bounds it on the H100: bytes.  Four [rows, N] streams (x and r
// read, out and s written) at ~10 flops per element.
//
// Design: layer_norm_fwd_kernel's, one block of 256 threads per row with
// scalar loads, neighbouring threads on neighbouring addresses.  The
// first pass adds x and r in f32, writes s and sums it; the second and
// third passes re-read x and r (from L1: a BERT row is 3-6 KB) and add
// them again, so the statistics and the output come from the f32 sum,
// never from the stored s that a bf16 input rounds.  Device memory sees
// each stream once.
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

template <typename T>
cudaError_t layer_norm_residual_fwd(const void* x, const void* r,
                                    const void* gamma, const void* beta,
                                    void* out, void* s, void* mu, void* rstd,
                                    int rows, int n, float eps,
                                    cudaStream_t stream) {
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
// per element).
//
// Design: the TPU kernel accumulates dgamma/dbeta into one output block
// that its sequential grid revisits; CUDA blocks run in no order, so the
// sum goes in two passes without atomics.  Pass 1: `nblk` blocks of 256
// threads, block b taking rows b, b + nblk, ...  Each row costs two block
// reductions (the two means) and a second read of the row (from L1/L2) to
// write dx.  Thread t owns columns t, t + 256, ... of the block's f32
// dgamma/dbeta accumulators in shared memory (2n floats), so no two
// threads touch one word; at the end the block writes them as its row of
// `partial` [2, nblk, n].  Pass 2 (`column_sum_kernel`) adds the nblk rows
// of each column in a fixed order, so the sums are the same on every run.
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

template <typename T>
cudaError_t layer_norm_bwd(const void* x, const void* gamma, const void* mu,
                           const void* rstd, const void* dout, void* dx,
                           void* dgamma, void* dbeta, void* partial, int rows,
                           int n, int nblk, cudaStream_t s) {
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
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int cblocks = (n + 255) / 256;
  ptt::column_sum_kernel<T><<<cblocks, 256, 0, s>>>(
      part, static_cast<T*>(dgamma), nblk, n);
  ptt::column_sum_kernel<T><<<cblocks, 256, 0, s>>>(
      part + static_cast<size_t>(nblk) * n, static_cast<T*>(dbeta), nblk, n);
  return cudaGetLastError();
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
  const dim3 grid(rows), block(256);
  if (dtype == PTT_DTYPE_F32) {
    layer_norm_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(out),
        static_cast<float*>(mu), static_cast<float*>(rstd), n, eps);
  } else if (dtype == PTT_DTYPE_BF16) {
    layer_norm_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gamma),
        static_cast<const __nv_bfloat16*>(beta),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(mu),
        static_cast<float*>(rstd), n, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
                                       rows, n, eps, st);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = layer_norm_residual_fwd<__nv_bfloat16>(x, r, gamma, beta, out, s,
                                               mu, rstd, rows, n, eps, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// partial: f32 scratch of 2 * nblk * n floats, 1 <= nblk <= rows.
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
                              partial, rows, n, nblk, s);
  } else if (dtype == PTT_DTYPE_BF16) {
    e = layer_norm_bwd<__nv_bfloat16>(x, gamma, mu, rstd, dout, dx, dgamma,
                                      dbeta, partial, rows, n, nblk, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
