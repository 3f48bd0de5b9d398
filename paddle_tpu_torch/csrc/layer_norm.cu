// Layer norm forward over the last dimension, with saved statistics.
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

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
