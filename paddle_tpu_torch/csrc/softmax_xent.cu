// Softmax cross-entropy from logits and integer labels, forward and
// backward.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_xent_fwd_kernel` (:759,
// called at :829 by `_fused_xent_2d_fwd`) and `_xent_bwd_kernel` (:802,
// called at :861 by `_fused_xent_2d_bwd`), the kernels behind
// `fused_softmax_cross_entropy` (:880).
//
//   forward:  lse = log(sum_c exp(x_c)) in f32; loss = lse - x[label] for
//             label >= 0, 0 for label < 0 (ignored rows still write lse).
//             A label >= V picks nothing, so its loss is lse, as in the
//             reference for labels past its padded vocab (the reference
//             pads V to its vocab block with -1e30 and would pick that
//             padding for a label in between).
//   backward: dx_c = (exp(x_c - lse) - [c == label]) * g * [label >= 0],
//             written in the logits' type; g is one f32 value per row.
//
// x is [rows, V] (f32 or bf16), labels are int64 [rows] (torch's index
// type, read as is: no conversion pass), loss/lse/g are f32 [rows].
//
// What bounds it on the H100: bytes.  The forward reads x once (~4 flops
// and one exp per value); the backward reads x and writes dx.
//
// Design: the TPU kernel walks vocab blocks on a sequential grid axis and
// carries the running max / sum-exp / picked logit in VMEM scratch.  Here
// one block of 256 threads owns a row.  Forward: each thread makes one
// online max/sum-exp pass over its strided columns (neighbouring threads
// on neighbouring addresses), the block merges the 256 (max, sum) pairs
// with warp shuffles, and thread 0 reads the picked logit by index.  The
// running max starts at the reference's -1e30, not -inf, so merging two
// empty pairs gives 0 and never NaN.  Backward: one block per row, each
// thread writing its strided columns.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(256)
    xent_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse_out,
                    int V) {
  __shared__ float red_m[32], red_s[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * V;
  float m = kNegInf, s = 0.f;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const float v = ptt::to_float(xr[c]);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    m = lane < nwarps ? red_m[lane] : kNegInf;
    s = lane < nwarps ? red_s[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float lse = m + logf(s);
      const int64_t lbl = labels[row];
      const float picked =
          (lbl >= 0 && lbl < V) ? ptt::to_float(xr[lbl]) : 0.f;
      loss[row] = lbl >= 0 ? lse - picked : 0.f;
      lse_out[row] = lse;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    xent_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    T* __restrict__ dx, int V) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;
  const int64_t lbl = labels[row];
  const float l = lse[row];
  const float scale = lbl >= 0 ? g[row] : 0.f;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const float p = expf(ptt::to_float(xr[c]) - l);
    dr[c] = ptt::from_float<T>((c == lbl ? p - 1.f : p) * scale);
  }
}

}  // namespace

extern "C" int ptt_softmax_xent_fwd(const void* x, const void* labels,
                                    void* loss, void* lse, int rows, int V,
                                    int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lbl = static_cast<const int64_t*>(labels);
  if (dtype == PTT_DTYPE_F32) {
    xent_fwd_kernel<float><<<rows, 256, 0, s>>>(
        static_cast<const float*>(x), lbl, static_cast<float*>(loss),
        static_cast<float*>(lse), V);
  } else if (dtype == PTT_DTYPE_BF16) {
    xent_fwd_kernel<__nv_bfloat16><<<rows, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lbl, static_cast<float*>(loss),
        static_cast<float*>(lse), V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_softmax_xent_bwd(const void* x, const void* labels,
                                    const void* lse, const void* g, void* dx,
                                    int rows, int V, int dtype, int device,
                                    void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lbl = static_cast<const int64_t*>(labels);
  if (dtype == PTT_DTYPE_F32) {
    xent_bwd_kernel<float><<<rows, 256, 0, s>>>(
        static_cast<const float*>(x), lbl, static_cast<const float*>(lse),
        static_cast<const float*>(g), static_cast<float*>(dx), V);
  } else if (dtype == PTT_DTYPE_BF16) {
    xent_bwd_kernel<__nv_bfloat16><<<rows, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lbl,
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(dx), V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
