// Segmented LoRA SGMV epilogue: s = z + (x_blk @ A[a]) @ B[a] and
// out = act(s), every row block with its own adapter a = aid[block].
//
// Replaces: paddle_tpu/ops/pallas_grouped.py `_lora_fwd_kernel` (:355,
// called from `_lora_call` :374), the multi-LoRA serving epilogue that
// follows each base projection (qkv, out, fc1 with its activation, fc2).
//
// Layout (the TPU kernel's, unchanged).  z [R, N] is the base
// pre-activation x @ W + b; x [R, K] with R = nb * bm, block i owning rows
// [i*bm, (i+1)*bm); A [L, K, r] and B [L, r, N] the packed adapter stacks,
// alpha / r folded into B; aid [nb] int32, where L (any id outside
// [0, L)) marks a null block.  z, x, A, B, out and s share one type (f32
// or bf16); every product and sum is f32, as the TPU kernel casts its
// operands to f32 before both dots.
//
// A null block adds nothing: it writes s = z and out = act(z), so the
// rows of requests without an adapter come out as the base model's.  The
// reference rides an appended zero adapter instead (pallas_grouped.py
// :414-417) and computes x @ 0 for them.
//
// What bounds it on the H100: bytes.  At the serving step (R = 368 rows,
// K = 1024, N = 3072, r = 16, bf16) the low-rank products are 2 R r (K + N)
// = 48 MFLOP, against 2.3 MB of z, out and s, the x rows and the factors of
// the adapters in use.
//
// Design, simple and right first: one block of 256 threads per (row
// block, 64-column tile).  The block first computes its rows' t =
// x_blk @ A[a], the [bm, r] f32 low-rank product, into shared memory:
// 64-deep slices of x and of A[a] are staged as f32 (A[a]'s rows are
// contiguous, so each slice is one coalesced run), and each thread sums
// its entries of t over the slice (when the entries are fewer than the
// threads, several threads split the depth of one entry and their partial
// sums are added in a fixed order).  Every column tile of a row block
// recomputes t; r is tiny, and this keeps the blocks independent.  Then
// it stages the [r, 64] slice of B[a], computes d = t @ B[a] for its
// [bm, 64] outputs on the CUDA cores, adds z in f32 and runs the
// activation through `ptt::apply_act` (the reference's `_act_f32`).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 64;        // output columns of a block
constexpr int kKC = 64;        // depth of a staged x / A slice
constexpr int kMaxPer = 8;     // entries of t a thread may own

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_sgmv_kernel(const T* __restrict__ z, const T* __restrict__ x,
                     const T* __restrict__ a, const T* __restrict__ b,
                     const int* __restrict__ aid, T* __restrict__ out,
                     T* __restrict__ s, int K, int N, int r, int L, int bm,
                     int act) {
  extern __shared__ float smem[];
  const int i = blockIdx.y;
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(i) * bm;
  const int ad = aid[i];

  if (ad < 0 || ad >= L) {  // a null block: s = z, out = act(z)
    for (int e = tid; e < bm * kTN; e += kThreads) {
      const int n = n0 + e % kTN;
      if (n >= N) continue;
      const size_t idx = (row0 + e / kTN) * N + n;
      const float zf = ptt::to_float(z[idx]);
      s[idx] = z[idx];
      out[idx] = ptt::from_float<T>(ptt::apply_act(zf, act));
    }
    return;
  }

  const int ent = bm * r;                    // entries of t
  // depth splits of one entry when the entries are fewer than the threads
  const int P = ent >= kThreads ? 1 : kThreads / ent;
  float* xs = smem;                          // [bm][kKC]
  float* as = xs + bm * kKC;                 // [kKC][r]
  float* part = as + kKC * r;                // [P][ent], then t [bm][r]
  const T* ae = a + static_cast<size_t>(ad) * K * r;
  const T* be = b + static_cast<size_t>(ad) * r * N;

  float acc[kMaxPer];
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) acc[j] = 0.f;
  const int p = tid / (ent < kThreads ? ent : kThreads);  // depth split
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    for (int e = tid; e < bm * kKC; e += kThreads) {
      const int m = e / kKC, k = e % kKC;
      xs[e] = k < kc ? ptt::to_float(x[(row0 + m) * K + k0 + k]) : 0.f;
    }
    for (int e = tid; e < kKC * r; e += kThreads)
      as[e] = e < kc * r ? ptt::to_float(ae[static_cast<size_t>(k0) * r + e])
                         : 0.f;
    __syncthreads();
    if (P > 1) {
      if (p < P) {
        const int e = tid % ent;
        const int m = e / r, j = e % r;
        float v = acc[0];
        for (int k = p; k < kKC; k += P) v = fmaf(xs[m * kKC + k],
                                                  as[k * r + j], v);
        acc[0] = v;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kMaxPer; ++q) {
        const int e = tid + q * kThreads;
        if (e < ent) {
          const int m = e / r, j = e % r;
          float v = acc[q];
          for (int k = 0; k < kKC; ++k) v = fmaf(xs[m * kKC + k],
                                                 as[k * r + j], v);
          acc[q] = v;
        }
      }
    }
    __syncthreads();
  }
  float* t = part;                           // [bm][r] after the reduction
  if (P > 1) {
    if (p < P) part[p * ent + tid % ent] = acc[0];
    __syncthreads();
    float v = 0.f;
    if (tid < ent)
      for (int q = 0; q < P; ++q) v += part[q * ent + tid];  // fixed order
    __syncthreads();
    if (tid < ent) t[tid] = v;
  } else {
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q) {
      const int e = tid + q * kThreads;
      if (e < ent) t[e] = acc[q];
    }
  }
  // stage B[a]'s [r, 64] column slice (zero past N) behind t
  float* bs = t + ent;
  for (int e = tid; e < r * kTN; e += kThreads) {
    const int j = e / kTN, n = n0 + e % kTN;
    bs[e] = n < N ? ptt::to_float(be[static_cast<size_t>(j) * N + n]) : 0.f;
  }
  __syncthreads();

  for (int e = tid; e < bm * kTN; e += kThreads) {
    const int m = e / kTN, c = e % kTN;
    const int n = n0 + c;
    if (n >= N) continue;
    const float* tm = t + m * r;
    float d = 0.f;
    for (int j = 0; j < r; ++j) d = fmaf(tm[j], bs[j * kTN + c], d);
    const size_t idx = (row0 + m) * N + n;
    const float sf = ptt::to_float(z[idx]) + d;
    s[idx] = ptt::from_float<T>(sf);
    out[idx] = ptt::from_float<T>(ptt::apply_act(sf, act));
  }
}

template <typename T>
int launch(const void* z, const void* x, const void* a, const void* b,
           const int* aid, void* out, void* s, int R, int K, int N, int r,
           int L, int bm, int act, cudaStream_t st) {
  const int ent = bm * r;
  if (bm <= 0 || r <= 0 || R % bm || ent > kMaxPer * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = ent >= kThreads ? 1 : kThreads / ent;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(bm) * kKC +
                       static_cast<size_t>(kKC) * r +
                       static_cast<size_t>(P) * ent +
                       static_cast<size_t>(r) * kTN);
  cudaError_t err = cudaFuncSetAttribute(
      lora_sgmv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTN - 1) / kTN, R / bm);
  lora_sgmv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(z), static_cast<const T*>(x),
      static_cast<const T*>(a), static_cast<const T*>(b), aid,
      static_cast<T*>(out), static_cast<T*>(s), K, N, r, L, bm, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_lora_sgmv_fwd(const void* z, const void* x, const void* a,
                                 const void* b, const void* aid, void* out,
                                 void* s, int R, int K, int N, int r, int L,
                                 int bm, int act, int dtype, int device,
                                 void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(aid);
  if (dtype == PTT_DTYPE_F32)
    return launch<float>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act, st);
  if (dtype == PTT_DTYPE_BF16)
    return launch<__nv_bfloat16>(z, x, a, b, ids, out, s, R, K, N, r, L, bm,
                                 act, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
