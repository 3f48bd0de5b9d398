// Flash attention, forward and backward, over [B, S, H, D].
//
// Replaces: paddle_tpu/ops/pallas_kernels.py
//   ptt_flash_attention_fwd      <- `_attn_fwd_kernel` (:78, driven by
//                                   `_flash_fwd` :222)
//   ptt_flash_attention_bwd_dq   <- `_attn_bwd_dq_kernel` (:128, driven by
//                                   `_flash_bwd` :251)
//   ptt_flash_attention_bwd_dkv  <- `_attn_bwd_dkv_kernel` (:170, ditto)
//
// What they compute, the TPU kernels' masked math exactly: scores
// s = (q . k) * scale in f32; row r (of Sq) sees key c (of Sk) iff
// c < Sk and, when causal, c <= r + (Sk - Sq) (bottom-right alignment);
// the forward keeps an online max m and sum l in f32 and writes
// out = acc / l and lse = m + log(l), or out = 0 and lse = -1e30 for a
// row that sees no key.  The backward takes lse (rows that saw nothing
// set to 1e30 by the caller, so exp(s - lse) = 0 there) and
// delta = rowsum(dout * out) as inputs, recomputes p = exp(s - lse),
// and forms ds = p * (dp - delta) * scale with dp = dout . v; dq sums
// ds . k over key tiles, dk sums ds^T . q and dv sums p^T . dout over
// query tiles.  Every product is f32: bf16 inputs are widened when they
// are staged, and p stays f32 into the P.V, dS.K and dS^T.Q products.
//
// Layout.  q/k/v/dout are read through their (batch, seq, head) strides
// with a contiguous last dim, so the views `qkv.unbind(2)` gives need no
// copy; out, dq, dk and dv are written contiguous [B, S, H, D]; lse and
// delta are f32 [B, H, Sq].
//
// What bounds it on the H100: operations.  At the training drive's shape
// (B=8, S=1024, H=16, D=128, causal) the forward does 4*D flops for each
// of the 67 M visible (row, key) pairs, 34 GFLOP against 67 MB of bf16
// traffic; dq 6*D and dk/dv 8*D flops per pair.  Those bounds assume
// the tensor cores (989 TFLOP/s bf16); this first design runs on the
// CUDA cores in f32 (67 TFLOP/s), which is what keeps p in f32 as the
// TPU kernel does.  Moving the products to wgmma is a later step.
//
// Design, kept simple and right first.  Blocks run in parallel in no
// order, so the TPU grid's sequential axis becomes a loop inside the
// block:
//  * forward and dq: one block of 256 threads per (b*h, q tile) walks
//    the key tiles up to the causal limit (whole tiles past it are
//    skipped).  Q (and dout) are staged once, transposed, as f32; each
//    key tile is staged as f32 in shared memory.  The 256 threads form a
//    16 x 16 grid over the score tile: a thread owns tile/16 of its rows
//    and of its columns (4 x 4 of a 64 x 64 tile) and those rows x D/16
//    columns of the output accumulator, so the running max and sum of a
//    row live in the 16 threads of a half-warp and are reduced with
//    shuffles.  Products read 8- or 16-byte vectors from shared memory;
//    transposed tiles are padded by 4 floats a row.
//  * dk/dv: one block per (b*h, key tile) walks the query tiles from the
//    first one that can see it, and keeps dk and dv in registers: the
//    sums over query tiles happen inside one block, in a fixed order,
//    with no atomics, so they are the same on every run.
// Tiles (`Tiles`): up to head_dim 128 the q and key tiles are 64 rows
// (dk/dv steps through 32 query rows); at 256 f32 staging would need
// ~223 KB (forward), ~360 KB (dq) and ~300 KB (dk/dv) of shared memory,
// past the 227 KB a block may have, so there the q tile is 32 rows, dq's
// key tile 32, and dk/dv owns 32 keys and steps through 16 query rows
// (~180, ~185 and ~150 KB).  head_dim up to 256 (instantiated for 64,
// 128 and 256; a smaller D is zero-padded in shared memory); any Sq and
// Sk, Sq = 1 and Sq > Sk included.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr int kThreads = 256;      // 16 x 16

// Rows of each tile, by padded head width (see the design note).
template <int kD>
struct Tiles {
  static constexpr int fwd_q = kD > 128 ? 32 : 64;   // fwd q rows a block
  static constexpr int fwd_k = 64;                   // fwd key tile
  static constexpr int dq_q = kD > 128 ? 32 : 64;    // dq q rows a block
  static constexpr int dq_k = kD > 128 ? 32 : 64;    // dq key tile
  static constexpr int dkv_k = kD > 128 ? 32 : 64;   // keys a dk/dv block
  static constexpr int dkv_q = kD > 128 ? 16 : 32;   // q rows a dk/dv step
};

// (batch, seq, head) strides of one [B, S, H, D] operand, in elements
struct View {
  long long b, s, h;
};

// Stage `kRows` rows (row0 ...) of one (batch, head)'s [S, D] slice as
// f32, transposed: dst[d * ld + r].  Rows past `rows_total` and columns
// past D are zero.
template <typename T, int kD, int kRows>
__device__ __forceinline__ void stage_t(float* __restrict__ dst, int ld,
                                        const T* __restrict__ src,
                                        long long row_stride, int row0,
                                        int rows_total, int D) {
  for (int e = threadIdx.x; e < kRows * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    const int gr = row0 + r;
    dst[d * ld + r] = (gr < rows_total && d < D)
                          ? ptt::to_float(src[gr * row_stride + d])
                          : 0.f;
  }
}

// The same rows, not transposed: dst[r * ld + d].
template <typename T, int kD, int kRows>
__device__ __forceinline__ void stage_r(float* __restrict__ dst, int ld,
                                        const T* __restrict__ src,
                                        long long row_stride, int row0,
                                        int rows_total, int D) {
  for (int e = threadIdx.x; e < kRows * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    const int gr = row0 + r;
    dst[r * ld + d] = (gr < rows_total && d < D)
                          ? ptt::to_float(src[gr * row_stride + d])
                          : 0.f;
  }
}

// N consecutive floats of shared memory (N-float aligned) in one load.
template <int N>
__device__ __forceinline__ void ldn(float (&a)[N], const float* p);
template <>
__device__ __forceinline__ void ldn<4>(float (&a)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
template <>
__device__ __forceinline__ void ldn<2>(float (&a)[2], const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a[0] = v.x;
  a[1] = v.y;
}
template <>
__device__ __forceinline__ void ldn<1>(float (&a)[1], const float* p) {
  a[0] = *p;
}

// Max / sum over the 16 threads of a half-warp (the threads of one row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a[kR] x b[kC] outer products summed over `kDepth`: aT and bT are
// transposed tiles ([depth][lda], [depth][ldb]); the thread's rows start
// at ra, its columns at cb.
template <int kDepth, int kR, int kC>
__device__ __forceinline__ void dot_tile(float (&s)[kR][kC],
                                         const float* __restrict__ aT,
                                         int lda,
                                         const float* __restrict__ bT,
                                         int ldb, int ra, int cb) {
#pragma unroll 8
  for (int d = 0; d < kDepth; ++d) {
    float a[kR], b[kC];
    ldn<kR>(a, aT + d * lda + ra);
    ldn<kC>(b, bT + d * ldb + cb);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ bool visible(int r, int c, int Sq, int Sk,
                                        int causal, int offset) {
  return r < Sq && c < Sk && (!causal || c <= r + offset);
}

// Key tiles of `kTK` rows a q tile of `kTQ` rows starting at q0 needs: up
// to the causal limit of its last row, and never past Sk.
template <int kTQ, int kTK>
__device__ __forceinline__ int key_tiles(int q0, int Sk, int causal,
                                         int offset) {
  int end = Sk;
  if (causal) end = min(Sk, max(q0 + kTQ + offset, 0));
  return (end + kTK - 1) / kTK;
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk, int D,
                     View qv, View kv, View vv, float scale, int causal) {
  constexpr int kTQ = Tiles<kD>::fwd_q, kTK = Tiles<kD>::fwd_k;
  constexpr int kR = kTQ / 16, kC = kTK / 16;  // score rows, cols a thread
  constexpr int kLdQ = kTQ + 4, kLdK = kTK + 4, kLdV = kD + 4;
  constexpr int kCols = kD / 64;  // float4 column groups a thread owns
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [kD][kLdQ]
  float* kT = qT + kD * kLdQ;                   // [kD][kLdK]
  float* vS = kT + kD * kLdK;                   // [kTK][kLdV]
  float* pT = vS + kTK * kLdV;                  // [kTK][kLdQ]: pT[c][r]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTQ;
  const int offset = Sk - Sq;
  const T* qp = q + b * qv.b + h * qv.h;
  const T* kp = k + b * kv.b + h * kv.h;
  const T* vp = v + b * vv.b + h * vv.h;

  stage_t<T, kD, kTQ>(qT, kLdQ, qp, qv.s, q0, Sq, D);
  float m[kR], l[kR], acc[kR][kCols * 4];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols * 4; ++j) acc[i][j] = 0.f;
  }

  const int ntiles = key_tiles<kTQ, kTK>(q0, Sk, causal, offset);
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * kTK;
    __syncthreads();  // the last tile's readers are done
    stage_t<T, kD, kTK>(kT, kLdK, kp, kv.s, c0, Sk, D);
    stage_r<T, kD, kTK>(vS, kLdV, vp, vv.s, c0, Sk, D);
    __syncthreads();

    float s[kR][kC] = {};
    dot_tile<kD, kR, kC>(s, qT, kLdQ, kT, kLdK, ty * kR, tx * kC);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = q0 + ty * kR + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = c0 + tx * kC + j;
        s[i][j] = visible(r, c, Sq, Sk, causal, offset) ? s[i][j] * scale
                                                        : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        // masked columns give exactly 0: for a row with nothing visible
        // yet, s - m_new would be 0, not -inf
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        psum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols * 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j)
        pT[(tx * kC + j) * kLdQ + ty * kR + i] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTK; ++c) {
      float p[kR];
      ldn<kR>(p, pT + c * kLdQ + ty * kR);
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        float vv4[4];
        ldn<4>(vv4, vS + c * kLdV + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(p[i], vv4[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty * kR + i;
    if (r >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + ((static_cast<size_t>(b) * Sq + r) * H + h) * D;
#pragma unroll
    for (int g = 0; g < kCols; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = g * 64 + tx * 4 + j;
        if (d < D) orow[d] = ptt::from_float<T>(acc[i][g * 4 + j] / ls);
      }
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Sq + r] =
          l[i] == 0.f ? kNegInf : m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Sq, int Sk, int D, View qv, View kv,
                        View vv, View dov, float scale, int causal) {
  constexpr int kTQ = Tiles<kD>::dq_q, kTK = Tiles<kD>::dq_k;
  constexpr int kR = kTQ / 16, kC = kTK / 16;
  constexpr int kLdQ = kTQ + 4, kLdK = kTK + 4, kLdKS = kD + 4;
  constexpr int kCols = kD / 64;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [kD][kLdQ]
  float* doT = qT + kD * kLdQ;                  // [kD][kLdQ]
  float* kT = doT + kD * kLdQ;                  // [kD][kLdK]
  float* vT = kT + kD * kLdK;                   // [kD][kLdK]
  float* kS = vT + kD * kLdK;                   // [kTK][kLdKS]
  float* dsT = kS + kTK * kLdKS;                // [kTK][kLdQ]: dsT[c][r]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kTQ;
  const int offset = Sk - Sq;
  const T* kp = k + b * kv.b + h * kv.h;
  const T* vp = v + b * vv.b + h * vv.h;

  stage_t<T, kD, kTQ>(qT, kLdQ, q + b * qv.b + h * qv.h, qv.s, q0, Sq, D);
  stage_t<T, kD, kTQ>(doT, kLdQ, dout + b * dov.b + h * dov.h, dov.s, q0,
                      Sq, D);
  float row_lse[kR], row_delta[kR], acc[kR][kCols * 4];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty * kR + i;
    const size_t idx = static_cast<size_t>(bh) * Sq + r;
    row_lse[i] = r < Sq ? lse[idx] : 1e30f;
    row_delta[i] = r < Sq ? delta[idx] : 0.f;
#pragma unroll
    for (int j = 0; j < kCols * 4; ++j) acc[i][j] = 0.f;
  }

  const int ntiles = key_tiles<kTQ, kTK>(q0, Sk, causal, offset);
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * kTK;
    __syncthreads();
    stage_t<T, kD, kTK>(kT, kLdK, kp, kv.s, c0, Sk, D);
    stage_t<T, kD, kTK>(vT, kLdK, vp, vv.s, c0, Sk, D);
    stage_r<T, kD, kTK>(kS, kLdKS, kp, kv.s, c0, Sk, D);
    __syncthreads();

    float s[kR][kC] = {}, dp[kR][kC] = {};
    dot_tile<kD, kR, kC>(s, qT, kLdQ, kT, kLdK, ty * kR, tx * kC);
    dot_tile<kD, kR, kC>(dp, doT, kLdQ, vT, kLdK, ty * kR, tx * kC);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int r = q0 + ty * kR + i, c = c0 + tx * kC + j;
        const float p = visible(r, c, Sq, Sk, causal, offset)
                            ? expf(s[i][j] * scale - row_lse[i])
                            : 0.f;
        dsT[(tx * kC + j) * kLdQ + ty * kR + i] =
            p * (dp[i][j] - row_delta[i]) * scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTK; ++c) {
      float ds[kR];
      ldn<kR>(ds, dsT + c * kLdQ + ty * kR);
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        float kk[4];
        ldn<4>(kk, kS + c * kLdKS + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(ds[i], kk[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty * kR + i;
    if (r >= Sq) continue;
    T* row = dq + ((static_cast<size_t>(b) * Sq + r) * H + h) * D;
#pragma unroll
    for (int g = 0; g < kCols; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = g * 64 + tx * 4 + j;
        if (d < D) row[d] = ptt::from_float<T>(acc[i][g * 4 + j]);
      }
  }
}

// ---------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H,
                         int Sq, int Sk, int D, View qv, View kv, View vv,
                         View dov, float scale, int causal) {
  constexpr int kTK = Tiles<kD>::dkv_k, kQS = Tiles<kD>::dkv_q;
  constexpr int kR = kTK / 16, kC = kQS / 16;  // keys, queries a thread
  constexpr int kLdK = kTK + 4, kLdQ = kQS + 4, kLdR = kD + 4;
  constexpr int kCols = kD / 64;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [kD][kLdK]
  float* vT = kT + kD * kLdK;                   // [kD][kLdK]
  float* qT = vT + kD * kLdK;                   // [kD][kLdQ]
  float* doT = qT + kD * kLdQ;                  // [kD][kLdQ]
  float* qS = doT + kD * kLdQ;                  // [kQS][kLdR]
  float* doS = qS + kQS * kLdR;                 // [kQS][kLdR]
  float* pS = doS + kQS * kLdR;                 // [kQS][kLdK]: pS[r][c]
  float* dsS = pS + kQS * kLdK;                 // [kQS][kLdK]
  float* lseS = dsS + kQS * kLdK;               // [kQS]
  float* deltaS = lseS + kQS;                   // [kQS]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kTK;
  const int offset = Sk - Sq;
  const T* qp = q + b * qv.b + h * qv.h;
  const T* dop = dout + b * dov.b + h * dov.h;

  stage_t<T, kD, kTK>(kT, kLdK, k + b * kv.b + h * kv.h, kv.s, k0, Sk, D);
  stage_t<T, kD, kTK>(vT, kLdK, v + b * vv.b + h * vv.h, vv.s, k0, Sk, D);
  float dk_acc[kR][kCols * 4], dv_acc[kR][kCols * 4];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kCols * 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // the first q row that can see this key tile: r >= k0 - offset
  const int first = causal ? max(k0 - offset, 0) / kQS : 0;
  const int nsteps = (Sq + kQS - 1) / kQS;
  for (int t = first; t < nsteps; ++t) {
    const int r0 = t * kQS;
    __syncthreads();
    stage_t<T, kD, kQS>(qT, kLdQ, qp, qv.s, r0, Sq, D);
    stage_t<T, kD, kQS>(doT, kLdQ, dop, dov.s, r0, Sq, D);
    stage_r<T, kD, kQS>(qS, kLdR, qp, qv.s, r0, Sq, D);
    stage_r<T, kD, kQS>(doS, kLdR, dop, dov.s, r0, Sq, D);
    for (int r = threadIdx.x; r < kQS; r += kThreads) {
      const size_t idx = static_cast<size_t>(bh) * Sq + r0 + r;
      lseS[r] = r0 + r < Sq ? lse[idx] : 1e30f;
      deltaS[r] = r0 + r < Sq ? delta[idx] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this block's keys (ty*kR + i), columns
    // the step's queries (tx*kC + j)
    float s[kR][kC] = {}, dp[kR][kC] = {};
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float kk[kR], vv[kR], qq[kC], gg[kC];
      ldn<kR>(kk, kT + d * kLdK + ty * kR);
      ldn<kR>(vv, vT + d * kLdK + ty * kR);
      ldn<kC>(qq, qT + d * kLdQ + tx * kC);
      ldn<kC>(gg, doT + d * kLdQ + tx * kC);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = k0 + ty * kR + i, rl = tx * kC + j;
        const float p = visible(r0 + rl, c, Sq, Sk, causal, offset)
                            ? expf(s[i][j] * scale - lseS[rl])
                            : 0.f;
        pS[rl * kLdK + ty * kR + i] = p;
        dsS[rl * kLdK + ty * kR + i] = p * (dp[i][j] - deltaS[rl]) * scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kQS; ++r) {
      float p[kR], ds[kR];
      ldn<kR>(p, pS + r * kLdK + ty * kR);
      ldn<kR>(ds, dsS + r * kLdK + ty * kR);
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        float gg[4], qq[4];
        ldn<4>(gg, doS + r * kLdR + g * 64 + tx * 4);
        ldn<4>(qq, qS + r * kLdR + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[i][g * 4 + j] = fmaf(p[i], gg[j], dv_acc[i][g * 4 + j]);
            dk_acc[i][g * 4 + j] = fmaf(ds[i], qq[j], dk_acc[i][g * 4 + j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = k0 + ty * kR + i;
    if (c >= Sk) continue;
    const size_t base = ((static_cast<size_t>(b) * Sk + c) * H + h) * D;
#pragma unroll
    for (int g = 0; g < kCols; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = g * 64 + tx * 4 + j;
        if (d < D) {
          dk[base + d] = ptt::from_float<T>(dk_acc[i][g * 4 + j]);
          dv[base + d] = ptt::from_float<T>(dv_acc[i][g * 4 + j]);
        }
      }
  }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------
template <int kD>
constexpr size_t fwd_smem() {
  constexpr int q = Tiles<kD>::fwd_q, k = Tiles<kD>::fwd_k;
  return sizeof(float) *
         (kD * (q + 4) + kD * (k + 4) + k * (kD + 4) + k * (q + 4));
}
template <int kD>
constexpr size_t dq_smem() {
  constexpr int q = Tiles<kD>::dq_q, k = Tiles<kD>::dq_k;
  return sizeof(float) * (2 * kD * (q + 4) + 2 * kD * (k + 4) +
                          k * (kD + 4) + k * (q + 4));
}
template <int kD>
constexpr size_t dkv_smem() {
  constexpr int k = Tiles<kD>::dkv_k, q = Tiles<kD>::dkv_q;
  return sizeof(float) * (2 * kD * (k + 4) + 2 * kD * (q + 4) +
                          2 * q * (kD + 4) + 2 * q * (k + 4) + 2 * q);
}
static_assert(fwd_smem<256>() <= 227 * 1024 && dq_smem<256>() <= 227 * 1024 &&
                  dkv_smem<256>() <= 227 * 1024,
              "a D=256 flash kernel needs more shared memory than a block "
              "may have");

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

View view(const long long* strides, int i) {
  return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <typename T, int kD>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse,
        int B, int H, int Sq, int Sk, int D, const long long* st,
        float scale, int causal, cudaStream_t s) {
  constexpr int kTQ = Tiles<kD>::fwd_q;
  const size_t smem = fwd_smem<kD>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, kD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTQ - 1) / kTQ, B * H);
  flash_fwd_kernel<T, kD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Sq, Sk, D,
      view(st, 0), view(st, 1), view(st, 2), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Sq, int Sk, int D, const long long* st, float scale,
           int causal, cudaStream_t s) {
  constexpr int kTQ = Tiles<kD>::dq_q;
  const size_t smem = dq_smem<kD>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, kD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTQ - 1) / kTQ, B * H);
  flash_bwd_dq_kernel<T, kD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Sq, Sk, D, view(st, 0), view(st, 1),
      view(st, 2), view(st, 3), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int B,
            int H, int Sq, int Sk, int D, const long long* st, float scale,
            int causal, cudaStream_t s) {
  constexpr int kTK = Tiles<kD>::dkv_k;
  const size_t smem = dkv_smem<kD>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, kD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + kTK - 1) / kTK, B * H);
  flash_bwd_dkv_kernel<T, kD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, D, view(st, 0),
      view(st, 1), view(st, 2), view(st, 3), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Pick the element type and the padded head width (64, 128 or 256).
#define PTT_FLASH_WIDTH(T, FN, ...)                                       \
  (D <= 64 ? FN<T, 64>(__VA_ARGS__)                                       \
           : D <= 128 ? FN<T, 128>(__VA_ARGS__) : FN<T, 256>(__VA_ARGS__))
#define PTT_FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                      \
    if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);   \
    if (dtype == PTT_DTYPE_F32)                                             \
      return PTT_FLASH_WIDTH(float, FN, __VA_ARGS__);                       \
    if (dtype == PTT_DTYPE_BF16)                                            \
      return PTT_FLASH_WIDTH(__nv_bfloat16, FN, __VA_ARGS__);               \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  } while (0)

}  // namespace

// strides: (batch, seq, head) of q, k, v in elements (9 values)
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int H, int Sq, int Sk, int D,
                                       const long long* strides, float scale,
                                       int causal, int dtype, int device,
                                       void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  PTT_FLASH_DISPATCH(fwd, q, k, v, out, l, B, H, Sq, Sk, D, strides, scale,
                     causal, s);
}

// strides: (batch, seq, head) of q, k, v, dout in elements (12 values)
extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Sq,
    int Sk, int D, const long long* strides, float scale, int causal,
    int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  PTT_FLASH_DISPATCH(bwd_dq, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D,
                     strides, scale, causal, s);
}

extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, const long long* strides, float scale,
    int causal, int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  PTT_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D,
                     strides, scale, causal, s);
}
