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
// query tiles.
//
// Layout.  q/k/v/dout are read through their (batch, seq, head) strides
// with a contiguous last dim, so the views `qkv.unbind(2)` gives need no
// copy; out, dq, dk and dv are written contiguous [B, S, H, D]; lse and
// delta are f32 [B, H, Sq].  head_dim up to 256 (instantiated for 64, 128
// and 256; a smaller D is zero-padded in shared memory); any Sq and Sk,
// Sq = 1 and Sq > Sk included.
//
// What bounds them on the H100.  At the training drive's shape (B=8,
// S=1024, H=16, D=128, causal) the forward does 4*D flops for each of the
// 67 M visible (row, key) pairs, 34 GFLOP against 67 MB of bf16 traffic:
// 0.035 ms on the tensor cores (989 TFLOP/s bf16) against 0.040 ms of
// bytes, so bytes by a little; dq does 6*D and dk/dv 8*D flops a pair, and
// the operations bound them.  In f32 (67 TFLOP/s on the CUDA cores) the
// operations bound all three, at 14x those times.
//
// Blocks run in parallel in no order, so the TPU grid's sequential axis
// becomes a loop inside the block: forward and dq blocks own a q tile and
// walk the key tiles up to the causal limit (whole tiles past it are
// skipped); a dk/dv block owns a key tile and walks the query tiles from
// the first one that can see it, keeping dk and dv in registers.  Every
// sum over tiles happens inside one block in a fixed order, with no
// atomics, so dq, dk and dv are the same bits on every run; that is why
// dq and dk/dv stay two kernels, each recomputing S and dP.
//
// bf16: the tensor cores (`tc::`, the kernels `*_mma`).  Every product
// is a warp's `mma.sync.m16n8k16` with bf16 operands and f32 sums
// (`mma.cuh`).  A warp owns 16 query rows (forward, dq) or 16 keys
// (dk/dv): the forward computes S = Q.K^T, then O += P.V; dq S and
// dP = dO.V^T, then dQ += dS.K; dk/dv S^T = K.Q^T and dP^T = V.dO^T with
// keys as rows, then dV += P^T.dO and dK += dS^T.Q.  The accumulators of
// two neighbouring n8 tiles are the A operand of the next k16 product, so
// P and dS go from the first product into the second in registers,
// rounded to bf16 there (as aten's flash kernel does; the TPU kernel and
// the plain version keep them f32: one bf16 rounding, 2^-9 relative, per
// term of the second product).  The online softmax's m, l and rescaling
// stay f32, a row's max and sum reduced over the 4 lanes of a quad.
// Tiles are staged as bf16, never widened: 16-byte `cp.async` copies
// (zero-filled past Sq, Sk and D through the source size) into rows
// whose 16-byte chunks are XOR-swizzled, so that every `ldmatrix` (.trans
// for the operands that are B along the sequence: V in the forward, K in
// dq, dO and Q in dk/dv) is free of bank conflicts.  The walked tiles are
// double-buffered: the next one's copy flies during this one's products.
// A head width off a multiple of 8, or an operand whose base or strides
// are off 16 bytes (heads of 129-255 padded to 256), stages element by
// element into the same layout (the `kVec` = false instantiations), in
// the same kernels.  Tiles (`tc::Tiles`): 64 q rows (4 warps) a forward
// or dq block and key tiles of 64 (32 at D = 256, where a warp's f32
// output accumulator is 128 registers a thread); dk/dv blocks of 64 keys
// stepping through 64 q rows (32 at D = 256), and at D = 256 two warps
// to each 16 keys, each summing one half of D.  Forward and dq launch the
// heaviest (last) q tiles first, so a causal grid's tail is short.  Only
// a warp's tiles that cross the causal diagonal or the Sq / Sk edge test
// each (row, key) pair for visibility: the softmax's scalar work, more
// than the products, bounds these kernels.
//
// f32: the CUDA cores (the kernels without `_mma`, the first design,
// kept for the parity runs).  One block of 256 threads per (b*h, tile):
// Q (and dout) staged once, transposed, as f32, each key tile as f32; the
// 256 threads form a 16 x 16 grid over the score tile, a thread owning
// tile/16 of its rows and columns and those rows x D/16 columns of the
// output accumulator, a row's max and sum reduced over a half-warp with
// shuffles; p stays f32 into every second product, as the TPU kernel
// keeps it.  Tiles (`Tiles`): up to head_dim 128 the q and key tiles are
// 64 rows (dk/dv steps through 32 query rows); at 256 f32 staging would
// need ~223 KB (forward), ~360 KB (dq) and ~300 KB (dk/dv) of shared
// memory, past the 227 KB a block may have, so there the q tile is 32
// rows, dq's key tile 32, and dk/dv owns 32 keys and steps through 16
// query rows (~180, ~185 and ~150 KB).
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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
// bf16: the same three kernels on the tensor cores
// ---------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using namespace ptt::mma;

// Rows of each tile, by padded head width.  A warp owns 16 query rows
// (forward, dq) or 16 keys (dk/dv); at D = 256 two warps share each 16
// keys of dk/dv, each accumulating one half of D (`dkv_split`), so that
// dk and dv (2 x 16 x 128 f32) fit a thread's registers.
template <int kD>
struct Tiles {
  static constexpr int fwd_q = 64;                  // 4 warps x 16 rows
  static constexpr int fwd_k = kD > 128 ? 32 : 64;  // key tile
  static constexpr int dq_q = 64;
  static constexpr int dq_k = kD > 128 ? 32 : 64;
  static constexpr int dkv_k = 64;                  // 4 key groups x 16
  static constexpr int dkv_q = kD > 128 ? 32 : 64;  // q rows a step
  static constexpr int dkv_split = kD > 128 ? 2 : 1;
  // a warp (32 threads) to each 16 rows, or 16 keys and a part of D
  static constexpr int fwd_threads = 2 * fwd_q;
  static constexpr int dq_threads = 2 * dq_q;
  static constexpr int dkv_threads = 2 * dkv_k * dkv_split;
};

// Stage rows row0..row0+kRows-1 (of rows_total) of one (batch, head)'s
// [S, D] slice into a swizzled [kRows][kD] tile, zero past rows_total and
// D.  kVec: one 16-byte cp.async a chunk (D a multiple of 8, the base
// and the strides 16-byte aligned); else element by element, stored
// synchronously into the same layout.
template <int kD, int kRows, int kThreads, bool kVec>
__device__ __forceinline__ void stage(bf16* __restrict__ tile,
                                      const bf16* __restrict__ src,
                                      long long row_stride, int row0,
                                      int rows_total, int D) {
  constexpr int kChunks = kD / 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int gr = row0 + r;
    bf16* dst = tile + swz<kD>(r, c);
    const bf16* s = src + static_cast<long long>(gr) * row_stride + c * 8;
    if constexpr (kVec) {
      const bool in = gr < rows_total && c * 8 < D;
      cp_async_16(dst, in ? s : src, in ? 16 : 0);
    } else {
      alignas(16) bf16 vals[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        vals[j] = (gr < rows_total && c * 8 + j < D) ? s[j]
                                                     : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
    }
  }
}

// kRows f32 row statistics (lse, delta) from src[row0..], zero past
// rows_total, by threads kFirst..kFirst+kRows-1
template <int kRows, int kFirst>
__device__ __forceinline__ void stage_stats(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int row0, int rows_total) {
  const int r = static_cast<int>(threadIdx.x) - kFirst;
  if (r >= 0 && r < kRows) {
    const bool in = row0 + r < rows_total;
    cp_async_4(dst + r, in ? src + row0 + r : src, in ? 4 : 0);
  }
}

// max / sum over the 4 lanes of a quad (the lanes holding one row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store columns d, d + 1 of one output row (contiguous, D values).
__device__ __forceinline__ void store_pair(bf16* row, int d, int D, float x0,
                                           float x1) {
  if ((D & 1) == 0) {
    if (d < D)
      *reinterpret_cast<__nv_bfloat162*>(row + d) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (d < D) row[d] = __float2bfloat16(x0);
    if (d + 1 < D) row[d + 1] = __float2bfloat16(x1);
  }
}

// s (+)= A . B^T over depth kD for one warp: A rows a0.. of tile `a`, B
// rows (the product's columns) 0..kCols-1 of tile `b`, both [row][depth].
template <int kD, int kCols>
__device__ __forceinline__ void dot_rows(float (&s)[kCols / 8][4],
                                         const bf16* a, int a0, const bf16* b,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a + frag_a<kD>(a0, kk, lane));
#pragma unroll
    for (int nj = 0; nj < kCols / 16; ++nj) {
      uint32_t fb[4];
      ldmatrix_x4(fb, b + frag_b<kD>(nj * 16, kk, lane));
      mma_bf16(s[2 * nj], fa, fb[0], fb[1]);
      mma_bf16(s[2 * nj + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[kOut / 8] += P . B over the kRows rows of tile `b` ([row][kD],
// read transposed), for output columns col0..col0+kOut-1: P is the warp's
// 16 x kRows C fragments, rounded to bf16 into A fragments in registers.
template <int kD, int kRows, int kOut>
__device__ __forceinline__ void dot_p(float (&acc)[kOut / 8][4],
                                      const float (&p)[kRows / 8][4],
                                      const bf16* b, int col0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    uint32_t fa[4];
    c_to_a(fa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dj = 0; dj < kOut / 16; ++dj) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, b + frag_bt<kD>(kk * 16, col0 / 16 + dj, lane));
      mma_bf16(acc[2 * dj], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * dj + 1], fa, fb[2], fb[3]);
    }
  }
}

template <int kD, bool kVec>
__global__ void __launch_bounds__(Tiles<kD>::fwd_threads)
    flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int H, int Sq, int Sk, int D,
                         View qv, View kv, View vv, float scale, int causal) {
  constexpr int kTQ = Tiles<kD>::fwd_q, kTK = Tiles<kD>::fwd_k;
  constexpr int kThreads = Tiles<kD>::fwd_threads;
  extern __shared__ uint4 smem_tc[];
  bf16* qS = reinterpret_cast<bf16*>(smem_tc);  // [kTQ][kD]
  bf16* kS = qS + kTQ * kD;                     // 2 x [kTK][kD]
  bf16* vS = kS + 2 * kTK * kD;                 // 2 x [kTK][kD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;  // heaviest first
  const int w0 = q0 + warp * 16;                      // the warp's rows
  const int offset = Sk - Sq;
  const bf16* kp = k + b * kv.b + h * kv.h;
  const bf16* vp = v + b * vv.b + h * vv.h;

  const int ntiles = key_tiles<kTQ, kTK>(q0, Sk, causal, offset);
  stage<kD, kTQ, kThreads, kVec>(qS, q + b * qv.b + h * qv.h, qv.s, q0,
                                    Sq, D);
  if (ntiles > 0) {
    stage<kD, kTK, kThreads, kVec>(kS, kp, kv.s, 0, Sk, D);
    stage<kD, kTK, kThreads, kVec>(vS, vp, vv.s, 0, Sk, D);
  }
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // keys past this one no row of the warp sees
  const int warp_end = causal ? min(Sk, w0 + 16 + offset) : Sk;

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * kTK;
    if (t + 1 < ntiles) {  // the next tile's copy flies during this one
      const int nb = (t + 1) & 1;
      stage<kD, kTK, kThreads, kVec>(kS + nb * kTK * kD, kp, kv.s,
                                        c0 + kTK, Sk, D);
      stage<kD, kTK, kThreads, kVec>(vS + nb * kTK * kD, vp, vv.s,
                                        c0 + kTK, Sk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = kS + (t & 1) * kTK * kD;
    const bf16* vt = vS + (t & 1) * kTK * kD;
    if (w0 < Sq && c0 < warp_end) {
      float s[kTK / 8][4] = {};
      dot_rows<kD, kTK>(s, qS, warp * 16, kt, lane);
      const bool full = w0 + 16 <= Sq && c0 + kTK <= Sk &&
                        (!causal || c0 + kTK - 1 <= w0 + offset);
      float mx[2] = {kNegInf, kNegInf};
      // masked: std::true_type to test each (row, key) pair
      auto scale_mask = [&](auto masked) {
        constexpr bool kMask = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = w0 + g + (e >> 1) * 8;
            const int c = c0 + 8 * j + 2 * tq + (e & 1);
            s[j][e] = (!kMask || visible(r, c, Sq, Sk, causal, offset))
                          ? s[j][e] * scale
                          : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      };
      if (full)  // the warp sees the whole tile: no mask to test
        scale_mask(std::false_type{});
      else
        scale_mask(std::true_type{});
      float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) m_new[i] = fmaxf(m[i], quad_max(mx[i]));
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked columns give exactly 0: for a row with nothing visible
          // yet, s - m_new would be 0, not -inf
          const float p =
              s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m_new[e >> 1]);
          s[j][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float alpha = expf(m[i] - m_new[i]);
        l[i] = alpha * l[i] + quad_sum(psum[i]);
        m[i] = m_new[i];
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          acc[j][2 * i] *= alpha;
          acc[j][2 * i + 1] *= alpha;
        }
      }
      dot_p<kD, kTK, kD>(acc, s, vt, 0, lane);
    }
    __syncthreads();  // this tile's readers are done before it is refilled
  }
  cp_async_wait<0>();  // nothing in flight at exit (ntiles may be 0)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    bf16* orow = out + ((static_cast<size_t>(b) * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      store_pair(orow, 8 * j + 2 * tq, D, acc[j][2 * i] / ls,
                 acc[j][2 * i + 1] / ls);
    if (tq == 0)
      lse[static_cast<size_t>(bh) * Sq + r] =
          l[i] == 0.f ? kNegInf : m[i] + logf(ls);
  }
}

template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel_mma(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int H, int Sq, int Sk,
                            int D, View qv, View kv, View vv, View dov,
                            float scale, int causal) {
  constexpr int kTQ = Tiles<kD>::dq_q, kTK = Tiles<kD>::dq_k;
  constexpr int kThreads = Tiles<kD>::dq_threads;
  extern __shared__ uint4 smem_tc[];
  bf16* qS = reinterpret_cast<bf16*>(smem_tc);  // [kTQ][kD]
  bf16* doS = qS + kTQ * kD;                    // [kTQ][kD]
  bf16* kS = doS + kTQ * kD;                    // 2 x [kTK][kD]
  bf16* vS = kS + 2 * kTK * kD;                 // 2 x [kTK][kD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;  // heaviest first
  const int w0 = q0 + warp * 16;
  const int offset = Sk - Sq;
  const bf16* kp = k + b * kv.b + h * kv.h;
  const bf16* vp = v + b * vv.b + h * vv.h;

  const int ntiles = key_tiles<kTQ, kTK>(q0, Sk, causal, offset);
  stage<kD, kTQ, kThreads, kVec>(qS, q + b * qv.b + h * qv.h, qv.s, q0,
                                    Sq, D);
  stage<kD, kTQ, kThreads, kVec>(doS, dout + b * dov.b + h * dov.h, dov.s,
                                    q0, Sq, D);
  if (ntiles > 0) {
    stage<kD, kTK, kThreads, kVec>(kS, kp, kv.s, 0, Sk, D);
    stage<kD, kTK, kThreads, kVec>(vS, vp, vv.s, 0, Sk, D);
  }
  cp_async_commit();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    const size_t idx = static_cast<size_t>(bh) * Sq + r;
    row_lse[i] = r < Sq ? lse[idx] : 1e30f;
    row_delta[i] = r < Sq ? delta[idx] : 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int warp_end = causal ? min(Sk, w0 + 16 + offset) : Sk;

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * kTK;
    if (t + 1 < ntiles) {
      const int nb = (t + 1) & 1;
      stage<kD, kTK, kThreads, kVec>(kS + nb * kTK * kD, kp, kv.s,
                                        c0 + kTK, Sk, D);
      stage<kD, kTK, kThreads, kVec>(vS + nb * kTK * kD, vp, vv.s,
                                        c0 + kTK, Sk, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = kS + (t & 1) * kTK * kD;
    const bf16* vt = vS + (t & 1) * kTK * kD;
    if (w0 < Sq && c0 < warp_end) {
      float s[kTK / 8][4] = {}, dp[kTK / 8][4] = {};
      dot_rows<kD, kTK>(s, qS, warp * 16, kt, lane);
      dot_rows<kD, kTK>(dp, doS, warp * 16, vt, lane);
      const bool full = w0 + 16 <= Sq && c0 + kTK <= Sk &&
                        (!causal || c0 + kTK - 1 <= w0 + offset);
      auto ds_of = [&](auto masked) {
        constexpr bool kMask = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int r = w0 + g + 8 * i, c = c0 + 8 * j + 2 * tq + (e & 1);
            const float p = (!kMask || visible(r, c, Sq, Sk, causal, offset))
                                ? expf(s[j][e] * scale - row_lse[i])
                                : 0.f;
            s[j][e] = p * (dp[j][e] - row_delta[i]) * scale;  // ds
          }
      };
      if (full)
        ds_of(std::false_type{});
      else
        ds_of(std::true_type{});
      dot_p<kD, kTK, kD>(acc, s, kt, 0, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= Sq) continue;
    bf16* row = dq + ((static_cast<size_t>(b) * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      store_pair(row, 8 * j + 2 * tq, D, acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <int kD, bool kVec>
__global__ void __launch_bounds__(Tiles<kD>::dkv_threads)
    flash_bwd_dkv_kernel_mma(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int H, int Sq, int Sk, int D, View qv, View kv,
                             View vv, View dov, float scale, int causal) {
  constexpr int kTK = Tiles<kD>::dkv_k, kQS = Tiles<kD>::dkv_q;
  constexpr int kThreads = Tiles<kD>::dkv_threads;
  constexpr int kDW = kD / Tiles<kD>::dkv_split;  // columns a warp sums
  extern __shared__ uint4 smem_tc[];
  bf16* kS = reinterpret_cast<bf16*>(smem_tc);  // [kTK][kD]
  bf16* vS = kS + kTK * kD;                     // [kTK][kD]
  bf16* qS = vS + kTK * kD;                     // 2 x [kQS][kD]
  bf16* doS = qS + 2 * kQS * kD;                // 2 x [kQS][kD]
  float* lseS = reinterpret_cast<float*>(doS + 2 * kQS * kD);  // 2 x [kQS]
  float* deltaS = lseS + 2 * kQS;                              // 2 x [kQS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp % (kTK / 16), col0 = (warp / (kTK / 16)) * kDW;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTK;  // the first key tiles are the heaviest
  const int kw0 = k0 + kg * 16;     // the warp's keys
  const int offset = Sk - Sq;
  const bf16* qp = q + b * qv.b + h * qv.h;
  const bf16* dop = dout + b * dov.b + h * dov.h;
  const float* lsep = lse + static_cast<size_t>(bh) * Sq;
  const float* deltap = delta + static_cast<size_t>(bh) * Sq;

  // the first q row that can see this key tile: r >= k0 - offset
  const int first = causal ? max(k0 - offset, 0) / kQS : 0;
  const int nsteps = (Sq + kQS - 1) / kQS;
  stage<kD, kTK, kThreads, kVec>(kS, k + b * kv.b + h * kv.h, kv.s, k0, Sk,
                                 D);
  stage<kD, kTK, kThreads, kVec>(vS, v + b * vv.b + h * vv.h, vv.s, k0, Sk,
                                 D);
  if (first < nsteps) {
    const int r0 = first * kQS;
    stage<kD, kQS, kThreads, kVec>(qS, qp, qv.s, r0, Sq, D);
    stage<kD, kQS, kThreads, kVec>(doS, dop, dov.s, r0, Sq, D);
    stage_stats<kQS, 0>(lseS, lsep, r0, Sq);
    stage_stats<kQS, kQS>(deltaS, deltap, r0, Sq);
  }
  cp_async_commit();

  float dk_acc[kDW / 8][4], dv_acc[kDW / 8][4];
#pragma unroll
  for (int j = 0; j < kDW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int t = first; t < nsteps; ++t) {
    const int r0 = t * kQS, buf = (t - first) & 1;
    if (t + 1 < nsteps) {
      const int nb = buf ^ 1;
      stage<kD, kQS, kThreads, kVec>(qS + nb * kQS * kD, qp, qv.s, r0 + kQS,
                                     Sq, D);
      stage<kD, kQS, kThreads, kVec>(doS + nb * kQS * kD, dop, dov.s,
                                     r0 + kQS, Sq, D);
      stage_stats<kQS, 0>(lseS + nb * kQS, lsep, r0 + kQS, Sq);
      stage_stats<kQS, kQS>(deltaS + nb * kQS, deltap, r0 + kQS, Sq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qS + buf * kQS * kD;
    const bf16* dot = doS + buf * kQS * kD;
    const float* lt = lseS + buf * kQS;
    const float* dlt = deltaS + buf * kQS;
    if (kw0 < Sk && (!causal || kw0 <= r0 + kQS - 1 + offset)) {
      // transposed scores: rows are the warp's keys, columns the step's
      // queries
      float st[kQS / 8][4] = {}, dpt[kQS / 8][4] = {};
      dot_rows<kD, kQS>(st, kS, kg * 16, qt, lane);
      dot_rows<kD, kQS>(dpt, vS, kg * 16, dot, lane);
      const bool full = kw0 + 16 <= Sk && r0 + kQS <= Sq &&
                        (!causal || kw0 + 15 <= r0 + offset);
      auto p_ds_of = [&](auto masked) {
        constexpr bool kMask = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < kQS / 8; ++j) {
          const int rl = 8 * j + 2 * tq;
          const float2 ls = *reinterpret_cast<const float2*>(lt + rl);
          const float2 dl = *reinterpret_cast<const float2*>(dlt + rl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = kw0 + g + 8 * (e >> 1), r = r0 + rl + (e & 1);
            const float p =
                (!kMask || visible(r, c, Sq, Sk, causal, offset))
                    ? expf(st[j][e] * scale - ((e & 1) ? ls.y : ls.x))
                    : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dl.y : dl.x)) * scale;
          }
        }
      };
      if (full)
        p_ds_of(std::false_type{});
      else
        p_ds_of(std::true_type{});
      dot_p<kD, kQS, kDW>(dv_acc, st, dot, col0, lane);
      dot_p<kD, kQS, kDW>(dk_acc, dpt, qt, col0, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kw0 + g + 8 * i;
    if (c >= Sk) continue;
    const size_t base = ((static_cast<size_t>(b) * Sk + c) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kDW / 8; ++j) {
      const int d = col0 + 8 * j + 2 * tq;
      store_pair(dk + base, d, D, dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      store_pair(dv + base, d, D, dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

template <int kD>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * kD * (Tiles<kD>::fwd_q + 4 * Tiles<kD>::fwd_k);
}
template <int kD>
constexpr size_t dq_smem() {
  return sizeof(bf16) * kD * (2 * Tiles<kD>::dq_q + 4 * Tiles<kD>::dq_k);
}
template <int kD>
constexpr size_t dkv_smem() {
  return sizeof(bf16) * kD * (2 * Tiles<kD>::dkv_k + 4 * Tiles<kD>::dkv_q) +
         sizeof(float) * 4 * Tiles<kD>::dkv_q;
}
static_assert(fwd_smem<256>() <= 227 * 1024 && dq_smem<256>() <= 227 * 1024 &&
                  dkv_smem<256>() <= 227 * 1024,
              "a D=256 bf16 flash kernel needs more shared memory than a "
              "block may have");

}  // namespace tc

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

// bf16 launches: the tensor-core kernels, with 16-byte cp.async staging
// when D is a multiple of 8 and every operand's base and strides are
// 16-byte aligned, else the element-wise staging into the same layout.
bool vec_ok(int D, const long long* st,
            std::initializer_list<const void*> operands) {
  if (D % 8 != 0) return false;
  int i = 0;
  for (const void* p : operands) {
    const View w = view(st, i++);
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || w.b % 8 != 0 ||
        w.s % 8 != 0 || w.h % 8 != 0)
      return false;
  }
  return true;
}

template <int kD, bool kVec>
int fwd_tc(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int Sq, int Sk, int D,
           const long long* st, float scale, int causal, cudaStream_t s) {
  constexpr int kTQ = tc::Tiles<kD>::fwd_q;
  const auto kernel = tc::flash_fwd_kernel_mma<kD, kVec>;
  const size_t smem = tc::fwd_smem<kD>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kTQ - 1) / kTQ);
  kernel<<<grid, tc::Tiles<kD>::fwd_threads, smem, s>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), lse, H,
      Sq, Sk, D, view(st, 0), view(st, 1), view(st, 2), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kVec>
int bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Sq, int Sk, int D, const long long* st, float scale,
              int causal, cudaStream_t s) {
  constexpr int kTQ = tc::Tiles<kD>::dq_q;
  const auto kernel = tc::flash_bwd_dq_kernel_mma<kD, kVec>;
  const size_t smem = tc::dq_smem<kD>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kTQ - 1) / kTQ);
  kernel<<<grid, tc::Tiles<kD>::dq_threads, smem, s>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      lse, delta, static_cast<tc::bf16*>(dq), H, Sq, Sk, D, view(st, 0),
      view(st, 1), view(st, 2), view(st, 3), scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kVec>
int bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Sq, int Sk, int D, const long long* st,
               float scale, int causal, cudaStream_t s) {
  constexpr int kTK = tc::Tiles<kD>::dkv_k;
  const auto kernel = tc::flash_bwd_dkv_kernel_mma<kD, kVec>;
  const size_t smem = tc::dkv_smem<kD>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sk + kTK - 1) / kTK);
  kernel<<<grid, tc::Tiles<kD>::dkv_threads, smem, s>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      lse, delta, static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), H,
      Sq, Sk, D, view(st, 0), view(st, 1), view(st, 2), view(st, 3), scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// Pick the element type and the padded head width (64, 128 or 256); bf16
// takes the tensor-core kernels (`VEC` says whether they may stage with
// 16-byte copies), f16 the f32 CUDA-core kernels on f16 loads and stores
// (scores, probabilities and dS stay f32 in shared memory).
#define PTT_FLASH_WIDTH(T, FN, ...)                                       \
  (D <= 64 ? FN<T, 64>(__VA_ARGS__)                                       \
           : D <= 128 ? FN<T, 128>(__VA_ARGS__) : FN<T, 256>(__VA_ARGS__))
#define PTT_FLASH_WIDTH_TC(V, FN, ...)                                    \
  (D <= 64 ? FN<64, V>(__VA_ARGS__)                                       \
           : D <= 128 ? FN<128, V>(__VA_ARGS__) : FN<256, V>(__VA_ARGS__))
#define PTT_FLASH_DISPATCH(FN, VEC, ...)                                    \
  do {                                                                      \
    if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);   \
    if (dtype == PTT_DTYPE_F32)                                             \
      return PTT_FLASH_WIDTH(float, FN, __VA_ARGS__);                       \
    if (dtype == PTT_DTYPE_F16)                                             \
      return PTT_FLASH_WIDTH(__half, FN, __VA_ARGS__);                      \
    if (dtype == PTT_DTYPE_BF16)                                            \
      return (VEC) ? PTT_FLASH_WIDTH_TC(true, FN##_tc, __VA_ARGS__)         \
                   : PTT_FLASH_WIDTH_TC(false, FN##_tc, __VA_ARGS__);       \
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
  PTT_FLASH_DISPATCH(fwd, vec_ok(D, strides, {q, k, v}), q, k, v, out, l, B,
                     H, Sq, Sk, D, strides, scale, causal, s);
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
  PTT_FLASH_DISPATCH(bwd_dq, vec_ok(D, strides, {q, k, v, dout}), q, k, v,
                     dout, l, dl, dq, B, H, Sq, Sk, D, strides, scale, causal,
                     s);
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
  PTT_FLASH_DISPATCH(bwd_dkv, vec_ok(D, strides, {q, k, v, dout}), q, k, v,
                     dout, l, dl, dk, dv, B, H, Sq, Sk, D, strides, scale,
                     causal, s);
}
