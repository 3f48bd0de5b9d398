// Segmented LoRA SGMV epilogue: s = z + (x_blk @ A[a]) @ B[a] and
// out = act(s), every row block with its own adapter a = aid[block].
//
// Replaces: paddle_tpu/ops/pallas_grouped.py `_lora_fwd_kernel` (:355,
// called from `_lora_call` :374), the multi-LoRA serving epilogue that
// follows each base projection (qkv, out, fc1 with its activation, fc2),
// which LoRA fine-tuning also runs forward.
//
// Layout (the TPU kernel's, unchanged).  z [R, N] is the base
// pre-activation x @ W + b; x [R, K] with R = nb * bm, block i owning rows
// [i*bm, (i+1)*bm); A [L, K, r] and B [L, r, N] the packed adapter stacks,
// alpha / r folded into B; aid [nb] int32, where L (any id outside
// [0, L)) marks a null block.  z, x, A, B, out and s share one type (f32
// or bf16); every product and sum is f32, as the TPU kernel casts its
// operands to f32 before both dots.  `out` may be null: then only s is
// written (act "none", where out equals s bit for bit and the wrapper
// returns s as both).
//
// A null block adds nothing: it writes s = z and out = act(z), so the
// rows of requests without an adapter come out as the base model's.  The
// reference rides an appended zero adapter instead (pallas_grouped.py
// :414-417) and computes x @ 0 for them.
//
// What bounds it on the H100: bytes.  z is read and s (and out) written
// once, x read once for the adapter rows, the factors of the adapters in
// use: 117 MB at the fine-tuning drive's qkv (8192 rows, 1024 -> 3072,
// r = 16, bf16, s alone), 0.035 ms at 3.35 TB/s; the low-rank products
// are 2 R r (K + N) = 1.1 GFLOP there.  The TPU kernel's grid, one program
// a (row block, column tile) recomputing x_blk @ A[a] in every tile, is
// free on the MXU; on the H100 it multiplied t's cost by the column tiles
// (48 at qkv) and read x 16-48 times.
//
// bf16 with 16-byte rows (K, N and r multiples of 8, every pointer 16-byte
// aligned; `mma_route`): `lora_sgmv_mma_kernel<kRW>`, 8 warps, one thread
// block a (row block, column span).
//  * The span (`span_chunks`): the whole N where the row blocks alone
//    fill the SMs (fine-tuning: 512 blocks), else N over ceil(SMs / nb)
//    spans rounded down to a multiple of 512 columns (a serving step's
//    23 blocks: 6 spans at N 3072, 8 at 4096, 2 at 1024).  Each span
//    recomputes t, which costs x_blk and A[a] once more from L2.
//  * t = x_blk @ A[a] once a block, for 16 rows at a time, on the tensor
//    cores: `mma.sync` m16n8k16 bf16 -> f32 (bf16 products are exact in
//    f32, so this is the reference's f32 dot in another order) with x as
//    A (`ldmatrix`) and A[a] [K, r] as B (`ldmatrix.trans`, in place),
//    staged by 16-byte `cp.async` into a ring of swizzled stages (rank
//    16: two stages 512 deep).  K is split across the warps by 16-deep
//    steps (warp w takes the steps s with s % 8 == w); each warp's
//    partial t goes to shared memory and the 8 partials are added in warp
//    order: the same sums every run, no atomics.  r pads to kRW (16, 32,
//    64 or 128) with zero columns.
//  * The expansion t @ B[a] in f32 on the CUDA cores: t stays f32 in
//    shared memory (rounding it to bf16 for a tensor-core product would
//    compute another function), B[a]'s span comes through shared memory
//    in double-buffered 16 KB tiles (the first one in flight with t's
//    stages), and each thread owns 4 rows x 8 columns: it reads its z as
//    four 16-byte vectors first, adds the r products in order (t four
//    values at a time, B once for the 4 rows), and writes s (and out) as
//    16-byte vectors, a warp covering 512 contiguous bytes of a row.
//  * A null block copies z to s and act(z) to out in 16-byte vectors.
// At the drives' shapes (H100, L2 flushed) it runs in 0.012-0.020 ms at a
// serving step, 1.6-2.1x the byte bound at fine-tuning's 8192 rows.
//
// f32, and bf16 rows off 16 bytes: `lora_sgmv_kernel<T>`, the first
// design, one value at a time.  One block of 256 threads per (row block,
// 64-column tile): each tile computes its rows' t = x_blk @ A[a] into
// shared memory (64-deep slices of x and of A[a] staged as f32, each
// thread summing its entries of t, depth split across threads in a fixed
// order when the entries are fewer than the threads), then d = t @ B[a]
// for its [bm, 64] outputs, the add to z in f32 and the activation.  The
// tensor cores would round f32 operands to TF32, so f32 stays on the
// CUDA cores.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptt::mma;

// ---- f32 and the element-wise route --------------------------------------
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
      s[idx] = z[idx];
      if (out != nullptr)
        out[idx] = ptt::from_float<T>(
            ptt::apply_act(ptt::to_float(z[idx]), act));
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
    if (out != nullptr)
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

// ---- bf16 with 16-byte rows: the tensor-core route ------------------------
constexpr int kMmaThreads = 256;
constexpr int kWarps = kMmaThreads / 32;
constexpr int kMaxRank = 128;
constexpr int kSpanChunks = 64;    // a span is a multiple of 512 columns

// The tile shapes of a padded rank kRW (16, 32, 64 or 128).
template <int kRW>
struct Mma {
  // the x / A ring: rank 16 (the drives') double-buffers 512-deep stages
  // (fewer barriers: serving fc2 0.0199 ms against 0.0217 with four
  // 256-deep stages on the H100, the fine-tuning shapes within 3%)
  static constexpr int kStages = kRW == 16 ? 2 : 4;
  static constexpr int kKC = kRW == 16 ? 512 : kRW == 32 ? 128 : 64;
  static constexpr int kXT = 16 * kKC;               // x tile: 16 rows
  static constexpr int kStage = kXT + kKC * kRW;     // x, then A [kKC][kRW]
  static constexpr int kBT = 8192 / kRW;             // B tile: 16 KB
  static constexpr int kBC = kBT / 8;                // its 16-byte chunks
  static_assert(kSpanChunks % kBC == 0, "a span is whole B tiles");
  static constexpr size_t kRing = sizeof(bf16) * kStages * kStage;
  static constexpr size_t kB = sizeof(bf16) * 2 * kRW * kBT;
  static_assert(kWarps * 16 * kRW * sizeof(float) <= kRing,
                "the warps' partial t reuse the ring");
  static size_t smem(int bm, int r) {
    return kRing + kB + sizeof(float) * static_cast<size_t>(bm) * r;
  }
};

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  v.x = pack_bf16(f[0], f[1]);
  v.y = pack_bf16(f[2], f[3]);
  v.z = pack_bf16(f[4], f[5]);
  v.w = pack_bf16(f[6], f[7]);
  return v;
}

// s (and out = act(s)) of one 16-byte chunk of a row from its f32 sum
__device__ __forceinline__ void store_chunk(bf16* s, bf16* out, size_t idx,
                                            float (&f)[8], int act) {
  *reinterpret_cast<uint4*>(s + idx) = pack8(f);
  if (out != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = ptt::apply_act(f[j], act);
    *reinterpret_cast<uint4*>(out + idx) = pack8(f);
  }
}

template <int kRW>
__global__ void __launch_bounds__(kMmaThreads)
    lora_sgmv_mma_kernel(const bf16* __restrict__ z,
                         const bf16* __restrict__ x,
                         const bf16* __restrict__ a,
                         const bf16* __restrict__ b,
                         const int* __restrict__ aid, bf16* __restrict__ out,
                         bf16* __restrict__ s, int K, int N, int r, int L,
                         int bm, int act, int span) {
  using C = Mma<kRW>;
  constexpr int kXC = C::kKC / 8;            // chunks of an x tile row
  constexpr int kAC = kRW / 8;               // chunks of an A tile row
  constexpr int kSteps = C::kKC / 16;        // 16-deep steps of a stage
  extern __shared__ uint4 smem_lora[];
  bf16* ring = reinterpret_cast<bf16*>(smem_lora);   // kStages x stage
  bf16* bt = ring + C::kStages * C::kStage;          // 2 x [kRW][kBT]
  float* ts = reinterpret_cast<float*>(bt + 2 * kRW * C::kBT);  // [bm][r]
  float* part = reinterpret_cast<float*>(ring);      // kWarps x [16][kRW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * bm;
  const int c0 = blockIdx.x * span;                  // chunks of 8 columns
  const int c1 = min(N / 8, c0 + span);
  const int ad = aid[blockIdx.y];

  if (ad < 0 || ad >= L) {  // a null block: s = z, out = act(z)
    const int w = c1 - c0;
    for (int e = tid; e < bm * w; e += kMmaThreads) {
      const size_t idx = (row0 + e / w) * N + (c0 + e % w) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(z + idx);
      *reinterpret_cast<uint4*>(s + idx) = v;
      if (out != nullptr) {
        float f[8];
        unpack8(v, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = ptt::apply_act(f[j], act);
        *reinterpret_cast<uint4*>(out + idx) = pack8(f);
      }
    }
    return;
  }

  const bf16* ae = a + static_cast<size_t>(ad) * K * r;
  const bf16* be = b + static_cast<size_t>(ad) * r * N;
  const int ktiles = (K + C::kKC - 1) / C::kKC;
  const int nt = (r + 15) / 16;              // 16-column pairs of t

  // x rows m0..m0+15 and A[a]'s rows at depth kt * kKC.. into a stage
  auto stage = [&](int m0, int kt, int slot) {
    const int k0 = kt * C::kKC;
    bf16* xd = ring + slot * C::kStage;
    bf16* ad_ = xd + C::kXT;
    for (int c = tid; c < 16 * kXC; c += kMmaThreads) {
      const int m = c / kXC, ch = c % kXC;
      const int gk = k0 + ch * 8;
      const bool in = gk < K;
      cp_async_16(xd + swz<C::kKC>(m, ch),
                  in ? x + (row0 + m0 + m) * K + gk : x, in ? 16 : 0);
    }
    for (int c = tid; c < C::kKC * kAC; c += kMmaThreads) {
      const int k = c / kAC, ch = c % kAC;
      const bool in = k0 + k < K && ch * 8 < r;
      cp_async_16(ad_ + swz<kRW>(k, ch),
                  in ? ae + static_cast<size_t>(k0 + k) * r + ch * 8 : a,
                  in ? 16 : 0);
    }
  };
  // B[a]'s rows over column tile ct of the span (zero past it)
  auto stage_b = [&](int ct, int buf) {
    const int cb = c0 + ct * C::kBC;
    bf16* bd = bt + buf * kRW * C::kBT;
    for (int c = tid; c < r * C::kBC; c += kMmaThreads) {
      const int j = c / C::kBC, ch = c % C::kBC;
      const bool in = cb + ch < c1;
      cp_async_16(bd + j * C::kBT + ch * 8,
                  in ? be + static_cast<size_t>(j) * N + (cb + ch) * 8 : b,
                  in ? 16 : 0);
    }
  };

  stage_b(0, 0);  // joins the first stage's group

  for (int m0 = 0; m0 < bm; m0 += 16) {
    float acc[kRW / 8][4];
#pragma unroll
    for (int j = 0; j < kRW / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    // the ring: stages kt + 1 .. kt + kStages - 1 fly while kt multiplies
#pragma unroll
    for (int st = 0; st < C::kStages - 1; ++st) {
      if (st < ktiles) stage(m0, st, st);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<C::kStages - 2>();
      __syncthreads();  // stage kt landed; every warp left stage kt - 1
      const int next = kt + C::kStages - 1;
      if (next < ktiles) stage(m0, next, next % C::kStages);
      cp_async_commit();
      const bf16* xd = ring + (kt % C::kStages) * C::kStage;
      const bf16* ad_ = xd + C::kXT;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if ((kt * kSteps + kk) % kWarps != warp) continue;  // the K split
        uint32_t fa[4];
        ldmatrix_x4(fa, xd + frag_a<C::kKC>(0, kk, lane));
#pragma unroll
        for (int j = 0; j < kRW / 16; ++j) {
          if (j >= nt) break;
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, ad_ + frag_bt<kRW>(16 * kk, j, lane));
          mma_bf16(acc[2 * j], fa, fb[0], fb[1]);
          mma_bf16(acc[2 * j + 1], fa, fb[2], fb[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: partials go there
    {
      float* pw = part + warp * 16 * kRW;
      const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kRW / 8; ++j) {
        if (j >= 2 * nt) break;
        pw[g * kRW + 8 * j + c] = acc[j][0];
        pw[g * kRW + 8 * j + c + 1] = acc[j][1];
        pw[(g + 8) * kRW + 8 * j + c] = acc[j][2];
        pw[(g + 8) * kRW + 8 * j + c + 1] = acc[j][3];
      }
    }
    __syncthreads();
    for (int e = tid; e < 16 * r; e += kMmaThreads) {
      const int m = e / r, j = e % r;
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += part[(w * 16 + m) * kRW + j];
      ts[(m0 + m) * r + j] = v;  // the K split's partials in warp order
    }
    __syncthreads();  // the next rows' stages overwrite the partials
  }

  // the expansion: B tile ct + 1 in flight while tile ct multiplies; an
  // item is 4 rows x 8 columns, 4 * (e / kBC).. and 8 * (e % kBC).. of
  // the tile
  const int ntiles = (c1 - c0 + C::kBC - 1) / C::kBC;
  const int items = (bm / 4) * C::kBC;
  for (int ct = 0; ct < ntiles; ++ct) {
    cp_async_wait<0>();
    __syncthreads();  // tile ct landed; every thread left tile ct - 1
    if (ct + 1 < ntiles) {
      stage_b(ct + 1, (ct + 1) & 1);
      cp_async_commit();
    }
    const bf16* bd = bt + (ct & 1) * kRW * C::kBT;
    for (int e = tid; e < items; e += kMmaThreads) {
      const int m = 4 * (e / C::kBC), ch = e % C::kBC;
      const int c = c0 + ct * C::kBC + ch;
      if (c >= c1) continue;
      const size_t idx = (row0 + m) * N + static_cast<size_t>(c) * 8;
      uint4 zv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        zv[q] = *reinterpret_cast<const uint4*>(z + idx + q * N);
      float d[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 8; ++k) d[q][k] = 0.f;
      const float* tm = ts + m * r;
      for (int j = 0; j < r; j += 4) {
        float4 tv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tv[q] = *reinterpret_cast<const float4*>(tm + q * r + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float bv[8];
          unpack8(*reinterpret_cast<const uint4*>(bd + (j + jj) * C::kBT +
                                                  ch * 8),
                  bv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float u = jj == 0   ? tv[q].x
                            : jj == 1 ? tv[q].y
                            : jj == 2 ? tv[q].z
                                      : tv[q].w;
#pragma unroll
            for (int k = 0; k < 8; ++k) d[q][k] = fmaf(u, bv[k], d[q][k]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[8];
        unpack8(zv[q], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] += d[q][k];
        store_chunk(s, out, idx + q * N, f, act);
      }
    }
  }
}

int sm_count(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
  return v > 0 ? v : 1;
}

// Chunks (8 columns) of a span: the whole N where nb blocks fill the
// SMs, else N over ceil(SMs / nb) spans rounded down to a multiple of
// kSpanChunks (at least one), so that a span is whole B tiles.
int span_chunks(int nb, int N, int device) {
  const int chunks = N / 8;
  const int spans = (sm_count(device) + nb - 1) / nb;
  if (spans == 1) return chunks;
  const int span = chunks / spans / kSpanChunks * kSpanChunks;
  return span > kSpanChunks ? span : kSpanChunks;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor-core route: bf16, 16-byte rows (K, N and r multiples of 8,
// every pointer 16-byte aligned), r at most kMaxRank.
bool mma_route(const void* z, const void* x, const void* a, const void* b,
               const void* out, const void* s, int K, int N, int r,
               int dtype) {
  return dtype == PTT_DTYPE_BF16 && K > 0 && K % 8 == 0 && N % 8 == 0 &&
         r > 0 && r % 8 == 0 && r <= kMaxRank && aligned16(z) &&
         aligned16(x) && aligned16(a) && aligned16(b) && aligned16(out) &&
         aligned16(s);
}

template <int kRW>
int launch_mma(const void* z, const void* x, const void* a, const void* b,
               const int* aid, void* out, void* s, int R, int K, int N,
               int r, int L, int bm, int act, int device, cudaStream_t st) {
  using C = Mma<kRW>;
  if (bm <= 0 || bm % 16 || R % bm || bm * r > kMaxPer * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = C::smem(bm, r);
  cudaError_t err = cudaFuncSetAttribute(
      lora_sgmv_mma_kernel<kRW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = R / bm;
  const int span = span_chunks(nb, N, device);
  const dim3 grid((N / 8 + span - 1) / span, nb);
  lora_sgmv_mma_kernel<kRW><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(x),
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), aid,
      static_cast<bf16*>(out), static_cast<bf16*>(s), K, N, r, L, bm, act,
      span);
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
  if (mma_route(z, x, a, b, out, s, K, N, r, dtype)) {
    if (r <= 16)
      return launch_mma<16>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act,
                            device, st);
    if (r <= 32)
      return launch_mma<32>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act,
                            device, st);
    if (r <= 64)
      return launch_mma<64>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act,
                            device, st);
    return launch_mma<128>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act,
                           device, st);
  }
  if (dtype == PTT_DTYPE_F32)
    return launch<float>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act, st);
  if (dtype == PTT_DTYPE_BF16)
    return launch<bf16>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act, st);
  if (dtype == PTT_DTYPE_F16)   // f32's CUDA-core kernel on f16 rows
    return launch<__half>(z, x, a, b, ids, out, s, R, K, N, r, L, bm, act,
                          st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 where `ptt_lora_sgmv_fwd` takes the tensor-core route, else 0
extern "C" int ptt_lora_sgmv_mma_route(const void* z, const void* x,
                                       const void* a, const void* b,
                                       const void* out, const void* s, int K,
                                       int N, int r, int dtype) {
  return mma_route(z, x, a, b, out, s, K, N, r, dtype) ? 1 : 0;
}

// The column spans of the tensor-core route's grid for nb row blocks
extern "C" int ptt_lora_sgmv_spans(int nb, int N, int device) {
  if (nb <= 0 || N <= 0 || N % 8) return 0;
  const int span = span_chunks(nb, N, device);
  return (N / 8 + span - 1) / span;
}
