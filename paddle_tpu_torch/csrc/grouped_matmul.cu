// Grouped-expert matmul: out = act(x_blk @ w[gid[i]] + b[gid[i]]) over a
// block-aligned grouped buffer, and its weight gradient.
//
// Replaces: paddle_tpu/ops/pallas_grouped.py `_gmm_fwd_kernel` (:85, called
// from `_gmm_call` :99) and `_gmm_dw_kernel` (:133, called from
// `_gmm_dw_call` :161), the dropless MoE's expert GEMMs; the port also runs
// them for LoRA's backward over the adapter stacks (ops/lora.py).
//
// Layout.  x is [R, K] with R = nb * bm: block i (rows [i*bm, (i+1)*bm))
// belongs wholly to expert gid[i], and an id outside [0, E) marks a null
// block (all rows padding).  w is the stacked expert weights, b [E, N] the
// biases (or null: no bias).  All float operands share one type (f32 or
// bf16); gid is int32.
//
// Forward (`ptt_grouped_matmul_fwd`).  w[e] is [K, N] (`trans` 0) or, for
// the backward's dx = dz @ w[e]^T, the weight as stored, [N, K] (`trans`
// 1): the kernel reads w[e] transposed in place, so the caller copies no
// weights.  The reference appends a zero null expert and pads N on every
// call (`_stacked_pad`, :188-196) and materialises swapaxes(w) for dx
// (:225-227); here a null block writes zeros to out and z (act(0) = 0 for
// every activation) and computes nothing.  z, the f32 pre-activation cast
// to the input type, is written when its pointer is not null, as
// pallas_grouped.py:93-95 saves it.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 67 f32, 3.35 TB/s).
//  * MoE serving (R = 1280 rows for 736 assignments, K 2048 -> N 8192
//    and back, bf16): the weights of the three experts in use (33.5 MB
//    each) bound it, ~0.03 ms, with the padded rows' 43 GFLOP close
//    behind; MoE training (16384 assignments, 768 <-> 3072): operations.
//  * LoRA's backward (8192 rows, one adapter of rank 16): u = ds @ B^T
//    and t = x @ A (N = 16) read x once, 50 or 17 MB: bytes; dx = u @ A^T
//    (K = 16) writes [8192, 1024]: bytes.
// So the bf16 design streams the operand that bounds each shape with the
// copies overlapping the products, and fills the tensor cores elsewhere.
//
// bf16 forward (`gmm_fwd_mma`), built on mma.cuh: `mma.sync` m16n8k16 with
// f32 accumulators, operands from swizzled shared tiles through `ldmatrix`
// (x as A; w[e] [K, N] through `ldmatrix.trans`, w[e] [N, K] through the
// plain `ldmatrix`, both in place), staged by 16-byte `cp.async` into a
// ring of 2-4 stages in dynamic shared memory, the next stages in flight
// while the current one multiplies (operands with K or N off a multiple
// of 8, or off 16 bytes, stage element by element into the same layout).
// Tile shapes, picked at launch:
//  * 128 x 128, 8 warps of 64 x 32, 3 stages of depth 64 (96 KB), when the
//    grid has a tile for every SM; with two tiles an SM or more, the same
//    tile capped at 128 registers a thread so that two blocks share an SM
//    (MoE serving's w1, training: the second block hides the first's
//    latency; w2's 160 tiles run faster one block an SM).  Smaller grids
//    (MoE decode steps) take 128 x 64, 8 warps of 32 x 32, 4 stages;
//  * N <= 16 (LoRA's u and t): 64 x 16 (4 warps of 16 rows), 4 stages of
//    depth 128, so no column of the tile is waste and 128 blocks stream x
//    in 256-byte row pieces;
//  * K <= 16 (LoRA's dx): 128 x 128 at depth 16, one step, bound by the
//    store of out.
// A row tile spans the consecutive blocks its rows fall in and reads
// their ids from gid.  Its distinct experts go to as many thread blocks
// (the grid's z: the most experts a tile's rows can hold, at most E),
// z-block i taking the i-th smallest: each stages only its expert's rows
// (the others zero, read from nowhere) and stores only them, and a warp
// whose rows hold none of them skips its products.  A tile of one expert
// (MoE's blocks of 128, single-adapter LoRA) keeps one z-block at work;
// blocks that alternate ids (multi-adapter LoRA, whose ids are unsorted;
// MoE decode steps, a block an expert) run their experts side by side,
// each row read once.  Null rows are written zero once, by the first
// z-block.  The accumulators stay in registers
// through the bias, the activation (`ptt::apply_act`, f32) and the cast;
// the bf16 out (and z) tiles then go through the idle ring so that every
// thread stores 16 bytes a row chunk.
//
// f32 forward (`gmm_fwd_fma`): the tensor cores would round to TF32, so
// the CUDA cores multiply in f32: a thread block owns TM rows x 64
// columns, TM the largest of 64, 32, 16 or 8 dividing bm (so one block,
// one expert), 16 x min(TM, 16) threads, each a (TM / 16 or 1) x 4
// register micro-tile, 16-deep shared slices, fmaf.
//
// Weight gradient (`ptt_grouped_matmul_dw`): dw[e] = sum over the blocks of
// expert e of x_blk^T @ dz_blk, summed in f32 and cast once to the type of
// x (= w's).  The TPU kernel walks the blocks in grid order and accumulates
// into a revisited output block.  Here a thread block owns one (K tile,
// N tile, expert, row slice): it finds its expert's run of blocks in gid
// (nondecreasing, see the wrapper) by binary search and sums its slice of
// those rows in registers.  With S = 1 slice it writes dw; when the tiles
// alone would not fill the card (LoRA: one adapter, a 1024 x 16 or 16 x
// 3072 dw) the rows split into S slices (`ptt_grouped_matmul_dw_slices`),
// each block writes its f32 partial to a [S, E, K, N] scratch the wrapper
// allocates, and `column_sum_kernel` adds the partials in slice order and
// casts once: no atomics, the same sums every run.  An expert that owns no
// block writes exact zeros (the reference's mask at :234-239).
//  * bf16 (`gmm_dw_mma`): mma.sync with x^T as A through `ldmatrix.trans`
//    on the row-major x tile and dz as B through `ldmatrix.trans`, a
//    cp.async ring over 64-row steps, 4 warps: tiles 128 x 128 (warps of
//    64 x 64, 3 stages), 64 x 16 (N <= 16, LoRA's dA) or 16 x 64 (K <= 16,
//    dB; 4 stages).
//  * f32 (`gmm_dw_fma`): the CUDA cores, 64 x 64 tiles, 16-row slices,
//    fmaf, under the same row split.
// Bound: operations at the training shape, bytes at LoRA's (x and dz read
// once).
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptt::mma;

constexpr int kGN = 64;  // output columns of an f32 forward tile

// The SMs of `device`, cached per device.
int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n < 1)
      n = 132;
    counts[device] = n;
  }
  return counts[device];
}

// ---- forward, bf16: tensor-core tiles --------------------------------------
// kBM x kBN outputs a block, depth kBK a stage, warps of kWM x kWN, a ring of
// kStages stages; kMinBlocks blocks an SM at least (registers capped to fit).
template <int kBM_, int kBN_, int kBK_, int kWM_, int kWN_, int kStages_,
          int kMinBlocks_ = 1>
struct Fwd {
  static constexpr int kBM = kBM_, kBN = kBN_, kBK = kBK_;
  static constexpr int kWM = kWM_, kWN = kWN_, kStages = kStages_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kWarpsN = kBN / kWN;
  static constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
  static constexpr int kXT = kBM * kBK, kWT = kBN * kBK;  // tile elements
  static constexpr int kOLd = kBN + 8;  // epilogue tile rows: 16-byte aligned
  static constexpr int kMaxBlocks = kBM / 16 + 1;  // blocks a tile touches
  static constexpr size_t kRing = sizeof(bf16) * kStages * (kXT + kWT);
  static constexpr size_t kEpi = sizeof(bf16) * kBM * kOLd;  // out or z
  // shared bytes of a launch: the ring, or the epilogue's out (and z) tiles
  static constexpr size_t smem(bool with_z) {
    const size_t epi = kEpi * (with_z ? 2 : 1);
    return kRing > epi ? kRing : epi;
  }
};
using FwdWide = Fwd<128, 128, 64, 64, 32, 3>;
using FwdWide2 = Fwd<128, 128, 64, 64, 32, 3, 2>;
using FwdMid = Fwd<128, 64, 64, 32, 32, 4>;
using FwdNarrowN = Fwd<64, 16, 128, 16, 16, 4>;
using FwdNarrowK = Fwd<128, 128, 16, 64, 32, 2>;

// 8 values from src into the 16-byte chunk dst, zero past the first
// `avail` (0: a zero chunk, nothing read).  vec: one cp.async (avail is 0
// or 8, src 16-byte aligned); else element by element, synchronously.
// `base` is any valid address, handed to a cp.async that reads nothing.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int avail,
                                      bool vec, const bf16* base) {
  if (vec) {
    cp_async_16(dst, avail > 0 ? src : base, avail > 0 ? 16 : 0);
  } else {
    alignas(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = j < avail ? src[j] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// Store 8 values (a 16-byte chunk of a shared row) at dst, or the first n
// of them one by one where the row is off 16 bytes or short.
__device__ __forceinline__ void store8(bf16* dst, const bf16* src, int n,
                                       bool vec) {
  if (vec && n >= 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    for (int j = 0; j < n && j < 8; ++j) dst[j] = src[j];
  }
}

template <class C, bool kTrans>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
    gmm_fwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ b, const int* __restrict__ gid,
                bf16* __restrict__ out, bf16* __restrict__ z, int R, int K,
                int N, int E, int bm, int act, bool vec, bool ovec) {
  constexpr int kBM = C::kBM, kBN = C::kBN, kBK = C::kBK;
  constexpr int kWM = C::kWM, kWN = C::kWN, kS = C::kStages;
  constexpr int kT = C::kThreads;
  constexpr int kXC = kBK / 8;                   // chunks of an x tile row
  constexpr int kXIt = kBM * kXC / kT;           // x chunks a thread stages
  constexpr int kWRows = kTrans ? kBN : kBK;     // w tile: [n][k] or [k][n]
  constexpr int kWW = kTrans ? kBK : kBN;
  constexpr int kWC = kWW / 8;
  constexpr int kWIt = (kWRows * kWC + kT - 1) / kT;
  constexpr int kOC = kBN / 8;                   // chunks of an out row
  static_assert(kBM * kXC % kT == 0 && kXIt <= 32, "x staging");
  extern __shared__ uint4 smem_gmm[];
  bf16* xs = reinterpret_cast<bf16*>(smem_gmm);  // kS x [kBM][kBK]
  bf16* ws = xs + kS * C::kXT;                   // kS x w tile
  __shared__ int ids[C::kMaxBlocks];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = min(kBM, R - m0);
  const int blk0 = m0 / bm;
  const int nblk = (m0 + rows - 1) / bm - blk0 + 1;
  for (int i = threadIdx.x; i < nblk; i += kT) ids[i] = gid[blk0 + i];
  __syncthreads();
  auto id_of = [&](int r) { return ids[(m0 + r) / bm - blk0]; };

  // null rows (no expert): zeros, by the tile's first z-block
  for (int c = threadIdx.x; blockIdx.z == 0 && c < rows * kOC; c += kT) {
    const int r = c / kOC, gn = n0 + (c % kOC) * 8;
    const int e = id_of(r);
    if ((e >= 0 && e < E) || gn >= N) continue;
    alignas(16) bf16 zero8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) zero8[j] = __float2bfloat16(0.f);
    const size_t o = static_cast<size_t>(m0 + r) * N + gn;
    store8(out + o, zero8, N - gn, ovec);
    if (z != nullptr) store8(z + o, zero8, N - gn, ovec);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / C::kWarpsN) * kWM, wn0 = (warp % C::kWarpsN) * kWN;
  const int g = lane >> 2, t = lane & 3;
  const int ktiles = (K + kBK - 1) / kBK;

  // this block's expert: the blockIdx.z-th smallest distinct id of the
  // tile (the z-blocks of one tile run its experts side by side)
  int e = -1;
  for (int p = 0; p <= static_cast<int>(blockIdx.z) && e < E; ++p) {
    int next = E;
    for (int i = 0; i < nblk; ++i) {
      const int v = ids[i];
      if (v > e && v < next) next = v;
    }
    e = next;
  }
  if (e >= E) return;  // the tile has fewer experts
  auto live = [&](int r) { return r < rows && id_of(r) == e; };
  uint32_t xlive = 0;  // bit i: this thread's i-th x chunk is e's row
#pragma unroll
  for (int i = 0; i < kXIt; ++i)
    if (live((threadIdx.x + i * kT) / kXC)) xlive |= 1u << i;
  bool wlive = false;  // the warp's rows hold a row of e
  if (wm0 < rows) {
    const int lo = (m0 + wm0) / bm - blk0;
    const int hi = (m0 + min(wm0 + kWM, rows) - 1) / bm - blk0;
    for (int i = lo; i <= hi; ++i) wlive |= ids[i] == e;
  }
  const bf16* we = w + static_cast<size_t>(e) * K * N;

  auto stage = [&](int kt, int slot) {
    const int k0 = kt * kBK;
    bf16* xd = xs + slot * C::kXT;
#pragma unroll
    for (int i = 0; i < kXIt; ++i) {
      const int c = threadIdx.x + i * kT;
      const int r = c / kXC, ch = c % kXC;
      const int gk = k0 + ch * 8;
      const int avail = ((xlive >> i) & 1) && gk < K ? min(8, K - gk) : 0;
      copy8(xd + swz<kBK>(r, ch), x + static_cast<size_t>(m0 + r) * K + gk,
            avail, vec, x);
    }
    bf16* wd = ws + slot * C::kWT;
#pragma unroll
    for (int i = 0; i < kWIt; ++i) {
      const int c = threadIdx.x + i * kT;
      if (kWRows * kWC % kT != 0 && c >= kWRows * kWC) break;
      const int r = c / kWC, ch = c % kWC;
      int avail;
      const bf16* src;
      if constexpr (kTrans) {  // w[e] [N, K]: row n, chunks along k
        const int gn = n0 + r, gk = k0 + ch * 8;
        avail = gn < N && gk < K ? min(8, K - gk) : 0;
        src = we + static_cast<size_t>(gn) * K + gk;
      } else {  // w[e] [K, N]: row k, chunks along n
        const int gk = k0 + r, gn = n0 + ch * 8;
        avail = gk < K && gn < N ? min(8, N - gn) : 0;
        src = we + static_cast<size_t>(gk) * N + gn;
      }
      copy8(wd + swz<kWW>(r, ch), src, avail, vec, w);
    }
  };

  float acc[kWM / 16][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto compute = [&](int slot) {
    const bf16* xd = xs + slot * C::kXT;
    const bf16* wd = ws + slot * C::kWT;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t fa[kWM / 16][4];
#pragma unroll
      for (int i = 0; i < kWM / 16; ++i)
        ldmatrix_x4(fa[i], xd + frag_a<kBK>(wm0 + 16 * i, kk, lane));
#pragma unroll
      for (int j = 0; j < kWN / 16; ++j) {
        uint32_t fb[4];
        if constexpr (kTrans)
          ldmatrix_x4(fb, wd + frag_b<kBK>(wn0 + 16 * j, kk, lane));
        else
          ldmatrix_x4_trans(fb,
                            wd + frag_bt<kBN>(16 * kk, wn0 / 16 + j, lane));
#pragma unroll
        for (int i = 0; i < kWM / 16; ++i) {
          mma_bf16(acc[i][2 * j], fa[i], fb[0], fb[1]);
          mma_bf16(acc[i][2 * j + 1], fa[i], fb[2], fb[3]);
        }
      }
    }
  };

  // the ring: stages kt + 1 .. kt + kS - 1 fly while stage kt multiplies
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < ktiles) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // stage kt landed; every warp left stage kt - 1
    const int nk = kt + kS - 1;
    if (nk < ktiles) stage(nk, nk % kS);
    cp_async_commit();
    if (wlive) compute(kt % kS);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue tiles

  // bias, activation and cast in registers; bf16 tiles through shared
  bf16* os = reinterpret_cast<bf16*>(smem_gmm);  // [kBM][kOLd]
  bf16* zs = os + kBM * C::kOLd;
  const bf16* be = b != nullptr ? b + static_cast<size_t>(e) * N : nullptr;
#pragma unroll
  for (int j = 0; j < kWN / 8; ++j) {
    const int c = wn0 + 8 * j + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (be != nullptr) {
      if (n0 + c < N) b0 = ptt::to_float(be[n0 + c]);
      if (n0 + c + 1 < N) b1 = ptt::to_float(be[n0 + c + 1]);
    }
#pragma unroll
    for (int i = 0; i < kWM / 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm0 + 16 * i + g + 8 * h;
        const float z0 = acc[i][j][2 * h] + b0;
        const float z1 = acc[i][j][2 * h + 1] + b1;
        *reinterpret_cast<__nv_bfloat162*>(os + r * C::kOLd + c) =
            __floats2bfloat162_rn(ptt::apply_act(z0, act),
                                  ptt::apply_act(z1, act));
        if (z != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(zs + r * C::kOLd + c) =
              __floats2bfloat162_rn(z0, z1);
      }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < rows * kOC; c += kT) {
    const int r = c / kOC, ch = c % kOC;
    const int gn = n0 + ch * 8;
    if (gn >= N || !live(r)) continue;
    const size_t o = static_cast<size_t>(m0 + r) * N + gn;
    store8(out + o, os + r * C::kOLd + ch * 8, N - gn, ovec);
    if (z != nullptr)
      store8(z + o, zs + r * C::kOLd + ch * 8, N - gn, ovec);
  }
}

// ---- forward, f32: CUDA-core register tiles -------------------------------
constexpr int kFK = 16;  // K depth of a staged slice

// Zeros for a null block's rows (no expert: act(0 + 0) = 0).
template <typename T>
__device__ __forceinline__ void zero_tile(T* out, T* z, int m0, int rows,
                                          int n0, int N) {
  const T zero = ptt::from_float<T>(0.f);
  for (int e = threadIdx.x; e < rows * kGN; e += blockDim.x) {
    const int gn = n0 + e % kGN;
    if (gn >= N) continue;
    const size_t idx = static_cast<size_t>(m0 + e / kGN) * N + gn;
    out[idx] = zero;
    if (z != nullptr) z[idx] = zero;
  }
}

template <typename T>
__device__ __forceinline__ void store_out(float acc, const T* be, T* out,
                                          T* z, int gm, int gn, int N,
                                          int act) {
  const float zf = be != nullptr ? acc + ptt::to_float(be[gn]) : acc;
  const size_t idx = static_cast<size_t>(gm) * N + gn;
  if (z != nullptr) z[idx] = ptt::from_float<T>(zf);
  out[idx] = ptt::from_float<T>(ptt::apply_act(zf, act));
}

template <typename T, int TM, bool kTrans>
__global__ void __launch_bounds__(256)
    gmm_fwd_fma(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, const int* __restrict__ gid,
                T* __restrict__ out, T* __restrict__ z, int K, int N, int E,
                int bm, int act) {
  constexpr int kTY = TM < 16 ? TM : 16;  // thread rows (blockDim 16 kTY)
  constexpr int kMR = TM / kTY;           // output rows of a thread
  __shared__ float Xs[kFK][TM + 4];       // Xs[k][m]
  __shared__ float Ws[kFK][kGN + 4];      // Ws[k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * kGN;
  const int e = gid[m0 / bm];
  if (e < 0 || e >= E) {  // a null block (any id outside the experts)
    zero_tile(out, z, m0, TM, n0, N);
    return;
  }
  const T* we = w + static_cast<size_t>(e) * K * N;
  const T* be = b != nullptr ? b + static_cast<size_t>(e) * N : nullptr;
  float acc[kMR][4];
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int idx = threadIdx.x; idx < TM * kFK; idx += blockDim.x) {
      const int r = idx / kFK, c = idx % kFK;  // x: row r, depth c
      const int gk = k0 + c;
      Xs[c][r] =
          gk < K ? ptt::to_float(x[static_cast<size_t>(m0 + r) * K + gk])
                 : 0.f;
    }
    for (int idx = threadIdx.x; idx < kFK * kGN; idx += blockDim.x) {
      // neighbouring threads read neighbouring addresses of w as stored
      const int kr = kTrans ? idx % kFK : idx / kGN;
      const int nc = kTrans ? idx / kFK : idx % kGN;
      const int gk = k0 + kr, gn = n0 + nc;
      float v = 0.f;
      if (gk < K && gn < N)
        v = ptt::to_float(kTrans ? we[static_cast<size_t>(gn) * K + gk]
                                 : we[static_cast<size_t>(gk) * N + gn]);
      Ws[kr][nc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[kMR], bb[4];
#pragma unroll
      for (int i = 0; i < kMR; ++i) a[i] = Xs[kk][ty * kMR + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N)
        store_out(acc[i][j], be, out, z, m0 + ty * kMR + i, gn, N, act);
    }
}

template <typename T, int TM, bool kTrans>
cudaError_t launch_fwd_fma(const void* x, const void* w, const void* b,
                           const int* gid, void* out, void* z, int R, int K,
                           int N, int E, int bm, int act, cudaStream_t s) {
  const dim3 grid((N + kGN - 1) / kGN, R / TM);
  constexpr int threads = 16 * (TM < 16 ? TM : 16);
  gmm_fwd_fma<T, TM, kTrans><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), gid, static_cast<T*>(out),
      static_cast<T*>(z), K, N, E, bm, act);
  return cudaGetLastError();
}

// f32 and f16: the CUDA-core tiles (f16 loaded and stored as such, f32
// products and sums; the tensor-core route is bf16's alone).
template <typename T, bool kTrans>
cudaError_t fwd_simt(int tm, const void* x, const void* w, const void* b,
                     const int* gid, void* out, void* z, int R, int K, int N,
                     int E, int bm, int act, cudaStream_t s) {
  switch (tm) {
    case 64:
      return launch_fwd_fma<T, 64, kTrans>(x, w, b, gid, out, z, R, K, N, E,
                                           bm, act, s);
    case 32:
      return launch_fwd_fma<T, 32, kTrans>(x, w, b, gid, out, z, R, K, N, E,
                                           bm, act, s);
    case 16:
      return launch_fwd_fma<T, 16, kTrans>(x, w, b, gid, out, z, R, K, N, E,
                                           bm, act, s);
    default:
      return launch_fwd_fma<T, 8, kTrans>(x, w, b, gid, out, z, R, K, N, E,
                                          bm, act, s);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class C, bool kTrans>
cudaError_t launch_fwd_mma(const void* x, const void* w, const void* b,
                           const int* gid, void* out, void* z, int R, int K,
                           int N, int E, int bm, int act, cudaStream_t s) {
  const auto kernel = gmm_fwd_mma<C, kTrans>;
  const size_t smem = C::smem(z != nullptr);
  const cudaError_t err = allow_smem(kernel, C::smem(true));
  if (err != cudaSuccess) return err;
  // 16-byte copies: rows a multiple of 8 values, operands 16-byte aligned
  const bool vec = K % 8 == 0 && (kTrans || N % 8 == 0) && aligned16(x) &&
                   aligned16(w);
  const bool ovec = N % 8 == 0 && aligned16(out) &&
                    (z == nullptr || aligned16(z));
  // z-blocks a tile: the most experts its rows can hold (blocks of bm
  // rows that a tile of kBM rows touches, and no more than E; at least
  // one, which writes the null rows)
  const int touched = C::kBM % bm == 0   ? C::kBM / bm
                      : bm % C::kBM == 0 ? 1
                                         : (C::kBM - 1) / bm + 2;
  const dim3 grid((R + C::kBM - 1) / C::kBM, (N + C::kBN - 1) / C::kBN,
                  std::max(1, std::min(touched, E)));
  kernel<<<grid, C::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), gid, static_cast<bf16*>(out),
      static_cast<bf16*>(z), R, K, N, E, bm, act, vec, ovec);
  return cudaGetLastError();
}

// The bf16 tile for a shape on `device` (see the note at the top).
template <bool kTrans>
cudaError_t fwd_bf16(const void* x, const void* w, const void* b,
                     const int* gid, void* out, void* z, int R, int K, int N,
                     int E, int bm, int act, int device, cudaStream_t s) {
  if (K <= 16)
    return launch_fwd_mma<FwdNarrowK, kTrans>(x, w, b, gid, out, z, R, K, N,
                                              E, bm, act, s);
  if (N <= 16)
    return launch_fwd_mma<FwdNarrowN, kTrans>(x, w, b, gid, out, z, R, K, N,
                                              E, bm, act, s);
  const long long wide_tiles =
      static_cast<long long>((R + 127) / 128) * ((N + 127) / 128);
  const int sms = sm_count(device);
  if (wide_tiles >= sms) {
    if (wide_tiles >= 2LL * sms)  // two blocks an SM hide more latency
      return launch_fwd_mma<FwdWide2, kTrans>(x, w, b, gid, out, z, R, K, N,
                                              E, bm, act, s);
    return launch_fwd_mma<FwdWide, kTrans>(x, w, b, gid, out, z, R, K, N, E,
                                           bm, act, s);
  }
  return launch_fwd_mma<FwdMid, kTrans>(x, w, b, gid, out, z, R, K, N, E, bm,
                                        act, s);
}

// ---- weight gradient ------------------------------------------------------
// First index i of the nondecreasing gid[0, n) with gid[i] >= v.
__device__ __forceinline__ int lower_bound(const int* gid, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (gid[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Rows [begin, end) of slice s of S of expert e's run of blocks: S equal
// runs of whole 16-row groups; slices past the rows are empty.
__device__ __forceinline__ void slice_rows(const int* gid, int nb, int bm,
                                           int e, int s, int S, int& begin,
                                           int& end) {
  const int rb = lower_bound(gid, nb, e) * bm;
  const int re = lower_bound(gid, nb, e + 1) * bm;
  const int per = ((re - rb + S - 1) / S + 15) & ~15;
  begin = min(re, rb + s * per);
  end = min(re, begin + per);
}

// kTK (K) x kTN (N) outputs a block over 4 warps of kWK x kWN, kBR rows a
// step, a ring of kStages steps.
template <int kTK_, int kTN_, int kWK_, int kWN_, int kStages_>
struct Dw {
  static constexpr int kTK = kTK_, kTN = kTN_, kWK = kWK_, kWN = kWN_;
  static constexpr int kBR = 64, kStages = kStages_, kThreads = 128;
  static constexpr int kWarpsN = kTN / kWN;
  static_assert((kTK / kWK) * kWarpsN == 4, "4 warps");
  static constexpr size_t kSmem =
      sizeof(bf16) * kStages * kBR * (kTK + kTN);
};
using DwWide = Dw<128, 128, 64, 64, 3>;
using DwNarrowN = Dw<64, 16, 16, 16, 4>;
using DwNarrowK = Dw<16, 64, 16, 16, 4>;

template <class C>
__global__ void __launch_bounds__(C::kThreads)
    gmm_dw_mma(const bf16* __restrict__ x, const bf16* __restrict__ dz,
               const int* __restrict__ gid, bf16* __restrict__ dw,
               float* __restrict__ part, int nb, int bm, int K, int N, int E,
               int S, bool vec) {
  constexpr int kTK = C::kTK, kTN = C::kTN, kWK = C::kWK, kWN = C::kWN;
  constexpr int kBR = C::kBR, kS = C::kStages, kT = C::kThreads;
  constexpr int kXC = kTK / 8, kDC = kTN / 8;  // chunks of a tile row
  extern __shared__ uint4 smem_gmm[];
  bf16* xs = reinterpret_cast<bf16*>(smem_gmm);  // kS x [kBR][kTK]
  bf16* ds = xs + kS * kBR * kTK;                // kS x [kBR][kTN]
  const int n0 = blockIdx.x * kTN, k0 = blockIdx.y * kTK;
  const int e = blockIdx.z % E, sl = blockIdx.z / E;
  int rb, re;
  slice_rows(gid, nb, bm, e, sl, S, rb, re);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk0 = (warp / C::kWarpsN) * kWK, wn0 = (warp % C::kWarpsN) * kWN;
  const int g = lane >> 2, t = lane & 3;

  auto stage = [&](int step, int slot) {
    const int r0 = rb + step * kBR;
    bf16* xd = xs + slot * kBR * kTK;
    for (int c = threadIdx.x; c < kBR * kXC; c += kT) {
      const int r = c / kXC, ch = c % kXC;
      const int gr = r0 + r, gk = k0 + ch * 8;
      const int avail = gr < re && gk < K ? min(8, K - gk) : 0;
      copy8(xd + swz<kTK>(r, ch), x + static_cast<size_t>(gr) * K + gk,
            avail, vec, x);
    }
    bf16* dd = ds + slot * kBR * kTN;
    for (int c = threadIdx.x; c < kBR * kDC; c += kT) {
      const int r = c / kDC, ch = c % kDC;
      const int gr = r0 + r, gn = n0 + ch * 8;
      const int avail = gr < re && gn < N ? min(8, N - gn) : 0;
      copy8(dd + swz<kTN>(r, ch), dz + static_cast<size_t>(gr) * N + gn,
            avail, vec, dz);
    }
  };

  float acc[kWK / 16][kWN / 8][4];
#pragma unroll
  for (int i = 0; i < kWK / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto compute = [&](int slot) {
    const bf16* xd = xs + slot * kBR * kTK;
    const bf16* dd = ds + slot * kBR * kTN;
#pragma unroll
    for (int rr = 0; rr < kBR; rr += 16) {
      uint32_t fa[kWK / 16][4];  // x^T: rows k, depth r
#pragma unroll
      for (int i = 0; i < kWK / 16; ++i)
        ldmatrix_x4_trans(fa[i], xd + frag_at<kTK>(rr, wk0 + 16 * i, lane));
#pragma unroll
      for (int j = 0; j < kWN / 16; ++j) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, dd + frag_bt<kTN>(rr, wn0 / 16 + j, lane));
#pragma unroll
        for (int i = 0; i < kWK / 16; ++i) {
          mma_bf16(acc[i][2 * j], fa[i], fb[0], fb[1]);
          mma_bf16(acc[i][2 * j + 1], fa[i], fb[2], fb[3]);
        }
      }
    }
  };

  const int steps = (re - rb + kBR - 1) / kBR;
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // step st landed; every warp left step st - 1
    const int nx = st + kS - 1;
    if (nx < steps) stage(nx, nx % kS);
    cp_async_commit();
    compute(st % kS);
  }
  cp_async_wait<0>();

  // S == 1: dw[e] in bf16; else this slice's f32 partial
  const size_t base = static_cast<size_t>(sl * E + e) * K * N;
#pragma unroll
  for (int i = 0; i < kWK / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gk = k0 + wk0 + 16 * i + g + 8 * h;
        const int gn = n0 + wn0 + 8 * j + 2 * t;
        if (gk >= K) continue;
        const size_t o = base + static_cast<size_t>(gk) * N + gn;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (gn + 1 < N && (N & 1) == 0) {  // gn even: an aligned pair
          if (S == 1)
            *reinterpret_cast<__nv_bfloat162*>(dw + o) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
        } else if (gn < N) {
          if (S == 1)
            dw[o] = __float2bfloat16(v0);
          else
            part[o] = v0;
          if (gn + 1 < N) {
            if (S == 1)
              dw[o + 1] = __float2bfloat16(v1);
            else
              part[o + 1] = v1;
          }
        }
      }
}

constexpr int kDT = 64;  // K and N extent of an f32 dw tile

template <typename T>
__global__ void __launch_bounds__(256)
    gmm_dw_fma(const T* __restrict__ x, const T* __restrict__ dz,
               const int* __restrict__ gid, T* __restrict__ dw,
               float* __restrict__ part, int nb, int bm, int K, int N, int E,
               int S) {
  __shared__ float Xs[kFK][kDT + 4];  // Xs[r][k]
  __shared__ float Ds[kFK][kDT + 4];  // Ds[r][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kDT;
  const int k0 = blockIdx.y * kDT;
  const int e = blockIdx.z % E, sl = blockIdx.z / E;
  int r_begin, r_end;
  slice_rows(gid, nb, bm, e, sl, S, r_begin, r_end);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kFK) {
    for (int idx = threadIdx.x; idx < kFK * kDT; idx += blockDim.x) {
      const int r = idx / kDT, c = idx % kDT;
      const int gr = r0 + r;
      const int gk = k0 + c, gn = n0 + c;
      Xs[r][c] = (gr < r_end && gk < K)
                     ? ptt::to_float(x[static_cast<size_t>(gr) * K + gk])
                     : 0.f;
      Ds[r][c] = (gr < r_end && gn < N)
                     ? ptt::to_float(dz[static_cast<size_t>(gr) * N + gn])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kFK; ++rr) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ds[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // S == 1: dw[e] in T; else this slice's f32 partial (the same layout)
  const size_t base = static_cast<size_t>(sl * E + e) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gk < K && gn < N) {
        const size_t o = base + static_cast<size_t>(gk) * N + gn;
        if (S == 1)
          dw[o] = ptt::from_float<T>(acc[i][j]);
        else
          part[o] = acc[i][j];
      }
    }
}

// Output tiles of the dw at a shape: (K tiles, N tiles) of its tile.
void dw_tiles(int K, int N, bool bf, int& tk, int& tn) {
  int ek = kDT, en = kDT;
  if (bf && K <= 16) {
    ek = DwNarrowK::kTK, en = DwNarrowK::kTN;
  } else if (bf && N <= 16) {
    ek = DwNarrowN::kTK, en = DwNarrowN::kTN;
  } else if (bf) {
    ek = DwWide::kTK, en = DwWide::kTN;
  }
  tk = (K + ek - 1) / ek;
  tn = (N + en - 1) / en;
}

// Row slices of the dw: enough for two blocks an SM, each slice at least
// kMinSliceRows of an expert's mean row count, at most 64.
constexpr int kMinSliceRows = 256;
int dw_slices(int R, int K, int N, int E, bool bf, int device) {
  int tk, tn;
  dw_tiles(K, N, bf, tk, tn);
  const long long tiles = static_cast<long long>(tk) * tn * E;
  const long long want = (2LL * sm_count(device) + tiles - 1) / tiles;
  const long long cap = R / E / kMinSliceRows;
  long long s = want < cap ? want : cap;
  if (s > 64) s = 64;
  if (s * E > 65535) s = 65535 / E;
  return s < 1 ? 1 : static_cast<int>(s);
}

template <class C>
cudaError_t launch_dw_mma(const void* x, const void* dz, const int* gid,
                          void* dw, float* part, int nb, int bm, int K, int N,
                          int E, int S, cudaStream_t s) {
  const auto kernel = gmm_dw_mma<C>;
  const cudaError_t err = allow_smem(kernel, C::kSmem);
  if (err != cudaSuccess) return err;
  const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(dz);
  const dim3 grid((N + C::kTN - 1) / C::kTN, (K + C::kTK - 1) / C::kTK,
                  E * S);
  kernel<<<grid, C::kThreads, C::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dz), gid,
      static_cast<bf16*>(dw), part, nb, bm, K, N, E, S, vec);
  return cudaGetLastError();
}

// Rows of an f32 forward tile: the largest of 64, 32, 16, 8 that divides bm.
int row_tile(int bm) {
  for (int tm = 64; tm >= 8; tm >>= 1)
    if (bm % tm == 0) return tm;
  return 0;
}

}  // namespace

// x [R, K]; w [E, K, N] (trans 0) or [E, N, K] (trans 1); b [E, N] or null;
// gid [R / bm] int32, an id outside [0, E) a null block (the forward does
// not need gid sorted); out and z (z may be null) [R, N]; all floats of
// `dtype`.
extern "C" int ptt_grouped_matmul_fwd(const void* x, const void* w,
                                      const void* b, const void* gid,
                                      void* out, void* z, int R, int K, int N,
                                      int E, int bm, int trans, int act,
                                      int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const bool bf = dtype == PTT_DTYPE_BF16;
  const int tm = row_tile(bm);
  if (act < ptt::kActNone || act > ptt::kActSilu || bm < 1 || R % bm != 0 ||
      (!bf && dtype != PTT_DTYPE_F32 && dtype != PTT_DTYPE_F16) ||
      (bf && (bm % 16 != 0 || (N + 63) / 64 > 65535)) ||
      (!bf && (tm == 0 || R / tm > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gid);
  cudaError_t e;
  if (bf)
    e = trans ? fwd_bf16<true>(x, w, b, g, out, z, R, K, N, E, bm, act,
                               device, s)
              : fwd_bf16<false>(x, w, b, g, out, z, R, K, N, E, bm, act,
                                device, s);
  else if (dtype == PTT_DTYPE_F16)
    e = trans ? fwd_simt<__half, true>(tm, x, w, b, g, out, z, R, K, N, E,
                                       bm, act, s)
              : fwd_simt<__half, false>(tm, x, w, b, g, out, z, R, K, N, E,
                                        bm, act, s);
  else
    e = trans ? fwd_simt<float, true>(tm, x, w, b, g, out, z, R, K, N, E, bm,
                                      act, s)
              : fwd_simt<float, false>(tm, x, w, b, g, out, z, R, K, N, E,
                                       bm, act, s);
  return static_cast<int>(e);
}

// Row slices S the dw splits each expert's rows into at this shape on
// `device` (1: no split, no scratch).
extern "C" int ptt_grouped_matmul_dw_slices(int R, int K, int N, int E,
                                            int dtype, int device) {
  if (R < 1 || E < 1) return 1;
  return dw_slices(R, K, N, E, dtype == PTT_DTYPE_BF16, device);
}

// x [R, K] and dz [R, N] of `dtype`; gid [R / bm] int32, nondecreasing, each
// in [0, E]; dw [E, K, N] of `dtype`, every element written.  S row slices
// (`ptt_grouped_matmul_dw_slices`); with S > 1, part is a [S, E, K, N] f32
// scratch the caller allocates (uninitialised: every element is written),
// summed in slice order into dw by a second launch on the same stream.
extern "C" int ptt_grouped_matmul_dw(const void* x, const void* dz,
                                     const void* gid, void* dw, void* part,
                                     int R, int K, int N, int E, int bm,
                                     int S, int dtype, int device,
                                     void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const bool bf = dtype == PTT_DTYPE_BF16;
  if (bm < 1 || R % bm != 0 || E < 1 || S < 1 ||
      static_cast<long long>(E) * S > 65535 || (S > 1 && part == nullptr) ||
      (K + 15) / 16 > 65535 ||
      (!bf && dtype != PTT_DTYPE_F32 && dtype != PTT_DTYPE_F16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = R / bm;
  const int* g = static_cast<const int*>(gid);
  float* p = static_cast<float*>(part);
  cudaError_t err;
  if (bf) {
    if (K <= 16)
      err = launch_dw_mma<DwNarrowK>(x, dz, g, dw, p, nb, bm, K, N, E, S, s);
    else if (N <= 16)
      err = launch_dw_mma<DwNarrowN>(x, dz, g, dw, p, nb, bm, K, N, E, S, s);
    else
      err = launch_dw_mma<DwWide>(x, dz, g, dw, p, nb, bm, K, N, E, S, s);
  } else if (dtype == PTT_DTYPE_F16) {
    const dim3 grid((N + kDT - 1) / kDT, (K + kDT - 1) / kDT, E * S);
    gmm_dw_fma<__half><<<grid, 256, 0, s>>>(
        static_cast<const __half*>(x), static_cast<const __half*>(dz), g,
        static_cast<__half*>(dw), p, nb, bm, K, N, E, S);
    err = cudaGetLastError();
  } else {
    const dim3 grid((N + kDT - 1) / kDT, (K + kDT - 1) / kDT, E * S);
    gmm_dw_fma<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dz), g,
        static_cast<float*>(dw), p, nb, bm, K, N, E, S);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const int n = E * K * N;
  if (bf)
    ptt::column_sum_kernel<bf16><<<(n + 255) / 256, 256, 0, s>>>(
        p, static_cast<bf16*>(dw), S, n);
  else if (dtype == PTT_DTYPE_F16)
    ptt::column_sum_kernel<__half><<<(n + 255) / 256, 256, 0, s>>>(
        p, static_cast<__half*>(dw), S, n);
  else
    ptt::column_sum_kernel<float><<<(n + 255) / 256, 256, 0, s>>>(
        p, static_cast<float*>(dw), S, n);
  return static_cast<int>(cudaGetLastError());
}
