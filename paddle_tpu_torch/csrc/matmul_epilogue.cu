// Matmul with a fused bias + activation epilogue: out = act(x @ w + b),
// and its weight-only int8 twin out = act((x @ w_q) * scale + b).
//
// Replaces: paddle_tpu/ops/pallas_fused.py `_me_fwd_kernel` (:266, called
// at :315), the Pallas matmul-epilogue forward that keeps the bias add and
// the activation out of device memory and optionally saves the
// pre-activation z for the backward; and `_me_int8_fwd_kernel` (:406,
// called at :444 by `fused_linear_act_int8` :516), its int8-weight form:
// w_q [K, N] int8 codes, scale [N] f32 (one per output channel) applied
// to the f32 accumulator after the dot, then the bias (:413-414).
//
// x is [M, K], w is [K, N] as stored (Paddle's [in, out] layout, never
// transposed by a copy), b is [N] (x's type, or f32 for int8 weights).
// z is written only when its pointer is not null: serving passes none.
//
// What bounds it on the H100 at the main path's shapes:
//  * training (M = 4096-8192 rows, K = 2048, N = 8192, bf16): operations,
//    0.14-0.28 ms of tensor-core work a launch at 989 TFLOP/s;
//  * serving fc1 (M = 368, K = 2048, N = 8192): both, ~12.5 us: 12.35
//    GFLOP against 41 MB of traffic (the 33.5 MB weight), ~301 flops a
//    byte, just past the ~295 at which the tensor cores become the
//    limit; int8 codes halve the weight bytes, not that bound;
//  * a decode step (4-8 rows): bytes, the weight streamed once (~10 us
//    for fc1's 33.5 MB at 3.35 TB/s).
// The full tensor-core rate is reached only through `wgmma` fed by TMA;
// the design (bf16 x, `csrc/wgmma.cuh`):
//  * a persistent block an SM, of three warpgroups (four with int8
//    codes), walks over 128 x 128 output tiles (and, under split-K, K
//    chunks).  The producer keeps a ring of stages in flight (as many as
//    fit: 5 for bf16 weights, 4 with int8 codes), each a 128 x 64 slice
//    of x and a 64 x 128 slice of w (two [64][64] boxes), 128-byte
//    swizzled; each
//    stage has a full and an empty mbarrier.  The two consumer
//    warpgroups run `wgmma` m64n128k16 on their 64 rows of a stage that
//    has arrived (x K-major, w MN-major through the instruction's
//    transpose-B form), f32 accumulators in registers, and release the
//    stage once the next stage's products are issued (one group in
//    flight).  The ring runs on across tiles, so the next tile's slices
//    load while the consumers finish this one's epilogue, and the bias
//    and scale load behind the products;
//  * what bounds the loop at the training shapes is the L2 traffic of
//    the stages (a 128 x 128 tile moves 32 KB a 64-deep slice for 2.1
//    MFLOP) and the epilogue, during which the tensor cores wait: trial
//    builds with the loads, the products or the epilogue taken out each
//    ran well short of the whole kernel's time.  Tiles of 256 x 128 (two
//    64-row blocks a warpgroup) and 128 x 256 (m64n256k16) move less a
//    product but measured slower end to end in those trials, and are not
//    used;
//  * two staging routes, chosen at launch (`tma_route`): TMA tile loads
//    where TMA can describe both operands (16-byte aligned bases and row
//    strides: K and N multiples of 8, of 16 for int8 codes: every model
//    shape), else the producer threads stage element by element, zero
//    past the edges, into the same swizzled layout (N = 130 or 9, K =
//    17), followed by the proxy fence;
//  * int8 weights: `wgmma` has no bf16 x int8 form, so the codes become
//    bf16 before the product.  One producer thread loads x's slice and
//    the int8 tile (64 x 128 codes, a ring beside the stages) by TMA as
//    far ahead as the ring allows; seven more producer warps (a second
//    producer warpgroup: 512 threads a block) widen each tile into the
//    stage's swizzled bf16 w slice, fence and arrive (the full barrier
//    counts their 224 arrivals beside x's bytes).  Widening in
//    shared memory keeps the consumers' code the bf16 path's; swapping
//    the operands to widen in registers would put the weight in the A
//    slot as its transpose, which the instruction does not read from
//    registers.  The widening is exact (|code| <= 127: a float's upper
//    half, built with byte permutes and one subtract, `widen4`), so every
//    product is the reference's; only the order of the sum differs;
//  * the epilogue from the accumulators: (* scale, rounded on its own,
//    never fused into an fma), + bias, z cast once and staged, then the
//    activation in f32 (the reference's `_act_f32`, pallas_fused.py:55,
//    `ptt::apply_act`, as the split-K pass and the f32 kernel apply it)
//    and one cast; each warp stages its 16 rows, 64 columns at a time, in
//    its own shared buffers: on the TMA route 128-byte swizzled and
//    written by one TMA store (two buffers, so the next half is staged
//    while the last is stored; the consumers go on to the next tile's
//    products without waiting for the stores), else leaving with 16-byte
//    stores, element by element only where N is off a multiple of 8;
//  * the tiles go in groups of 8 row tiles, each group sweeping the
//    columns, so the w columns the card reads at once stay in L2.
// Where the 128 x 128 tiles do not fill the card's SMs (serving's N =
// 2048 GEMMs: 48 tiles; decode steps: 16-64), the caller splits K
// (`ops/matmul_epilogue.py` `split_k`): work item (tile, z) sums its tile
// over the z-th chunk of whole 64-deep slices and writes the f32 partial
// to `partial` [splits, M, N]; `splitk_epilogue_kernel` adds the chunks
// in order (no atomics: the same sums every run) and applies the same
// epilogue.
//
// f32 x (the parity runs): the tensor cores would round the operands to
// TF32, so the f32 path multiplies on the CUDA cores: 256 threads per
// 64x64 tile, each accumulating a 4x4 micro-tile in registers from
// 16-deep shared slices with fmaf in f32, int8 codes widened to f32 as
// they are staged, split-K over 32-deep slices.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

using ptt::apply_act;
using ptt::kActGelu;
using ptt::kActGeluTanh;
using ptt::kActNone;
using ptt::kActRelu;
using ptt::kActSilu;

// z = acc (* scale, int8 weights) + b; out = act(z).  The scale's product
// is rounded before the bias is added (__fmul_rn is never fused into an
// fma), as the reference computes `z * s + b`.
template <typename T, typename TB>
__device__ __forceinline__ void store_epilogue(float acc, const float* scale,
                                               const TB* b, T* out, T* z,
                                               int gm, int gn, int N,
                                               int act) {
  const float zs = scale != nullptr ? __fmul_rn(acc, scale[gn]) : acc;
  const float zf = zs + ptt::to_float(b[gn]);
  const size_t idx = static_cast<size_t>(gm) * N + gn;
  if (z != nullptr) z[idx] = ptt::from_float<T>(zf);
  out[idx] = ptt::from_float<T>(apply_act(zf, act));
}

// A tile's value at (gm, gn): its epilogue, or under split-K (`partial`
// not null) the f32 partial sum of this block's K chunk, blockIdx.z.
template <typename T, typename TB>
__device__ __forceinline__ void store_or_split(float acc, float* partial,
                                               const float* scale,
                                               const TB* b, T* out, T* z,
                                               int gm, int gn, int M, int N,
                                               int act) {
  if (partial != nullptr)
    partial[(static_cast<size_t>(blockIdx.z) * M + gm) * N + gn] = acc;
  else
    store_epilogue(acc, scale, b, out, z, gm, gn, N, act);
}


// ---- bf16: warpgroup tensor cores fed by TMA -----------------------------
namespace wg {

using namespace ptt::wgmma;

constexpr int kBM = 128;       // tile rows: 64 a consumer warpgroup
constexpr int kBN = 128;       // tile columns: one m64n128k16 a 16-deep step
constexpr int kBK = 64;        // one 128-byte swizzled row of bf16
constexpr int kConsumers = 256;
// The producer threads: one warpgroup (one thread of it loads by TMA, or
// all 128 stage element by element); two for int8 codes by TMA, whose
// warps 1-7 widen the codes.  The two consumer warpgroups follow.
template <bool kWiden>
constexpr int kProducers = kWiden ? 256 : 128;
constexpr int kBoxBytes = kBK * 128;  // one [64 depth][64 columns] w box
constexpr int kSmemMax = 232448;      // 227 KB a block
constexpr int kOutLd = 64 + 8;        // element route: a staged half row
constexpr int kHalfBytes = 16 * 128;  // TMA route: a warp's 16 x 64 half

// Byte offsets in the block's shared memory (from a 1024-byte aligned
// base): the x stages, the w stages, the int8 code stages (int8 weights
// only), each consumer warp's staged output rows (two 1024-byte aligned
// buffers of 16 rows x 64 columns), the tile's bias and scale in two
// buffers (a tile's, the next tile's), then the barriers.
template <bool kInt8>
struct Layout {
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * kBN * 2;
  static constexpr int kRawBytes = kInt8 ? kBK * kBN : 0;
  static constexpr int kOutWarpBytes = 2 * kHalfBytes;  // >= 16 * kOutLd * 2
  static constexpr int kFixed = (kConsumers / 32) * kOutWarpBytes +
                                2 * 2 * kBN * 4 + 1024 + 256;
  // as many stages as fit beside the rest
  static constexpr int kStages =
      (kSmemMax - kFixed) / (kABytes + kBBytes + kRawBytes) < 8
          ? (kSmemMax - kFixed) / (kABytes + kBBytes + kRawBytes)
          : 8;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kStages * kABytes;
  static constexpr int kRaw = kB + kStages * kBBytes;
  static constexpr int kOut = kRaw + kStages * kRawBytes;
  static constexpr int kBias = kOut + (kConsumers / 32) * kOutWarpBytes;
  static constexpr int kBar = kBias + 2 * 2 * kBN * 4;
  static constexpr int kBytes = kBar + 3 * kStages * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static_assert(kStages >= 2 && kAlloc <= kSmemMax,
                "at most 227 KB of shared memory");
};

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(int8_t v) {
  return __float2bfloat16(static_cast<float>(v));
}

// Four int8 codes (one word, lowest first) as four bf16 values (two
// words), exactly: code + 128 goes into the low byte of 2^23's float,
// 2^23 + 128 is subtracted, and the upper half of each float is its bf16
// (a value of at most 8 significant bits has zeros below).
__device__ __forceinline__ uint2 widen4(uint32_t q) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// A stage's 64 x kBN int8 codes (row-major, as TMA left them) widened
// into its swizzled bf16 w boxes by widening thread u (of kWideners).
template <int kWideners>
__device__ __forceinline__ void widen_tile(uint8_t* __restrict__ b_tile,
                                           const uint8_t* __restrict__ raw,
                                           int u) {
  constexpr int kChunks = kBN / 16;  // 16 codes a load
#pragma unroll
  for (int c = u; c < kBK * kChunks; c += kWideners) {
    const int k = c / kChunks, n = (c % kChunks) * 16;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + k * kBN + n);
    const uint2 w0 = widen4(q.x), w1 = widen4(q.y), w2 = widen4(q.z),
                w3 = widen4(q.w);
    uint8_t* box = b_tile + (n / 64) * kBoxBytes;
    const int col = n % 64;
    *reinterpret_cast<uint4*>(box + sw128(k * 128 + col * 2)) =
        make_uint4(w0.x, w0.y, w1.x, w1.y);
    *reinterpret_cast<uint4*>(box + sw128(k * 128 + (col + 8) * 2)) =
        make_uint4(w2.x, w2.y, w3.x, w3.y);
  }
}

// The element-wise route: one stage's x slice (128 rows x 64 deep) and w
// slice (64 deep x kBN) written by the producer warpgroup's thread t into
// the swizzled layout TMA would give, eight values a 16-byte store, zero
// past M, K and N.
template <typename TW>
__device__ __forceinline__ void stage_elements(
    uint8_t* __restrict__ a_tile, uint8_t* __restrict__ b_tile,
    const bf16* __restrict__ x, const TW* __restrict__ w, int m0, int n0,
    int k0, int M, int K, int N, int t) {
  const bf16 zero = __float2bfloat16(0.f);
  alignas(16) bf16 v[8];
  for (int c = t; c < kBM * 8; c += 128) {
    const int r = c >> 3, ch = c & 7;
    const int gm = m0 + r, gk = k0 + 8 * ch;
    const bf16* s = x + static_cast<size_t>(gm) * K + gk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = gm < M && gk + j < K ? s[j] : zero;
    *reinterpret_cast<uint4*>(a_tile + sw128(r * 128 + ch * 16)) =
        *reinterpret_cast<const uint4*>(v);
  }
  constexpr int kChunks = kBN / 8;
  for (int c = t; c < kBK * kChunks; c += 128) {
    const int k = c / kChunks, ch = c % kChunks;
    const int gk = k0 + k, gn = n0 + 8 * ch;
    const TW* s = w + static_cast<size_t>(gk) * N + gn;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = gk < K && gn + j < N ? to_bf16(s[j]) : zero;
    *reinterpret_cast<uint4*>(b_tile + (ch / 8) * kBoxBytes +
                              sw128(k * 128 + (ch % 8) * 16)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The element route's store of one warp's 16 x kBN values (its
// accumulator fragment, `acc`) rounded to bf16, to rows row0.. of dst
// [M, N]: each 64-column half staged in the warp's shared rows, then 16
// bytes a store (element by element where N is off a multiple of 8 or
// the tile's edge).
__device__ __forceinline__ void store_rows(const float (&acc)[kBN / 2],
                                           bf16* __restrict__ stage,
                                           bf16* __restrict__ dst,
                                           int row0, int n0, int M, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bool vec = N % 8 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (8 * half + j) + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * h) * kOutLd +
                                           8 * j + 2 * q) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    __syncwarp();
#pragma unroll
    for (int c = lane; c < 16 * 8; c += 32) {
      const int r = c >> 3, ch = c & 7;
      const int gm = row0 + r, gn = n0 + 64 * half + 8 * ch;
      if (gm < M && gn < N) {
        const bf16* s = stage + r * kOutLd + 8 * ch;
        bf16* d = dst + static_cast<size_t>(gm) * N + gn;
        if (vec) {
          *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
        } else {
          for (int e = 0; e < 8 && gn + e < N; ++e) d[e] = s[e];
        }
      }
    }
    __syncwarp();
  }
}

// The TMA route's store of one warp's 16 x kBN values: each 64-column
// half rounded to bf16 into one of the warp's two buffers, 128-byte
// swizzled (bank-conflict free), fenced, then written by one bulk
// tensor store from lane 0 (rows and columns past M and N left out by
// TMA).  A buffer is rewritten only once its previous store has read it.
__device__ __forceinline__ void tma_store_rows(const float (&acc)[kBN / 2],
                                               uint8_t* __restrict__ bufs,
                                               const CUtensorMap* map,
                                               int row0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint8_t* buf = bufs + half * kHalfBytes;
    if (lane == 0) bulk_wait_read<1>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (8 * half + j) + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(
            buf + sw128((g + 8 * h) * 128 + 16 * j + 4 * q)) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tma_store_2d(map, buf, n0 + 64 * half, row0);
      bulk_commit();
    }
  }
}

// Work item `wi` (a tile and, under split-K, a K chunk): the tile's first
// row and column and its 64-deep slices [kt0, kt0 + nk).  Tiles go in
// groups of 8 row tiles, each group sweeping the columns, so the w
// columns the card reads at once stay in L2.
__device__ __forceinline__ void work_item(int wi, int M, int N, int K,
                                          int chunk_tiles, int& m0, int& n0,
                                          int& kt0, int& nk) {
  const int tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + kBM - 1) / kBM;
  const int tiles = tiles_m * tiles_n;
  const int z = wi / tiles, tile = wi % tiles;
  const int per_group = 8 * tiles_n;
  const int first_m = tile / per_group * 8;
  const int group_m = min(tiles_m - first_m, 8);
  const int in_group = tile % per_group;
  m0 = (first_m + in_group % group_m) * kBM;
  n0 = in_group / group_m * kBN;
  kt0 = z * chunk_tiles;
  nk = max(0, min((K + kBK - 1) / kBK, kt0 + chunk_tiles) - kt0);
}

// TW: the weight's type (bf16, or int8 codes with a per-column
// `scale`); TB: the bias's (bf16, or f32 for int8 weights); kTma: the
// staging route.  Persistent: block b takes work items b, b + gridDim.x,
// ... of the `works` (tiles x K chunks); the stage ring runs on across
// them, so the producer loads the next tile while the consumers finish
// this one's epilogue.  Block: kBlock = kProducers + kConsumers threads.
template <typename TW, typename TB, bool kTma, int kBlock>
__global__ void __launch_bounds__(kBlock, 1)
    me_fwd_wgmma(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_out,
                 const __grid_constant__ CUtensorMap tm_z,
                 const bf16* __restrict__ x, const TW* __restrict__ w,
                 const float* __restrict__ scale, const TB* __restrict__ b,
                 bf16* __restrict__ out, bf16* __restrict__ z,
                 float* __restrict__ partial, int M, int K, int N,
                 int chunk_tiles, int works, int act) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  using L = Layout<kInt8>;
  constexpr int kProd = kBlock - kConsumers;
  static_assert(kProd == kProducers<kTma && kInt8>, "the block's producers");
  constexpr int kWideners = kProd - 32;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* raw_full = empty + kStages;

  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: TMA's single arrival with its bytes, plus the widening
      // threads for int8 codes; the element route's 128 threads
      mbar_init(&full[s], kTma ? (kInt8 ? 1 + kWideners : 1) : 128);
      mbar_init(&empty[s], kConsumers);
      mbar_init(&raw_full[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (t < kProd) {
    // ---- the producer warpgroup: the same sequence of slices as the
    // consumers, `it` counting them across the work items
    uint8_t* a_st = smem + L::kA;
    uint8_t* b_st = smem + L::kB;
    uint8_t* raw = smem + L::kRaw;
    if (kTma && t != 0 && (!kInt8 || t < 32)) return;
    uint32_t it = 0;
    for (int wi = blockIdx.x; wi < works; wi += gridDim.x) {
      int m0, n0, kt0, nk;
      work_item(wi, M, N, K, chunk_tiles, m0, n0, kt0, nk);
      for (int i = 0; i < nk; ++i, ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = (kt0 + i) * kBK;
        mbar_wait(&empty[s], ph ^ 1);
        if constexpr (kTma && !kInt8) {
          mbar_arrive_expect_tx(&full[s], L::kABytes + L::kBBytes);
          tma_load_2d(a_st + s * L::kABytes, &tm_x, &full[s], k0, m0);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(b_st + s * L::kBBytes + j * kBoxBytes, &tm_w,
                        &full[s], n0 + 64 * j, k0);
        } else if constexpr (kTma) {
          if (t == 0) {
            // the loader: x's slice and the codes, as far ahead as the
            // ring lets it
            mbar_arrive_expect_tx(&full[s], L::kABytes);
            tma_load_2d(a_st + s * L::kABytes, &tm_x, &full[s], k0, m0);
            mbar_arrive_expect_tx(&raw_full[s], L::kRawBytes);
            tma_load_2d(raw + s * L::kRawBytes, &tm_w, &raw_full[s], n0, k0);
          } else {
            // the wideners (warps 1-7): the codes into the bf16 slice
            mbar_wait(&raw_full[s], ph);
            widen_tile<kWideners>(b_st + s * L::kBBytes,
                                  raw + s * L::kRawBytes, t - 32);
            fence_proxy_async();
            mbar_arrive(&full[s]);
          }
        } else {
          stage_elements(a_st + s * L::kABytes, b_st + s * L::kBBytes,
                              x, w, m0, n0, k0, M, K, N, t);
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: rows 64 * cw.. of each tile
  const int ct = t - kProd, cw = ct / 128;
  const int warp = (t >> 5) & 3, lane = t & 31, g = lane >> 2, q = lane & 3;
  const uint32_t a_base = smem_u32(smem + L::kA) + cw * 64 * 128;
  const uint32_t b_base = smem_u32(smem + L::kB);
  uint8_t* stage = smem + L::kOut + (ct / 32) * L::kOutWarpBytes;
  uint32_t it = 0, item = 0;
  for (int wi = blockIdx.x; wi < works; wi += gridDim.x, ++item) {
    int m0, n0, kt0, nk;
    work_item(wi, M, N, K, chunk_tiles, m0, n0, kt0, nk);
    // this tile's bias (consumer threads 0-127) and scale (128-255), in
    // f32: loaded now, stored to shared memory after the products, so
    // the load's latency hides behind them
    float pre = 0.f;
    if (partial == nullptr) {
      const int gn = n0 + ct % kBN;
      if (ct < kBN)
        pre = gn < N ? ptt::to_float(b[gn]) : 0.f;
      else
        pre = scale != nullptr && gn < N ? scale[gn] : 1.f;
    }
    float acc[kBN / 2];
#pragma unroll
    for (int r = 0; r < kBN / 2; ++r) acc[r] = 0.f;
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) fence_operand(acc[r]);
      fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma<kBN>(acc, desc_k_major(a_base + s * L::kABytes + kk * 32),
                 desc_mn_major(b_base + s * L::kBBytes + kk * 16 * 128,
                               kBoxBytes),
                 1);
      commit();
      wait<1>();
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) fence_operand(acc[r]);
      // the previous slice's products are done: hand its stage back
      if (i > 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wait<0>();
#pragma unroll
    for (int r = 0; r < kBN / 2; ++r) fence_operand(acc[r]);
    if (nk > 0) mbar_arrive(&empty[(it - 1) % kStages]);

    const int row0 = m0 + 64 * cw + 16 * warp;
    if (partial != nullptr) {
      // split-K: this chunk's f32 sums
      float* p = partial + static_cast<size_t>(kt0 / chunk_tiles) * M * N;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = row0 + g + 8 * h, gn = n0 + 8 * j + 2 * q;
          if (gm >= M) continue;
          float* pr = p + static_cast<size_t>(gm) * N;
          if (gn < N) pr[gn] = acc[4 * j + 2 * h];
          if (gn + 1 < N) pr[gn + 1] = acc[4 * j + 2 * h + 1];
        }
      continue;
    }
    // two buffers: the next tile's cannot overwrite a slow warp's reads
    // of this one's
    float* bias_s = reinterpret_cast<float*>(smem + L::kBias) +
                    (item & 1) * 2 * kBN;
    bias_s[ct] = pre;
    named_barrier(1, kConsumers);
    // z = acc (* scale) + b, the scale's product rounded on its own
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * q + e;
        const float bias = bias_s[col], sc = bias_s[kBN + col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& a = acc[4 * j + 2 * h + e];
          a = (scale != nullptr ? __fmul_rn(a, sc) : a) + bias;
        }
      }
    if constexpr (kTma) {
      if (z != nullptr) tma_store_rows(acc, stage, &tm_z, row0, n0);
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) acc[r] = apply_act(acc[r], act);
      tma_store_rows(acc, stage, &tm_out, row0, n0);
    } else {
      bf16* st = reinterpret_cast<bf16*>(stage);
      if (z != nullptr) store_rows(acc, st, z, row0, n0, M, N);
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) acc[r] = apply_act(acc[r], act);
      store_rows(acc, st, out, row0, n0, M, N);
    }
  }
  // the stores are done before the block's shared memory goes
  if (kTma && lane == 0) bulk_wait_all();
}

// TMA describes both operands: 16-byte aligned bases and row strides
template <typename TW>
bool tma_route(const void* x, const void* w, int K, int N) {
  return tma_ok(x, K, 2) && tma_ok(w, N, sizeof(TW));
}

// A persistent grid: one block an SM (at most one a work item).
template <typename TW, typename TB, bool kTma>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const CUtensorMap& tout, const CUtensorMap& tz,
                   const bf16* x, const TW* w, const float* scale,
                   const TB* b, bf16* out, bf16* z, float* partial, int M,
                   int K, int N, int chunk_tiles, int chunks, int act,
                   int sms, cudaStream_t s) {
  constexpr int kSmem = Layout<std::is_same<TW, int8_t>::value>::kAlloc;
  constexpr int kBlock =
      kProducers<kTma && std::is_same<TW, int8_t>::value> + kConsumers;
  const cudaError_t e = cudaFuncSetAttribute(
      me_fwd_wgmma<TW, TB, kTma, kBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int works = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) * chunks;
  me_fwd_wgmma<TW, TB, kTma, kBlock><<<min(works, sms), kBlock, kSmem, s>>>(
      tx, tw, tout, tz, x, w, scale, b, out, z, partial, M, K, N,
      chunk_tiles, works, act);
  return cudaGetLastError();
}

}  // namespace wg

// ---- f32: CUDA-core register tiles --------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <typename T, typename TW, typename TB>
__global__ void __launch_bounds__(256)
    me_fwd_fma(const T* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ scale, const TB* __restrict__ b,
               T* __restrict__ out, T* __restrict__ z,
               float* __restrict__ partial, int M, int K, int N, int kchunk,
               int act) {
  __shared__ float As[kFK][kFM + 4];  // As[k][m]
  __shared__ float Bs[kFK][kFN + 4];  // Bs[k][n]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kFM;
  const int n0 = blockIdx.x * kFN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // this block's K chunk (all of K without split-K)
  const int k_end = min(K, static_cast<int>(blockIdx.z + 1) * kchunk);
  for (int k0 = blockIdx.z * kchunk; k0 < k_end; k0 += kFK) {
    for (int e = threadIdx.x; e < kFM * kFK; e += blockDim.x) {
      const int r = e / kFK, c = e % kFK;  // x tile: row r, depth c
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < k_end)
                     ? ptt::to_float(x[static_cast<size_t>(gm) * K + gk])
                     : 0.f;
      const int kr = e / kFN, nc = e % kFN;  // w tile: depth kr, col nc
      const int gk2 = k0 + kr, gn = n0 + nc;
      Bs[kr][nc] = (gk2 < k_end && gn < N)
                       ? ptt::to_float(w[static_cast<size_t>(gk2) * N + gn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gm < M && gn < N)
        store_or_split(acc[i][j], partial, scale, b, out, z, gm, gn, M, N,
                       act);
    }
}

// The second pass of split-K: out[m, n] = epilogue(sum over the chunks of
// partial[s, m, n]), the chunks added in order.  One thread per output.
template <typename T, typename TB>
__global__ void __launch_bounds__(256)
    splitk_epilogue_kernel(const float* __restrict__ partial, int splits,
                           const float* __restrict__ scale,
                           const TB* __restrict__ b, T* __restrict__ out,
                           T* __restrict__ z, int M, int N, int act) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= total) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[s * total + idx];
  store_epilogue(acc, scale, b, out, z, static_cast<int>(idx / N),
                 static_cast<int>(idx % N), N, act);
}

// ---- backward of the epilogue --------------------------------------------
// Replaces: paddle_tpu/ops/pallas_fused.py `_me_bwd_kernel` (:278, called
// at :345 by `_matmul_epilogue_2d_bwd`): dz = g * act'(z) from the saved
// pre-activation z, written in z's type, and db = the column sums of the
// f32 dz (before that cast).  dx = dz @ w^T and dw = x^T @ dz stay plain
// GEMMs outside the kernel, as the reference leaves them to XLA.
//
// What bounds it on the H100: bytes (z and g read, dz written; ~20 flops
// per element for the GELUs): 60 us for [4096, 8192] in bf16.  db is a sum
// over every row: the TPU grid walks the row blocks of a column block in
// order and accumulates into a revisited block, but CUDA blocks run in no
// order and float atomics would give other sums on every run, so db takes
// two passes, the first leaving f32 partial rows.
//
// Design, the vector route (`me_bwd_vec_kernel<T, ACT>`), rows of whole
// 16-byte vectors at 16-byte aligned bases (every model's widths, bf16 and
// f32):
//  * the grid is (spans, slices): a block owns a span of 32 vectors of
//    columns (256 bf16 or 128 f32 columns) and a contiguous slice of rows.
//    The slices are as many as one wave of the card's resident blocks
//    holds (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), with at
//    least two rows a warp;
//  * each of the block's 16 warps reads 512 contiguous bytes of a row a
//    load, a lane one 16-byte vector (8 bf16 or 4 f32 columns); warp w
//    takes the slice's rows w, w + 16, ... and loads its next row before
//    it computes this one; dz leaves in 16-byte stores;
//  * the activation is a template parameter, so the inner loop carries no
//    switch; `act_grad` keeps the reference's formulas (tanhf, erff, expf);
//  * each lane adds its columns' f32 dz into registers over its rows; at
//    the end the 16 warps' sums are added in warp order through shared
//    memory into the block's one partial row, partial [slices, N];
//  * the last block of a span to finish (a ticket: one atomic on the
//    span's counter after a fence) adds the span's partial rows into db,
//    its thread groups each over a contiguous run of slices in order, then
//    the groups in order, and sets the counter back to 0.  That saves the
//    second launch the first design made (`ptt::column_sum_kernel`, 32
//    blocks of one thread a column at N = 8192).
// Every sum runs in a fixed order whatever order the blocks finish in, so
// reruns are bit-identical; no float atomics.  Trials with 8 and 32 warps
// a block, rows unrolled 2-8, fewer registers, the next row not loaded
// ahead, a second launch for db, 2-8 waves of blocks, or a block's warps
// on one row's neighbouring spans were no faster
// (`scripts/torch_decode_bwd_sweep.py`).
//
// The element-wise route (`me_bwd_kernel`), rows off 16 bytes: block
// (bx, by) owns 256 columns and the by-th of kBwdChunks chunks of rows;
// each thread walks its one column down the chunk, so a warp reads 32
// neighbouring values a row, and keeps its column's db partial in a
// register; the chunk's partials land in row `by` of `partial` [nchunks,
// N], and `ptt::column_sum_kernel` adds them in a fixed order.
__device__ __forceinline__ float act_grad(float z, int act) {
  // the reference's `_act_grad_f32` (pallas_fused.py:70-87), op for op
  switch (act) {
    case kActRelu:
      return z > 0.f ? 1.f : 0.f;
    case kActGelu: {
      const float phi = 0.3989422804014327f * expf(-0.5f * z * z);
      return 0.5f * (1.f + erff(z / 1.4142135623730951f)) + z * phi;
    }
    case kActGeluTanh: {
      const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
      const float t = tanhf(u);
      const float du = 0.7978845608028654f * (1.f + 3.f * 0.044715f * z * z);
      return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
    }
    case kActSilu: {
      const float s = 1.f / (1.f + expf(-z));
      return s * (1.f + z * (1.f - s));
    }
    default:
      return 1.f;
  }
}

constexpr int kBwdWarps = 16;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdChunks = 64;   // the element-wise route's row chunks

// Whether a backward takes the vector route: rows of whole 16-byte
// vectors, z, g and dz 16-byte aligned (ops/matmul_epilogue.py
// `bwd_vector_route` is the Python copy).
bool bwd_vec_route(const void* z, const void* g, const void* dz, int N,
                   int isz) {
  return N > 0 && (static_cast<long long>(N) * isz) % 16 == 0 &&
         ptt::aligned16(z) && ptt::aligned16(g) && ptt::aligned16(dz);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kBwdThreads)
    me_bwd_vec_kernel(const T* __restrict__ z, const T* __restrict__ g,
                      T* __restrict__ dz, T* __restrict__ dbias,
                      float* __restrict__ partial, int* __restrict__ tickets,
                      int M, int N, int rows_per_slice) {
  using V = ptt::Vec16<T>;
  constexpr int kN = V::kN;
  constexpr int kSpan = 32 * kN;   // a block's columns
  // the partial-row sums of each warp, then of each group of slices
  __shared__ float red[kBwdWarps][kSpan];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = N / kN;
  const int vi = blockIdx.x * 32 + lane;   // this lane's vector of a row
  const bool live = vi < nv;
  const int r0 = blockIdx.y * rows_per_slice;
  const int r1 = min(M, r0 + rows_per_slice);
  const V* zv = reinterpret_cast<const V*>(z);
  const V* gv = reinterpret_cast<const V*>(g);
  V* dv = reinterpret_cast<V*>(dz);
  float db[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) db[j] = 0.f;
  // warp w takes rows r0 + w, r0 + w + kBwdWarps, ...
  V a, b;
  int r = r0 + warp;
  if (live && r < r1) {
    a = zv[static_cast<size_t>(r) * nv + vi];
    b = gv[static_cast<size_t>(r) * nv + vi];
  }
  for (; r < r1; r += kBwdWarps) {
    // the next row's loads in flight while this one is computed
    V na, nb;
    if (live && r + kBwdWarps < r1) {
      na = zv[static_cast<size_t>(r + kBwdWarps) * nv + vi];
      nb = gv[static_cast<size_t>(r + kBwdWarps) * nv + vi];
    }
    if (live) {
      V o;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float d =
            ptt::to_float(b.v[j]) * act_grad(ptt::to_float(a.v[j]), ACT);
        o.v[j] = ptt::from_float<T>(d);
        db[j] += d;
      }
      dv[static_cast<size_t>(r) * nv + vi] = o;
    }
    a = na;
    b = nb;
  }
  // the block's partial row: its warps' sums added in warp order
#pragma unroll
  for (int j = 0; j < kN; ++j) red[warp][lane * kN + j] = db[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kSpan; c += kBwdThreads) {
    const int col = blockIdx.x * kSpan + c;
    if (col < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) s += red[w][c];
      partial[static_cast<size_t>(blockIdx.y) * N + col] = s;
    }
  }
  // the span's last block to finish adds its slices' partial rows: the
  // block's writes, then one thread's fence and ticket (a grid barrier's
  // release pattern); the last resets the counter for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(tickets + blockIdx.x, 1) == gridDim.y - 1;
    if (last) tickets[blockIdx.x] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // kParts groups of threads each add a contiguous run of the slices in
  // order, then the groups' sums are added in group order
  constexpr int kParts = kBwdThreads > kSpan ? kBwdThreads / kSpan : 1;
  const int nslice = gridDim.y;
  const int per = (nslice + kParts - 1) / kParts;
  for (int i = threadIdx.x; i < kParts * kSpan; i += kBwdThreads) {
    const int c = i % kSpan, part = i / kSpan;
    const int col = blockIdx.x * kSpan + c;
    float s = 0.f;
    if (col < N) {
      const int s1 = min(nslice, (part + 1) * per);
#pragma unroll 8
      for (int k = part * per; k < s1; ++k)
        s += __ldcg(partial + static_cast<size_t>(k) * N + col);
    }
    red[part][c] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kSpan; c += kBwdThreads) {
    const int col = blockIdx.x * kSpan + c;
    if (col < N) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kParts; ++k) s += red[k][c];
      dbias[col] = ptt::from_float<T>(s);
    }
  }
}

// The row slices of the vector route's grid for [M, N] of T: as many as
// one wave of the card's resident blocks holds beside the column spans,
// each of at least two rows a warp.
template <typename T>
int bwd_vec_slices(int M, int N, int device) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, me_bwd_vec_kernel<T, kActGeluTanh>, kBwdThreads, 0);
    return n > 0 ? n : 1;
  }();
  const int spans = (N / ptt::Vec16<T>::kN + 31) / 32;
  constexpr int kMinRows = 2 * kBwdWarps;
  long long slices = static_cast<long long>(ptt::sm_count(device)) * per_sm /
                     spans;
  slices = std::min<long long>(slices, (M + kMinRows - 1) / kMinRows);
  slices = std::min<long long>(slices, 65535);
  return static_cast<int>(std::max<long long>(slices, 1));
}

template <typename T, int ACT>
cudaError_t me_bwd_vec(const void* z, const void* g, void* dz, void* db,
                       float* partial, int* tickets, int M, int N,
                       int slices, cudaStream_t s) {
  const int rows_per_slice = (M + slices - 1) / slices;
  const dim3 grid((N / ptt::Vec16<T>::kN + 31) / 32, slices);
  me_bwd_vec_kernel<T, ACT><<<grid, kBwdThreads, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(g), static_cast<T*>(dz),
      static_cast<T*>(db), partial, tickets, M, N, rows_per_slice);
  return cudaGetLastError();
}

template <typename T>
cudaError_t me_bwd_vec_act(const void* z, const void* g, void* dz, void* db,
                           float* partial, int* tickets, int M, int N,
                           int slices, int act, cudaStream_t s) {
  switch (act) {
    case kActRelu:
      return me_bwd_vec<T, kActRelu>(z, g, dz, db, partial, tickets, M, N,
                                     slices, s);
    case kActGelu:
      return me_bwd_vec<T, kActGelu>(z, g, dz, db, partial, tickets, M, N,
                                     slices, s);
    case kActGeluTanh:
      return me_bwd_vec<T, kActGeluTanh>(z, g, dz, db, partial, tickets, M,
                                         N, slices, s);
    case kActSilu:
      return me_bwd_vec<T, kActSilu>(z, g, dz, db, partial, tickets, M, N,
                                     slices, s);
    default:
      return me_bwd_vec<T, kActNone>(z, g, dz, db, partial, tickets, M, N,
                                     slices, s);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    me_bwd_kernel(const T* __restrict__ z, const T* __restrict__ g,
                  T* __restrict__ dz, float* __restrict__ partial, int M,
                  int N, int rows_per_chunk, int act) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float db = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t idx = static_cast<size_t>(r) * N + col;
    const float d =
        ptt::to_float(g[idx]) * act_grad(ptt::to_float(z[idx]), act);
    dz[idx] = ptt::from_float<T>(d);
    db += d;
  }
  partial[static_cast<size_t>(blockIdx.y) * N + col] = db;
}

template <typename T>
cudaError_t me_bwd(const void* z, const void* g, void* dz, void* db,
                   float* partial, int M, int N, int nchunks, int act,
                   cudaStream_t s) {
  const int rows_per_chunk = (M + nchunks - 1) / nchunks;
  const dim3 grid((N + 255) / 256, nchunks);
  me_bwd_kernel<T><<<grid, 256, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(g), static_cast<T*>(dz),
      partial, M, N, rows_per_chunk, act);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ptt::column_sum_kernel<T><<<(N + 255) / 256, 256, 0, s>>>(
      partial, static_cast<T*>(db), nchunks, N);
  return cudaGetLastError();
}

// The partial rows a backward uses: the vector route's slices, else the
// element-wise route's row chunks.
int bwd_parts(const void* z, const void* g, const void* dz, int M, int N,
              int dtype, int device) {
  if (M < 1 || N < 1) return 1;
  const int isz = dtype == PTT_DTYPE_F32 ? 4 : 2;
  if (!bwd_vec_route(z, g, dz, N, isz)) return std::min(M, kBwdChunks);
  return dtype == PTT_DTYPE_F32 ? bwd_vec_slices<float>(M, N, device)
                                : bwd_vec_slices<bf16>(M, N, device);
}

}  // namespace

// dz has z's shape and type; db is [N] of z's type; partial is f32 scratch
// of nparts * N floats, nparts = `ptt_matmul_epilogue_bwd_parts` for the
// same call; tickets: at least ceil(N / 128) int32 counters that are 0
// (each launch leaves them 0).
extern "C" int ptt_matmul_epilogue_bwd(const void* z, const void* g, void* dz,
                                       void* db, void* partial, void* tickets,
                                       int M, int N, int nparts, int act,
                                       int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (act < kActNone || act > kActSilu || M < 1 || N < 1 ||
      (dtype != PTT_DTYPE_BF16 && dtype != PTT_DTYPE_F32) ||
      nparts != bwd_parts(z, g, dz, M, N, dtype, device))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  cudaError_t e;
  if (bwd_vec_route(z, g, dz, N, dtype == PTT_DTYPE_F32 ? 4 : 2)) {
    int* tix = static_cast<int*>(tickets);
    if (tix == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    e = dtype == PTT_DTYPE_BF16
            ? me_bwd_vec_act<bf16>(z, g, dz, db, part, tix, M, N, nparts, act,
                                   s)
            : me_bwd_vec_act<float>(z, g, dz, db, part, tix, M, N, nparts,
                                    act, s);
  } else {
    e = dtype == PTT_DTYPE_BF16
            ? me_bwd<bf16>(z, g, dz, db, part, M, N, nparts, act, s)
            : me_bwd<float>(z, g, dz, db, part, M, N, nparts, act, s);
  }
  return static_cast<int>(e);
}

// The rows of f32 partial sums (of N floats each) a backward of [M, N] at
// these pointers uses.
extern "C" int ptt_matmul_epilogue_bwd_parts(const void* z, const void* g,
                                             const void* dz, int M, int N,
                                             int dtype, int device) {
  return bwd_parts(z, g, dz, M, N, dtype, device);
}

// 1 where a backward takes the vector route, else 0.
extern "C" int ptt_matmul_epilogue_bwd_vector_route(const void* z,
                                                    const void* g,
                                                    const void* dz, int N,
                                                    int dtype) {
  return bwd_vec_route(z, g, dz, N, dtype == PTT_DTYPE_F32 ? 4 : 2) ? 1 : 0;
}

namespace {

// bf16 x: the wgmma forward over (tiles, 1, chunks) and, under split-K
// (splits > 1, `partial` [splits, M, N] f32 scratch), the second pass.
// K is cut into chunks of whole 64-deep slices, so only the last chunk
// is ragged; `chunks` (at most `splits`) is how many that gives.
template <typename TW, typename TB>
cudaError_t me_fwd_bf16(const void* x, const void* w, const float* scale,
                        const void* b, void* out, void* z, void* partial,
                        int splits, int M, int K, int N, int act, int device,
                        cudaStream_t s) {
  constexpr bool kInt8 = std::is_same<TW, int8_t>::value;
  const int k_tiles = (K + wg::kBK - 1) / wg::kBK;
  const bool split = splits > 1 && k_tiles > 0;
  const int chunk_tiles =
      split ? (k_tiles + splits - 1) / splits : (k_tiles > 0 ? k_tiles : 1);
  const int chunks = split ? (k_tiles + chunk_tiles - 1) / chunk_tiles : 1;
  float* part = split ? static_cast<float*>(partial) : nullptr;
  const bf16* xt = static_cast<const bf16*>(x);
  const TW* wt = static_cast<const TW*>(w);
  const TB* bt = static_cast<const TB*>(b);
  bf16* o = static_cast<bf16*>(out);
  bf16* zt = static_cast<bf16*>(z);
  CUtensorMap tx, tw, tout, tz;
  for (CUtensorMap* m : {&tx, &tw, &tout, &tz}) std::memset(m, 0, sizeof(*m));
  cudaError_t e;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      sms < 1)
    return cudaErrorInvalidValue;
  if (wg::tma_route<TW>(x, w, K, N)) {
    const bool maps =
        ptt::wgmma::make_tmap_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                 M, K, wg::kBM, wg::kBK, true) &&
        (kInt8 ? ptt::wgmma::make_tmap_2d(&tw, w,
                                          CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K,
                                          N, wg::kBK, wg::kBN, false)
               : ptt::wgmma::make_tmap_2d(&tw, w,
                                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                          K, N, wg::kBK, 64, true)) &&
        (split || ptt::wgmma::make_tmap_2d(&tout, out,
                                           CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                           2, M, N, 16, 64, true)) &&
        (split || z == nullptr ||
         ptt::wgmma::make_tmap_2d(&tz, z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                  M, N, 16, 64, true));
    if (!maps) return cudaErrorInvalidValue;
    e = wg::launch<TW, TB, true>(tx, tw, tout, tz, xt, wt, scale, bt, o, zt,
                                 part, M, K, N, chunk_tiles, chunks, act, sms,
                                 s);
  } else {
    e = wg::launch<TW, TB, false>(tx, tw, tout, tz, xt, wt, scale, bt, o, zt,
                                  part, M, K, N, chunk_tiles, chunks, act,
                                  sms, s);
  }
  if (e != cudaSuccess || part == nullptr) return e;
  const size_t total = static_cast<size_t>(M) * N;
  splitk_epilogue_kernel<bf16, TB><<<(total + 255) / 256, 256, 0, s>>>(
      part, chunks, scale, bt, o, zt, M, N, act);
  return cudaGetLastError();
}

// f32 x: the CUDA-core forward over a (N/64, M/64, chunks) grid, K cut
// into chunks of whole 32-deep slices, and the same second pass.
constexpr int kF32Slice = 32;

template <typename TW, typename TB>
cudaError_t me_fwd_f32(const void* x, const void* w, const float* scale,
                       const void* b, void* out, void* z, void* partial,
                       int splits, int M, int K, int N, int act,
                       cudaStream_t s) {
  const int kchunk =
      splits > 1
          ? ((K + splits - 1) / splits + kF32Slice - 1) / kF32Slice * kF32Slice
          : K;
  const int chunks = splits > 1 ? (K + kchunk - 1) / kchunk : 1;
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const TB* bt = static_cast<const TB*>(b);
  float* o = static_cast<float*>(out);
  float* zt = static_cast<float*>(z);
  const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM, chunks);
  me_fwd_fma<float, TW, TB><<<grid, 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<const TW*>(w), scale, bt, o,
      zt, part, M, K, N, kchunk, act);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return e;
  const size_t total = static_cast<size_t>(M) * N;
  splitk_epilogue_kernel<float, TB><<<(total + 255) / 256, 256, 0, s>>>(
      part, chunks, scale, bt, o, zt, M, N, act);
  return cudaGetLastError();
}

bool bad_split(int splits, const void* partial) {
  return splits < 1 || splits > 65535 || (splits > 1 && partial == nullptr);
}

}  // namespace

// x [M, K], w [K, N], b [N], out and z (z may be null) [M, N], all of
// `dtype`; `partial` f32 [splits, M, N] when splits > 1 (split-K).
extern "C" int ptt_matmul_epilogue_fwd(const void* x, const void* w,
                                       const void* b, void* out, void* z,
                                       void* partial, int M, int K, int N,
                                       int splits, int act, int dtype,
                                       int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < kActNone || act > kActSilu || bad_split(splits, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == PTT_DTYPE_BF16)
    e = me_fwd_bf16<bf16, bf16>(x, w, nullptr, b, out, z, partial, splits, M,
                                K, N, act, device, s);
  else if (dtype == PTT_DTYPE_F32)
    e = me_fwd_f32<float, float>(x, w, nullptr, b, out, z, partial, splits,
                                 M, K, N, act, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// x [M, K] of `dtype`; w_q [K, N] int8; scale [N] f32; b [N] of
// `bias_dtype`; out [M, N] of `dtype`; `partial` as above.
extern "C" int ptt_matmul_epilogue_int8_fwd(const void* x, const void* w_q,
                                            const void* scale, const void* b,
                                            void* out, void* partial, int M,
                                            int K, int N, int splits,
                                            int act, int dtype,
                                            int bias_dtype, int device,
                                            void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < kActNone || act > kActSilu || bad_split(splits, partial))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  const bool b_f32 = bias_dtype == PTT_DTYPE_F32;
  if (!b_f32 && bias_dtype != PTT_DTYPE_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == PTT_DTYPE_BF16)
    e = b_f32 ? me_fwd_bf16<int8_t, float>(x, w_q, sc, b, out, nullptr,
                                           partial, splits, M, K, N, act,
                                           device, s)
              : me_fwd_bf16<int8_t, bf16>(x, w_q, sc, b, out, nullptr,
                                          partial, splits, M, K, N, act,
                                          device, s);
  else if (dtype == PTT_DTYPE_F32)
    e = b_f32 ? me_fwd_f32<int8_t, float>(x, w_q, sc, b, out, nullptr,
                                          partial, splits, M, K, N, act, s)
              : me_fwd_f32<int8_t, bf16>(x, w_q, sc, b, out, nullptr,
                                         partial, splits, M, K, N, act, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// Which staging route a bf16 forward with these operands takes: 1 TMA,
// 0 element by element (w_bytes: 2 for bf16 weights, 1 for int8 codes).
extern "C" int ptt_matmul_epilogue_tma_route(const void* x, const void* w,
                                             int K, int N, int w_bytes) {
  return w_bytes == 1 ? wg::tma_route<int8_t>(x, w, K, N)
                      : wg::tma_route<bf16>(x, w, K, N);
}
