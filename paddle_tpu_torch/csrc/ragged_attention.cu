// Ragged paged attention: one launch for a mixed prefill + decode batch.
//
// Replaces: paddle_tpu/ops/pallas_ragged.py `_ragged_attn_body` (:115) /
// `_ragged_attn_kernel` (:189, called at :279).
//
// Layout (the TPU kernel's, unchanged):
//   q            [T, H, D]   T = num_q_blocks * block_q flat query rows
//   k/v pools    [num_blocks, H, block_size, D]
//   block_tables [S, W] int32, context_lens [S] int32
//   seq_ids / q_starts / q_valids [num_q_blocks] int32: q-block i belongs
//   to sequence seq_ids[i] (== S: the null segment, all padding), its
//   first row sits at absolute position q_starts[i], and its first
//   q_valids[i] rows are real.
// Row r of q-block i sees key position c iff
//   r < q_valids[i]  &&  c <= q_starts[i] + r  &&  c < context_len,
// so a decode row and a prefill-chunk row fall out of one predicate.  A
// row that sees nothing (padding, the null segment, context 0) is zeros.
//
// What bounds it on the H100: bytes.  At the main path's shapes (H = 16,
// D = 128, block_size = 16, bf16) a decode row does 4 flops per key
// element it reads, and even a 256-row prefill chunk reuses each key
// block for only 16 rows per q-block; the KV blocks dominate the traffic.
// Yet a step's pages are few (the mixed step of the serving drive reads
// about 40 MB of them, 0.012 ms at 3.35 TB/s), so what sets the time is how
// many pages a (q-block, head) walks one after another and how long each
// trip takes.
//
// Three routes: the tensor-core route where `mma_route` allows it, else
// the CUDA-core kernel, for f32 queries (the f32 route) or for bf16 ones
// (the element-wise route).  The wrapper keeps a Python copy of the rule
// and counts each route's launches.
//
// The tensor-core route, bf16 queries with D 64 or 128, 16-row q-blocks, pages a multiple of 16
// slots and 16-byte aligned bases: `ragged_attn_mma_kernel<TKV, kD>` on
// the tensor cores, TKV bf16 (row 1) or int8 codes (row 10).
//  * One block of 4 warps a (q-block, head).  The q-block's 16 rows are
//    one m16 tile: every warp holds Q as `mma.sync` A fragments in
//    registers, loaded once (over int8 pools at D = 128 it reads them
//    from shared memory each tile instead: registers, `kQInRegisters`).
//  * The walk over the keys (16 at a time: a page of 16 slots, or a
//    16-slot slice of a larger page) is split across the warps: warp w
//    takes tiles w, w + 4, w + 8, ..., up to the last tile a valid row can
//    see (the CUDA-core kernel's skip).  The block table's entries for
//    the walk are read into shared memory first, so no copy waits on a
//    dependent global load.  A (page, head) of the pool is one contiguous
//    16 x D tile; each warp fills its own ring of `kStages` stages with
//    16-byte `cp.async` into swizzled rows, the next tiles' copies flying
//    while this one is multiplied, and synchronises with `__syncwarp`
//    only.
//  * S = Q K^T on the tensor cores with f32 sums, then the scale, the
//    mask and an online softmax on the fragments (a row's max and sum
//    over the 4 lanes of a quad; scores scaled by log2(e) so that each
//    exponential is one exp2), each warp with its own m, l and a 16 x D
//    f32 accumulator.  A masked entry gives p = 0 exactly, as the TPU
//    kernel's jnp.where(mask, exp(...), 0): a warp may see nothing of a
//    row (a decode row whose context ends in another warp's tile, an
//    early row of a prefill chunk), and exp(-1e30 - -1e30) would be 1.
//  * P V on the tensor cores with P at f32 precision, as the TPU kernel
//    keeps it: p is split into bf16 hi = bf16(p) and lo = bf16(p - hi)
//    (about 16 bits of p) and both are multiplied, acc += hi V + lo V.
//    One bf16 rounding of P would move the output by up to 2^-9 of a
//    term, which the gate against the plain version with f32
//    probabilities (2^-8 of the RMS + 2^-7 relative) does not allow at
//    the tails.
//  * The 4 partial states (m, l, acc) go to shared memory and are merged
//    in warp order: M = max m_w, L = sum exp(m_w - M) l_w, out =
//    sum exp(m_w - M) acc_w / L.  A warp that saw nothing of a row enters
//    with weight 0; a row no warp saw is zeros.  No atomics: the same
//    bits on every run.
//  * int8 pools (row 10): the codes (|code| <= 127, exact in bf16) are
//    staged as int8, each warp widens its tile to bf16 in shared memory
//    (never to f32; `widen4`, byte permutes and one f32 subtraction per
//    code) and multiplies the codes on the tensor cores.  Each
//    slot's K scale multiplies its score column after the dot, in f32:
//    s = (q . code) * k_scale * scale; each slot's V scale multiplies its
//    probability column before the hi/lo split, while l sums the
//    unscaled p.  Both reassociate against the reference's "dequantize,
//    then dot" at the level of one f32 rounding a term.  The scale tables
//    [nb, bs, 1] f32 are staged with their tile.
//  * Shared memory at D = 128: 4 KB of Q and 16 KB a warp (two stages of
//    K and V; int8: two stages of codes and one widened tile), ~70 KB a
//    block, so 3 blocks fit an SM (228 KB) and a serving step's 368
//    blocks run in one wave on 132 SMs.  Three or four stages (2 or 1
//    blocks an SM) were slower at the mixed step on the H100.
//  * On the H100 at the serving drive's mixed step (16 heads of 128)
//    this route takes about 0.027 ms in bf16 and 0.035 ms over int8
//    pools, 2.2x and 5.4x their byte bounds: the copies alone take about
//    0.025 ms, the products alone 0.020, and the int8 widening adds
//    about 0.011 ms of instructions.
//
// The CUDA-core kernel, f32 queries, and bf16 queries of another D,
// block_q or page size or off 16 bytes: `ragged_attn_kernel<T, TKV>`,
// the first design, on the CUDA
// cores (the tensor cores would round f32 queries to bf16).  One block
// of 128 threads per (q-block, head) walks the block table in order.  The
// block stages its block_q x D queries in shared memory as f32, then for
// each KV block it needs stages K and V with 16-byte loads, computes the
// scores of its valid rows with the mask (eight threads per dot product,
// so a decode row's 16 scores still occupy the whole block), and updates
// an online softmax (running max m, running sum l, accumulator acc, all
// f32 in shared memory).  Rows past q_valids are never computed: a
// decode q-block does one row's work, not block_q's.  The probabilities
// stay in f32 for the PV product; the reference composite rounds them to
// the query type first, which is the only intended difference.  int8
// pools: K/V tiles are read with 16-byte loads (16 codes each), widened
// to f32 and multiplied by their slot's scale as they are staged, before
// the score and PV products, as the TPU kernel dequantizes its VMEM tile
// (pallas_ragged.py:149-150, 168-169).
//
// int8 pools replace: paddle_tpu/ops/pallas_ragged.py
// `_ragged_attn_int8_kernel` (:197, the int8 branch of
// `ragged_paged_attention` :268-279) over the shared body
// `_ragged_attn_body` (:115).  The pools are int8
// [num_blocks, H, block_size, D]; k_scales / v_scales are
// [num_blocks, block_size, 1] f32 (KV_SCALE_LANES = 1), one dequant
// scale per slot shared by every head, walked through the same block
// table as K/V.  q and the output stay f32 or bf16.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr int kLanes = 8;          // threads that share one score's dot

// Copy `rows` rows of `cols` contiguous values of type T into f32 shared
// memory rows `ld` apart: 16 bytes per load where the source allows it.
// With `row_scale` (int8 codes), row r is widened and multiplied by
// row_scale[r] in f32.
template <typename T>
__device__ __forceinline__ void stage_rows(
    float* __restrict__ dst, int ld, const T* __restrict__ src, int rows,
    int cols, bool vec, const float* __restrict__ row_scale = nullptr) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x * kVec; e < rows * cols;
         e += blockDim.x * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + e);
      const T* v = reinterpret_cast<const T*>(&raw);
      const int r = e / cols;
      float* d = dst + r * ld + e % cols;
      if (row_scale != nullptr) {
        const float sc = row_scale[r];
#pragma unroll
        for (int j = 0; j < kVec; ++j) d[j] = ptt::to_float(v[j]) * sc;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) d[j] = ptt::to_float(v[j]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const float f = ptt::to_float(src[e]);
      dst[(e / cols) * ld + e % cols] =
          row_scale != nullptr ? f * row_scale[e / cols] : f;
    }
  }
}

// T: the queries' and the output's type; TKV: the pools' (T, or int8
// codes with per-slot scales k_scales / v_scales [nb, bs], else null).
template <typename T, typename TKV>
__global__ void __launch_bounds__(128)
    ragged_attn_kernel(const T* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       const int* __restrict__ seq_ids,
                       const int* __restrict__ q_starts,
                       const int* __restrict__ q_valids, T* __restrict__ out,
                       int num_seqs, int H, int D, int bs, int W,
                       int block_q, float scale) {
  // q and K rows are padded to D + 8 floats: the four 8-lane groups of
  // a warp read four different rows at the same offsets, which D + 8
  // spreads over disjoint banks (a stride of D would stack them)
  const int ld = D + kLanes;
  extern __shared__ float smem[];
  float* qs = smem;                 // [block_q][D + 8]
  float* ks = qs + block_q * ld;    // [bs][D + 8]
  float* vs = ks + bs * ld;         // [bs][D]
  float* acc = vs + bs * D;         // [block_q][D]
  float* p = acc + block_q * D;     // [block_q][bs] scores, then probs
  float* m = p + block_q * bs;      // [block_q]
  float* l = m + block_q;           // [block_q]
  float* alpha = l + block_q;       // [block_q]

  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int sid = seq_ids[i];
  const bool real = sid >= 0 && sid < num_seqs;  // else the null segment
  const int ctx = real ? context_lens[sid] : 0;
  const int q0 = q_starts[i];
  const int qv = q_valids[i];
  const size_t row0 = static_cast<size_t>(i) * block_q;

  // 16-byte copies need 16-byte aligned bases and D filling whole vectors
  // (every row and pool block then starts on a 16-byte boundary)
  const bool q_vec = D % (16 / sizeof(T)) == 0 &&
                     (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const bool kv_vec = D % (16 / sizeof(TKV)) == 0 &&
                      ((reinterpret_cast<uintptr_t>(k_pool) |
                        reinterpret_cast<uintptr_t>(v_pool)) & 15) == 0;
  for (int r = 0; r < block_q; ++r)
    stage_rows<T>(qs + r * ld, ld, q + ((row0 + r) * H + h) * D, 1, D,
                  q_vec);
  for (int e = tid; e < block_q * D; e += nt) acc[e] = 0.f;
  for (int r = tid; r < block_q; r += nt) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  __syncthreads();

  // keys past the context or past the last valid row's causal bound are
  // invisible to every row: skip their blocks entirely
  const int kv_end = qv > 0 ? min(ctx, q0 + qv) : 0;
  const int nblk = min(W, (kv_end + bs - 1) / bs);
  const int* table = block_tables + static_cast<size_t>(real ? sid : 0) * W;

  for (int w = 0; w < nblk; ++w) {
    const size_t base = (static_cast<size_t>(table[w]) * H + h) * bs * D;
    const size_t slot0 = static_cast<size_t>(table[w]) * bs;
    stage_rows<TKV>(ks, ld, k_pool + base, bs, D, kv_vec,
                    k_scales != nullptr ? k_scales + slot0 : nullptr);
    stage_rows<TKV>(vs, D, v_pool + base, bs, D, kv_vec,
                    v_scales != nullptr ? v_scales + slot0 : nullptr);
    __syncthreads();

    // rows past q_valids see nothing: only the valid rows are computed
    // (a decode q-block has one), the others keep l = 0 and emit zeros.
    // Each score's dot product is split over kLanes threads and reduced
    // with shuffles; the loop runs the same trips in every lane of the
    // block, so the shuffles always see the full warp.
    const int lane = tid % kLanes;
    for (int e0 = 0; e0 < qv * bs; e0 += nt / kLanes) {
      const int e = e0 + tid / kLanes;
      const int r = e / bs, c = e % bs;
      const int col = w * bs + c;
      const bool visible = e < qv * bs && col <= q0 + r && col < ctx;
      float dot = 0.f;
      if (visible) {
        const float* qr = qs + r * ld;
        const float* kc = ks + c * ld;
        for (int d = lane; d < D; d += kLanes) dot = fmaf(qr[d], kc[d], dot);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0 && e < qv * bs)
        p[e] = visible ? dot * scale : -INFINITY;  // -inf marks masked
    }
    __syncthreads();

    for (int r = tid; r < qv; r += nt) {
      float* pr = p + r * bs;
      float mx = m[r];
      for (int c = 0; c < bs; ++c) mx = fmaxf(mx, pr[c]);
      float sum = 0.f;
      for (int c = 0; c < bs; ++c) {
        const float e = pr[c] == -INFINITY ? 0.f : expf(pr[c] - mx);
        pr[c] = e;
        sum += e;
      }
      const float a = expf(m[r] - mx);
      l[r] = a * l[r] + sum;
      m[r] = mx;
      alpha[r] = a;
    }
    __syncthreads();

    for (int e = tid; e < qv * D; e += nt) {
      const int r = e / D, d = e % D;
      const float* pr = p + r * bs;
      float pv = 0.f;
      for (int c = 0; c < bs; ++c) pv = fmaf(pr[c], vs[c * D + d], pv);
      acc[e] = acc[e] * alpha[r] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < block_q * D; e += nt) {
    const int r = e / D, d = e % D;
    const float lr = l[r];
    out[((row0 + r) * H + h) * D + d] =
        ptt::from_float<T>(lr > 0.f ? acc[e] / lr : 0.f);
  }
}

template <typename T, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scales, const float* v_scales,
           const int* block_tables, const int* context_lens,
           const int* seq_ids, const int* q_starts, const int* q_valids,
           void* out, int num_q_blocks, int num_seqs, int H, int D, int bs,
           int W, int block_q, float scale, cudaStream_t s) {
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(block_q) * (2 * D + kLanes) +
       static_cast<size_t>(bs) * (2 * D + kLanes) +
       static_cast<size_t>(block_q) * bs + 3 * static_cast<size_t>(block_q));
  cudaError_t err = cudaFuncSetAttribute(
      ragged_attn_kernel<T, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(num_q_blocks, H);
  ragged_attn_kernel<T, TKV><<<grid, 128, smem, s>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), k_scales, v_scales, block_tables,
      context_lens, seq_ids, q_starts, q_valids, static_cast<T*>(out),
      num_seqs, H, D, bs, W, block_q, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The tensor-core route (see the note at the top)
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using namespace ptt::mma;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16;   // a bf16 q-block: one m16 tile
constexpr int kTileKeys = 16;  // keys a step of the walk

// Shared memory of one warp (bytes), for pools of TKV and heads of kD.
template <typename TKV, int kD>
struct MmaSmem {
  static constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  static constexpr int kStages = 2;
  // one side (K or V) of a tile as staged: bf16 values, or int8 codes
  static constexpr int kSide = kTileKeys * kD * static_cast<int>(sizeof(TKV));
  // a stage: K, V, and for int8 the tile's 16 K then 16 V scales
  static constexpr int kStage = 2 * kSide + (kInt8 ? 2 * kTileKeys * 4 : 0);
  // int8: the K and V codes of the current tile widened to bf16
  static constexpr int kWide = kInt8 ? 2 * kTileKeys * kD * 2 : 0;
  // after the walk: the warp's partial acc [16][kD + 8] f32, m and l [16]
  static constexpr int kLd = kD + 8;
  static constexpr int kPart = (kMmaRows * kLd + 2 * kMmaRows) * 4;
  static constexpr int kRing = kStages * kStage + kWide;
  static constexpr int kWarp = kRing > kPart ? kRing : kPart;
  // Q as A fragments in registers for the whole walk, except over int8
  // pools at D = 128: there the widening needs one register more than 3
  // blocks an SM leave (168), so Q is read again from shared memory
  static constexpr bool kQInRegisters = !(kInt8 && kD == 128);
  // Q, the warps' regions, then the walk's page ids (W of them)
  static size_t bytes(int W) {
    return static_cast<size_t>(kMmaRows) * kD * 2 +
           static_cast<size_t>(kMmaWarps) * kWarp +
           static_cast<size_t>(W) * 4;
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warp's copies of one side of a tile: 16 rows of kD values from
// `src` (contiguous).  bf16 into a swizzled [16][kD] tile, int8 codes
// into plain rows.
template <typename TKV, int kD>
__device__ __forceinline__ void stage_side(unsigned char* dst,
                                           const TKV* src, int lane) {
  if constexpr (std::is_same<TKV, int8_t>::value) {
    for (int c = lane; c < kTileKeys * kD / 16; c += 32)
      cp_async_16(dst + c * 16, src + c * 16, 16);
  } else {
    constexpr int kChunks = kD / 8;
    bf16* d = reinterpret_cast<bf16*>(dst);
    for (int c = lane; c < kTileKeys * kChunks; c += 32)
      cp_async_16(d + swz<kD>(c / kChunks, c % kChunks), src + c * 8, 16);
  }
}

// Four int8 codes (one 32-bit word) as two bf16 pairs, exactly: byte i
// + 128 goes into the low byte of the f32 2^23 (so the float is 2^23 +
// code + 128), one subtraction leaves the code, and a code's bf16 is the
// upper half of its f32 (|code| <= 127 has at most 7 significant bits).
__device__ __forceinline__ void widen4(uint32_t word, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;  // each byte: code + 128
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + i)) -
           8388736.f;  // 2^23 + 128
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// One warp widens one side's staged int8 codes (plain rows) to a
// swizzled bf16 [16][kD] tile.
template <int kD>
__device__ __forceinline__ void widen_side(bf16* dst,
                                           const unsigned char* src,
                                           int lane) {
  constexpr int kPerRow = kD / 16;  // 16-code chunks a row
  for (int c = lane; c < kTileKeys * kPerRow; c += 32) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + c * 16);
    uint32_t w[8];
    widen4(raw.x, w[0], w[1]);
    widen4(raw.y, w[2], w[3]);
    widen4(raw.z, w[4], w[5]);
    widen4(raw.w, w[6], w[7]);
    const int r = c / kPerRow, cc = 2 * (c % kPerRow);
    *reinterpret_cast<uint4*>(dst + swz<kD>(r, cc)) =
        make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(dst + swz<kD>(r, cc + 1)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// bf16 queries; TKV: bf16 pools, or int8 codes with per-slot scales
// k_scales / v_scales [nb, bs] (else null).  block_q is kMmaRows, D is
// kD, bs a multiple of kTileKeys.
template <typename TKV, int kD>
__global__ void __launch_bounds__(kMmaThreads, 3)
    ragged_attn_mma_kernel(const bf16* __restrict__ q,
                           const TKV* __restrict__ k_pool,
                           const TKV* __restrict__ v_pool,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ context_lens,
                           const int* __restrict__ seq_ids,
                           const int* __restrict__ q_starts,
                           const int* __restrict__ q_valids,
                           bf16* __restrict__ out, int num_seqs, int H,
                           int bs, int W, float scale) {
  using Sm = MmaSmem<TKV, kD>;
  constexpr int kStages = Sm::kStages;
  constexpr int kChunks = kD / 8;  // 16-byte chunks of a bf16 row
  extern __shared__ uint4 smem_rg[];
  bf16* qS = reinterpret_cast<bf16*>(smem_rg);  // [16][kD] swizzled
  unsigned char* regions = reinterpret_cast<unsigned char*>(qS + kMmaRows * kD);
  int* pages = reinterpret_cast<int*>(regions + kMmaWarps * Sm::kWarp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int i = blockIdx.x, h = blockIdx.y;
  const int sid = seq_ids[i];
  const bool real = sid >= 0 && sid < num_seqs;  // else the null segment
  const int ctx = real ? context_lens[sid] : 0;
  const int q0 = q_starts[i];
  const int qv = q_valids[i];
  const size_t row0 = static_cast<size_t>(i) * kMmaRows;

  // keys past the context or past the last valid row's causal bound are
  // invisible to every row: the walk stops before them
  const int kv_end = qv > 0 ? min(ctx, q0 + qv) : 0;
  const int per_page = bs / kTileKeys;
  const int ntiles = min(W * per_page, (kv_end + kTileKeys - 1) / kTileKeys);
  if (ntiles <= 0) {  // no row sees a key: zeros
    for (int c = tid; c < kMmaRows * kChunks; c += kMmaThreads)
      *reinterpret_cast<uint4*>(out + ((row0 + c / kChunks) * H + h) * kD +
                                (c % kChunks) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int* table = block_tables + static_cast<size_t>(real ? sid : 0) * W;
  for (int p = tid; p < (ntiles + per_page - 1) / per_page; p += kMmaThreads)
    pages[p] = table[p];
  for (int c = tid; c < kMmaRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    cp_async_16(qS + swz<kD>(r, cc), q + ((row0 + r) * H + h) * kD + cc * 8,
                16);
  }
  cp_async_commit();
  __syncthreads();  // the page ids

  unsigned char* mine = regions + warp * Sm::kWarp;
  // the warp's tiles: warp, warp + 4, ... below ntiles
  const int nmine =
      ntiles > warp ? (ntiles - warp + kMmaWarps - 1) / kMmaWarps : 0;
  // the warp's j-th tile into stage j % kStages
  auto issue = [&](int j) {
    const int t = warp + j * kMmaWarps;
    const int page = pages[t / per_page], sub = (t % per_page) * kTileKeys;
    const size_t row =  // the tile's first row of the pool [nb * H * bs, D]
        (static_cast<size_t>(page) * H + h) * bs + sub;
    unsigned char* st = mine + (j % kStages) * Sm::kStage;
    stage_side<TKV, kD>(st, k_pool + row * kD, lane);
    stage_side<TKV, kD>(st + Sm::kSide, v_pool + row * kD, lane);
    if constexpr (Sm::kInt8) {
      const size_t slot = static_cast<size_t>(page) * bs + sub;
      if (lane < 8)
        cp_async_16(st + 2 * Sm::kSide + lane * 16,
                    (lane < 4 ? k_scales : v_scales) + slot + (lane & 3) * 4,
                    16);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nmine) issue(j);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // this thread's Q copies
  __syncthreads();               // everyone's
  uint32_t qf[Sm::kQInRegisters ? kD / 16 : 1][4];
  if constexpr (Sm::kQInRegisters) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      ldmatrix_x4(qf[kk], qS + frag_a<kD>(0, kk, lane));
  }

  // scores in base 2 (exp2 is one instruction): s * scale * log2(e)
  const float scale2 = scale * 1.4426950408889634f;
  // the keys row g + 8x sees: c < lim[x]
  int lim[2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
    lim[x] = g + 8 * x < qv ? min(ctx, q0 + g + 8 * x + 1) : 0;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < nmine; ++j) {
    if (j + kStages - 1 < nmine) issue(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of tile j have landed
    const unsigned char* st = mine + (j % kStages) * Sm::kStage;
    const bf16* kt = reinterpret_cast<const bf16*>(st);
    const bf16* vt = reinterpret_cast<const bf16*>(st + Sm::kSide);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * Sm::kSide);
    const float* vsc = ksc + kTileKeys;
    if constexpr (Sm::kInt8) {
      bf16* wide = reinterpret_cast<bf16*>(mine + kStages * Sm::kStage);
      widen_side<kD>(wide, st, lane);
      widen_side<kD>(wide + kTileKeys * kD, st + Sm::kSide, lane);
      __syncwarp();
      kt = wide;
      vt = wide + kTileKeys * kD;
    }
    const int c0 = (warp + j * kMmaWarps) * kTileKeys;

    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t fb[4];
      ldmatrix_x4(fb, kt + frag_b<kD>(0, kk, lane));
      if constexpr (Sm::kQInRegisters) {
        mma_bf16(s[0], qf[kk], fb[0], fb[1]);
        mma_bf16(s[1], qf[kk], fb[2], fb[3]);
      } else {
        uint32_t fa[4];
        ldmatrix_x4(fa, qS + frag_a<kD>(0, kk, lane));
        mma_bf16(s[0], fa, fb[0], fb[1]);
        mma_bf16(s[1], fa, fb[2], fb[3]);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * jj + 2 * tq + (e & 1);
        float v = s[jj][e];
        if constexpr (Sm::kInt8) v *= ksc[cl];
        // -inf marks masked
        s[jj][e] = c0 + cl < lim[e >> 1] ? v * scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[jj][e]);
      }
    float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) m_new[x] = fmaxf(m[x], quad_max(mx[x]));
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[jj][e] == -INFINITY ? 0.f : exp2f(s[jj][e] - m_new[e >> 1]);
        psum[e >> 1] += p;
        s[jj][e] = p;
        if constexpr (Sm::kInt8) s[jj][e] *= vsc[8 * jj + 2 * tq + (e & 1)];
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float alpha = exp2f(m[x] - m_new[x]);
      l[x] = alpha * l[x] + quad_sum(psum[x]);
      m[x] = m_new[x];
#pragma unroll
      for (int jd = 0; jd < kD / 8; ++jd) {
        acc[jd][2 * x] *= alpha;
        acc[jd][2 * x + 1] *= alpha;
      }
    }
    // P at f32 precision as bf16 hi + lo, the A fragments of 16 keys
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float* c = s[x >> 1] + 2 * (x & 1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(c[0], c[1]);
      ahi[x] = *reinterpret_cast<const uint32_t*>(&hi);
      alo[x] = pack_bf16(c[0] - __bfloat162float(hi.x),
                         c[1] - __bfloat162float(hi.y));
    }
#pragma unroll
    for (int dj = 0; dj < kD / 16; ++dj) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, vt + frag_bt<kD>(0, dj, lane));
      mma_bf16(acc[2 * dj], ahi, fb[0], fb[1]);
      mma_bf16(acc[2 * dj + 1], ahi, fb[2], fb[3]);
      mma_bf16(acc[2 * dj], alo, fb[0], fb[1]);
      mma_bf16(acc[2 * dj + 1], alo, fb[2], fb[3]);
    }
    __syncwarp();  // tile j is read before its stage is refilled
  }
  cp_async_wait<0>();  // nothing in flight before the region is reused
  __syncwarp();

  // the warp's partial state: acc [16][kLd], then m [16] and l [16]
  float* part = reinterpret_cast<float*>(mine);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = g + 8 * x;
#pragma unroll
    for (int jd = 0; jd < kD / 8; ++jd)
      *reinterpret_cast<float2*>(part + r * Sm::kLd + 8 * jd + 2 * tq) =
          make_float2(acc[jd][2 * x], acc[jd][2 * x + 1]);
    if (tq == 0) {
      part[kMmaRows * Sm::kLd + r] = m[x];
      part[kMmaRows * Sm::kLd + kMmaRows + r] = l[x];
    }
  }
  __syncthreads();

  // merge the 4 partial states in warp order, 8 columns a thread
  for (int c = tid; c < kMmaRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8;
    float mw[kMmaWarps], lw[kMmaWarps], mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float* pw = reinterpret_cast<const float*>(regions + w * Sm::kWarp);
      mw[w] = pw[kMmaRows * Sm::kLd + r];
      lw[w] = pw[kMmaRows * Sm::kLd + kMmaRows + r];
      mx = fmaxf(mx, mw[w]);
    }
    float o[8] = {}, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      // an empty state (l = 0: nothing of this row seen) weighs 0
      const float f = lw[w] > 0.f ? exp2f(mw[w] - mx) : 0.f;
      const float* a = reinterpret_cast<const float*>(regions + w * Sm::kWarp) +
                       r * Sm::kLd + d0;
      lsum += f * lw[w];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] += f * a[e];
    }
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      packed[e] = lsum > 0.f ? pack_bf16(o[2 * e] / lsum, o[2 * e + 1] / lsum)
                             : 0u;
    *reinterpret_cast<uint4*>(out + ((row0 + r) * H + h) * kD + d0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The tensor-core route's domain: bf16 queries, D 64 or 128, q-blocks of
// 16 rows, pages a multiple of 16 slots, every base 16-byte aligned
// (ops/ragged.py `mma_route` is the Python copy).
bool mma_route(const void* q, const void* k_pool, const void* v_pool,
               const void* k_scales, const void* v_scales, const void* out,
               int D, int bs, int block_q, int dtype) {
  return dtype == PTT_DTYPE_BF16 && (D == 64 || D == 128) && bs > 0 &&
         bs % kTileKeys == 0 && block_q == kMmaRows && aligned16(q) &&
         aligned16(k_pool) && aligned16(v_pool) && aligned16(k_scales) &&
         aligned16(v_scales) && aligned16(out);
}

template <typename TKV, int kD>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const float* k_scales, const float* v_scales,
               const int* block_tables, const int* context_lens,
               const int* seq_ids, const int* q_starts, const int* q_valids,
               void* out, int num_q_blocks, int num_seqs, int H, int bs,
               int W, float scale, cudaStream_t s) {
  const size_t smem = MmaSmem<TKV, kD>::bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_attn_mma_kernel<TKV, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(num_q_blocks, H);
  ragged_attn_mma_kernel<TKV, kD><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), k_scales, v_scales, block_tables,
      context_lens, seq_ids, q_starts, q_valids, static_cast<bf16*>(out),
      num_seqs, H, bs, W, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int launch_mma_d(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scales, const float* v_scales,
                 const int* block_tables, const int* context_lens,
                 const int* seq_ids, const int* q_starts, const int* q_valids,
                 void* out, int num_q_blocks, int num_seqs, int H, int D,
                 int bs, int W, float scale, cudaStream_t s) {
  if (D == 64)
    return launch_mma<TKV, 64>(q, k_pool, v_pool, k_scales, v_scales,
                               block_tables, context_lens, seq_ids, q_starts,
                               q_valids, out, num_q_blocks, num_seqs, H, bs,
                               W, scale, s);
  return launch_mma<TKV, 128>(q, k_pool, v_pool, k_scales, v_scales,
                              block_tables, context_lens, seq_ids, q_starts,
                              q_valids, out, num_q_blocks, num_seqs, H, bs, W,
                              scale, s);
}

}  // namespace

extern "C" int ptt_ragged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* context_lens, const void* seq_ids,
    const void* q_starts, const void* q_valids, void* out, int num_q_blocks,
    int num_seqs, int H, int D, int bs, int W, int block_q, float scale,
    int dtype, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  const int* sid = static_cast<const int*>(seq_ids);
  const int* qs = static_cast<const int*>(q_starts);
  const int* qv = static_cast<const int*>(q_valids);
  if (mma_route(q, k_pool, v_pool, nullptr, nullptr, out, D, bs, block_q,
                dtype))
    return launch_mma_d<bf16>(q, k_pool, v_pool, nullptr, nullptr, bt, cl,
                              sid, qs, qv, out, num_q_blocks, num_seqs, H, D,
                              bs, W, scale, s);
  if (dtype == PTT_DTYPE_F32)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, bt, cl,
                                sid, qs, qv, out, num_q_blocks, num_seqs, H,
                                D, bs, W, block_q, scale, s);
  if (dtype == PTT_DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, bt, cl, sid, qs, qv, out,
        num_q_blocks, num_seqs, H, D, bs, W, block_q, scale, s);
  if (dtype == PTT_DTYPE_F16)   // f32's CUDA-core kernel on f16 rows
    return launch<__half, __half>(q, k_pool, v_pool, nullptr, nullptr, bt,
                                  cl, sid, qs, qv, out, num_q_blocks,
                                  num_seqs, H, D, bs, W, block_q, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8 pools' entry: k_pool / v_pool int8, k_scales / v_scales f32
// [num_blocks, bs] (one lane); q and out of `dtype`.
extern "C" int ptt_ragged_attention_int8_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* context_lens, const void* seq_ids, const void* q_starts,
    const void* q_valids, void* out, int num_q_blocks, int num_seqs, int H,
    int D, int bs, int W, int block_q, float scale, int dtype, int device,
    void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ksc = static_cast<const float*>(k_scales);
  const float* vsc = static_cast<const float*>(v_scales);
  if (ksc == nullptr || vsc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  const int* sid = static_cast<const int*>(seq_ids);
  const int* qs = static_cast<const int*>(q_starts);
  const int* qv = static_cast<const int*>(q_valids);
  if (mma_route(q, k_pool, v_pool, ksc, vsc, out, D, bs, block_q, dtype))
    return launch_mma_d<int8_t>(q, k_pool, v_pool, ksc, vsc, bt, cl, sid, qs,
                                qv, out, num_q_blocks, num_seqs, H, D, bs, W,
                                scale, s);
  if (dtype == PTT_DTYPE_F32)
    return launch<float, int8_t>(q, k_pool, v_pool, ksc, vsc, bt, cl, sid,
                                 qs, qv, out, num_q_blocks, num_seqs, H, D,
                                 bs, W, block_q, scale, s);
  if (dtype == PTT_DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, ksc, vsc, bt, cl,
                                         sid, qs, qv, out, num_q_blocks,
                                         num_seqs, H, D, bs, W, block_q,
                                         scale, s);
  if (dtype == PTT_DTYPE_F16)
    return launch<__half, int8_t>(q, k_pool, v_pool, ksc, vsc, bt, cl, sid,
                                  qs, qv, out, num_q_blocks, num_seqs, H, D,
                                  bs, W, block_q, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Whether `ptt_ragged_attention_fwd` (k_scales / v_scales null) or
// `ptt_ragged_attention_int8_fwd` takes the tensor-core route on these
// arguments (1) or a CUDA-core kernel (0).
extern "C" int ptt_ragged_attention_mma_route(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* out, int D,
    int bs, int block_q, int dtype) {
  return mma_route(q, k_pool, v_pool, k_scales, v_scales, out, D, bs,
                   block_q, dtype)
             ? 1
             : 0;
}
