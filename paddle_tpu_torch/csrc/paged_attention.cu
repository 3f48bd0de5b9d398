// Paged decode attention: one query row per (sequence, head) against the
// sequence's pages of a paged KV pool.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_paged_attn_kernel` (:898,
// called from `paged_attention` :964), the decode mode of
// `PagedLayerCache.attend` (inference/serving/attention.py:383).
//
// Layout (the TPU kernel's, unchanged):
//   q            [B, 1, H, D]
//   k/v pools    [num_blocks, H, block_size, D]
//   block_tables [B, W] int32 (entries past the context are padding)
//   context_lens [B] int32
// Sequence b sees the keys at positions [0, context_lens[b]), position c
// in page block_tables[b][c / block_size] at offset c % block_size.  A
// sequence with context 0 gives zeros.  q, the pools and the output share
// one type (f32 or bf16); every product and sum is f32.
//
// What bounds it on the H100: bytes.  Each visible key element read feeds
// 4 flops.  At the paged drive's decode step (B = 4, H = 16, D = 128,
// contexts of 129-192 keys, bf16) the visible K/V rows are ~1.3 MB, 0.4
// us at 3.35 TB/s, so a launch and the chain of dependent round trips to
// device memory (context length, page ids, K/V rows, the merge) bound it;
// at a long decode (4 sequences of 4096 keys) the 134 MB of K and V take
// 40 us and the memory's rate bounds it.
//
// Two routes, picked at launch (`vec_route`; ops/paged.py `vector_route`
// is the Python copy):
//
// The vector route (`paged_attn_vec_kernel<T, G, VPL>`), rows of D values
// that are whole 16-byte vectors at 16-byte aligned bases (every model's
// heads, bf16 and f32), the flash-decoding design:
//  * The key walk is split across blocks: the grid is (S, H, B), block
//    (s, h, b) taking the s-th of S contiguous runs of key tiles of
//    sequence b.  The runs follow the sequence's own context, so a short
//    sequence's keys spread over all S blocks too.  S (`vec_splits`) is
//    the most that one wave of the card's resident blocks holds for the
//    B * H pairs, no more than gives each warp a tile at the table's
//    full width W * block_size, and at most kMaxSplits (one block a pair
//    ran 64-80 blocks on 132 SMs at the drives' decode steps).
//  * A block (4 warps) first stages page ids in shared memory: the
//    table's whole row, loaded beside the context length (rows up to
//    kRowPages wide), else its run's own once the context length is in;
//    warp w takes the run's tiles w, w + 4, ...  A key row of D values is
//    NV = D * sizeof(T) / 16 vectors; G lanes (NV rounded up to a power
//    of two, at most 32) read one row, each lane VPL 16-byte vectors of it
//    (VPL 2 only for f32 rows of 256), so a warp reads 32 / G rows an
//    instruction: two at D = 128 in bf16.  A tile is the rows that
//    kLaneElems values a lane cover (2 vectors of bf16, 4 of f32): 4 keys
//    at D = 128.
//  * q is held in registers as f32, scaled by scale * log2(e), so scores
//    come in base 2 and the softmax uses exp2f.  A score is each lane's
//    dot over its vectors, reduced over its G lanes by xor shuffles.
//  * Each warp loads its next tile's K and V rows into registers before it
//    computes the current one (a two-tile ring in registers), so a round
//    trip to memory overlaps the arithmetic, and every load is 16 bytes.
//  * Online softmax in f32 a warp: the tile's max over the warp, the
//    running max m, the scale alpha = exp2(m_old - m_new); each lane keeps
//    the sum l and the accumulator for its row's columns over its own
//    keys, and at the end of the walk the 32 / G key slots are added by
//    xor shuffles (every lane gets the same sums).  Masked keys score
//    -inf and weigh exactly 0; their rows are never read, nor are the
//    pages that table entries past the context point at.
//  * The merge: the 4 warps' (m, l, acc) in warp order through shared
//    memory, a warp with no key weighing 0.  With S = 1 the block writes
//    the output.  Otherwise it writes its (m, l, acc) to `partial`, and
//    one thread fences and takes a ticket (an atomic on the pair's counter
//    in `tickets`); the block that takes the last ticket resets the counter
//    to 0 for the next launch and merges the S states in split order,
//    an empty split weighing 0.  The order is fixed whatever order the
//    blocks arrive in, so the output is the same on every run; no float
//    atomics.
//
// The element-wise route (`paged_attn_kernel`), other layouts (bf16 heads
// off 16 bytes, misaligned views): one block of 4 warps a (b, h), the
// TPU kernel's sequential walk over the table as a loop inside the block.
// The block stages q in shared memory as f32.  Warp w takes the pages w,
// w + 4, ... that hold visible keys and keeps its own online softmax:
// running max m and sum l in registers, the f32 accumulator spread over
// its lanes (lane j owns d = j, j + 32, ...).  A page's scores are dot
// products split over 8 lanes each and reduced with shuffles; the PV
// product reads V rows with neighbouring lanes on neighbouring elements.
// At the end the four warps' (m, l, acc) are merged in shared memory in
// warp order.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's _NEG_INF
constexpr int kWarps = 4;
constexpr int kLanes = 8;          // lanes that share one score's dot
constexpr int kMaxD = 256;         // the TPU path's head_dim limit
constexpr int kPerLane = kMaxD / 32;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ context_lens,
                      T* __restrict__ out, int H, int D, int bs, int W,
                      float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [D]
  float* sc = qs + D;                 // [kWarps][bs] scores, then probs
  float* wm = sc + kWarps * bs;       // [kWarps] each warp's max
  float* wl = wm + kWarps;            // [kWarps] each warp's sum
  float* wacc = wl + kWarps;          // [kWarps][D] each warp's acc

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ctx = context_lens[b];
  const int* table = block_tables + static_cast<size_t>(b) * W;
  const size_t qrow = (static_cast<size_t>(b) * H + h) * D;

  for (int d = tid; d < D; d += blockDim.x) qs[d] = ptt::to_float(q[qrow + d]);
  __syncthreads();

  float m = kNegInf, l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
  float* ws = sc + warp * bs;
  const int npages = min(W, (ctx + bs - 1) / bs);

  for (int w = warp; w < npages; w += kWarps) {
    const size_t base = (static_cast<size_t>(table[w]) * H + h) * bs * D;
    const T* kp = k_pool + base;
    const T* vp = v_pool + base;
    const int nvis = min(bs, ctx - w * bs);   // visible keys of this page
    // scores: 4 keys at a time, 8 lanes to a dot product; every lane runs
    // the same trips, so the shuffles see the full warp
    const int sub = lane % kLanes;
    for (int c0 = 0; c0 < bs; c0 += 32 / kLanes) {
      const int c = c0 + lane / kLanes;
      float dot = 0.f;
      if (c < nvis) {
        const T* kr = kp + static_cast<size_t>(c) * D;
        for (int d = sub; d < D; d += kLanes)
          dot = fmaf(qs[d], ptt::to_float(kr[d]), dot);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (sub == 0 && c < bs) ws[c] = dot * scale;
    }
    __syncwarp();
    float mx = m;
    for (int c = 0; c < nvis; ++c) mx = fmaxf(mx, ws[c]);
    float sum = 0.f;
    const float alpha = expf(m - mx);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] *= alpha;
    for (int c = 0; c < nvis; ++c) {
      const float p = expf(ws[c] - mx);
      sum += p;
      const T* vr = vp + static_cast<size_t>(c) * D;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(p, ptt::to_float(vr[d]), acc[j]);
      }
    }
    l = alpha * l + sum;
    m = mx;
    __syncwarp();  // the next page's scores overwrite ws
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int d = lane + 32 * j;
    if (d < D) wacc[warp * D + d] = acc[j];
  }
  __syncthreads();

  float M = kNegInf;
  for (int v = 0; v < kWarps; ++v) M = fmaxf(M, wm[v]);
  float L = 0.f;
  float f[kWarps];
  for (int v = 0; v < kWarps; ++v) {
    f[v] = wl[v] > 0.f ? expf(wm[v] - M) : 0.f;  // an empty warp adds 0
    L += wl[v] * f[v];
  }
  for (int d = tid; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int v = 0; v < kWarps; ++v) a += wacc[v * D + d] * f[v];
    out[qrow + d] = ptt::from_float<T>(L > 0.f ? a / L : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* block_tables, const int* context_lens, void* out,
           int B, int H, int D, int bs, int W, float scale, cudaStream_t s) {
  if (D > kMaxD || bs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
                      (static_cast<size_t>(D) * (1 + kWarps) +
                       static_cast<size_t>(kWarps) * bs + 2 * kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, H);
  paged_attn_kernel<T><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, context_lens,
      static_cast<T*>(out), H, D, bs, W, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The vector route (see the note at the top)
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using ptt::Vec16;

constexpr int kVecWarps = 4;
constexpr int kVecThreads = 32 * kVecWarps;
constexpr int kLaneElems = 16;   // K (and V) values a lane loads a tile
constexpr int kMaxSplits = 32;   // key-walk splits of one (b, h) at most
constexpr int kRowPages = 4096;  // table rows staged whole up to this width
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Whether a call takes the vector route: rows of whole 16-byte vectors and
// 16-byte aligned bases (ops/paged.py `vector_route` is the Python copy).
bool vec_route(const void* q, const void* k_pool, const void* v_pool,
               const void* out, int D, int isz) {
  return D > 0 && D <= kMaxD && (D * isz) % 16 == 0 && ptt::aligned16(q) &&
         ptt::aligned16(k_pool) && ptt::aligned16(v_pool) &&
         ptt::aligned16(out);
}

// The route's instantiation for rows of D values of isz bytes: G lanes a
// row (its vector count rounded up to a power of two, at most 32) and
// VPL vectors a lane.
struct VecGeo {
  int g, vpl;
};
VecGeo vec_geo(int D, int isz) {
  const int nv = D * isz / 16;
  int g = 1;
  while (g < nv && g < 32) g *= 2;
  return {g, (nv + g - 1) / g};
}

template <typename T, int G, int VPL>
struct VecShape {
  using V = Vec16<T>;
  static constexpr int kRows = kLaneElems / (V::kN * VPL);  // rows a lane
  static constexpr int kPerLoad = 32 / G;          // rows a warp reads at once
  static constexpr int kTileKeys = kRows * kPerLoad;
};

// One warp's loads of tile `t`: lane (slot, sub) reads vectors sub, sub +
// G, ... of key rows t * kTileKeys + r * kPerLoad + slot, for the rows
// below `k1` (the run's end), from the pages staged in `pages` (the
// run's first page is p0).
template <typename T, int G, int VPL>
__device__ __forceinline__ void load_tile(
    typename VecShape<T, G, VPL>::V (&kr)[VecShape<T, G, VPL>::kRows][VPL],
    typename VecShape<T, G, VPL>::V (&vr)[VecShape<T, G, VPL>::kRows][VPL],
    const T* k_pool, const T* v_pool, const int* pages, int t, int k1,
    int p0, int slot, int sub, int nv, int h, int H, int bs, int D) {
  using S = VecShape<T, G, VPL>;
  using V = typename S::V;
#pragma unroll
  for (int r = 0; r < S::kRows; ++r) {
    const int pos = t * S::kTileKeys + r * S::kPerLoad + slot;
    if (pos < k1) {
      const size_t row =
          (static_cast<size_t>(pages[pos / bs - p0]) * H + h) * bs + pos % bs;
      const V* kp = reinterpret_cast<const V*>(k_pool + row * D);
      const V* vp = reinterpret_cast<const V*>(v_pool + row * D);
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (sub + v * G < nv) {
          kr[r][v] = kp[sub + v * G];
          vr[r][v] = vp[sub + v * G];
        }
      }
    }
  }
}

// At least 4 blocks an SM: without that bound ptxas spilled 8 bytes in
// some instantiations (f32 rows of 256, bf16 rows of 8).
template <typename T, int G, int VPL>
__global__ void __launch_bounds__(kVecThreads, 4)
    paged_attn_vec_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ context_lens,
                          T* __restrict__ out, float* __restrict__ partial,
                          int* __restrict__ tickets, int H, int D, int bs,
                          int W, int whole_row, float scale_log2) {
  using S = VecShape<T, G, VPL>;
  using V = typename S::V;
  constexpr int kN = V::kN;
  constexpr int kRows = S::kRows;
  constexpr int kTK = S::kTileKeys;
  extern __shared__ int pages[];   // page ids from the table, from p0 on
  __shared__ float wm[kVecWarps], wl[kVecWarps];
  __shared__ float wacc[kVecWarps][kMaxD];
  __shared__ float sm[kMaxSplits], sl[kMaxSplits], sf[kMaxSplits];
  __shared__ int last;

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / G, sub = lane % G;
  const int nv = D * static_cast<int>(sizeof(T)) / 16;
  const size_t bh = static_cast<size_t>(b) * H + h;

  // q as f32 in registers, scaled so that scores come in base 2
  float qf[VPL][kN];
  const V* qv = reinterpret_cast<const V*>(q + bh * D);
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const V x = sub + v * G < nv ? qv[sub + v * G] : V{};
#pragma unroll
    for (int j = 0; j < kN; ++j)
      qf[v][j] = sub + v * G < nv ? ptt::to_float(x.v[j]) * scale_log2 : 0.f;
  }

  // the page ids in shared memory: with `whole_row` the table's row,
  // loaded beside the context length; else, once the context length has
  // given this block its run, the run's own
  const int* table = block_tables + static_cast<size_t>(b) * W;
  if (whole_row)
    for (int i = threadIdx.x; i < W; i += kVecThreads) pages[i] = table[i];
  // this block's run of tiles [t0, t1), keys [t0 * kTK, k1)
  const int ctx = max(0, min(context_lens[b], W * bs));
  const int tiles = (ctx + kTK - 1) / kTK;
  const int per = (tiles + nsplit - 1) / nsplit;
  const int t0 = min(tiles, split * per), t1 = min(tiles, t0 + per);
  const int k1 = min(ctx, t1 * kTK);
  const int p0 = whole_row ? 0 : t0 * kTK / bs;
  if (!whole_row) {
    const int np = t1 > t0 ? (k1 - 1) / bs - p0 + 1 : 0;
    for (int i = threadIdx.x; i < np; i += kVecThreads)
      pages[i] = table[p0 + i];
  }
  __syncthreads();

  float m = -INFINITY, l = 0.f;
  float acc[VPL][kN];
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[v][j] = 0.f;
  V ck[kRows][VPL], cv[kRows][VPL];
  int t = t0 + warp;
  if (t < t1)
    load_tile<T, G, VPL>(ck, cv, k_pool, v_pool, pages, t, k1, p0, slot, sub,
                         nv, h, H, bs, D);
  for (; t < t1; t += kVecWarps) {
    V nk[kRows][VPL], nvv[kRows][VPL];
    if (t + kVecWarps < t1)
      load_tile<T, G, VPL>(nk, nvv, k_pool, v_pool, pages, t + kVecWarps, k1,
                           p0, slot, sub, nv, h, H, bs, D);
    float sc[kRows];
    float mt = -INFINITY;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float d = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (sub + v * G < nv) {
#pragma unroll
          for (int j = 0; j < kN; ++j)
            d = fmaf(qf[v][j], ptt::to_float(ck[r][v].v[j]), d);
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
      // every row of the tile is below the run's end but the last tile's
      // tail: those score -inf and weigh exactly 0
      sc[r] = t * kTK + r * S::kPerLoad + slot < k1 ? d : -INFINITY;
      mt = fmaxf(mt, sc[r]);
    }
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
    const float mn = fmaxf(m, mt);        // finite: a tile has a visible key
    const float alpha = exp2f(m - mn);    // 0 at the first tile (m = -inf)
    l *= alpha;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[v][j] *= alpha;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (sc[r] != -INFINITY) {   // a masked row was not loaded
        const float p = exp2f(sc[r] - mn);
        l += p;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
#pragma unroll
          for (int j = 0; j < kN; ++j)
            acc[v][j] = fmaf(p, ptt::to_float(cv[r][v].v[j]), acc[v][j]);
      }
    }
    m = mn;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        ck[r][v] = nk[r][v];
        cv[r][v] = nvv[r][v];
      }
  }
  // the warp's key slots added (each lane ends with the same sums)
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    l += __shfl_xor_sync(kFull, l, o);
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int j = 0; j < kN; ++j)
        acc[v][j] += __shfl_xor_sync(kFull, acc[v][j], o);
  }
  if (lane < G) {
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (lane + v * G < nv)
#pragma unroll
        for (int j = 0; j < kN; ++j)
          wacc[warp][(lane + v * G) * kN + j] = acc[v][j];
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();

  // the warps' states merged in warp order; a warp with no key weighs 0
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kVecWarps; ++w)
    if (wl[w] > 0.f) M = fmaxf(M, wm[w]);
  float f[kVecWarps], L = 0.f;
#pragma unroll
  for (int w = 0; w < kVecWarps; ++w) {
    f[w] = wl[w] > 0.f ? exp2f(wm[w] - M) : 0.f;
    L += wl[w] * f[w];
  }
  if (nsplit == 1) {
    for (int d = threadIdx.x; d < D; d += kVecThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kVecWarps; ++w) a += wacc[w][d] * f[w];
      out[bh * D + d] = ptt::from_float<T>(L > 0.f ? a / L : 0.f);
    }
    return;
  }

  // partial: the states' acc [B * H * S][D], then their (m, l) [B*H*S][2]
  const size_t states = static_cast<size_t>(gridDim.z) * H * nsplit;
  float* pacc = partial + bh * nsplit * D;
  float* pml = partial + states * D + bh * nsplit * 2;
  for (int d = threadIdx.x; d < D; d += kVecThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kVecWarps; ++w) a += wacc[w][d] * f[w];
    pacc[static_cast<size_t>(split) * D + d] = a;
  }
  if (threadIdx.x == 0) {
    pml[2 * split] = M;
    pml[2 * split + 1] = L;
  }
  // the block's writes, then one thread's fence and ticket (the release
  // pattern of a grid-wide barrier)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(tickets + bh, 1) == nsplit - 1;
    if (last) tickets[bh] = 0;   // zero again for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: the S states merged in split order
  for (int i = threadIdx.x; i < nsplit; i += kVecThreads) {
    sm[i] = __ldcg(pml + 2 * i);
    sl[i] = __ldcg(pml + 2 * i + 1);
  }
  __syncthreads();
  float Ms = -INFINITY;
  for (int i = 0; i < nsplit; ++i)
    if (sl[i] > 0.f) Ms = fmaxf(Ms, sm[i]);
  for (int i = threadIdx.x; i < nsplit; i += kVecThreads)
    sf[i] = sl[i] > 0.f ? exp2f(sm[i] - Ms) : 0.f;   // an empty split: 0
  __syncthreads();
  float Ls = 0.f;
  for (int i = 0; i < nsplit; ++i) Ls += sl[i] * sf[i];
  for (int d = threadIdx.x; d < D; d += kVecThreads) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i)
      a += __ldcg(pacc + static_cast<size_t>(i) * D + d) * sf[i];
    out[bh * D + d] = ptt::from_float<T>(Ls > 0.f ? a / Ls : 0.f);
  }
}

// The splits S of the key walk: the blocks one wave of the card holds for
// the B * H pairs, no more than gives every warp a tile at the table's
// full width (W pages), within [1, kMaxSplits].
template <typename T, int G, int VPL>
int vec_splits(int B, int H, int bs, int W, int device) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, paged_attn_vec_kernel<T, G, VPL>, kVecThreads, 0);
    return n > 0 ? n : 1;
  }();
  constexpr int kTK = VecShape<T, G, VPL>::kTileKeys;
  const long long pairs = static_cast<long long>(B) * H;
  const long long tiles = (static_cast<long long>(W) * bs + kTK - 1) / kTK;
  long long s = static_cast<long long>(ptt::sm_count(device)) * per_sm /
                (pairs > 0 ? pairs : 1);
  s = std::min(s, (tiles + kVecWarps - 1) / kVecWarps);
  s = std::min<long long>(s, kMaxSplits);
  return static_cast<int>(std::max<long long>(s, 1));
}

template <typename T, int G, int VPL>
int launch_vec(const void* q, const void* k_pool, const void* v_pool,
               const int* block_tables, const int* context_lens, void* out,
               float* partial, int* tickets, int B, int H, int D, int bs,
               int W, int splits, float scale, cudaStream_t s) {
  constexpr int kTK = VecShape<T, G, VPL>::kTileKeys;
  // the table's whole row where it fits kRowPages, else the pages a run of
  // tiles spans at most
  const long long tiles = (static_cast<long long>(W) * bs + kTK - 1) / kTK;
  const long long per = (tiles + splits - 1) / splits;
  const int whole_row = W <= kRowPages;
  const long long ids =
      whole_row ? std::max(W, 1) : (per * kTK + bs - 1) / bs + 1;
  const size_t smem = sizeof(int) * static_cast<size_t>(ids);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_vec_kernel<T, G, VPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(splits, H, B);
  paged_attn_vec_kernel<T, G, VPL><<<grid, kVecThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, context_lens,
      static_cast<T*>(out), partial, tickets, H, D, bs, W, whole_row,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int VPL>
struct VecTag {
  using type = T;
  static constexpr int kG = G, kVpl = VPL;
};

// fn(VecTag<T, G, VPL>{}) for the instantiation of (g, vpl).
template <typename T, typename Fn>
int with_vec_tag(VecGeo geo, Fn&& fn) {
  switch (geo.g) {
    case 1: return fn(VecTag<T, 1, 1>{});
    case 2: return fn(VecTag<T, 2, 1>{});
    case 4: return fn(VecTag<T, 4, 1>{});
    case 8: return fn(VecTag<T, 8, 1>{});
    case 16: return fn(VecTag<T, 16, 1>{});
    default:
      if constexpr (sizeof(T) == 4)   // f32 rows of more than 128 values
        if (geo.vpl == 2) return fn(VecTag<T, 32, 2>{});
      return fn(VecTag<T, 32, 1>{});
  }
}

template <typename T>
int vec_launch(const void* q, const void* k_pool, const void* v_pool,
               const int* bt, const int* cl, void* out, float* partial,
               int* tickets, int B, int H, int D, int bs, int W, int splits,
               float scale, cudaStream_t s) {
  return with_vec_tag<T>(vec_geo(D, sizeof(T)), [&](auto tag) {
    using Tag = decltype(tag);
    return launch_vec<T, Tag::kG, Tag::kVpl>(q, k_pool, v_pool, bt, cl, out,
                                             partial, tickets, B, H, D, bs,
                                             W, splits, scale, s);
  });
}

template <typename T>
int vec_splits_any(int B, int H, int D, int bs, int W, int device) {
  return with_vec_tag<T>(vec_geo(D, sizeof(T)), [&](auto tag) {
    using Tag = decltype(tag);
    return vec_splits<T, Tag::kG, Tag::kVpl>(B, H, bs, W, device);
  });
}

}  // namespace

// partial: f32 scratch of B * H * splits * (D + 2) values and tickets B * H
// int32 counters that are 0 (each launch leaves them 0), both used only
// where the vector route takes splits > 1 (`ptt_paged_attention_splits`).
extern "C" int ptt_paged_attention_fwd(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* block_tables,
                                       const void* context_lens, void* out,
                                       void* partial, void* tickets, int B,
                                       int H, int D, int bs, int W,
                                       int splits, float scale, int dtype,
                                       int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  if (dtype != PTT_DTYPE_F32 && dtype != PTT_DTYPE_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int isz = dtype == PTT_DTYPE_F32 ? 4 : 2;
  if (vec_route(q, k_pool, v_pool, out, D, isz)) {
    if (bs <= 0 || splits < 1 || splits > kMaxSplits ||
        (splits > 1 && (partial == nullptr || tickets == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    float* part = static_cast<float*>(partial);
    int* tix = static_cast<int*>(tickets);
    if (dtype == PTT_DTYPE_F32)
      return vec_launch<float>(q, k_pool, v_pool, bt, cl, out, part, tix, B,
                               H, D, bs, W, splits, scale, s);
    return vec_launch<bf16>(q, k_pool, v_pool, bt, cl, out, part, tix, B, H,
                            D, bs, W, splits, scale, s);
  }
  if (dtype == PTT_DTYPE_F32)
    return launch<float>(q, k_pool, v_pool, bt, cl, out, B, H, D, bs, W,
                         scale, s);
  return launch<bf16>(q, k_pool, v_pool, bt, cl, out, B, H, D, bs, W, scale,
                      s);
}

// 1 where a call takes the vector route, else 0 (the element-wise route).
extern "C" int ptt_paged_attention_vector_route(const void* q,
                                                const void* k_pool,
                                                const void* v_pool,
                                                const void* out, int D,
                                                int dtype) {
  return vec_route(q, k_pool, v_pool, out, D, dtype == PTT_DTYPE_F32 ? 4 : 2)
             ? 1
             : 0;
}

// The splits S the vector route takes for this call on `device`.
extern "C" int ptt_paged_attention_splits(int B, int H, int D, int bs,
                                          int W, int dtype, int device) {
  if (D <= 0 || D > kMaxD || bs <= 0) return 1;
  return dtype == PTT_DTYPE_F32 ? vec_splits_any<float>(B, H, D, bs, W, device)
                                : vec_splits_any<bf16>(B, H, D, bs, W, device);
}
