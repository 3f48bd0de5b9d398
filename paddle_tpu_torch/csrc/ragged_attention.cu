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
//
// Design, kept simple and right first: one block of 128 threads per
// (q-block, head).  Blocks run in parallel in no order, so the TPU grid's
// sequential walk over the block table becomes a loop inside the block.
// The block stages its block_q x D queries in shared memory as f32, then
// for each KV block it needs (it stops at the context length and at the
// causal bound of its last valid row, so it never reads a block no row
// can see) stages K and V with 16-byte loads, computes the scores of its
// valid rows with the mask (eight threads per dot product, so a decode
// row's 16 scores still occupy the whole block), and updates an online
// softmax (running max m, running sum l, accumulator acc, all f32 in
// shared memory).  Rows past q_valids are never computed: a decode
// q-block does one row's work, not block_q's.  The probabilities stay in
// f32 for the PV product; the reference composite rounds them to the
// query type first, which is the only intended difference.
//
// int8 pools: the same kernel over int8 K/V codes.
//
// Replaces: paddle_tpu/ops/pallas_ragged.py `_ragged_attn_int8_kernel`
// (:197, the int8 branch of `ragged_paged_attention` :268-279) over the
// shared body `_ragged_attn_body` (:115).  The pools are int8
// [num_blocks, H, block_size, D]; k_scales / v_scales are
// [num_blocks, block_size, 1] f32 (KV_SCALE_LANES = 1), one dequant
// scale per slot shared by every head, walked through the same block
// table as K/V.  q and the output stay f32 or bf16.
//
// What bounds it on the H100: what bounds the float kernel.  int8 halves
// the K/V bytes of bf16 (plus 4 bytes of scale per slot and side), but
// the float kernel already runs ~42x its byte bound, limited by its
// CUDA-core products and barriers, which int8 does not change.
//
// Design: the float kernel, templated on the pool's element type.  K/V
// tiles are read with 16-byte loads (16 codes each), widened to f32 and
// multiplied by their slot's scale as they are staged, BEFORE the score
// and PV products, as the TPU kernel dequantizes its VMEM tile
// (pallas_ragged.py:149-150, 168-169).  The scale is not folded into the
// score after the dot: that would reassociate against the reference.
// Masking, the online softmax, null segments and zero rows are the float
// kernel's.
#include <cstdint>

#include "common.cuh"

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
  if (dtype == PTT_DTYPE_F32)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, bt, cl,
                                sid, qs, qv, out, num_q_blocks, num_seqs, H,
                                D, bs, W, block_q, scale, s);
  if (dtype == PTT_DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, bt, cl, sid, qs, qv, out,
        num_q_blocks, num_seqs, H, D, bs, W, block_q, scale, s);
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
  if (dtype == PTT_DTYPE_F32)
    return launch<float, int8_t>(q, k_pool, v_pool, ksc, vsc, bt, cl, sid,
                                 qs, qv, out, num_q_blocks, num_seqs, H, D,
                                 bs, W, block_q, scale, s);
  if (dtype == PTT_DTYPE_BF16)
    return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, ksc, vsc, bt, cl,
                                         sid, qs, qv, out, num_q_blocks,
                                         num_seqs, H, D, bs, W, block_q,
                                         scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
