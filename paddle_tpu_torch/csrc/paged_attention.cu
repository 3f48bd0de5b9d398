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
// What bounds it on the H100: bytes.  At the paged drive's decode step
// (B = 4, H = 16, D = 128, contexts of ~129-192 keys, bf16) each key
// element read feeds 4 flops; the visible K/V pages are ~1.3 MB against
// ~0.8 MFLOP.
//
// Design, simple first: one block of 128 threads (4 warps) per (b, h);
// the TPU kernel's sequential walk over the table becomes a loop inside
// the block.  The block stages q in shared memory as f32.  Warp w takes
// the pages w, w + 4, ... that hold visible keys (pages past the context
// are never read, as the TPU kernel's `pl.when` skips them) and keeps its
// own online softmax: running max m and sum l in registers, the f32
// accumulator spread over its lanes (lane j owns d = j, j + 32, ...).  A
// page's scores are dot products split over 8 lanes each and reduced with
// shuffles; the PV product reads V rows with neighbouring lanes on
// neighbouring elements.  At the end the four warps' (m, l, acc) are
// merged in shared memory in warp order, a fixed order, so the result is
// the same on every run.  This follows the decode rows of
// ragged_attention.cu.
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

}  // namespace

extern "C" int ptt_paged_attention_fwd(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* block_tables,
                                       const void* context_lens, void* out,
                                       int B, int H, int D, int bs, int W,
                                       float scale, int dtype, int device,
                                       void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  if (dtype == PTT_DTYPE_F32)
    return launch<float>(q, k_pool, v_pool, bt, cl, out, B, H, D, bs, W,
                         scale, s);
  if (dtype == PTT_DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, bt, cl, out, B, H, D, bs,
                                 W, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
