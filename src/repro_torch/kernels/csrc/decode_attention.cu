// Flash-decode GQA attention: one query token per sequence over a KV cache,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.decode_attention.decode_attention_pallas
// (src/repro/kernels/decode_attention.py:81, body _kernel at :38-77).  For
// every sequence b and query head h = kh * G + g of kv head kh:
//
//   out[b, h] = sum_{j < len_b} softmax_j(q[b, h] . k[b, j, kh] / sqrt(D)) v[b, j, kh]
//
// with the softmax in float32 and the output in q's dtype; q, k and v may
// each be float32 or bfloat16 (k and v of one type).
//
// What bounds it: every valid cache row is read once and used by the G query
// heads of its kv head, about 4 G operations per element of k and v.  At the
// serving path's shape (B 4, H 10, KVH 1, D 256, S 2048, float32 cache) that
// is 16.8 MB of k and v, 5.0 us at 3.35 TB/s, against 84 MFLOP (1.3 us at
// 67 TFLOP/s float32), so bytes bind.
//
// Design: the Pallas kernel walks S in order in one program per (b, kv head),
// carrying the running (m, l, acc) from one grid step to the next.  GPU blocks
// run in no order, and one block per (b, kv head) would be 4 blocks on 132
// SMs at the path's shape.  So S is split into chunks of kChunk rows, one
// block per (chunk, kv head, b): each block stages the G query rows in shared
// memory, reads its k rows once (one warp per row, lanes along D, coalesced,
// two rows' loads in flight per warp) to score all G heads, takes the chunk's
// softmax, reads its v rows once (one thread per element of D, kAheadV rows'
// loads in flight) to weight them, and writes a partial (m, l, acc).  A
// second launch, one block per (head, kv head, b), combines the partials in
// float32.  A block whose chunk lies wholly at or past len_b returns at once
// and reads nothing; inside a chunk, rows past len_b are neither read nor
// counted.  Heads are taken kGroup at a time so the accumulators stay in
// registers for any G; G and D stay run-time values, and the guarded loops
// this needs make the first pass, not memory, the long pole on the card
// (PERF.md).  Output is acc / max(l, 1e-30), as in the Pallas kernel, so a
// sequence of length 0 gives zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 64;    // cache rows per block
constexpr int kThreads = 256;  // one thread per element of D in the weighting pass
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;    // query heads accumulated in registers at once
constexpr int kMaxD = kThreads;
constexpr int kPerLane = kMaxD / 32;  // elements of a row each lane reads
constexpr int kMaxG = 32;     // q rows of G * D floats fit in shared memory
constexpr int kAheadV = 16;   // rows of v loaded before they are weighted

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One cache row's elements of this lane (lane, lane + 32, ...), as float32.
template <typename TKV>
__device__ __forceinline__ void load_row(const TKV* row, int lane, int d, float (&x)[kPerLane]) {
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int dd = lane + 32 * u;
    x[u] = dd < d ? to_f32(row[dd]) : 0.f;
  }
}

// Scores of one row for heads g0 .. g0 + kGroup - 1 into p_s (lane 0 writes).
__device__ __forceinline__ void score_row(const float* q_s, const float (&x)[kPerLane], int lane,
                                          int d, int g0, int g_n, int j, float scale,
                                          float* p_s) {
  float dot[kGroup];
#pragma unroll
  for (int gg = 0; gg < kGroup; ++gg) dot[gg] = 0.f;
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int dd = lane + 32 * u;
    if (dd < d) {
#pragma unroll
      for (int gg = 0; gg < kGroup; ++gg)
        if (g0 + gg < g_n) dot[gg] += q_s[(g0 + gg) * d + dd] * x[u];
    }
  }
#pragma unroll
  for (int gg = 0; gg < kGroup; ++gg) {
    if (g0 + gg < g_n) {
      const float sum = warp_sum(dot[gg]);
      if (lane == 0) p_s[(g0 + gg) * kChunk + j] = sum * scale;
    }
  }
}

// grid (n_chunks, KVH, B).  Partials are laid out (B, KVH, n_chunks, G[, D]).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v, const int* __restrict__ length,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int h, int kvh, int d, int s,
                      float scale) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int g_n = h / kvh;
  const int n_chunks = gridDim.x;
  const int start = chunk * kChunk;
  const int len = min(length[b], s);
  if (start >= len) return;  // wholly past the fill: read nothing
  const int count = min(kChunk, len - start);

  float* q_s = smem;                 // (G, D) query rows, float32
  float* p_s = smem + g_n * d;       // (G, kChunk) scores, then weights
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const TQ* qb = q + (static_cast<size_t>(b) * h + static_cast<size_t>(kh) * g_n) * d;
  for (int i = tid; i < g_n * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(kvh) * d;  // between cache rows
  const TKV* kb = k + (static_cast<size_t>(b) * s + start) * row_stride + static_cast<size_t>(kh) * d;
  const TKV* vb = v + (static_cast<size_t>(b) * s + start) * row_stride + static_cast<size_t>(kh) * d;

  // Scores: one warp per cache row, lanes along D, two rows' loads in flight.
  for (int j = warp; j < count; j += 2 * kWarps) {
    const int j2 = j + kWarps;
    float x0[kPerLane], x1[kPerLane];
    load_row(kb + j * row_stride, lane, d, x0);
    if (j2 < count) load_row(kb + j2 * row_stride, lane, d, x1);
    for (int g0 = 0; g0 < g_n; g0 += kGroup) {
      score_row(q_s, x0, lane, d, g0, g_n, j, scale, p_s);
      if (j2 < count) score_row(q_s, x1, lane, d, g0, g_n, j2, scale, p_s);
    }
  }
  __syncthreads();

  // The chunk's softmax statistics: one warp per head.
  const size_t part = (static_cast<size_t>(b) * kvh + kh) * n_chunks + chunk;
  for (int g = warp; g < g_n; g += kWarps) {
    float* pg = p_s + g * kChunk;
    float m = -CUDART_INF_F;
    for (int j = lane; j < count; j += 32) m = fmaxf(m, pg[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < count; j += 32) {
      const float p = expf(pg[j] - m);
      pg[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_m[part * g_n + g] = m;
      part_l[part * g_n + g] = l;
    }
  }
  __syncthreads();

  // Weighted values: one thread per element of D, kAheadV rows of v in flight.
  if (tid >= d) return;
  float* acc_out = part_acc + part * g_n * d + tid;
  for (int g0 = 0; g0 < g_n; g0 += kGroup) {
    float acc[kGroup];
#pragma unroll
    for (int gg = 0; gg < kGroup; ++gg) acc[gg] = 0.f;
    for (int j0 = 0; j0 < count; j0 += kAheadV) {
      float vv[kAheadV];
#pragma unroll
      for (int u = 0; u < kAheadV; ++u)
        vv[u] = j0 + u < count ? to_f32(vb[(j0 + u) * row_stride + tid]) : 0.f;
#pragma unroll
      for (int u = 0; u < kAheadV; ++u) {
        if (j0 + u < count) {
#pragma unroll
          for (int gg = 0; gg < kGroup; ++gg)
            if (g0 + gg < g_n) acc[gg] += p_s[(g0 + gg) * kChunk + j0 + u] * vv[u];
        }
      }
    }
#pragma unroll
    for (int gg = 0; gg < kGroup; ++gg)
      if (g0 + gg < g_n) acc_out[(g0 + gg) * d] = acc[gg];
  }
}

// grid (G, KVH, B); threads along D.  Each block first turns its head's
// partial maxima into chunk weights w_c = exp(m_c - M) in shared memory, with
// l = sum_c w_c l_c, then sums w_c acc_c along D.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const int* __restrict__ length, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, const float* __restrict__ part_acc,
                      TQ* __restrict__ out, int h, int kvh, int d, int s, int n_chunks) {
  extern __shared__ float w_s[];  // (n_chunks,) chunk weights
  __shared__ float red[kWarps];
  const int g = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int g_n = h / kvh;
  const int tid = threadIdx.x;
  const int len = min(length[b], s);
  const int live = len > 0 ? (len + kChunk - 1) / kChunk : 0;
  const size_t base = (static_cast<size_t>(b) * kvh + kh) * n_chunks;

  float m = -CUDART_INF_F;
  for (int c = tid; c < live; c += kThreads) m = fmaxf(m, part_m[(base + c) * g_n + g]);
  m = warp_max(m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  __syncthreads();

  float l = 0.f;
  for (int c = tid; c < live; c += kThreads) {
    const float w = expf(part_m[(base + c) * g_n + g] - m);
    w_s[c] = w;
    l += w * part_l[(base + c) * g_n + g];
  }
  l = warp_sum(l);
  if ((tid & 31) == 0) red[tid >> 5] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) l += red[i];
  const float denom = fmaxf(l, 1e-30f);

  TQ* ob = out + (static_cast<size_t>(b) * h + static_cast<size_t>(kh) * g_n + g) * d;
  const float* ab = part_acc + (base * g_n + g) * d;
  const size_t stride = static_cast<size_t>(g_n) * d;  // between chunks
  for (int dd = tid; dd < d; dd += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < live; ++c) acc += w_s[c] * ab[c * stride + dd];
    store(ob + dd, acc / denom);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* length, float* part_m,
           float* part_l, float* part_acc, void* out, int b, int h, int kvh, int d, int s,
           cudaStream_t stream) {
  const int n_chunks = (s + kChunk - 1) / kChunk;
  const int g_n = h / kvh;
  const size_t smem = static_cast<size_t>(g_n) * (d + kChunk) * sizeof(float);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  decode_partial_kernel<TQ, TKV><<<dim3(n_chunks, kvh, b), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      length, part_m, part_l, part_acc, h, kvh, d, s, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<TQ><<<dim3(g_n, kvh, b), kThreads, n_chunks * sizeof(float), stream>>>(
      length, part_m, part_l, part_acc, static_cast<TQ*>(out), h, kvh, d, s, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, D); k, v (B, S, KVH, D); length (B,) int32; out (B, H, D) in q's
// type; part_m, part_l (B, KVH, ceil(S / 64), G) and part_acc (B, KVH,
// ceil(S / 64), G, D) float32 scratch.  All contiguous on the current device.
// q_bf16 and kv_bf16 select bfloat16 (1) or float32 (0).  Launches on
// `stream` and returns cudaGetLastError(), so a refused launch is reported.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const int* length,
                                float* part_m, float* part_l, float* part_acc, void* out,
                                int b, int h, int kvh, int d, int s, int q_bf16, int kv_bf16,
                                void* stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (kvh <= 0 || h % kvh != 0 || h / kvh > kMaxG || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<bf16, bf16>(q, k, v, length, part_m, part_l, part_acc, out, b, h, kvh, d, s, st);
  if (q_bf16)
    return launch<bf16, float>(q, k, v, length, part_m, part_l, part_acc, out, b, h, kvh, d, s, st);
  if (kv_bf16)
    return launch<float, bf16>(q, k, v, length, part_m, part_l, part_acc, out, b, h, kvh, d, s, st);
  return launch<float, float>(q, k, v, length, part_m, part_l, part_acc, out, b, h, kvh, d, s, st);
}
