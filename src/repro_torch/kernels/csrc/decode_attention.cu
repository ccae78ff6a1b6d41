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
// 67 TFLOP/s float32), so bytes bind: the kernel has to keep enough of the
// cache in flight on every SM, and spend few instructions per byte.
//
// Design.  The Pallas kernel walks S in order in one program per (b, kv
// head), carrying the running (m, l, acc) from one grid step to the next.
// GPU blocks run in no order, and one block per (b, kv head) would be 4
// blocks on 132 SMs at the path's shape.  So S is split into chunks of kChunk
// rows, one block per (chunk, kv head, b), and a second launch combines the
// chunks' partial (m, l, acc).  G and D are template parameters, so every
// loop has a fixed trip count and the accumulators live in registers;
// `decode_attention` instantiates the (G, D) pairs of the repository's
// configurations and parity shapes and refuses any other.  One block:
//
//   1. one warp starts a TMA bulk copy of every valid row of k into shared
//      memory, completing on an mbarrier (64 KB in flight per block at the
//      path's shape, 8.4 MB on the card); when k is in, the same for v,
//      which then loads while k is scored.  (Issued together, k and v
//      arrive together, since every SM's rows share the memory's queues,
//      and the scoring would wait for the last row of both.)  Rows sit at a
//      pitch of D plus 16 bytes, so the row-parallel reads below meet no
//      bank conflicts;
//   2. scores as a register-tiled (G x D) . (D x kChunk) product from shared
//      memory: thread (row lane, slice) holds 4 rows x G heads of dot
//      products over one slice of D, so each 16-byte read of q serves four
//      rows and each read of k all G heads; no warp reduction per row;
//   3. one warp per head sums the slices, takes the chunk's maximum, the
//      exponentials and their sum (two shuffle reductions per head and
//      chunk), and writes the chunk's (m, l) and the weights;
//   4. thread (4 elements of D, row group) accumulates G x 4 weighted sums of
//      v over its rows, one read of v and ceil(G / 4) reads of the weights
//      per row; the row groups' sums meet in shared memory and the chunk's
//      acc goes out as float32.
//
// The combine launch runs one block per (tile of 64 d, head, kv head, b):
// every thread issues the loads of its chunks' acc first, one warp turns the
// chunks' maxima into weights exp(m_c - M) meanwhile, and the thread groups'
// weighted sums meet in shared memory.  A chunk wholly at or past len_b
// reads nothing; inside a chunk, rows past len_b are neither copied nor
// counted.  Output is acc / max(l, 1e-30), as in the Pallas kernel, so a
// sequence of length 0 gives zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

#include "tma.cuh"

namespace {

constexpr int kChunk = 64;     // cache rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCombineD = 64;  // elements of D per combine block

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

// 16 bytes of shared memory as float32 values.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bfloat16 is the high half of a float32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// --- the first pass ----------------------------------------------------------

// 8 bytes of shared memory, four bfloat16 values, as float32 values.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Compile-time layout of one block for G heads of head dimension D.
template <int G, int D, typename TKV>
struct Layout {
  static_assert(D % 16 == 0 && D <= 4 * kThreads, "D: a multiple of 16, at most 1024");
  static constexpr int kVec = 16 / sizeof(TKV);          // elements of one 16-byte read
  static constexpr int kPitch = D + kVec;                // row pitch in shared memory
  static constexpr int kRowBytes = D * sizeof(TKV);
  // Scores: thread (row lane, slice) holds kRows rows x G heads over a slice of D.
  static constexpr int kRows = 4;
  static constexpr int kRowLanes = kChunk / kRows;       // rows lane, lane + 16, ...
  static constexpr int kMaxSlices = kThreads / kRowLanes;
  static constexpr int kSlices = kRowBytes / 16 < kMaxSlices ? kRowBytes / 16 : kMaxSlices;
  static constexpr int kSliceLen = D / kSlices;
  // Values: thread (quad of D, row group) holds G x 4 sums over its rows.
  static constexpr int kQuads = D / 4;
  static constexpr int kRowGroups = kThreads / kQuads;
  static constexpr int kGroupRows = kChunk / kRowGroups;
  static constexpr int kG4 = (G + 3) / 4 * 4;            // a row's weights, padded to float4
  // Shared memory, in bytes: barriers, k, v, q, weights (kChunk, kG4), and
  // one region for the score slices and, later, the row groups' sums.
  static constexpr size_t kBarBytes = 16;
  static constexpr size_t kKVBytes = static_cast<size_t>(kChunk) * kPitch * sizeof(TKV);
  static constexpr size_t kQBytes = static_cast<size_t>(G) * D * 4;
  static constexpr size_t kPBytes = static_cast<size_t>(kChunk) * kG4 * 4;
  static constexpr size_t kSlicesBytes = static_cast<size_t>(kSlices) * G * kChunk * 4;
  static constexpr size_t kSumsBytes = static_cast<size_t>(kRowGroups) * G * D * 4;
  static constexpr size_t kSBytes = kSlicesBytes > kSumsBytes ? kSlicesBytes : kSumsBytes;
  static constexpr size_t kBytes = kBarBytes + 2 * kKVBytes + kQBytes + kPBytes + kSBytes;
  static_assert(kSliceLen % kVec == 0, "a slice is whole 16-byte reads");
  static_assert(kThreads % kQuads == 0 && kRowGroups * kGroupRows == kChunk,
                "the row groups take every thread and split the chunk evenly");
};

// grid (n_chunks, KVH, B).  Partials are laid out (B, KVH, n_chunks, G[, D]).
template <int G, int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads, 1)
decode_partial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v, const int* __restrict__ length,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int kvh, int s, float scale) {
  using L = Layout<G, D, TKV>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int start = chunk * kChunk;
  const int len = min(length[b], s);
  if (start >= len) return;  // wholly past the fill: read nothing
  const int count = min(kChunk, len - start);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [0] k rows, [1] v rows
  TKV* k_s = reinterpret_cast<TKV*>(smem + L::kBarBytes);
  TKV* v_s = reinterpret_cast<TKV*>(smem + L::kBarBytes + L::kKVBytes);
  float* q_s = reinterpret_cast<float*>(smem + L::kBarBytes + 2 * L::kKVBytes);
  float* p_s = q_s + G * D;            // (kChunk, kG4) weights
  float* s_s = p_s + kChunk * L::kG4;  // (kSlices, G, kChunk) scores, then sums
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. Every valid row of k in flight at once; v's rows follow when k's are in.
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_fence_init();
    mbar_arrive_expect(&bars[0], count * L::kRowBytes);
    mbar_arrive_expect(&bars[1], count * L::kRowBytes);
  }
  __syncthreads();
  const size_t row_stride = static_cast<size_t>(kvh) * D;  // between cache rows
  const size_t first = (static_cast<size_t>(b) * s + start) * row_stride + static_cast<size_t>(kh) * D;
  if (warp == 0) {
    for (int j = lane; j < count; j += 32)
      bulk_copy(k_s + j * L::kPitch, k + first + j * row_stride, L::kRowBytes, &bars[0]);
  }
  const TQ* qb = q + (static_cast<size_t>(b) * kvh + kh) * G * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(qb[i]);
  __syncthreads();
  mbar_wait(&bars[0], 0);
  if (warp == 0) {  // v's rows once k's are in: they load while k is scored
    for (int j = lane; j < count; j += 32)
      bulk_copy(v_s + j * L::kPitch, v + first + j * row_stride, L::kRowBytes, &bars[1]);
  }

  // 2. Scores: thread (row lane r, slice) takes kRows x G dot products over
  // its slice of D for rows r, r + 16, ...: each q read serves kRows rows.
  // Rows past `count` hold stale shared memory; their scores are dropped.
  if (tid < L::kRowLanes * L::kSlices) {
    const int r = tid % L::kRowLanes;
    const int slice = tid / L::kRowLanes;
    float dot[L::kRows][G];
#pragma unroll
    for (int i = 0; i < L::kRows; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g) dot[i][g] = 0.f;
    const TKV* kr = k_s + r * L::kPitch + slice * L::kSliceLen;
    const float* qs = q_s + slice * L::kSliceLen;
#pragma unroll
    for (int e = 0; e < L::kSliceLen; e += L::kVec) {
      float x[L::kRows][L::kVec];
#pragma unroll
      for (int i = 0; i < L::kRows; ++i) load16(kr + i * L::kRowLanes * L::kPitch + e, x[i]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int u = 0; u < L::kVec; u += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qs + g * D + e + u);
#pragma unroll
          for (int i = 0; i < L::kRows; ++i) {
            dot[i][g] = fmaf(qq.x, x[i][u], dot[i][g]);
            dot[i][g] = fmaf(qq.y, x[i][u + 1], dot[i][g]);
            dot[i][g] = fmaf(qq.z, x[i][u + 2], dot[i][g]);
            dot[i][g] = fmaf(qq.w, x[i][u + 3], dot[i][g]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L::kRows; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g) s_s[(slice * G + g) * kChunk + r + i * L::kRowLanes] = dot[i][g];
  }
  __syncthreads();

  // 3. The chunk's softmax statistics: one warp per head, two rows per lane.
  // Weights go out row-major, (kChunk, kG4), for the value pass.
  const size_t part = (static_cast<size_t>(b) * kvh + kh) * gridDim.x + chunk;
  for (int g = warp; g < G; g += kWarps) {
    float sc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lane + 32 * i;
      float x = 0.f;
#pragma unroll
      for (int sl = 0; sl < L::kSlices; ++sl) x += s_s[(sl * G + g) * kChunk + row];
      sc[i] = row < count ? x * scale : -CUDART_INF_F;
    }
    const float m = warp_max(fmaxf(sc[0], sc[1]));  // finite: count >= 1
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p = lane + 32 * i < count ? expf(sc[i] - m) : 0.f;
      p_s[(lane + 32 * i) * L::kG4 + g] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_m[part * G + g] = m;
      part_l[part * G + g] = l;
    }
  }
  __syncthreads();
  mbar_wait(&bars[1], 0);

  // 4. Weighted values: thread (quad of D, row group) sums G x 4 outputs over
  // its rows, one 16-byte (or 8-byte) read of v and kG4 / 4 reads of the
  // weights per row; the row groups meet in shared memory.
  const int quad = tid % L::kQuads;
  const int group = tid / L::kQuads;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  const int j1 = min((group + 1) * L::kGroupRows, count);
  for (int j = group * L::kGroupRows; j < j1; ++j) {
    float x[4];
    if constexpr (sizeof(TKV) == 4)
      load16(v_s + j * L::kPitch + 4 * quad, x);
    else
      load8(v_s + j * L::kPitch + 4 * quad, x);
#pragma unroll
    for (int g4 = 0; g4 < L::kG4; g4 += 4) {
      const float4 pw4 = *reinterpret_cast<const float4*>(p_s + j * L::kG4 + g4);
      const float pw[4] = {pw4.x, pw4.y, pw4.z, pw4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (g4 + u < G) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g4 + u][c] = fmaf(pw[u], x[c], acc[g4 + u][c]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(s_s + (group * G + g) * D + 4 * quad) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  float* acc_out = part_acc + part * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int r = 0; r < L::kRowGroups; ++r) x += s_s[r * G * D + i];
    acc_out[i] = x;
  }
}

// --- the combine -------------------------------------------------------------

// grid (ceil(D / kCombineD), G, B * KVH); dynamic shared memory holds one
// weight per chunk.  Warp 0 turns the live chunks' maxima into weights
// w_c = exp(m_c - M) and l = sum_c w_c l_c while every thread's loads of its
// chunks' values are in flight; thread (dd, group) then sums w_c acc_c over
// chunks c = group, group + kGroups, ..., and the groups meet in shared memory.
template <int G, int D, typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const int* __restrict__ length, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, const float* __restrict__ part_acc,
                      TQ* __restrict__ out, int kvh, int s, int n_chunks) {
  constexpr int kTileD = D < kCombineD ? D : kCombineD;
  constexpr int kGroups = kThreads / kTileD;
  constexpr int kAhead = 8;
  extern __shared__ float w_s[];  // (n_chunks,)
  __shared__ float red[kGroups][kTileD];
  __shared__ float l_total;
  const int g = blockIdx.y;
  const int bk = blockIdx.z;  // b * KVH + kh
  const int b = bk / kvh;
  const int tid = threadIdx.x;
  const int dd = tid % kTileD;
  const int group = tid / kTileD;
  const int d = blockIdx.x * kTileD + dd;
  const int len = min(length[b], s);
  const int live = len > 0 ? (len + kChunk - 1) / kChunk : 0;
  const size_t base = static_cast<size_t>(bk) * n_chunks;

  float ahead[kAhead];  // this thread's first chunks' values, loaded early
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int c = group + i * kGroups;
    ahead[i] = c < live ? part_acc[((base + c) * G + g) * D + d] : 0.f;
  }
  if (tid < 32) {
    float m = -CUDART_INF_F;
    for (int c = tid; c < live; c += 32) m = fmaxf(m, part_m[(base + c) * G + g]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = tid; c < live; c += 32) {
      const float w = expf(part_m[(base + c) * G + g] - m);
      w_s[c] = w;
      l += w * part_l[(base + c) * G + g];
    }
    l = warp_sum(l);
    if (tid == 0) l_total = l;
  }
  __syncthreads();
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int c = group + i * kGroups;
    if (c < live) a = fmaf(w_s[c], ahead[i], a);
  }
  for (int c = group + kAhead * kGroups; c < live; c += kGroups)
    a = fmaf(w_s[c], part_acc[((base + c) * G + g) * D + d], a);
  red[group][dd] = a;
  __syncthreads();
  if (group == 0) {
    for (int r = 1; r < kGroups; ++r) a += red[r][dd];
    store(out + (static_cast<size_t>(bk) * G + g) * D + d, a / fmaxf(l_total, 1e-30f));
  }
}

template <int G, int D, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* length, float* part_m,
           float* part_l, float* part_acc, void* out, int b, int kvh, int s,
           cudaStream_t stream) {
  using L = Layout<G, D, TKV>;
  const int n_chunks = (s + kChunk - 1) / kChunk;
  auto partial = decode_partial_kernel<G, D, TQ, TKV>;
  // The first pass takes more than the default 48 KB of dynamic shared
  // memory: raise its limit once on each device, not on every call.
  static std::atomic<uint64_t> raised{0};  // one bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  partial<<<dim3(n_chunks, kvh, b), kThreads, L::kBytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), length,
      part_m, part_l, part_acc, kvh, s, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kTileD = D < kCombineD ? D : kCombineD;
  decode_combine_kernel<G, D, TQ><<<dim3(D / kTileD, G, b * kvh), kThreads,
                                    n_chunks * sizeof(float), stream>>>(
      length, part_m, part_l, part_acc, static_cast<TQ*>(out), kvh, s, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int G, int D>
int launch_types(const void* q, const void* k, const void* v, const int* length, float* part_m,
                 float* part_l, float* part_acc, void* out, int b, int kvh, int s, int q_bf16,
                 int kv_bf16, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<G, D, bf16, bf16>(q, k, v, length, part_m, part_l, part_acc, out, b, kvh, s, st);
  if (q_bf16)
    return launch<G, D, bf16, float>(q, k, v, length, part_m, part_l, part_acc, out, b, kvh, s, st);
  if (kv_bf16)
    return launch<G, D, float, bf16>(q, k, v, length, part_m, part_l, part_acc, out, b, kvh, s, st);
  return launch<G, D, float, float>(q, k, v, length, part_m, part_l, part_acc, out, b, kvh, s, st);
}

}  // namespace

// q (B, H, D); k, v (B, S, KVH, D), 16-byte aligned; length (B,) int32; out
// (B, H, D) in q's type; part_m, part_l (B, KVH, ceil(S / 64), G) and
// part_acc (B, KVH, ceil(S / 64), G, D) float32 scratch.  All contiguous on
// the current device.  q_bf16 and kv_bf16 select bfloat16 (1) or float32 (0).
// G = H / KVH and D must be one of the instantiated pairs below (the Python
// wrapper's INSTANTIATED); any other returns cudaErrorInvalidValue.  Launches
// on `stream` and returns cudaGetLastError(), so a refused launch is reported.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const int* length,
                                float* part_m, float* part_l, float* part_acc, void* out,
                                int b, int h, int kvh, int d, int s, int q_bf16, int kv_bf16,
                                void* stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (kvh <= 0 || h % kvh != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = h / kvh;
#define DECODE_CASE(G, D)                                                                    \
  if (g == G && d == D)                                                                      \
    return launch_types<G, D>(q, k, v, length, part_m, part_l, part_acc, out, b, kvh, s, q_bf16, \
                              kv_bf16, st);
  DECODE_CASE(10, 256)  // recurrentgemma-2b
  DECODE_CASE(8, 64)    // tinyllama-1.1b
  DECODE_CASE(3, 64)    // smollm-135m (granite-moe-3b has the same pair)
  DECODE_CASE(4, 16)    // the reduced configurations of both
  DECODE_CASE(4, 64)    // the parity shapes of tests/test_kernels.py
  DECODE_CASE(1, 32)
  DECODE_CASE(3, 16)
  DECODE_CASE(4, 32)
#undef DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
