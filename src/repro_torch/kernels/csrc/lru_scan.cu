// Linear-recurrence scan h_t = a_t * h_{t-1} + b_t along time (the RG-LRU
// core), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.lru_scan.lru_scan_pallas
// (src/repro/kernels/lru_scan.py:52, body _kernel at :33-46).  a, b are
// (B, T, R), both float32 or both bfloat16, and h0 is (B, R) float32; the
// state is float32 and h (B, T, R) is written in a's type.
//
// What bounds it: each element of a and b is read once and each h written
// once, with one fused multiply-add per element.  At the serving path's
// prefill (B 4, T 4096, R 2560, float32) that is 503 MB, 150 us at
// 3.35 TB/s, against 84 MFLOP, so bytes bind.
//
// Design: the Pallas kernel tiles T and R and carries the state in scratch
// across a sequential T grid axis, padding ragged tiles with a = 0.  Here one
// thread owns one (b, r) channel and walks all of T with the state in a
// register; neighbouring threads take neighbouring r, so every load and store
// of a time step is coalesced, and the last block masks its own edge, so
// nothing is padded.  Each thread loads kAhead steps of a and b before it
// runs their chain, so kAhead loads per array are in flight while the
// dependent multiply-adds wait on none of them.  At the path's shape B * R =
// 10,240 threads are 80 blocks of 128 on 132 SMs.  The kernel reaches about
// a quarter of the memory rate; 32 steps ahead in one-warp blocks, spread
// over all SMs, measured the same on the card, so per-thread load latency is
// not what holds it.  Splitting T with a carry pass (later work) would give
// the recurrence more parallelism.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;  // time steps loaded before their chain runs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                T* __restrict__ out, int batch, int t_n, int r_n) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * r_n) return;
  const int bi = static_cast<int>(idx / r_n);
  const int r = static_cast<int>(idx - static_cast<long long>(bi) * r_n);
  const size_t base = static_cast<size_t>(bi) * t_n * r_n + r;
  float h = h0[idx];
  for (int t0 = 0; t0 < t_n; t0 += kAhead) {
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const size_t off = base + static_cast<size_t>(t0 + i) * r_n;
      const bool live = t0 + i < t_n;
      av[i] = live ? to_f32(a[off]) : 0.f;
      bv[i] = live ? to_f32(b[off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t0 + i < t_n) {
        h = fmaf(av[i], h, bv[i]);
        store(out + base + static_cast<size_t>(t0 + i) * r_n, h);
      }
    }
  }
}

}  // namespace

// a, b, out (B, T, R), all bfloat16 (is_bf16 = 1) or all float32 (0); h0
// (B, R) float32; contiguous on the current device.  Launches on `stream` and
// returns cudaGetLastError(), so a refused launch is reported.
extern "C" int lru_scan(const void* a, const void* b, const float* h0, void* out, int batch,
                        int t_n, int r_n, int is_bf16, void* stream) {
  const long long n = static_cast<long long>(batch) * r_n;
  if (n <= 0 || t_n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    lru_scan_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), h0, static_cast<bf16*>(out),
        batch, t_n, r_n);
  } else {
    lru_scan_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), h0,
        static_cast<float*>(out), batch, t_n, r_n);
  }
  return static_cast<int>(cudaGetLastError());
}
