// Fused fleet evaluation of both exponent log-posteriors (Eqs 10 and 11),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.posterior_grid.posterior_grid_fleet_pallas
// (src/repro/kernels/posterior_grid.py:108, body _fleet_kernel at :52-101).
// For every worker k and grid point g:
//
//   out[k,0,g] = -lam/2 * (A0 - 2 mu <pg, u> + mu^2 <pg^2, wb2>)
//                + (a_a - 1) log g + (a_b - 1) log(1 - g)
//   out[k,1,g] = -lam/2 * <1/pg^2, w> - g * sum(m log f)
//                + (b_a - 1) log g + (b_b - 1) log(1 - g)
//
// with pg = f^g (f clamped at 1e-6), wb2 = m f^(-2 beta), u = wb2 t,
// A0 = sum(u t), w = m r^2 and r = t - f^alpha mu.
//
// What bounds it: each (k, g, n) cell costs one exp, one reciprocal and
// about eight other float32 operations, about 10 in all, against 12 bytes of
// telemetry per (k, n) that every grid point shares.  At K = 4096, G = 256,
// N = 256 that is 2.7e9 operations (40 us at the card's 67 TFLOP/s float32
// peak) against about 21 MB (6 us at 3.35 TB/s), so it is bound by
// operations, and the exp and the reciprocal run on the slower
// special-function unit.
//
// Design: the Pallas kernel accumulated its output across a sequential N grid
// axis.  GPU blocks run in no order, so here one block owns one (worker, tile
// of 128 grid points) pair, one thread per grid point, and loops over N
// itself: each step stages 128 observations' O(N) terms (log f, u, wb2, w)
// in shared memory, computed once per observation rather than once per cell,
// and every thread accumulates its three inner products in float32
// registers.  A0 and sum(m log f) come from a block reduction at the end, and
// the prior terms are added once.  Ragged G and N are masked by bounds
// checks, so nothing is padded.  No fast-math: expf/logf/log1pf and IEEE
// division, to stay within the reference's tolerance.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockG = 128;  // grid points per block, one per thread
constexpr int kTileN = kBlockG;  // observations staged per step, one per thread
constexpr int kWarps = kBlockG / 32;
constexpr int kParams = 8;  // mu, lam, alpha, beta, a_a, a_b, b_a, b_b

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kBlockG)
posterior_grid_fleet_kernel(const float* __restrict__ grid,
                            const float* __restrict__ t,
                            const float* __restrict__ f,
                            const float* __restrict__ mask,
                            const float* __restrict__ params,
                            float* __restrict__ out,
                            int n, int g_n) {
  __shared__ float s_logf[kTileN];
  __shared__ float s_u[kTileN];
  __shared__ float s_wb2[kTileN];
  __shared__ float s_w[kTileN];
  __shared__ float s_red[2][kWarps];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int gi = blockIdx.y * kBlockG + tid;
  const bool live = gi < g_n;

  const float* pk = params + static_cast<size_t>(k) * kParams;
  const float mu = pk[0];
  const float lam = pk[1];
  const float alpha = pk[2];
  const float beta = pk[3];
  const float g = live ? grid[gi] : 0.5f;

  const size_t row = static_cast<size_t>(k) * n;
  const float* tk = t + row;
  const float* fk = f + row;
  const float* mk = mask + row;

  float s1 = 0.f, s2 = 0.f, s3 = 0.f;  // <pg, u>, <pg^2, wb2>, <1/pg^2, w>
  float a0 = 0.f, sum_logf = 0.f;      // this thread's share of the row sums

  for (int n0 = 0; n0 < n; n0 += kTileN) {
    const int j = n0 + tid;
    float lf = 0.f, u = 0.f, wb2 = 0.f, w = 0.f;
    if (j < n) {
      const float fj = fmaxf(fk[j], 1e-6f);
      const float tj = tk[j];
      const float m = mk[j];
      lf = logf(fj);
      wb2 = m * expf(-2.0f * beta * lf);
      u = wb2 * tj;
      const float r = tj - expf(alpha * lf) * mu;
      w = m * r * r;
      a0 += u * tj;
      sum_logf += lf * m;
    }
    s_logf[tid] = lf;
    s_u[tid] = u;
    s_wb2[tid] = wb2;
    s_w[tid] = w;
    __syncthreads();

    const int count = min(kTileN, n - n0);
    for (int i = 0; i < count; ++i) {
      const float pg = expf(g * s_logf[i]);
      const float pg2 = pg * pg;
      s1 += pg * s_u[i];
      s2 += pg2 * s_wb2[i];
      s3 += (1.0f / pg2) * s_w[i];
    }
    __syncthreads();
  }

  // Block sums of A0 and sum(m log f), in a fixed order on every thread.
  a0 = warp_sum(a0);
  sum_logf = warp_sum(sum_logf);
  if ((tid & 31) == 0) {
    s_red[0][tid >> 5] = a0;
    s_red[1][tid >> 5] = sum_logf;
  }
  __syncthreads();
  a0 = 0.f;
  sum_logf = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    a0 += s_red[0][i];
    sum_logf += s_red[1][i];
  }

  if (live) {
    const float gc = fminf(fmaxf(g, 1e-6f), 1.0f - 1e-6f);
    const float lg = logf(gc);
    const float l1mg = log1pf(-gc);
    const float quad_a = -0.5f * lam * (a0 - 2.0f * mu * s1 + mu * mu * s2);
    const float quad_b = -0.5f * lam * s3;
    float* ok = out + static_cast<size_t>(k) * 2 * g_n;
    ok[gi] = (pk[4] - 1.0f) * lg + (pk[5] - 1.0f) * l1mg + quad_a;
    ok[g_n + gi] = (pk[6] - 1.0f) * lg + (pk[7] - 1.0f) * l1mg - g * sum_logf + quad_b;
  }
}

}  // namespace

// grid (G,); t, f, mask (K, N); params (K, 8); out (K, 2, G); all float32,
// contiguous, on the current device.  Launches on `stream` and returns
// cudaGetLastError(), so a refused launch is reported to the caller.
extern "C" int posterior_grid_fleet(const float* grid, const float* t, const float* f,
                                    const float* mask, const float* params, float* out,
                                    int k, int n, int g_n, void* stream) {
  if (k <= 0 || g_n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 blocks(k, (g_n + kBlockG - 1) / kBlockG);
  posterior_grid_fleet_kernel<<<blocks, kBlockG, 0, static_cast<cudaStream_t>(stream)>>>(
      grid, t, f, mask, params, out, n, g_n);
  return static_cast<int>(cudaGetLastError());
}
