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
// Two modes.  The general one computes <1/pg^2, w> as written.  The mirrored
// one (`mirror`, the reference's symmetric_grid=True, which the Gibbs sweep
// asks for) holds only for a grid with g_i + g_(G-1-i) = s for all i, as
// `exponent_grid` is: there f^(-2 g_i) = f^(-2s) f^(2 g_(G-1-i)), so the
// thread of grid point i accumulates <pg^2, w f^(-2s)> beside its alpha-mode
// sums and writes it to index G-1-i of the beta row.  No reciprocal per cell.
//
// What bounds it: each (k, g, n) cell of the mirrored mode costs nine float32
// operations (a multiply, the exp2, a square and three fused multiply-adds
// counted as two each; the general mode adds a reciprocal), against 12 bytes
// of telemetry per (k, n) that every grid point shares.  At K = 4096,
// G = 256, N = 256 that is 2.7e8 cells and 2.4e9 operations (36 us at the
// card's 67 TFLOP/s float32 peak), against about 21 MB (6 us at 3.35 TB/s):
// bound by operations.  The exp2 runs on the special-function unit, 16 per
// clock on each of 132 SMs, so one per cell puts a floor of about 64 us under
// the kernel at the card's 1.98 GHz boost clock; the other instructions of a
// cell (two multiplies, three fused multiply-adds, a quarter of a 16-byte
// shared load) issue beside it.
//
// Design: the Pallas kernel accumulated its output across a sequential N grid
// axis.  Here one block of 64 threads owns one worker and all its grid points
// (kPoints = 4 per thread, 256 per pass; a larger grid takes further passes).
// The per-observation terms (log2 f, u, wb2, w) are computed once per worker
// into shared memory, packed into one float4 per observation, so that each
// observation costs one 16-byte broadcast load for four cells; then every
// thread walks N accumulating its points' three inner products in float32
// registers, so the shared-memory loads take a quarter of an issue slot per
// cell and leave the slots to the arithmetic.  pg = 2^(g log2 f) on the
// staged log2 f, with ex2.approx (the instruction exp2f itself uses for
// exponents above -126; here |g log2 f| stays below 20 for f >= 1e-6 and a
// grid inside [0, 1]).  A0 and sum(m log f) come from a block reduction, and
// the prior terms are added once.  No fast-math flag: logf, expf and log1pf
// keep their full precision where they run once per observation or point.
#include <cuda_runtime.h>

namespace {

constexpr int kPass = 256;         // grid points per pass over N
constexpr int kPoints = 4;         // grid points per thread
constexpr int kThreads = kPass / kPoints;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileN = 2048;    // observations staged at once (32 KB of float4)
constexpr int kParams = 8;         // mu, lam, alpha, beta, a_a, a_b, b_a, b_b

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kMirror>
__global__ void __launch_bounds__(kThreads)
posterior_grid_fleet_kernel(const float* __restrict__ grid,
                            const float* __restrict__ t,
                            const float* __restrict__ f,
                            const float* __restrict__ mask,
                            const float* __restrict__ params,
                            float* __restrict__ out,
                            int n, int g_n, int tile_n) {
  extern __shared__ float4 terms[];  // (tile_n,) of (log2 f, u, wb2, w)
  __shared__ float s_red[2][kWarps];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pk = params + static_cast<size_t>(k) * kParams;
  const float mu = pk[0];
  const float lam = pk[1];
  const float alpha = pk[2];
  const float beta = pk[3];
  // f^(-2s) turns the beta mode's weights into the mirrored ones.
  const float two_s = kMirror ? 2.0f * (grid[0] + grid[g_n - 1]) : 0.f;

  const size_t row = static_cast<size_t>(k) * n;
  const float* tk = t + row;
  const float* fk = f + row;
  const float* mk = mask + row;
  float* ok = out + static_cast<size_t>(k) * 2 * g_n;

  float a0 = 0.f, sum_logf = 0.f;  // this thread's share, then the block's sums
  for (int g0 = 0; g0 < g_n; g0 += kPass) {  // one pass for G <= 256
    // This thread's points: g0 + tid + p * kThreads.
    float g[kPoints];
    float s1[kPoints], s2[kPoints], s3[kPoints];  // <pg, u>, <pg^2, wb2>, <pg^-2, w> or mirrored
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const int gi = g0 + tid + p * kThreads;
      g[p] = gi < g_n ? grid[gi] : 0.5f;
      s1[p] = s2[p] = s3[p] = 0.f;
    }
    for (int n0 = 0; n0 < n; n0 += tile_n) {
      const int count = min(tile_n, n - n0);
      if (g0 == 0 || n > tile_n) {  // stage the tile, once per worker if N fits one
        __syncthreads();
        for (int i = tid; i < count; i += kThreads) {
          const int j = n0 + i;
          const float fj = fmaxf(fk[j], 1e-6f);
          const float tj = tk[j];
          const float m = mk[j];
          const float lf = logf(fj);
          const float wb2 = m * expf(-2.0f * beta * lf);
          const float u = wb2 * tj;
          const float r = tj - expf(alpha * lf) * mu;
          float w = m * r * r;
          if (kMirror) w *= expf(-two_s * lf);
          if (g0 == 0) {
            a0 += u * tj;
            sum_logf += lf * m;
          }
          terms[i] = make_float4(log2f(fj), u, wb2, w);
        }
        __syncthreads();
      }
#pragma unroll 4
      for (int i = 0; i < count; ++i) {
        const float4 c = terms[i];  // the same address across the block: a broadcast
#pragma unroll
        for (int p = 0; p < kPoints; ++p) {
          const float pg = ex2(g[p] * c.x);
          const float pg2 = pg * pg;
          s1[p] = fmaf(pg, c.y, s1[p]);
          s2[p] = fmaf(pg2, c.z, s2[p]);
          s3[p] = fmaf(kMirror ? pg2 : __fdividef(1.0f, pg2), c.w, s3[p]);
        }
      }
    }

    if (g0 == 0) {  // block sums of A0 and sum(m log f), in a fixed order
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
    }

#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const int gi = g0 + tid + p * kThreads;
      if (gi >= g_n) continue;
      const float gc = fminf(fmaxf(g[p], 1e-6f), 1.0f - 1e-6f);
      const float quad_a = -0.5f * lam * (a0 - 2.0f * mu * s1[p] + mu * mu * s2[p]);
      ok[gi] = (pk[4] - 1.0f) * logf(gc) + (pk[5] - 1.0f) * log1pf(-gc) + quad_a;
      // The beta row's point: this one, or its mirror image.
      const int gb = kMirror ? g_n - 1 - gi : gi;
      const float gv = kMirror ? grid[gb] : g[p];
      const float gvc = fminf(fmaxf(gv, 1e-6f), 1.0f - 1e-6f);
      ok[g_n + gb] = (pk[6] - 1.0f) * logf(gvc) + (pk[7] - 1.0f) * log1pf(-gvc)
                     - gv * sum_logf - 0.5f * lam * s3[p];
    }
  }
}

}  // namespace

// grid (G,); t, f, mask (K, N); params (K, 8); out (K, 2, G); all float32,
// contiguous, on the current device.  mirror = 1 takes the mirrored form of
// the beta mode, valid only for a grid symmetric about its midpoint.
// Launches on `stream` and returns cudaGetLastError(), so a refused launch is
// reported to the caller.
extern "C" int posterior_grid_fleet(const float* grid, const float* t, const float* f,
                                    const float* mask, const float* params, float* out,
                                    int k, int n, int g_n, int mirror, void* stream) {
  if (k <= 0 || g_n <= 0) return static_cast<int>(cudaSuccess);
  const int tile_n = n < 1 ? 1 : (n < kMaxTileN ? n : kMaxTileN);
  const size_t smem = static_cast<size_t>(tile_n) * sizeof(float4);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mirror)
    posterior_grid_fleet_kernel<true><<<k, kThreads, smem, st>>>(grid, t, f, mask, params, out,
                                                                 n, g_n, tile_n);
  else
    posterior_grid_fleet_kernel<false><<<k, kThreads, smem, st>>>(grid, t, f, mask, params, out,
                                                                  n, g_n, tile_n);
  return static_cast<int>(cudaGetLastError());
}
