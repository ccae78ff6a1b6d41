// Linear-recurrence scan h_t = a_t * h_{t-1} + b_t along time (the RG-LRU
// core), hand-written for Hopper (sm_90a): a single-pass chunked scan with a
// chained carry.
//
// Replaces the TPU kernel repro.kernels.lru_scan.lru_scan_pallas
// (src/repro/kernels/lru_scan.py:52, body _kernel at :33-46).  a, b are
// (B, T, R), both float32 or both bfloat16, and h0 is (B, R) float32; the
// state is float32 and h (B, T, R) is written in a's type.
//
// What bounds it: each element of a and b is read once and each h written
// once, with one fused multiply-add per element.  At the serving path's
// prefill (B 4, T 4096, R 2560, float32) that is 503 MB, 150 us at
// 3.35 TB/s, against 84 MFLOP, so bytes bind.  The card holds that rate only
// with ~25 KB in flight on every SM; one thread per (b, r) channel walking
// all of T (this kernel's first version) gave 80 blocks and ~8 KB in flight
// per busy SM, a quarter of the rate.
//
// Design.  The Pallas kernel runs T in order on one core and carries h in
// scratch across the sequential grid axis.  Here T is cut into chunks of
// kChunk steps and R into channel tiles of kWidth, and a block, one warp,
// takes one tile (b, channel tile, chunk): at the path's shape 10,240 tiles
// of 32 KB of a and b, six blocks on an SM (shared memory bounds it).
// Each block:
//
//   1. takes its tile id from an atomic counter, chunk-major (id = chunk *
//      B * ceil(R / W) + b * ceil(R / W) + channel tile), so it only ever
//      waits on a tile that a block already running holds: forward progress
//      does not rest on the order in which blocks are scheduled;
//   2. stages its tile of a and b in shared memory, issued before anything
//      else: one TMA bulk copy per time row on one mbarrier, or, where a
//      row is not 16-byte aligned (R x element size not a multiple of 16),
//      plain loads of each thread's own column, 32 rows in flight.  No
//      thread reads another's column.  The plain loads are slower at the
//      path's shape (PERF.md, K3), so TMA takes every row it can;
//   3. walks its chunk from a zero state, one thread per channel, for the
//      chunk's decay A = prod a_t and local end state H;
//   4. takes the inclusive state h_in of the same (b, channel) at chunk - 1
//      (chunk 0 takes h0) and publishes its own, h_in * A + H.  Each carry
//      is one 64-bit word, the float's bits and a ready flag above them,
//      stored and polled whole (st/ld.relaxed.gpu, single-copy atomic), so
//      each thread waits for its own channel alone and a hop costs one
//      store and one poll: no fence, no block barrier, no second read.
//      Only the immediate predecessor's inclusive state is read, never a
//      combination of aggregates, so every call rounds alike and gives the
//      same bits;
//   5. walks the chunk again from h_in in shared memory and writes h, W
//      channels of a time step in one coalesced row.
//
// a and b are read once and h written once; the carries add B R (T / C - 1)
// words of 8 bytes.  The counter and the carries live in the caller's
// workspace, cleared by cudaMemsetAsync on the launch's stream before every
// launch, so a CUDA graph that captures a call replays it correctly.  The
// tile is fixed here; the Python wrapper (kernels/lru_scan.py, scan_layout)
// sizes the workspace and passes the tile it assumed, which must be this.
//
// The backward (entry point lru_scan_bwd).  The TPU kernel has none: the
// reference's model stack scans with lax.associative_scan and differentiates
// it with jax.grad (src/repro/models/recurrent.py:344).  The port runs K3 in
// that place, so it needs one.  With upstream gradient dy,
//
//   g_t = dy_t + a_{t+1} g_{t+1}  (g_{T-1} = dy_{T-1}),
//   db_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0),  dh0 = a_0 g_0,
//
// a linear recurrence run in reverse time with a shifted by one step.  It
// reads a, dy and h once and writes da and db, 5/3 of the forward's bytes:
// at the training path's (B 2, T 512, R 2560) float32 52.4 MB, 15.7 us at
// 3.35 TB/s, so bytes bind.  It is the forward's scan walking time
// backwards, on a tile of its own (kBwdChunk steps by kBwdWidth channels,
// one thread a channel), tiles numbered so that the LAST chunk comes first
// (id = (n_chunks - 1 - chunk) * B * ceil(R / W) + ...): a block again
// waits only on a tile a running block holds.  Each block
//
//   1. stages all three inputs of its tile before anything else, by TMA
//      bulk copies on one mbarrier: a_{t+1} and dy of rows t0 .., and
//      h_{t-1}, h's rows t0 - 1 .. t0 + steps - 2 (at t0 = 0, h0 takes the
//      row before the first, read into a register); or, where a row is not
//      16-byte aligned, plain loads of each thread's own column, 16 rows of
//      all three in flight.  The first version left h to plain loads in the
//      second walk, one row a step: ~1 KB in flight a warp, some 16 serial
//      round trips to DRAM a 128-step chunk, 38 % of the bound;
//   2. walks it backwards from a zero state for its decay and local g;
//   3. takes the successor chunk's inclusive g (its first row's) and
//      publishes its own in the carry word of chunk - 1, as the forward;
//   4. walks it again from shared memory alone, writing db = g and
//      da = g h_{t-1}, one coalesced row of each a step.
//
// g is float32 in both types.  The tile, 64 steps by 64 channels (two
// warps), is the fastest of the candidates timed at the training shape, and
// at the prefill shape too (tools/tune_lru_scan_bwd.py builds each with
// -DLRU_SCAN_BWD_CHUNK and -DLRU_SCAN_BWD_WIDTH; PERF.md): at (2, 512, 2560)
// 8 chunks x 2 x 40 = 640 tiles of 48 KB in float32, whose 256-byte rows
// take half the copies of 128-byte ones.  There the inputs (31.5 MB) exceed
// the card's shared memory (132 x 227 KB), so some tiles start in a second
// wave whatever the tile.  dh0 is one elementwise product on (B, R), left to
// the wrapper.  The workspace is laid out as the forward's, sized for the
// backward's chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace {

constexpr int kChunk = 128;  // time steps of a tile
constexpr int kWidth = 32;   // channels of a tile: one warp, one thread each
constexpr int kCounterBytes = 16;  // the workspace's tile counter, padded
constexpr uint64_t kWatchdogNs = 1000000000ull;  // longest wait on a predecessor

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// --- the chained carry: 64-bit words, the flag above the float's bits ------

constexpr unsigned long long kReady = 1ull << 32;

__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_word(unsigned long long* p, float h) {
  const unsigned long long v = kReady | __float_as_uint(h);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One block of kWidth threads per tile.  bulk = 1 stages rows by TMA.
template <typename T>
__global__ void __launch_bounds__(kWidth)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                T* __restrict__ out, int* __restrict__ counter,
                unsigned long long* __restrict__ carries, int batch, int t_n, int r_n,
                int bulk) {
  __shared__ __align__(16) T a_s[kChunk][kWidth];
  __shared__ __align__(16) T b_s[kChunk][kWidth];
  __shared__ uint64_t bar;
  const int lane = threadIdx.x;

  // 1. The tile, in the order blocks start.
  int tile = 0;
  if (lane == 0) tile = atomicAdd(counter, 1);
  tile = __shfl_sync(0xffffffffu, tile, 0);
  const int n_rtiles = (r_n + kWidth - 1) / kWidth;
  const int per_chunk = batch * n_rtiles;  // tiles of one chunk
  const int c = tile / per_chunk;
  const int bi = (tile - c * per_chunk) / n_rtiles;
  const int r0 = (tile - c * per_chunk - bi * n_rtiles) * kWidth;
  const int t0 = c * kChunk;
  const int steps = min(kChunk, t_n - t0);  // the last chunk's ragged edge
  const size_t row0 = (static_cast<size_t>(bi) * t_n + t0) * r_n + r0;  // (b, t0, r0)

  // 2. Every row of the tile in flight at once.
  if (bulk) {
    const uint32_t row_bytes = static_cast<uint32_t>(min(kWidth, r_n - r0) * sizeof(T));
    if (lane == 0) {
      mbar_init(&bar);
      mbar_fence_init();
      mbar_arrive_expect(&bar, 2u * steps * row_bytes);
    }
    __syncwarp();
    for (int j = lane; j < steps; j += kWidth) {
      const size_t off = row0 + static_cast<size_t>(j) * r_n;
      bulk_copy(&a_s[j][0], a + off, row_bytes, &bar);
      bulk_copy(&b_s[j][0], b + off, row_bytes, &bar);
    }
    mbar_wait(&bar, 0);
  }
  if (r0 + lane >= r_n) return;  // past the last channel tile's edge
  const size_t first = row0 + lane;
  if (!bulk && steps == kChunk) {  // each thread its own column, 32 rows in flight
#pragma unroll 32
    for (int j = 0; j < kChunk; ++j) {
      a_s[j][lane] = a[first + static_cast<size_t>(j) * r_n];
      b_s[j][lane] = b[first + static_cast<size_t>(j) * r_n];
    }
  } else if (!bulk) {  // the last chunk's ragged edge
    for (int j = 0; j < steps; ++j) {
      a_s[j][lane] = a[first + static_cast<size_t>(j) * r_n];
      b_s[j][lane] = b[first + static_cast<size_t>(j) * r_n];
    }
  }

  // 3. The chunk's own decay and end state, from a zero state.
  float decay = 1.f, local = 0.f;
#pragma unroll 8
  for (int j = 0; j < steps; ++j) {
    const float aj = to_f32(a_s[j][lane]);
    local = fmaf(aj, local, to_f32(b_s[j][lane]));
    decay *= aj;
  }

  // 4. The inclusive state before the chunk, then this chunk's, published.
  const size_t chan = static_cast<size_t>(bi) * r_n + r0 + lane;  // (b, r)
  const size_t plane = static_cast<size_t>(batch) * r_n;          // carries of one chunk
  float h;
  if (c == 0) {
    h = h0[chan];
  } else {
    // The predecessor is held by a running block and publishes within
    // microseconds; a wait of a second means a broken workspace, and traps
    // (a launch failure the caller sees) instead of holding the card.
    const unsigned long long* p = carries + static_cast<size_t>(c - 1) * plane + chan;
    const uint64_t start = global_ns();
    unsigned long long v;
    while (!((v = ld_word(p)) & kReady)) {
      if (global_ns() - start > kWatchdogNs) __trap();
    }
    h = __uint_as_float(static_cast<unsigned>(v));
  }
  if (t0 + kChunk < t_n)  // a later chunk waits on this one
    st_word(carries + static_cast<size_t>(c) * plane + chan, fmaf(decay, h, local));

  // 5. The chunk's h from h_in, one coalesced row of W channels per step.
  T* o = out + first;
#pragma unroll 8
  for (int j = 0; j < steps; ++j) {
    h = fmaf(to_f32(a_s[j][lane]), h, to_f32(b_s[j][lane]));
    store(o + static_cast<size_t>(j) * r_n, h);
  }
}

template <typename T>
void launch(const void* a, const void* b, const float* h0, void* out, int* counter,
            unsigned long long* carries, int batch, int t_n, int r_n, long long n_tiles,
            cudaStream_t st) {
  // TMA bulk copies take rows of a multiple of 16 bytes at 16-byte addresses.
  const int bulk = (r_n * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  lru_scan_kernel<T><<<static_cast<unsigned>(n_tiles), kWidth, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, static_cast<T*>(out), counter,
      carries, batch, t_n, r_n, bulk);
}

// The backward's tile: kBwdChunk steps by kBwdWidth channels, one thread a
// channel.  Its shared memory (a_{t+1}, dy and h_{t-1} of one tile) is
// dynamic, above 48 KB only after cudaFuncSetAttribute.
#ifndef LRU_SCAN_BWD_CHUNK
#define LRU_SCAN_BWD_CHUNK 64
#endif
#ifndef LRU_SCAN_BWD_WIDTH
#define LRU_SCAN_BWD_WIDTH 64
#endif
constexpr int kBwdChunk = LRU_SCAN_BWD_CHUNK;
constexpr int kBwdWidth = LRU_SCAN_BWD_WIDTH;
static_assert(kBwdChunk > 0 && kBwdWidth % 32 == 0 && kBwdWidth <= 1024, "a tile of whole warps");

template <typename T>
constexpr size_t bwd_smem_bytes() {
  return 3ull * kBwdChunk * kBwdWidth * sizeof(T);
}

// The backward: one block of kBwdWidth threads per tile, the last chunk
// first.  a_s[j] holds a at t0 + 1 + j (0 past the sequence's end), dy_s[j]
// dy at t0 + j and h_s[j] h at t0 + j - 1 (at t0 = 0, h_s[0] is not staged:
// h0 stands there).
template <typename T>
__global__ void __launch_bounds__(kBwdWidth)
lru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ dy, const T* __restrict__ h,
                    const float* __restrict__ h0, T* __restrict__ da, T* __restrict__ db,
                    int* __restrict__ counter, unsigned long long* __restrict__ carries,
                    int batch, int t_n, int r_n, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Row = T[kBwdWidth];
  Row* a_s = reinterpret_cast<Row*>(smem);
  Row* dy_s = a_s + kBwdChunk;
  Row* h_s = dy_s + kBwdChunk;
  __shared__ uint64_t bar;
  __shared__ int tile_s;
  const int lane = threadIdx.x;  // the thread's channel in the tile

  // 1. The tile, in the order blocks start: chunks from the last.
  if (lane == 0) tile_s = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = tile_s;
  const int n_chunks = (t_n + kBwdChunk - 1) / kBwdChunk;
  const int n_rtiles = (r_n + kBwdWidth - 1) / kBwdWidth;
  const int per_chunk = batch * n_rtiles;
  const int k = tile / per_chunk;  // chunks from the end
  const int c = n_chunks - 1 - k;
  const int bi = (tile - k * per_chunk) / n_rtiles;
  const int r0 = (tile - k * per_chunk - bi * n_rtiles) * kBwdWidth;
  const int t0 = c * kBwdChunk;
  const int steps = min(kBwdChunk, t_n - t0);
  const int n_next = t0 + steps < t_n ? steps : steps - 1;  // rows of a_{t+1} inside T
  const int h_lo = t0 > 0 ? 0 : 1;  // h_s's first staged row
  const size_t row0 = (static_cast<size_t>(bi) * t_n + t0) * r_n + r0;  // (b, t0, r0)

  // 2. dy at t0.., a at t0 + 1.., h at t0 - 1..: every row in flight at once.
  if (bulk) {
    const uint32_t row_bytes = static_cast<uint32_t>(min(kBwdWidth, r_n - r0) * sizeof(T));
    if (lane == 0) {
      mbar_init(&bar);
      mbar_fence_init();
      mbar_arrive_expect(&bar, static_cast<uint32_t>(2 * steps + n_next - h_lo) * row_bytes);
    }
    __syncthreads();
    for (int j = lane; j < steps; j += kBwdWidth) {
      const size_t off = row0 + static_cast<size_t>(j) * r_n;
      bulk_copy(&dy_s[j][0], dy + off, row_bytes, &bar);
      if (j < n_next) bulk_copy(&a_s[j][0], a + off + r_n, row_bytes, &bar);
      if (j >= h_lo) bulk_copy(&h_s[j][0], h + (off - r_n), row_bytes, &bar);
    }
    mbar_wait(&bar, 0);
  }
  if (r0 + lane >= r_n) return;  // past the last channel tile's edge
  const size_t first = row0 + lane;
  if (!bulk && steps == kBwdChunk && n_next == steps && h_lo == 0) {
    // each thread its own column, 16 rows of all three in flight
#pragma unroll 16
    for (int j = 0; j < kBwdChunk; ++j) {
      const size_t off = first + static_cast<size_t>(j) * r_n;
      dy_s[j][lane] = dy[off];
      a_s[j][lane] = a[off + r_n];
      h_s[j][lane] = h[off - r_n];
    }
  } else if (!bulk) {  // a chunk at either end of the sequence
    for (int j = 0; j < steps; ++j) {
      const size_t off = first + static_cast<size_t>(j) * r_n;
      dy_s[j][lane] = dy[off];
      if (j < n_next) a_s[j][lane] = a[off + r_n];
      if (j >= h_lo) h_s[j][lane] = h[off - r_n];
    }
  }
  if (n_next < steps) store(&a_s[steps - 1][lane], 0.f);  // g_T = 0 has no a_T

  // 3. The chunk's own decay and first-row g, from a zero state at its end.
  float decay = 1.f, local = 0.f;
#pragma unroll 8
  for (int j = steps - 1; j >= 0; --j) {
    const float aj = to_f32(a_s[j][lane]);
    local = fmaf(aj, local, to_f32(dy_s[j][lane]));
    decay *= aj;
  }

  // 4. The inclusive g after the chunk (chunk + 1's first row; 0 after the
  // last), then this chunk's, published for chunk - 1 in word c - 1.
  const size_t chan = static_cast<size_t>(bi) * r_n + r0 + lane;  // (b, r)
  const size_t plane = static_cast<size_t>(batch) * r_n;
  const float h_first = h_lo ? h0[chan] : to_f32(h_s[0][lane]);  // h_{t0 - 1}
  float g = 0.f;
  if (c < n_chunks - 1) {
    const unsigned long long* p = carries + static_cast<size_t>(c) * plane + chan;
    const uint64_t start = global_ns();
    unsigned long long v;
    while (!((v = ld_word(p)) & kReady)) {
      if (global_ns() - start > kWatchdogNs) __trap();
    }
    g = __uint_as_float(static_cast<unsigned>(v));
  }
  if (c > 0) st_word(carries + static_cast<size_t>(c - 1) * plane + chan, fmaf(decay, g, local));

  // 5. The chunk's g from the successor's, backwards, from shared memory
  // alone: db = g, da = g h_{t-1}.
  T* dap = da + first;
  T* dbp = db + first;
#pragma unroll 8
  for (int j = steps - 1; j > 0; --j) {
    g = fmaf(to_f32(a_s[j][lane]), g, to_f32(dy_s[j][lane]));
    store(dbp + static_cast<size_t>(j) * r_n, g);
    store(dap + static_cast<size_t>(j) * r_n, g * to_f32(h_s[j][lane]));
  }
  g = fmaf(to_f32(a_s[0][lane]), g, to_f32(dy_s[0][lane]));
  store(dbp, g);
  store(dap, g * h_first);
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* dy, const void* h, const float* h0, void* da,
                       void* db, int* counter, unsigned long long* carries, int batch, int t_n,
                       int r_n, long long n_tiles, cudaStream_t st) {
  // TMA bulk copies take rows of a multiple of 16 bytes at 16-byte addresses.
  const int bulk = (r_n * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0;
  constexpr size_t smem = bwd_smem_bytes<T>();
  if (smem > 46 * 1024) {  // past the default, with the static barrier beside it
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(lru_scan_bwd_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lru_scan_bwd_kernel<T><<<static_cast<unsigned>(n_tiles), kBwdWidth, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(dy), static_cast<const T*>(h), h0,
      static_cast<T*>(da), static_cast<T*>(db), counter, carries, batch, t_n, r_n, bulk);
  return cudaGetLastError();
}

// The tile and workspace checks both entry points make, each against its
// own tile (tile_chunk, tile_width); false refuses.
bool layout_ok(int batch, int t_n, int r_n, int chunk, int width, int tile_chunk, int tile_width,
               long long workspace_bytes, long long* n_tiles) {
  const long long n_chunks = (t_n + tile_chunk - 1) / tile_chunk;
  *n_tiles = n_chunks * batch * ((r_n + tile_width - 1) / tile_width);
  return chunk == tile_chunk && width == tile_width &&
         workspace_bytes == kCounterBytes + 8LL * (n_chunks - 1) * batch * r_n;
}

}  // namespace

// a, b, out (B, T, R), all bfloat16 (is_bf16 = 1) or all float32 (0); h0
// (B, R) float32; contiguous on the current device.  `chunk` and `width` are
// the tile the caller sized `workspace` for, and must be kChunk and kWidth;
// `workspace` holds workspace_bytes = 16 + 8 * (ceil(T / kChunk) - 1) * B *
// R: the tile counter, padded to 16 bytes, then the carry words.  Anything
// else returns cudaErrorInvalidValue before anything is enqueued.  Clears
// the workspace and launches on `stream`; returns the first CUDA error, so
// a refused launch is reported.
extern "C" int lru_scan(const void* a, const void* b, const float* h0, void* out,
                        void* workspace, long long workspace_bytes, int batch, int t_n,
                        int r_n, int chunk, int width, int is_bf16, void* stream) {
  if (batch <= 0 || t_n <= 0 || r_n <= 0) return static_cast<int>(cudaSuccess);
  long long n_tiles;
  if (!layout_ok(batch, t_n, r_n, chunk, width, kChunk, kWidth, workspace_bytes, &n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  int* counter = reinterpret_cast<int*>(ws);
  auto* carries = reinterpret_cast<unsigned long long*>(ws + kCounterBytes);
  const cudaError_t err = cudaMemsetAsync(ws, 0, static_cast<size_t>(workspace_bytes), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_bf16)
    launch<__nv_bfloat16>(a, b, h0, out, counter, carries, batch, t_n, r_n, n_tiles, st);
  else
    launch<float>(a, b, h0, out, counter, carries, batch, t_n, r_n, n_tiles, st);
  return static_cast<int>(cudaGetLastError());
}

// The backward: a, dy, h, da, db (B, T, R), all bfloat16 (is_bf16 = 1) or all
// float32 (0); h0 (B, R) float32; h the forward's output on a, b, h0.  Writes
// da = dL/da and db = dL/db for dL/dh = dy.  `chunk` and `width` must be the
// backward's own tile, kBwdChunk and kBwdWidth, and `workspace` hold 16 +
// 8 * (ceil(T / kBwdChunk) - 1) * B * R bytes, laid out as lru_scan's and
// checked alike.
extern "C" int lru_scan_bwd(const void* a, const void* dy, const void* h, const float* h0,
                            void* da, void* db, void* workspace, long long workspace_bytes,
                            int batch, int t_n, int r_n, int chunk, int width, int is_bf16,
                            void* stream) {
  if (batch <= 0 || t_n <= 0 || r_n <= 0) return static_cast<int>(cudaSuccess);
  long long n_tiles;
  if (!layout_ok(batch, t_n, r_n, chunk, width, kBwdChunk, kBwdWidth, workspace_bytes, &n_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  int* counter = reinterpret_cast<int*>(ws);
  auto* carries = reinterpret_cast<unsigned long long*>(ws + kCounterBytes);
  const cudaError_t err = cudaMemsetAsync(ws, 0, static_cast<size_t>(workspace_bytes), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      is_bf16 ? launch_bwd<__nv_bfloat16>(a, dy, h, h0, da, db, counter, carries, batch, t_n,
                                          r_n, n_tiles, st)
              : launch_bwd<float>(a, dy, h, h0, da, db, counter, carries, batch, t_n, r_n,
                                  n_tiles, st));
}
