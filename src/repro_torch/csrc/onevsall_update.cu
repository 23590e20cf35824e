// K5: the §V proximal update of the one-vs-all readout, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/onevsall.py
// onevsall_update (kernel body _upd_kernel):
//     out = W - eta * X^T (sigmoid(X W) - Y)
// for X (B, D1), Y (B, C), W (D1, C), all float32.  The TPU kernel walks
// row tiles on its sequential grid and carries the (D1, C) gradient in
// VMEM scratch from one grid step to the next; blocks on the card run in
// no order, so here each block owns a tile of rows and writes its part of
// the gradient, and a second kernel adds the parts in tile order.  It pads
// nothing: the Pallas kernel's pad rows (x = 0, y = 0.5) only zero their
// own gradient, so looping over exactly B rows computes the same function.
//
// Determinism: there are no float atomics.  Every residual
// sigmoid(x.w_c) - y_c is summed by one warp in a fixed order (lane l over
// k = l, l + 32, ... by fmaf, then a fixed xor-shuffle tree), every
// gradient element by one thread over its tile's rows (four partial sums
// in row order, added in a fixed order), and the tiles' parts by one
// thread in tile order, so the result is
// bit-identical from run to run -- the promotion gate and rollback compare
// accuracies and restore weights bit for bit, and a W that changed with
// the launch could flip a gate decision.
//
// What bounds it on the card: latency, not bytes or operations.  The
// learner runs one step per labelled instance (B = 1, D1 = 129, C = 8:
// ~4 KB of W in and out, ~8 kFLOP), and the reference's replay
// (repro.core.incremental.batch_update, a lax.scan of update_proximal) is
// a chain of such steps, each reading the W the last one wrote.  So the
// design shortens the chain and runs it in one launch:
//   * one step (onevsall_update_step_kernel, B up to one tile of rows):
//     one block stages W (rows padded to an odd stride, so the 32 lanes'
//     reads of one class fall in 32 banks) and the tile's x rows in shared
//     memory with coalesced loads, computes each residual with a warp
//     (row_residuals), then each thread forms out[j, c] = w[j, c] - eta *
//     acc for its elements, the multiply and the subtraction rounded
//     separately (-fmad=false);
//   * a larger batch: the same kernel on one block per tile writes each
//     tile's (D1, C) part of the gradient to a workspace, and
//     onevsall_update_combine_kernel adds the parts in tile order;
//   * a replay (onevsall_update_replay_kernel): one persistent block keeps
//     W in shared memory and walks the buffer `passes` times in the
//     reference's order, each step the one-row step above; a warp owns its
//     classes' columns (residual, then the column's rank-1 update), so the
//     warps need no barrier between steps, and cp.async brings the rows a
//     chunk at a time.  W goes back to global memory once.  Each step runs
//     the same residual functions and the same update arithmetic as a
//     one-row launch of the step kernel, so the replay equals a loop of
//     single-step launches bit for bit; where W does not fit one block's
//     shared memory, the launcher runs that loop itself.
#include <cuda_runtime.h>

#include "primitives.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileRows = 32;
constexpr int kTileBytes = 24 * 1024;      // a tile's x rows and residuals
constexpr size_t kMaxSmem = 48 * 1024;     // dynamic smem without opt-in
constexpr int kCombineUnroll = 16;
constexpr int kKBatch = 4;                 // k steps whose loads go together
constexpr int kChunkRows = 8;              // replay rows fetched together
constexpr unsigned kFull = 0xffffffffu;

// odd shared row stride for C classes: conflict-free reads of one class
__host__ __device__ inline int staged_stride(int C) { return C | 1; }

inline int rows_per_tile(int D1, int C) {
  return max(1, min(kMaxTileRows, kTileBytes / (4 * (D1 + C))));
}

// the replay block's shared memory: W and two chunks of x and y rows
inline size_t replay_smem(int D1, int C) {
  return sizeof(float) * ((size_t)D1 * staged_stride(C) +
                          2 * (size_t)kChunkRows * (D1 + C));
}

// The proximal step's last operation, rounded as the plain version's
// w - eta * grad: a multiply, then a subtraction.
__device__ __forceinline__ float proximal(float w, float acc, float eta) {
  return w - eta * acc;
}

// The three parts of a residual sigmoid(x . w_c) - y_c, shared by every
// K5 path so that each computes the same bits for the same row and W:
//   lane_dots: lane l's sums over k = l, l + 32, ... by fmaf in k order
//     for the NC classes c0 .. c0 + NC - 1 (those below C), the loads of
//     kKBatch such k issued before their fmafs; a k past D1 adds
//     fmaf(0, 0, acc) = acc (acc starts at +0 and is never -0).  NC only
//     sets how many classes share one pass over the row: each class's
//     arithmetic is the same for every NC.
//   warp_sum: the fixed xor-shuffle tree over the 32 lane sums; both lanes
//     of each pair add the same two values, so every lane ends with the
//     same bits.  The whole warp must call it.
//   residual: sigmoid(z) - y.
template <int NC>
__device__ __forceinline__ void lane_dots(const float* xr, const float* w,
                                          int sw, int D1, int C, int c0,
                                          int lane, float (&acc)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;
  for (int k0 = lane; k0 < D1; k0 += 32 * kKBatch) {
    float xv[kKBatch], wv[kKBatch][NC];
#pragma unroll
    for (int i = 0; i < kKBatch; ++i) {
      const int k = k0 + 32 * i;
      xv[i] = k < D1 ? xr[k] : 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wv[i][j] = k < D1 && c0 + j < C ? w[(size_t)k * sw + c0 + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kKBatch; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = fmaf(xv[i], wv[i][j], acc[j]);
  }
}

__device__ __forceinline__ float warp_sum(float z) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
  return z;
}

__device__ __forceinline__ float residual(float z, float y) {
  return 1.f / (1.f + expf(-z)) - y;
}

// g[c] for the NC classes c0 .. c0 + NC - 1 of one row, by one warp: lane
// j takes class c0 + j's total, so the NC sigmoids run side by side.
template <int NC>
__device__ __forceinline__ void row_residuals(
    const float* xr, const float* w, int sw, const float* yr, float* g,
    int D1, int C, int c0, int lane) {
  float acc[NC];
  lane_dots<NC>(xr, w, sw, D1, C, c0, lane, acc);
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float z = warp_sum(acc[j]);
    if (lane == j) mine = z;
  }
  if (lane < NC && c0 + lane < C) g[c0 + lane] = residual(mine, yr[c0 + lane]);
}

// One tile of up to tile_rows rows (block b takes rows b * tile_rows on):
// the tile's residuals against W, then for every (j, c) the tile's part of
// the gradient, sum_r x_rj g_rc: row r goes by fmaf into partial sum r % 4
// in row order, and the four are added as (p0 + p1) + (p2 + p3), so the
// four chains run side by side (with one row, p1 = p2 = p3 = +0 and the
// sum is p0 = fmaf(x, g, 0), which is never -0).  With `part` null
// (a batch of one tile) it writes out = w - eta * acc; otherwise the part
// goes to part[b] for the combine kernel.  W is staged in shared memory
// when it fits beside the tile (w_staged), else read from global memory.
template <int NC>
__global__ void __launch_bounds__(kThreads)
onevsall_update_step_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            const float* __restrict__ w,
                            float* __restrict__ out, float* __restrict__ part,
                            int B, int D1, int C, int tile_rows, int w_staged,
                            float eta) {
  extern __shared__ float sm[];
  float* xs = sm;                              // (tile_rows, D1)
  float* g = xs + (size_t)tile_rows * D1;      // (tile_rows, C)
  float* ws = g + (size_t)tile_rows * C;       // (D1, sw) when staged
  const int r0 = blockIdx.x * tile_rows;
  const int rows = max(0, min(tile_rows, B - r0));
  const int sw = w_staged ? staged_stride(C) : C;
  for (int e = threadIdx.x; e < rows * D1; e += kThreads)
    xs[e] = __ldg(x + (size_t)r0 * D1 + e);
  if (w_staged) {
    for (int e = threadIdx.x; e < D1 * C; e += kThreads) {
      const int k = e / C;
      ws[k * sw + e - k * C] = __ldg(w + e);
    }
  }
  __syncthreads();
  const float* wr = w_staged ? ws : w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (C + NC - 1) / NC;
  for (int p = warp; p < rows * chunks; p += kWarps) {
    const int r = p / chunks;
    row_residuals<NC>(xs + (size_t)r * D1, wr, sw, y + (size_t)(r0 + r) * C,
                      g + (size_t)r * C, D1, C, (p - r * chunks) * NC, lane);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < D1 * C; o += kThreads) {
    const int j = o / C, c = o - j * C;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int r = 0;
    for (; r + 4 <= rows; r += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = fmaf(xs[(size_t)(r + i) * D1 + j],
                    g[(size_t)(r + i) * C + c], a[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)              // the last rows % 4 rows
      if (r + i < rows)
        a[i] = fmaf(xs[(size_t)(r + i) * D1 + j],
                    g[(size_t)(r + i) * C + c], a[i]);
    const float acc = (a[0] + a[1]) + (a[2] + a[3]);
    if (part != nullptr)
      part[(size_t)blockIdx.x * D1 * C + o] = acc;
    else
      out[o] = proximal(__ldg(w + o), acc, eta);
  }
}

// out = w - eta * (the tiles' parts added in tile order), one thread per
// element; each thread issues kCombineUnroll loads before it adds them.
__global__ void __launch_bounds__(kThreads)
onevsall_update_combine_kernel(const float* __restrict__ part,
                               const float* __restrict__ w,
                               float* __restrict__ out, int n, int tiles,
                               float eta) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n) return;
  float acc = 0.f;
  int t = 0;
  for (; t + kCombineUnroll <= tiles; t += kCombineUnroll) {
    float v[kCombineUnroll];
#pragma unroll
    for (int i = 0; i < kCombineUnroll; ++i)
      v[i] = __ldg(part + (size_t)(t + i) * n + o);
#pragma unroll
    for (int i = 0; i < kCombineUnroll; ++i) acc += v[i];
  }
  for (; t < tiles; ++t) acc += __ldg(part + (size_t)t * n + o);
  out[o] = proximal(__ldg(w + o), acc, eta);
}

// `steps` one-row proximal steps over the rows of xs / ys in order,
// wrapping after N rows (steps = passes * N), W in shared memory.  Warp w
// owns classes w, w + kWarps, ...: for each it computes the step's
// residual (every lane gets the total, so every lane forms g_c) and then
// updates column c, lane l the rows k = l, l + 32, ... that its own sums
// read.  A column is read and written only by its warp, each entry only by
// one lane, so the warps run their steps without waiting for each other.
// The rows come kChunkRows steps at a time into one half of a double
// buffer, by cp.async while the steps before them run on the other half;
// the barrier closing a chunk's last step waits for the next chunk and
// frees the half that the chunk after it will fill.
__global__ void __launch_bounds__(kThreads)
onevsall_update_replay_kernel(const float* __restrict__ xs,
                              const float* __restrict__ ys,
                              const float* __restrict__ w,
                              float* __restrict__ out, int N, int D1, int C,
                              int steps, float eta) {
  extern __shared__ float sm[];
  const int sw = staged_stride(C);
  float* ws = sm;                              // (D1, sw)
  float* xb = ws + (size_t)D1 * sw;            // (2, kChunkRows, D1)
  float* yb = xb + 2 * kChunkRows * D1;        // (2, kChunkRows, C)
  for (int e = threadIdx.x; e < D1 * C; e += kThreads) {
    const int k = e / C;
    ws[k * sw + e - k * C] = __ldg(w + e);
  }
  // the rows of steps s0 .. s0 + kChunkRows - 1 into half h
  auto fetch = [&](int s0, int h, bool async) {
    for (int e = threadIdx.x; e < kChunkRows * D1; e += kThreads) {
      const int r = e / D1, s = s0 + r;
      if (s >= steps) break;
      const float* src = xs + (size_t)(s % N) * D1 + (e - r * D1);
      float* dst = xb + (size_t)h * kChunkRows * D1 + e;
      if (async) cp_async_4(dst, src, true); else *dst = __ldg(src);
    }
    for (int e = threadIdx.x; e < kChunkRows * C; e += kThreads) {
      const int r = e / C, s = s0 + r;
      if (s >= steps) break;
      const float* src = ys + (size_t)(s % N) * C + (e - r * C);
      float* dst = yb + (size_t)h * kChunkRows * C + e;
      if (async) cp_async_4(dst, src, true); else *dst = __ldg(src);
    }
    if (async) cp_async_commit();
  };
  fetch(0, 0, false);
  if (kChunkRows < steps) fetch(kChunkRows, 1, true);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = 0; s < steps; ++s) {
    const int q = s / kChunkRows, i = s - q * kChunkRows, h = q & 1;
    if (i == 0 && q > 0 && s + kChunkRows < steps)
      fetch(s + kChunkRows, h ^ 1, true);    // the half chunk q-1 used
    const float* xr = xb + ((size_t)h * kChunkRows + i) * D1;
    const float* yr = yb + ((size_t)h * kChunkRows + i) * C;
    for (int c = warp; c < C; c += kWarps) {
      float acc[1];
      lane_dots<1>(xr, ws, sw, D1, C, c, lane, acc);
      const float gc = residual(warp_sum(acc[0]), yr[c]);
      for (int k = lane; k < D1; k += 32) {
        float* wkc = ws + (size_t)k * sw + c;
        *wkc = proximal(*wkc, fmaf(xr[k], gc, 0.f), eta);
      }
    }
    if (i == kChunkRows - 1) {
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < D1 * C; e += kThreads) {
    const int k = e / C;
    out[e] = ws[k * sw + e - k * C];
  }
}

// One proximal step of B rows: the step kernel on one block (B within a
// tile), or on one block per tile and the combine kernel.
int launch_step(const float* x, const float* y, const float* w, float* out,
                float* part, int part_tiles, int B, int D1, int C, float eta,
                cudaStream_t st) {
  const int rows = rows_per_tile(D1, C);
  const int tiles = B > rows ? (B + rows - 1) / rows : 1;
  const size_t tile_smem = sizeof(float) * (size_t)rows * (D1 + C);
  if (tile_smem > kMaxSmem || (tiles > 1 && part_tiles < tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t w_smem = sizeof(float) * (size_t)D1 * staged_stride(C);
  const int staged = tile_smem + w_smem <= kMaxSmem;
  const size_t smem = tile_smem + (staged ? w_smem : 0);
  float* p = tiles > 1 ? part : nullptr;
  if (min(B, rows) * C <= kWarps)              // a warp per residual
    onevsall_update_step_kernel<1><<<tiles, kThreads, smem, st>>>(
        x, y, w, out, p, B, D1, C, rows, staged, eta);
  else                                         // a warp per row of 8 classes
    onevsall_update_step_kernel<8><<<tiles, kThreads, smem, st>>>(
        x, y, w, out, p, B, D1, C, rows, staged, eta);
  if (tiles > 1) {
    const int n = D1 * C;
    onevsall_update_combine_kernel<<<(n + kThreads - 1) / kThreads, kThreads,
                                     0, st>>>(part, w, out, n, tiles, eta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, D1), y (B, C), w (D1, C) f32 -> out (D1, C) f32; part: a workspace
// of part_tiles (D1, C) floats, used when B is more than one tile of rows.
extern "C" int vpaas_onevsall_update(const void* x, const void* y,
                                     const void* w, void* out, void* part,
                                     int part_tiles, int B, int D1, int C,
                                     float eta, void* stream) {
  if (D1 <= 0 || C <= 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_step(static_cast<const float*>(x),
                     static_cast<const float*>(y),
                     static_cast<const float*>(w), static_cast<float*>(out),
                     static_cast<float*>(part), part_tiles, B, D1, C, eta,
                     static_cast<cudaStream_t>(stream));
}

// xs (N, D1), ys (N, C), w (D1, C) f32 -> out (D1, C): `passes` passes of
// one-row proximal steps over the N rows in order, one launch.  When the
// replay block's shared memory would pass kMaxSmem, the same steps run as
// single-step launches alternating between out and tmp (a (D1, C)
// workspace), so that the last lands in out.
extern "C" int vpaas_onevsall_replay(const void* xs, const void* ys,
                                     const void* w, void* out, void* tmp,
                                     int N, int D1, int C, int passes,
                                     float eta, void* stream) {
  if (N <= 0 || D1 <= 0 || C <= 0 || passes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(xs);
  const float* yf = static_cast<const float*>(ys);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = N * passes;
  const size_t smem = replay_smem(D1, C);
  if (smem <= kMaxSmem) {
    onevsall_update_replay_kernel<<<1, kThreads, smem, st>>>(
        xf, yf, wf, of, N, D1, C, steps, eta);
    return static_cast<int>(cudaGetLastError());
  }
  if (tmp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* bufs[2] = {of, static_cast<float*>(tmp)};
  const float* src = wf;
  for (int s = 0; s < steps; ++s) {
    const int row = s % N;
    float* dst = bufs[(steps - 1 - s) & 1];
    const int rc = launch_step(xf + (size_t)row * D1, yf + (size_t)row * C,
                               src, dst, nullptr, 0, 1, D1, C, eta, st);
    if (rc != 0) return rc;
    src = dst;
  }
  return 0;
}
