// K5: the §V proximal update of the one-vs-all readout, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/onevsall.py
// onevsall_update (kernel body _upd_kernel):
//     out = W - eta * X^T (sigmoid(X W) - Y)
// for X (B, D1), Y (B, C), W (D1, C), all float32.  The TPU kernel walks
// row tiles on its sequential grid and carries the (D1, C) gradient in
// VMEM scratch from one grid step to the next; blocks on the card run in
// no order, so here each block owns a slice of the output instead and
// loops over the row tiles itself.  It pads nothing: the Pallas kernel's
// pad rows (x = 0, y = 0.5) only zero their own gradient, so looping over
// exactly B rows computes the same function.
//
// Determinism: there are no float atomics.  Every output element is summed
// by one thread over the rows in a fixed order, and every residual
// sigmoid(x.w_c) - y_c by one thread over k in a fixed order, so the result
// is bit-identical from run to run -- the promotion gate and rollback
// compare accuracies and restore weights bit for bit, and a W that changed
// with the launch could flip a gate decision.
//
// What bounds it on the card: the learner calls it once per labelled
// instance (B = 1, D1 = 129, C = 8: ~4 KB of W in and out, ~8 kFLOP), so a
// launch costs far more than either the bytes or the operations, and the
// design is the simple one: a grid over ceil(D1 * C / 256) blocks, one
// thread per (j, c) output element.  For each tile of up to 32 rows the
// block first recomputes the tile's residuals sigmoid(x_r . w_c) - y_rc
// into shared memory (one thread per (row, class), an fmaf dot product over
// the unpadded D1 in k order), then every thread adds x_rj * g_rc for its
// (j, c) over the tile's rows in row order.  Each block recomputes the
// residuals of every row (5 blocks at the learner's shape); a version that
// splits the rows across blocks and reduces in a fixed order, or that runs
// one launch per replay, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 32;

__global__ void __launch_bounds__(kThreads)
onevsall_update_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ w, float* __restrict__ out,
                       int B, int D1, int C, int tile_rows, float eta) {
  extern __shared__ float g[];               // (tile_rows, C) residuals
  const int o = blockIdx.x * kThreads + threadIdx.x;
  const bool owns = o < D1 * C;
  const int j = owns ? o / C : 0;
  const int c = owns ? o - j * C : 0;
  float acc = 0.f;
  for (int r0 = 0; r0 < B; r0 += tile_rows) {
    const int rows = min(tile_rows, B - r0);
    for (int p = threadIdx.x; p < rows * C; p += kThreads) {
      const int r = p / C;
      const int k = p - r * C;
      const float* xr = x + (size_t)(r0 + r) * D1;
      float z = 0.f;
      for (int i = 0; i < D1; ++i)
        z = fmaf(__ldg(xr + i), __ldg(w + (size_t)i * C + k), z);
      const float prob = 1.f / (1.f + expf(-z));
      g[p] = prob - __ldg(y + (size_t)(r0 + r) * C + k);
    }
    __syncthreads();
    if (owns) {
      const float* xj = x + (size_t)r0 * D1 + j;
      for (int r = 0; r < rows; ++r)
        acc = fmaf(__ldg(xj + (size_t)r * D1), g[r * C + c], acc);
    }
    __syncthreads();                         // g is rewritten next tile
  }
  // separately rounded multiply and subtract (-fmad=false), as the plain
  // version's w - eta * grad
  if (owns) out[o] = w[o] - eta * acc;
}

}  // namespace

// x (B, D1), y (B, C), w (D1, C) f32 -> out (D1, C) f32.
extern "C" int vpaas_onevsall_update(const void* x, const void* y,
                                     const void* w, void* out, int B, int D1,
                                     int C, float eta, void* stream) {
  if (D1 <= 0 || C <= 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  int tile_rows = (kMaxTileRows * 8) / C;    // 32 rows at C <= 8, >= 1 row
  tile_rows = max(1, min(kMaxTileRows, tile_rows));
  const size_t smem = sizeof(float) * (size_t)tile_rows * C;
  const int blocks = (D1 * C + kThreads - 1) / kThreads;
  onevsall_update_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), static_cast<float*>(out), B, D1, C,
      tile_rows, eta);
  return static_cast<int>(cudaGetLastError());
}
