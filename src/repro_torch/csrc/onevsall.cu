// K3: one-vs-all readout scores, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/onevsall.py
// onevsall_scores (kernel body _fwd_kernel): scores = sigmoid(X @ W).
// This kernel also takes a stack of G readouts Ws (G, D1, C) and an optional
// per-row readout index widx (B,), so the cross-stream compacted classify
// (repro.models.classifier.classify_multi, einsum("bd,bdc->bc", x, Ws[widx]))
// runs through the same kernel as the full-budget classify (G = 1, widx
// null = readout 0).  G is one readout per stream in a flush (up to the
// pack bucket's 64) or G * T snapshots on the ensemble path, unbounded.
//
// What bounds it on the card: at the serving path's shapes (B up to 1024
// rows, D1 = 129, C = 8) the product is ~2 MFLOP over ~0.5 MB of X, well
// under a microsecond of either resource, so a launch costs more than the
// work and tensor cores would buy nothing yet (K = 129 is also not a
// multiple of any MMA depth).  The design keeps it one simple pass with one
// thread per (row, class) output, so B = 1024 rows spread over 64 blocks:
// an fp32 fmaf dot product over the unpadded K = 129, then
// 1 / (1 + expf(-z)).  The readouts are read from global memory through the
// read-only cache (one readout is 4 KB and the rows of a block share a few),
// so any G fits; consecutive threads take consecutive classes of a row, so
// the W loads and output writes are coalesced and the X loads broadcast
// within a row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
onevsall_kernel(const float* __restrict__ x, const float* __restrict__ ws,
                const int32_t* __restrict__ widx, float* __restrict__ out,
                int B, int D1, int C, int G) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= B * C) return;
  const int r = p / C;
  const int c = p - r * C;
  const int g = widx ? min(max(__ldg(widx + r), 0), G - 1) : 0;
  const float* xr = x + (size_t)r * D1;
  const float* wg = ws + (size_t)g * D1 * C + c;
  float z = 0.f;
  for (int k = 0; k < D1; ++k) z = fmaf(__ldg(xr + k), __ldg(wg + k * C), z);
  out[p] = 1.f / (1.f + expf(-z));
}

}  // namespace

// x (B, D1) f32, ws (G, D1, C) f32, widx (B,) int32 or null -> out (B, C).
extern "C" int vpaas_onevsall_scores(const void* x, const void* ws,
                                     const void* widx, void* out, int B,
                                     int D1, int C, int G, void* stream) {
  if (B == 0) return 0;
  const int blocks = (B * C + kThreads - 1) / kThreads;
  onevsall_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ws),
      static_cast<const int32_t*>(widx), static_cast<float*>(out), B, D1, C,
      G);
  return static_cast<int>(cudaGetLastError());
}
