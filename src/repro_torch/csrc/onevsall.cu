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
// under a microsecond of either resource, so the launch and one pass of
// memory latency set its time; tensor cores would buy nothing (K = 129 is
// not a multiple of any MMA depth).  The design gives each row one warp:
// the lanes stride over D1, so X is read coalesced, and each lane keeps
// partial sums for up to 8 classes at a time in registers (fmaf over its
// ceil(D1 / 32) terms); a warp butterfly then reduces each class and lane
// c writes sigmoid(z) = 1 / (1 + expf(-z)) of class c.  A lane loads its
// first eight features before anything else, so their latency overlaps
// the readout's staging.  Eight warps a block, so B = 1024 rows is 128
// blocks: one wave on 132 SMs.  With one
// readout (G = 1) the block stages it once in shared memory, rows padded
// to an odd number of floats so the 32 lanes' reads of one class fall in
// 32 banks (4.6 KB at 129 x 8).  With G > 1 each warp reads its row's
// readout through the read-only cache, so any G fits: the 64-stream flush
// and the G * T ensemble alike.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 8;                 // classes summed per pass
constexpr int kXRegs = 8;                 // x values a lane loads up front
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxStaged = 48 * 1024;  // static dynamic-smem limit

// odd shared row stride for C classes: conflict-free reads of one class
__host__ __device__ inline int staged_stride(int C) { return C | 1; }

template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
onevsall_kernel(const float* __restrict__ x, const float* __restrict__ ws,
                const int32_t* __restrict__ widx, float* __restrict__ out,
                int B, int D1, int C, int G) {
  extern __shared__ float wsh[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  // the row's first 32 * kXRegs features, loaded before the readout is
  // staged so that both global loads are in flight together
  const float* xr = x + (size_t)min(r, B - 1) * D1;
  float xv[kXRegs];
#pragma unroll
  for (int i = 0; i < kXRegs; ++i) {
    const int kk = lane + 32 * i;
    xv[i] = kk < D1 ? __ldg(xr + kk) : 0.f;
  }
  const float* w = ws;
  int sw = C;
  if (STAGED) {                    // G == 1: the block's one readout
    sw = staged_stride(C);
    for (int e = threadIdx.x; e < D1 * C; e += kThreads) {
      const int kk = e / C;
      wsh[kk * sw + e - kk * C] = __ldg(ws + e);
    }
    __syncthreads();
    w = wsh;
  }
  if (r >= B) return;              // after the block's only barrier
  if (!STAGED && widx != nullptr)
    w = ws + (size_t)min(max(__ldg(widx + r), 0), G - 1) * D1 * C;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kXRegs; ++i) {
      const int kk = lane + 32 * i;
      if (kk >= D1) break;
      const float* wr = w + kk * sw + c0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (c0 + j < C)
          acc[j] = fmaf(xv[i], STAGED ? wr[j] : __ldg(wr + j), acc[j]);
    }
    for (int kk = lane + 32 * kXRegs; kk < D1; kk += 32) {
      const float xk = __ldg(xr + kk);
      const float* wr = w + kk * sw + c0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (c0 + j < C)
          acc[j] = fmaf(xk, STAGED ? wr[j] : __ldg(wr + j), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float z = acc[j];
      for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(kFull, z, o);
      if (lane == j && c0 + j < C)
        out[(size_t)r * C + c0 + j] = 1.f / (1.f + expf(-z));
    }
  }
}

}  // namespace

// x (B, D1) f32, ws (G, D1, C) f32, widx (B,) int32 or null -> out (B, C).
extern "C" int vpaas_onevsall_scores(const void* x, const void* ws,
                                     const void* widx, void* out, int B,
                                     int D1, int C, int G, void* stream) {
  if (B == 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(ws);
  const int32_t* wi = static_cast<const int32_t*>(widx);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)D1 * staged_stride(C);
  if (G == 1 && smem <= kMaxStaged)
    onevsall_kernel<true><<<blocks, kThreads, smem, st>>>(xf, wf, nullptr,
                                                         of, B, D1, C, G);
  else
    onevsall_kernel<false><<<blocks, kThreads, 0, st>>>(xf, wf, wi, of, B,
                                                        D1, C, G);
  return static_cast<int>(cudaGetLastError());
}
