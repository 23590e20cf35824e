// K1: whole-flush Section IV.B region filter, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/iou_filter.py
// region_filter_mask_batch (kernel body _filter_kernel_batch).
//
// What it computes, per frame f and proposal n:
//   keep = prop_valid & loc >= theta_loc
//        & max_m(valid_m ? IoU(prop_n, acc_m) : 0) < theta_iou
//        & area(prop_n) / frame_area <= theta_back
//
// What bounds it on the card: at the serving path's largest flush (F = 32
// frames, N = M = 256 boxes) the filter is ~2 M IoU pairs, ~30 MFLOP of fp32
// including one correctly rounded division per pair, over ~0.3 MB of I/O --
// well under a microsecond of either, so one launch costs more than the
// work.  The design therefore keeps the whole filter in ONE launch over the
// flush: one block per (frame, 128-proposal tile), each thread owns one
// proposal and walks the frame's accepted boxes, which the block stages in
// shared memory (256 boxes x (16 B box + 4 B area + 1 B flag)).  The Pallas
// kernel's running max across sequential M tiles becomes a per-thread
// register; nothing carries between blocks.
//
// The thresholds are runtime arguments (the Pallas kernel baked them in as
// static values), so per-site thresholds use the same kernel.
//
// Rounding: built with -fmad=false, every op below rounds once, in the order
// of repro_torch.kernels.ref.iou_matrix / region_filter_mask, and the
// division is IEEE-correct -- so the mask equals the plain version exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // proposals per block
constexpr int kTile = 256;      // accepted boxes staged per pass

__global__ void __launch_bounds__(kThreads)
region_filter_kernel(const float4* __restrict__ prop,
                     const uint8_t* __restrict__ prop_valid,
                     const float4* __restrict__ acc,
                     const uint8_t* __restrict__ acc_valid,
                     const float* __restrict__ loc,
                     uint8_t* __restrict__ keep,
                     int n_prop, int n_acc, float theta_loc, float theta_iou,
                     float theta_back, float frame_area) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ uint8_t s_valid[kTile];

  const int f = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < n_prop;
  const float4 p = live ? prop[(size_t)f * n_prop + n]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float pw = fmaxf(p.z - p.x, 0.f);
  const float ph = fmaxf(p.w - p.y, 0.f);
  const float area_p = pw * ph;

  float best = 0.f;               // jnp.max(..., initial=0.0)
  for (int m0 = 0; m0 < n_acc; m0 += kTile) {
    const int mt = min(kTile, n_acc - m0);
    __syncthreads();
    for (int j = threadIdx.x; j < mt; j += kThreads) {
      const size_t g = (size_t)f * n_acc + m0 + j;
      const float4 b = acc[g];
      s_box[j] = b;
      s_area[j] = fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
      s_valid[j] = acc_valid[g];
    }
    __syncthreads();
    for (int j = 0; j < mt; ++j) {
      if (!s_valid[j]) continue;  // masked pairs contribute 0 <= best
      const float4 b = s_box[j];
      const float iw = fmaxf(fminf(p.z, b.z) - fmaxf(p.x, b.x), 0.f);
      const float ih = fmaxf(fminf(p.w, b.w) - fmaxf(p.y, b.y), 0.f);
      const float inter = iw * ih;
      const float uni = (area_p + s_area[j]) - inter;
      const float iou = inter / fmaxf(uni, 1e-9f);
      best = fmaxf(best, iou);
    }
  }
  if (!live) return;
  const size_t o = (size_t)f * n_prop + n;
  const bool k = prop_valid[o] && (loc[o] >= theta_loc) &&
                 (best < theta_iou) && (area_p / frame_area <= theta_back);
  keep[o] = k ? 1 : 0;
}

}  // namespace

extern "C" const char* vpaas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// proposals (F, N, 4) f32, prop_valid (F, N) bool, accepted (F, M, 4) f32,
// acc_valid (F, M) bool, loc (F, N) f32 -> keep (F, N) bool.
extern "C" int vpaas_region_filter_mask_batch(
    const void* proposals, const void* prop_valid, const void* accepted,
    const void* acc_valid, const void* loc, void* keep, int F, int N, int M,
    float theta_loc, float theta_iou, float theta_back, float frame_area,
    void* stream) {
  if (F == 0 || N == 0) return 0;
  dim3 grid((N + kThreads - 1) / kThreads, F);
  region_filter_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(proposals),
      static_cast<const uint8_t*>(prop_valid),
      static_cast<const float4*>(accepted),
      static_cast<const uint8_t*>(acc_valid),
      static_cast<const float*>(loc), static_cast<uint8_t*>(keep), N, M,
      theta_loc, theta_iou, theta_back, frame_area);
  return static_cast<int>(cudaGetLastError());
}
