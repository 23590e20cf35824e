// The pairwise IoU (K4a) and the Section IV.B region filter over a flush
// (K1) and over one frame (K4b), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/iou_filter.py:
//   K1  region_filter_mask_batch (kernel body _filter_kernel_batch),
//   K4a iou_matrix               (kernel body _iou_kernel),
//   K4b region_filter_mask       (kernel body _filter_kernel).
// All three share one IoU of a pair (pair_iou) and K1/K4b share one
// per-proposal filter body (filter_tile), so they round alike.
//
// The filter, per frame f and proposal n:
//   keep = prop_valid & loc >= theta_loc
//        & max_m(valid_m ? IoU(prop_n, acc_m) : 0) < theta_iou
//        & area(prop_n) / frame_area <= theta_back
//
// What bounds the filter on the card: at the serving path's largest flush
// (F = 32 frames, N = M = 256 boxes) it is ~2 M IoU pairs, ~30 MFLOP of
// fp32 including one correctly rounded division per pair, over ~0.3 MB of
// I/O -- well under a microsecond of either, so one launch costs more than
// the work.  K1 therefore keeps the whole flush in ONE launch: one block
// per (frame, 128-proposal tile), each thread owns one proposal and walks
// the frame's accepted boxes, which the block stages in shared memory
// (256 boxes x (16 B box + 4 B area + 1 B flag)).  The Pallas kernel's
// running max across sequential M tiles becomes a per-thread register;
// nothing carries between blocks.  K4b is the same body on one frame (the
// JAX package's K1 is bit-identical to mapping K4b over frames).
//
// What bounds K4a: it writes B*N*M floats and reads only (N + M) boxes
// per batch row, ~14 flops per pair (at NMS's (32, 256, 256): 8.4 MB
// written, ~29 MFLOP), so the bytes bound it.  One block per (batch row,
// 32-row tile, 128-column tile) stages both box tiles and their areas in
// shared memory once; 128 consecutive threads then write 128 consecutive
// floats of an output row, so every store is coalesced along M.
//
// The thresholds are runtime arguments (the Pallas kernels baked them in
// as static values), so per-site thresholds use the same kernel.
//
// Rounding: built with -fmad=false, every op below rounds once, in the order
// of repro_torch.kernels.ref.iou_matrix / region_filter_mask (the union is
// (area_a + area_b) - inter), and the division is IEEE-correct -- so the
// IoU matrix and the masks equal the plain versions exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // proposals per filter block
constexpr int kTile = 256;      // accepted boxes staged per pass
constexpr int kIouRows = 32;    // K4a: rows of boxes_a per block
constexpr int kIouCols = 128;   // K4a: columns of boxes_b per block
constexpr int kIouThreads = 256;

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
}

// IoU of one pair, in the plain version's order.
__device__ __forceinline__ float pair_iou(float4 a, float area_a, float4 b,
                                          float area_b) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
  const float inter = iw * ih;
  const float uni = (area_a + area_b) - inter;
  return inter / fmaxf(uni, 1e-9f);
}

// The filter for one frame's 128-proposal tile starting at n0: every
// thread of the block calls it (it stages the accepted boxes with barriers).
__device__ void filter_tile(const float4* __restrict__ prop,
                            const uint8_t* __restrict__ prop_valid,
                            const float4* __restrict__ acc,
                            const uint8_t* __restrict__ acc_valid,
                            const float* __restrict__ loc,
                            uint8_t* __restrict__ keep, int n0, int n_prop,
                            int n_acc, float theta_loc, float theta_iou,
                            float theta_back, float frame_area) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ uint8_t s_valid[kTile];

  const int n = n0 + threadIdx.x;
  const bool live = n < n_prop;
  const float4 p = live ? prop[n] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float area_p = box_area(p);

  float best = 0.f;               // jnp.max(..., initial=0.0)
  for (int m0 = 0; m0 < n_acc; m0 += kTile) {
    const int mt = min(kTile, n_acc - m0);
    __syncthreads();
    for (int j = threadIdx.x; j < mt; j += kThreads) {
      const float4 b = acc[m0 + j];
      s_box[j] = b;
      s_area[j] = box_area(b);
      s_valid[j] = acc_valid[m0 + j];
    }
    __syncthreads();
    for (int j = 0; j < mt; ++j) {
      if (!s_valid[j]) continue;  // masked pairs contribute 0 <= best
      best = fmaxf(best, pair_iou(p, area_p, s_box[j], s_area[j]));
    }
  }
  if (!live) return;
  const bool k = prop_valid[n] && (loc[n] >= theta_loc) &&
                 (best < theta_iou) && (area_p / frame_area <= theta_back);
  keep[n] = k ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
region_filter_kernel(const float4* __restrict__ prop,
                     const uint8_t* __restrict__ prop_valid,
                     const float4* __restrict__ acc,
                     const uint8_t* __restrict__ acc_valid,
                     const float* __restrict__ loc,
                     uint8_t* __restrict__ keep,
                     int n_prop, int n_acc, float theta_loc, float theta_iou,
                     float theta_back, float frame_area) {
  const size_t fp = (size_t)blockIdx.y * n_prop;
  const size_t fa = (size_t)blockIdx.y * n_acc;
  filter_tile(prop + fp, prop_valid + fp, acc + fa, acc_valid + fa, loc + fp,
              keep + fp, blockIdx.x * kThreads, n_prop, n_acc, theta_loc,
              theta_iou, theta_back, frame_area);
}

__global__ void __launch_bounds__(kThreads)
region_filter_frame_kernel(const float4* __restrict__ prop,
                           const uint8_t* __restrict__ prop_valid,
                           const float4* __restrict__ acc,
                           const uint8_t* __restrict__ acc_valid,
                           const float* __restrict__ loc,
                           uint8_t* __restrict__ keep, int n_prop, int n_acc,
                           float theta_loc, float theta_iou,
                           float theta_back, float frame_area) {
  filter_tile(prop, prop_valid, acc, acc_valid, loc, keep,
              blockIdx.x * kThreads, n_prop, n_acc, theta_loc, theta_iou,
              theta_back, frame_area);
}

__global__ void __launch_bounds__(kIouThreads)
iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  float* __restrict__ out, int n, int m) {
  __shared__ float4 s_a[kIouRows];
  __shared__ float s_area_a[kIouRows];
  __shared__ float4 s_b[kIouCols];
  __shared__ float s_area_b[kIouCols];

  const size_t row = blockIdx.z;
  const int i0 = blockIdx.y * kIouRows;
  const int j0 = blockIdx.x * kIouCols;
  const int rows = min(kIouRows, n - i0);
  const int cols = min(kIouCols, m - j0);
  for (int t = threadIdx.x; t < rows; t += kIouThreads) {
    const float4 box = a[row * n + i0 + t];
    s_a[t] = box;
    s_area_a[t] = box_area(box);
  }
  for (int t = threadIdx.x; t < cols; t += kIouThreads) {
    const float4 box = b[row * m + j0 + t];
    s_b[t] = box;
    s_area_b[t] = box_area(box);
  }
  __syncthreads();
  const int j = threadIdx.x % kIouCols;
  if (j >= cols) return;
  const float4 bj = s_b[j];
  const float area_b = s_area_b[j];
  float* o = out + (row * n + i0) * (size_t)m + j0 + j;
  for (int i = threadIdx.x / kIouCols; i < rows;
       i += kIouThreads / kIouCols) {
    o[(size_t)i * m] = pair_iou(s_a[i], s_area_a[i], bj, area_b);
  }
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

// proposals (N, 4) f32, prop_valid (N,) bool, accepted (M, 4) f32,
// acc_valid (M,) bool, loc (N,) f32 -> keep (N,) bool.
extern "C" int vpaas_region_filter_mask(
    const void* proposals, const void* prop_valid, const void* accepted,
    const void* acc_valid, const void* loc, void* keep, int N, int M,
    float theta_loc, float theta_iou, float theta_back, float frame_area,
    void* stream) {
  if (N == 0) return 0;
  dim3 grid((N + kThreads - 1) / kThreads);
  region_filter_frame_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(proposals),
      static_cast<const uint8_t*>(prop_valid),
      static_cast<const float4*>(accepted),
      static_cast<const uint8_t*>(acc_valid),
      static_cast<const float*>(loc), static_cast<uint8_t*>(keep), N, M,
      theta_loc, theta_iou, theta_back, frame_area);
  return static_cast<int>(cudaGetLastError());
}

// boxes_a (B, N, 4) f32, boxes_b (B, M, 4) f32 -> out (B, N, M) f32.
extern "C" int vpaas_iou_matrix(const void* boxes_a, const void* boxes_b,
                                void* out, int B, int N, int M,
                                void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  dim3 grid((M + kIouCols - 1) / kIouCols, (N + kIouRows - 1) / kIouRows, B);
  iou_matrix_kernel<<<grid, kIouThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes_a), static_cast<const float4*>(boxes_b),
      static_cast<float*>(out), N, M);
  return static_cast<int>(cudaGetLastError());
}
