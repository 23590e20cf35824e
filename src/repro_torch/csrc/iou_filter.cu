// The pairwise IoU (K4a) and the Section IV.B region filter over a flush
// (K1) and over one frame (K4b), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/iou_filter.py:
//   K1  region_filter_mask_batch (kernel body _filter_kernel_batch),
//   K4a iou_matrix               (kernel body _iou_kernel),
//   K4b region_filter_mask       (kernel body _filter_kernel).
// All three share one IoU of a pair (pair_iou), so they round alike, and
// K1 and K4b are one kernel (region_filter_kernel) with two launchers.
//
// The filter, per frame f and proposal n:
//   keep = prop_valid & loc >= theta_loc
//        & max(0, max over valid m of IoU(prop_n, acc_m)) < theta_iou
//        & area(prop_n) / frame_area <= theta_back
//
// What bounds K1 and K4b on this card is latency, not bytes or arithmetic:
// at the serving path's largest flush (F = 32 frames, N = M = 256 boxes)
// the inputs are ~0.3 MB (~0.1 us of HBM), and even a dense frame's
// ~2 M pairs at ~14 operations and one IEEE division each are well under
// a microsecond of the card's fp32 issue.  A call waits for the launch, one
// memory round trip to stage a frame's accepted boxes, then the longest
// walk of one proposal over them, a division deep per step.  The design
// shortens each part:
//   - The cheap terms first: a proposal that fails prop_valid, the location
//     test or the background test is dropped with no walk (keep is an
//     AND), and theta_iou <= 0 drops every proposal (the max starts at 0).
//   - Each block stages its frame's VALID accepted boxes and their areas in
//     shared memory once, compacted by a warp ballot, __popc offsets and
//     one shared atomic a warp.  The order of the list does not matter, so
//     a walk is as long as the accepted set (a few boxes after NMS on the
//     serving path), not as wide as the frame.
//   - A warp takes one proposal (kProps = 8 proposals, 8 warps a block;
//     a warp beat groups of 8 and 16 lanes on an H100 at the dense shapes
//     and on the serving path's operands, PERF.md).  The lanes stride the
//     compacted list, each testing !(IoU < theta_iou), and a warp ballot
//     ends the proposal's walk at the first pair that reaches theta_iou: keep needs only whether such a pair exists, since the max
//     is < theta iff every pair is < theta and 0 < theta.  A NaN IoU fails
//     "< theta" as the reference's propagated NaN max does.  Pairs that do
//     not meet skip the division (their IoU is 0 unless it is NaN).
//   - One block per (8 proposals, frame): 1,024 blocks at F = 32, N = 256
//     on the card's 132 SMs, 32 for one frame of 256 (K4b).  Past 256
//     accepted boxes a frame the block stages and walks them in passes.
// The sizes and thresholds come in one host struct (VpaasFilterArgs),
// which the wrappers cache, so a launch takes seven arguments and the
// stream.
//
// What bounds K4a: it writes B*N*M floats and reads only (N + M) boxes
// per batch row, ~14 flops and one IEEE division per pair (at NMS's (32,
// 256, 256): 8.4 MB written, ~29 MFLOP), so the bytes bound it: 2.6 us at
// 3.35 TB/s.  The design serves the stores and the launch path:
//   - A block of 8 warps covers 8 rows of boxes_a x 128 columns of boxes_b
//     (2,048 blocks at (32, 256, 256), about two waves of 132 SMs); it
//     stages its boxes and their areas in shared memory once, a column at
//     [c % 4][c / 4], so lane l reads its four columns 4l..4l+3 without
//     bank conflicts.
//   - A warp takes one row; each lane computes 4 consecutive columns and
//     stores them as one aligned float4, so a warp writes 512 contiguous
//     bytes.  Where M % 4 != 0 the rows do not start on 16 bytes and every
//     store of the matrix is scalar.
//   - A pair whose boxes do not meet skips the division (pair_iou): a
//     zero numerator sends the IEEE division down its slow path.
//   - Stores use the default caching: the 8.4 MB stay in the 50 MB L2 for
//     the NMS kernel (csrc/nms.cu) that reads them next.
//   - The sizes come in one host struct (VpaasIouArgs), cached by the
//     wrapper, so a launch takes four arguments and the stream.
//
// The thresholds are runtime arguments (the Pallas kernels baked them in
// as static values), so per-site thresholds use the same kernel.
//
// Rounding: built with -fmad=false, every op below rounds once, in the order
// of repro_torch.kernels.ref.iou_matrix / region_filter_mask (the union is
// (area_a + area_b) - inter), and the division is IEEE-correct -- so the
// IoU matrix and the masks equal the plain versions exactly.  Min and max
// propagate NaN (fmin_nan / fmax_nan), as torch.minimum / maximum /
// clamp_min and jnp.minimum / maximum do: a NaN coordinate gives a NaN
// IoU here as there.
#include <cuda_runtime.h>
#include <stdint.h>

#include "primitives.cuh"

// The filter launchers' sizes and thresholds in one host struct
// (kernels/iou_filter.py's FilterArgs mirrors the layout).
struct VpaasFilterArgs {
  int F, N, M;        // frames (1 for K4b), proposals, accepted boxes
  float theta_loc, theta_iou, theta_back, frame_area;
};

// K4a's sizes (kernels/iou_matrix.py's IouArgs mirrors the layout).
struct VpaasIouArgs {
  int B, N, M;        // batch rows, boxes_a and boxes_b a row
};

namespace {

constexpr int kProps = 8;       // proposals (warps) per filter block
constexpr int kFilterThreads = kProps * 32;
constexpr int kTile = 256;      // accepted boxes staged per pass
constexpr int kIouRows = 8;     // K4a: rows of boxes_a per block, a warp each
constexpr int kIouCols = 128;   // K4a: columns of boxes_b per block, 4 a lane
constexpr int kIouThreads = kIouRows * 32;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return fmax_nan(b.z - b.x, 0.f) * fmax_nan(b.w - b.y, 0.f);
}

// The intersection of one pair and its union floored at 1e-9 (the IoU's
// numerator and denominator), in the plain version's order.
__device__ __forceinline__ void pair_overlap(float4 a, float area_a,
                                             float4 b, float area_b,
                                             float& inter, float& den) {
  const float iw = fmax_nan(fmin_nan(a.z, b.z) - fmax_nan(a.x, b.x), 0.f);
  const float ih = fmax_nan(fmin_nan(a.w, b.w) - fmax_nan(a.y, b.y), 0.f);
  inter = iw * ih;
  den = fmax_nan((area_a + area_b) - inter, 1e-9f);
}

// IoU of one pair, in the plain version's order.  Where the boxes do not
// meet, the quotient is the intersection's zero (den > 0) or NaN (den NaN)
// without the division: a zero numerator takes the IEEE division's slow
// path, and in a warp of dense random boxes one such lane holds all 32.
__device__ __forceinline__ float pair_iou(float4 a, float area_a, float4 b,
                                          float area_b) {
  float inter, den;
  pair_overlap(a, area_a, b, area_b, inter, den);
  if (inter == 0.f) return den != den ? den : inter;
  return inter / den;
}

// !(IoU < theta) for theta > 0, the filter's test of one pair.  Where the
// boxes do not meet, the IoU 0 / den is a zero, below theta, unless den is
// NaN; so the division runs only for pairs that overlap.
__device__ __forceinline__ bool reaches(float4 a, float area_a, float4 b,
                                        float area_b, float theta) {
  float inter, den;
  pair_overlap(a, area_a, b, area_b, inter, den);
  if (inter == 0.f) return den != den;
  return !(inter / den < theta);
}

// The filter of frame blockIdx.y's proposals [8 blockIdx.x, 8 blockIdx.x +
// 8), a warp each.
__global__ void __launch_bounds__(kFilterThreads)
region_filter_kernel(const float4* __restrict__ prop,
                     const uint8_t* __restrict__ prop_valid,
                     const float4* __restrict__ acc,
                     const uint8_t* __restrict__ acc_valid,
                     const float* __restrict__ loc,
                     uint8_t* __restrict__ keep, const VpaasFilterArgs a) {
  __shared__ float4 s_box[kTile];   // the pass's valid accepted boxes
  __shared__ float s_area[kTile];
  __shared__ int s_count[2];        // boxes staged, by pass parity
  const size_t fp = (size_t)blockIdx.y * a.N;
  const size_t fa = (size_t)blockIdx.y * a.M;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kProps + threadIdx.x / 32;
  const bool live = n < a.N;

  // the cheap terms (their loads overlap the staging's)
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
  bool pv = false;
  float l = 0.f;
  if (live) {
    p = prop[fp + n];
    pv = prop_valid[fp + n];
    l = loc[fp + n];
  }
  const float area_p = box_area(p);
  // the warp searches for a pair at theta_iou until it finds one (the
  // flag is the same in all its lanes)
  bool search = live & pv & (l >= a.theta_loc) &
                (area_p / a.frame_area <= a.theta_back) &
                (0.f < a.theta_iou);

  if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
  for (int m0 = 0, pass = 0; m0 < a.M; m0 += kTile, ++pass) {
    const int mt = min(kTile, a.M - m0);
    int* count = &s_count[pass & 1];
    __syncthreads();   // count is 0; the last pass's walks are done
    for (int j0 = 0; j0 < mt; j0 += kFilterThreads) {
      const int j = j0 + threadIdx.x;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      bool v = false;
      if (j < mt) {
        b = acc[fa + m0 + j];
        v = acc_valid[fa + m0 + j];
      }
      const unsigned votes = __ballot_sync(kAll, v);
      int base = 0;
      if (lane == 0 && votes) base = atomicAdd(count, __popc(votes));
      base = __shfl_sync(kAll, base, 0);
      if (v) {
        const int k = base + __popc(votes & ((1u << lane) - 1u));
        s_box[k] = b;
        s_area[k] = box_area(b);
      }
    }
    if (threadIdx.x == 0) s_count[(pass + 1) & 1] = 0;   // the next pass's
    __syncthreads();
    const int nv = *count;
    for (int j0 = 0; j0 < nv && search; j0 += 32) {
      const int j = j0 + lane;
      const bool hit = j < nv &&
                       reaches(p, area_p, s_box[j], s_area[j], a.theta_iou);
      if (__ballot_sync(kAll, hit)) search = false;
    }
  }
  // no pair reached theta_iou: every term holds
  if (live && lane == 0) keep[fp + n] = search ? 1 : 0;
}

__global__ void __launch_bounds__(kIouThreads)
iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  float* __restrict__ out, const VpaasIouArgs s) {
  // column c of the tile at [c % 4][c / 4]: lane l's columns 4l + k at
  // [k][l], consecutive lanes on consecutive slots
  __shared__ float4 s_b[4][kIouCols / 4];
  __shared__ float s_area_b[4][kIouCols / 4];
  __shared__ float4 s_a[kIouRows];
  __shared__ float s_area_a[kIouRows];

  const size_t row = blockIdx.z;
  const int n = s.N, m = s.M;
  const int i0 = blockIdx.y * kIouRows;
  const int j0 = blockIdx.x * kIouCols;
  const int t = threadIdx.x;
  if (t < kIouCols) {
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 + t < m) box = b[row * m + j0 + t];
    s_b[t % 4][t / 4] = box;
    s_area_b[t % 4][t / 4] = box_area(box);
  } else if (t < kIouCols + kIouRows) {
    const int r = t - kIouCols;
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i0 + r < n) box = a[row * n + i0 + r];
    s_a[r] = box;
    s_area_a[r] = box_area(box);
  }
  __syncthreads();
  const int r = t / 32, lane = t % 32;
  const int i = i0 + r, j = j0 + 4 * lane;
  if (i >= n || j >= m) return;
  const float4 ai = s_a[r];
  const float area_a = s_area_a[r];
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = pair_iou(ai, area_a, s_b[k][lane], s_area_b[k][lane]);
  float* o = out + (row * n + i) * (size_t)m + j;
  if (m % 4 == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < 4 && j + k < m; ++k) o[k] = v[k];
  }
}

}  // namespace

extern "C" const char* vpaas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

int launch_filter(const void* proposals, const void* prop_valid,
                  const void* accepted, const void* acc_valid,
                  const void* loc, void* keep, const VpaasFilterArgs* a,
                  int frames, void* stream) {
  if (frames == 0 || a->N == 0) return 0;
  const dim3 grid((a->N + kProps - 1) / kProps, frames);
  region_filter_kernel<<<grid, kFilterThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(proposals),
      static_cast<const uint8_t*>(prop_valid),
      static_cast<const float4*>(accepted),
      static_cast<const uint8_t*>(acc_valid),
      static_cast<const float*>(loc), static_cast<uint8_t*>(keep), *a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// proposals (F, N, 4) f32, prop_valid (F, N) bool, accepted (F, M, 4) f32,
// acc_valid (F, M) bool, loc (F, N) f32 -> keep (F, N) bool; the sizes and
// thresholds in *a.
extern "C" int vpaas_region_filter_mask_batch(
    const void* proposals, const void* prop_valid, const void* accepted,
    const void* acc_valid, const void* loc, void* keep,
    const VpaasFilterArgs* a, void* stream) {
  return launch_filter(proposals, prop_valid, accepted, acc_valid, loc, keep,
                       a, a->F, stream);
}

// proposals (N, 4) f32, prop_valid (N,) bool, accepted (M, 4) f32,
// acc_valid (M,) bool, loc (N,) f32 -> keep (N,) bool; one frame.
extern "C" int vpaas_region_filter_mask(
    const void* proposals, const void* prop_valid, const void* accepted,
    const void* acc_valid, const void* loc, void* keep,
    const VpaasFilterArgs* a, void* stream) {
  return launch_filter(proposals, prop_valid, accepted, acc_valid, loc, keep,
                       a, 1, stream);
}

// boxes_a (B, N, 4) f32, boxes_b (B, M, 4) f32 -> out (B, N, M) f32; the
// sizes in *s.
extern "C" int vpaas_iou_matrix(const void* boxes_a, const void* boxes_b,
                                void* out, const VpaasIouArgs* s,
                                void* stream) {
  if (s->B == 0 || s->N == 0 || s->M == 0) return 0;
  const dim3 grid((s->M + kIouCols - 1) / kIouCols,
                  (s->N + kIouRows - 1) / kIouRows, s->B);
  iou_matrix_kernel<<<grid, kIouThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes_a), static_cast<const float4*>(boxes_b),
      static_cast<float*>(out), *s);
  return static_cast<int>(cudaGetLastError());
}
