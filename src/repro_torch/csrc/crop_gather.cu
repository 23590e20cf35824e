// K2: compacted bilinear crop gather, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/crop_gather.py
// crop_gather (kernel body _crop_kernel, which runs
// repro.kernels.ref.bilinear_crops on one bucket row).
//
// What it computes: for bucket row b with compaction indices
// (fidx, ridx) = (idxs[0, b], idxs[1, b]), both clipped into range (pad rows
// carry fidx = F and clip to the last frame), the bilinear resample of box
// boxes[fidx, ridx] (xyxy in [0, 1]) out of frames[fidx] to (OH, OW, C),
// with out-of-frame taps contributing zero (map_coordinates mode='constant').
//
// What bounds it on the card: bytes.  At the serving path's largest bucket
// (B = 128 crops of 40 x 40 x 3) the kernel writes ~2.5 MB and reads at most
// four taps per output element, ~1.5 us of HBM bandwidth at 3.35 TB/s; the
// arithmetic (~11 flops per output element) is negligible.  The design:
// one block per bucket row, threads striding over the row's output pixels;
// each thread computes its sample position and weights once and gathers
// the four taps of all C channels straight from global memory (a 128 x 128
// x 3 frame is 196 KB and stays in L2 across the rows that share it), and
// consecutive threads write consecutive output pixels.  The Pallas kernel
// streamed a whole frame into VMEM per row; here only the touched taps move.
//
// Rounding: the sample grid lin_y / lin_x is passed in as a tensor (the
// baked np.linspace float32 grid), and every multiply and add below is an
// explicit round-to-nearest intrinsic in the plain version's order --
// positions ya + yb, weights (wy * wx) * tap, sum ((t00 + t01) + t10) + t11
// -- so the output equals repro_torch.kernels.ref.bilinear_crops bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tap(const float* __restrict__ frame, int H,
                                     int W, int C, int yi, int xi, int c) {
  const bool ok = (yi >= 0) && (yi < H) && (xi >= 0) && (xi < W);
  const int yc = min(max(yi, 0), H - 1);
  const int xc = min(max(xi, 0), W - 1);
  return ok ? frame[((size_t)yc * W + xc) * C + c] : 0.f;
}

__global__ void __launch_bounds__(kThreads)
crop_gather_kernel(const float* __restrict__ frames,
                   const float* __restrict__ boxes,
                   const int32_t* __restrict__ idxs, int idx_stride,
                   const float* __restrict__ lin_y,
                   const float* __restrict__ lin_x, float* __restrict__ out,
                   int F, int H, int W, int C, int N, int OH, int OW) {
  const int b = blockIdx.x;
  const int f = min(max(idxs[b], 0), F - 1);
  const int r = min(max(idxs[idx_stride + b], 0), N - 1);
  const float* box = boxes + ((size_t)f * N + r) * 4;
  const float x1 = box[0], y1 = box[1], x2 = box[2], y2 = box[3];
  const float hm1 = (float)(H - 1), wm1 = (float)(W - 1);
  const float ya = __fmul_rn(y1, hm1);
  const float xa = __fmul_rn(x1, wm1);
  const float ys_span = __fmul_rn(__fsub_rn(y2, y1), hm1);
  const float xs_span = __fmul_rn(__fsub_rn(x2, x1), wm1);
  const float* frame = frames + (size_t)f * H * W * C;
  float* dst = out + (size_t)b * OH * OW * C;

  for (int p = threadIdx.x; p < OH * OW; p += kThreads) {
    const int oy = p / OW, ox = p - oy * OW;
    const float ys = __fadd_rn(ya, __fmul_rn(ys_span, lin_y[oy]));
    const float xs = __fadd_rn(xa, __fmul_rn(xs_span, lin_x[ox]));
    const float y_lo_f = floorf(ys), x_lo_f = floorf(xs);
    const float wy_hi = __fsub_rn(ys, y_lo_f);
    const float wy_lo = __fsub_rn(1.f, wy_hi);
    const float wx_hi = __fsub_rn(xs, x_lo_f);
    const float wx_lo = __fsub_rn(1.f, wx_hi);
    const int y_lo = (int)y_lo_f, x_lo = (int)x_lo_f;
    const int y_hi = y_lo + 1, x_hi = x_lo + 1;
    const float w00 = __fmul_rn(wy_lo, wx_lo);
    const float w01 = __fmul_rn(wy_lo, wx_hi);
    const float w10 = __fmul_rn(wy_hi, wx_lo);
    const float w11 = __fmul_rn(wy_hi, wx_hi);
    for (int c = 0; c < C; ++c) {
      const float t00 = __fmul_rn(w00, tap(frame, H, W, C, y_lo, x_lo, c));
      const float t01 = __fmul_rn(w01, tap(frame, H, W, C, y_lo, x_hi, c));
      const float t10 = __fmul_rn(w10, tap(frame, H, W, C, y_hi, x_lo, c));
      const float t11 = __fmul_rn(w11, tap(frame, H, W, C, y_hi, x_hi, c));
      dst[(size_t)p * C + c] = __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10),
                                         t11);
    }
  }
}

}  // namespace

// frames (F, H, W, C) f32, boxes (F, N, 4) f32, idxs (>=2, B) int32 with row
// stride idx_stride, lin_y (OH,) f32, lin_x (OW,) f32 -> out (B, OH, OW, C).
extern "C" int vpaas_crop_gather(const void* frames, const void* boxes,
                                 const void* idxs, const void* lin_y,
                                 const void* lin_x, void* out, int idx_stride,
                                 int F, int H, int W, int C, int N, int OH,
                                 int OW, void* stream) {
  if (idx_stride == 0) return 0;
  crop_gather_kernel<<<idx_stride, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(boxes),
      static_cast<const int32_t*>(idxs), idx_stride,
      static_cast<const float*>(lin_y), static_cast<const float*>(lin_x),
      static_cast<float*>(out), F, H, W, C, N, OH, OW);
  return static_cast<int>(cudaGetLastError());
}
