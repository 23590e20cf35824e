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
// What bounds it on the card: bytes, and before them latency.  At the
// serving path's largest bucket (B = 128 crops of 40 x 40 x 3) the kernel
// writes ~2.5 MB and reads at most four taps per output element, ~1.3 us of
// HBM bandwidth at 3.35 TB/s; the arithmetic (~11 flops per output
// element) is negligible.  A gather this small is set by how many loads
// are in flight, so the grid is (pixel tiles of one crop, bucket rows):
// kPix output pixels per block, one per thread (13 blocks per 40 x 40
// crop, ~1,700 at B = 128, rows past 65,535 taken by a grid-stride loop).
// Each thread loads the row's frame index and box itself (one broadcast
// load per warp: loading them once per block in one thread needs a
// barrier that holds every tap behind that thread's two dependent loads,
// 0.7 us more at B = 128 on an H100) beside its sample-grid entries, computes its pixel's position and weights,
// issues the four taps' loads of up to kChan channels before any
// arithmetic (a tap's address is clipped into the frame, so every load
// is in bounds, and an out-of-frame tap is zeroed after the load), and
// stages its C outputs in shared memory; the block then writes its
// contiguous kPix * C floats with 16-byte stores where the destination is
// 16-byte aligned.  The path's frames are RGB, and a build for C = 3 with
// the channel loops resolved at compile time takes 0.6 us less at B = 128
// on an H100 (3.9 against 4.6 us); other C take the run-time loop.  A 128 x 128 x 3 frame is 196 KB and stays in L2
// across the rows that share it.  The Pallas kernel streamed a whole frame
// into VMEM per row; here only the touched taps move.
//
// Rounding: the sample grid lin_y / lin_x is passed in as a tensor (the
// baked np.linspace float32 grid), and every multiply and add below is an
// explicit round-to-nearest intrinsic in the plain version's order --
// positions ya + yb, weights (wy * wx) * tap, sum ((t00 + t01) + t10) + t11
// -- so the output equals repro_torch.kernels.ref.bilinear_crops bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

// The launcher's sizes and the sample grid in one host struct: the wrapper
// keeps one per shape, so a call passes six arguments instead of fifteen
// (kernels/crop_gather.py's CropArgs mirrors the layout).
struct VpaasCropArgs {
  const float* lin_y;            // (OH,) f32 on the card
  const float* lin_x;            // (OW,) f32 on the card
  int B, F, H, W, C, N, OH, OW;
};

namespace {

constexpr int kPix = 128;        // output pixels per block, one a thread
constexpr int kChan = 4;         // channels whose taps load together
constexpr int kMaxRowsY = 65535; // gridDim.y limit

// CC > 0 fixes the channel count at compile time (the path's RGB
// frames); CC = 0 reads C.
template <int CC>
__global__ void __launch_bounds__(kPix)
crop_gather_kernel(const float* __restrict__ frames,
                   const float* __restrict__ boxes,
                   const int32_t* __restrict__ idxs, int B,
                   const float* __restrict__ lin_y,
                   const float* __restrict__ lin_x, float* __restrict__ out,
                   int F, int H, int W, int C, int N, int OH, int OW) {
  extern __shared__ float4 stage4[];   // the block's kPix * C outputs
  float* stage = reinterpret_cast<float*>(stage4);
  const int P = OH * OW;
  const int p0 = blockIdx.x * kPix;
  const int np = min(kPix, P - p0);
  const int p = p0 + threadIdx.x;
  const bool live = threadIdx.x < np;
  // the pixel's sample grid entries, loaded beside the row's box
  const float ly = live ? __ldg(lin_y + p / OW) : 0.f;
  const float lx = live ? __ldg(lin_x + p % OW) : 0.f;
  const float hm1 = (float)(H - 1), wm1 = (float)(W - 1);
  const int Cn = CC > 0 ? CC : C;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    if (live) {
      // every thread reads the row's indices and box: a warp's reads of
      // one address are one broadcast load, and no barrier holds the
      // block's taps behind one thread's two dependent loads
      const int f = min(max(__ldg(idxs + b), 0), F - 1);
      const int r = min(max(__ldg(idxs + B + b), 0), N - 1);
      const float* box = boxes + ((size_t)f * N + r) * 4;
      const float x1 = __ldg(box), y1 = __ldg(box + 1);
      const float x2 = __ldg(box + 2), y2 = __ldg(box + 3);
      const float ys = __fadd_rn(__fmul_rn(y1, hm1),
                                 __fmul_rn(__fmul_rn(__fsub_rn(y2, y1), hm1),
                                           ly));
      const float xs = __fadd_rn(__fmul_rn(x1, wm1),
                                 __fmul_rn(__fmul_rn(__fsub_rn(x2, x1), wm1),
                                           lx));
      const float y_lo_f = floorf(ys), x_lo_f = floorf(xs);
      const float wy_hi = __fsub_rn(ys, y_lo_f);
      const float wy_lo = __fsub_rn(1.f, wy_hi);
      const float wx_hi = __fsub_rn(xs, x_lo_f);
      const float wx_lo = __fsub_rn(1.f, wx_hi);
      const int y_lo = (int)y_lo_f, x_lo = (int)x_lo_f;
      const int y_hi = y_lo + 1, x_hi = x_lo + 1;
      const float wt[4] = {__fmul_rn(wy_lo, wx_lo), __fmul_rn(wy_lo, wx_hi),
                           __fmul_rn(wy_hi, wx_lo), __fmul_rn(wy_hi, wx_hi)};
      const int ty[4] = {y_lo, y_lo, y_hi, y_hi};
      const int tx[4] = {x_lo, x_hi, x_lo, x_hi};
      const float* frame = frames + (size_t)f * H * W * Cn;
      size_t off[4];
      bool ok[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        ok[t] = ty[t] >= 0 && ty[t] < H && tx[t] >= 0 && tx[t] < W;
        off[t] = ((size_t)min(max(ty[t], 0), H - 1) * W +
                  min(max(tx[t], 0), W - 1)) * Cn;
      }
      float* dst = stage + threadIdx.x * Cn;
      for (int c0 = 0; c0 < Cn; c0 += kChan) {
        float v[4][kChan];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int j = 0; j < kChan; ++j)
            v[t][j] = c0 + j < Cn ? __ldg(frame + off[t] + c0 + j) : 0.f;
#pragma unroll
        for (int j = 0; j < kChan; ++j) {
          if (c0 + j >= Cn) break;
          float s = __fmul_rn(wt[0], ok[0] ? v[0][j] : 0.f);
          s = __fadd_rn(s, __fmul_rn(wt[1], ok[1] ? v[1][j] : 0.f));
          s = __fadd_rn(s, __fmul_rn(wt[2], ok[2] ? v[2][j] : 0.f));
          dst[c0 + j] = __fadd_rn(s, __fmul_rn(wt[3], ok[3] ? v[3][j] : 0.f));
        }
      }
    }
    __syncthreads();
    float* o = out + ((size_t)b * P + p0) * Cn;
    const int n = np * Cn;
    int e0 = 0;
    if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int e = threadIdx.x; e < n / 4; e += kPix) o4[e] = stage4[e];
      e0 = n / 4 * 4;
    }
    for (int e = e0 + threadIdx.x; e < n; e += kPix) o[e] = stage[e];
    if (b + gridDim.y < B) __syncthreads();   // stage is rewritten next
  }
}

}  // namespace

// frames (F, H, W, C) f32, boxes (F, N, 4) f32, idxs (>=2, B) int32 (rows
// 0 and 1 used) -> out (B, OH, OW, C); the sizes and the sample grid
// lin_y (OH,), lin_x (OW,) in *a.
extern "C" int vpaas_crop_gather(const void* frames, const void* boxes,
                                 const void* idxs, void* out,
                                 const VpaasCropArgs* a, void* stream) {
  if (a->B == 0 || a->OH * a->OW == 0) return 0;
  const dim3 grid((a->OH * a->OW + kPix - 1) / kPix, min(a->B, kMaxRowsY));
  const size_t smem = sizeof(float) * (size_t)kPix * a->C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fr = static_cast<const float*>(frames);
  const float* bx = static_cast<const float*>(boxes);
  const int32_t* ix = static_cast<const int32_t*>(idxs);
  float* o = static_cast<float*>(out);
  if (a->C == 3)                 // RGB: the channel loops compiled out
    crop_gather_kernel<3><<<grid, kPix, smem, st>>>(
        fr, bx, ix, a->B, a->lin_y, a->lin_x, o, a->F, a->H, a->W, a->C,
        a->N, a->OH, a->OW);
  else
    crop_gather_kernel<0><<<grid, kPix, smem, st>>>(
        fr, bx, ix, a->B, a->lin_y, a->lin_x, o, a->F, a->H, a->W, a->C,
        a->N, a->OH, a->OW);
  return static_cast<int>(cudaGetLastError());
}
