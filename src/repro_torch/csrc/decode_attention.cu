// K7: decode attention (one query token against the KV cache), hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// decode_attention (kernel body _kernel): each batch row's new token
// attends to the first cache_len[b] slots of its cache (cache_len a device
// array, one entry per row), with an optional window (slots
// >= cache_len - window) and logit softcap, GQA, float32.  As in the plain
// version (repro_torch/kernels/ref.py decode_attention), logits are scaled
// by d^-0.5, soft-capped, then masked with the finite -1e30: a row with no
// valid slot (cache_len <= 0) averages V uniformly over all S slots, and
// this kernel gives it that mean too.
//
// What bounds it on the card: decode reads each valid cache row once
// (zamba2 at 4 slots x 512 x 32 heads x d = 112: up to 29 MB per call,
// ~9 us at 3.35 TB/s) and does 4 flops per cached float, so bytes bound
// it.  The design: one block per (kv-head, batch row) carrying the q-heads
// of the GQA group (up to 8 per block; larger groups take several blocks),
// so each K/V row is read from device memory once per group, not once per
// q-head.  The four warps split the valid slots in interleaved 32-slot
// tiles; within a tile a lane owns one slot, the warp loads each K and V
// row coalesced (lanes across d), reduces the q.k dot products with
// shuffles and keeps a running max / sum / output per q-head; the warps'
// partial softmax states are merged through shared memory at the end.
// Only slots inside [cache_len - window, cache_len) are read.  Split-KV
// across blocks is not needed at the path's 4 x 32 = 128 blocks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;                   // slots per warp tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// G = q-heads per block (>= the heads it carries), NC = columns per lane.
template <int G, int NC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int32_t* __restrict__ cache_len,
                        float* __restrict__ out, int S, int Hq, int Hkv, int D,
                        int group, int nsub, int window, float softcap,
                        float scale) {
  extern __shared__ float red[];           // [kWarps][G][D + 2]
  const int hk = blockIdx.x / nsub;
  const int h0 = hk * group + (blockIdx.x % nsub) * G;   // first q-head
  const int nh = min(G, hk * group + group - h0);        // heads carried
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int clen = cache_len[b];
  const int lo = window > 0 ? max(0, clen - window) : 0;
  const int hi = min(clen, S);
  const size_t row_stride = (size_t)Hkv * D;
  const float* kb = k + (size_t)b * S * row_stride + (size_t)hk * D;
  const float* vb = v + (size_t)b * S * row_stride + (size_t)hk * D;
  float* ob = out + ((size_t)b * Hq + h0) * D;

  if (lo >= hi) {
    // no valid slot: the plain version's softmax over S equal -1e30 logits
    // is uniform, so every carried head gets the mean of V
    for (int e = tid; e < nh * D; e += kThreads) {
      const int c = e % D;
      float sum = 0.f;
      for (int j = 0; j < S; ++j) sum += vb[j * row_stride + c];
      ob[e] = sum / (float)S;
    }
    return;
  }

  float qr[G][NC], acc[G][NC], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      qr[g][i] = (g < nh && c < D) ? q[((size_t)b * Hq + h0 + g) * D + c] : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int kt = lo + warp * kBK; kt < hi; kt += kWarps * kBK) {
    const int n = min(kBK, hi - kt);       // valid slots in this tile
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    for (int jj = 0; jj < n; ++jj) {
      const float* kr = kb + (size_t)(kt + jj) * row_stride;
      float kx[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        kx[i] = c < D ? kr[c] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NC; ++i) part = fmaf(qr[g][i], kx[i], part);
        part = warp_sum(part);
        if (lane == jj) s[g] = part;
      }
    }
    const bool ok = lane < n;
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float x = s[g] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      // the tile holds >= 1 valid slot, so m_new is finite
      const float m_new = fmaxf(m[g], warp_max(ok ? x : -INFINITY));
      const float alpha = expf(m[g] - m_new);
      p[g] = ok ? expf(x - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[g][i] *= alpha;
    }
    for (int jj = 0; jj < n; ++jj) {
      const float* vr = vb + (size_t)(kt + jj) * row_stride;
      float vx[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        vx[i] = c < D ? vr[c] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(kFull, p[g], jj);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[g][i] = fmaf(pj, vx[i], acc[g][i]);
      }
    }
  }

  // merge the warps' partial softmax states (a warp that saw no tile holds
  // m = -inf, l = 0, acc = 0 and weighs 0)
  const int stride = D + 2;
  float* mine = red + (size_t)warp * G * stride;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < D) mine[g * stride + c] = acc[g][i];
    }
    if (lane == 0) {
      mine[g * stride + D] = m[g];
      mine[g * stride + D + 1] = l[g];
    }
  }
  __syncthreads();
  for (int e = tid; e < nh * D; e += kThreads) {
    const int g = e / D;
    const int c = e - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, red[(w * G + g) * stride + D]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* r = red + (w * G + g) * stride;
      const float f = expf(r[D] - mx);
      num += r[c] * f;
      den += r[D + 1] * f;
    }
    ob[e] = num / den;
  }
}

template <int G, int NC>
int launch(const float* q, const float* k, const float* v, const int32_t* cl,
           float* out, int B, int S, int Hq, int Hkv, int D, int window,
           float softcap, float scale, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int nsub = (group + G - 1) / G;
  const size_t smem = sizeof(float) * kWarps * G * (D + 2);
  dim3 grid(Hkv * nsub, B);
  decode_attention_kernel<G, NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, cl, out, S, Hq, Hkv, D, group, nsub, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int G>
int launch_nc(const float* q, const float* k, const float* v,
              const int32_t* cl, float* out, int B, int S, int Hq, int Hkv,
              int D, int window, float softcap, float scale,
              cudaStream_t stream) {
  if (D <= 32)
    return launch<G, 1>(q, k, v, cl, out, B, S, Hq, Hkv, D, window, softcap,
                        scale, stream);
  if (D <= 64)
    return launch<G, 2>(q, k, v, cl, out, B, S, Hq, Hkv, D, window, softcap,
                        scale, stream);
  if (D <= 128)
    return launch<G, 4>(q, k, v, cl, out, B, S, Hq, Hkv, D, window, softcap,
                        scale, stream);
  return launch<G, 8>(q, k, v, cl, out, B, S, Hq, Hkv, D, window, softcap,
                      scale, stream);
}

}  // namespace

// q (B, Hq, D), k and v caches (B, S, Hkv, D) f32, cache_len (B,) int32 ->
// out (B, Hq, D).  window <= 0: none; softcap <= 0: none.
extern "C" int vpaas_decode_attention(const void* q, const void* k,
                                      const void* v, const void* cache_len,
                                      void* out, int B, int S, int Hq,
                                      int Hkv, int D, int window,
                                      float softcap, float scale,
                                      void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int32_t* cl = static_cast<const int32_t*>(cache_len);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (group == 1)
    return launch_nc<1>(qf, kf, vf, cl, of, B, S, Hq, Hkv, D, window, softcap,
                        scale, st);
  if (group == 2)
    return launch_nc<2>(qf, kf, vf, cl, of, B, S, Hq, Hkv, D, window, softcap,
                        scale, st);
  if (group <= 4)
    return launch_nc<4>(qf, kf, vf, cl, of, B, S, Hq, Hkv, D, window, softcap,
                        scale, st);
  return launch_nc<8>(qf, kf, vf, cl, of, B, S, Hq, Hkv, D, window, softcap,
                      scale, st);
}
