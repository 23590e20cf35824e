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
// What bounds it on the card: decode reads each valid K and V row once and
// does 4 flops per cached float, so bytes bound it.  zamba2's decode (4
// slots x 512 x 32 heads x d = 112) holds 58.7 MB of K and V; at the
// path's lengths (385-399 valid slots) a call reads 45.0 MB, 13.5 us at
// 3.35 TB/s.  Reaching that rate takes tens of KB of loads in flight on
// every SM, which one block per (kv-head, row) -- 128 blocks of 4 warps,
// each walking ~400 slots one dependent step at a time -- never had.
//
// The design: two kernels from one launcher.
//  1. decode_split_kernel, grid (kv-head group, batch row, split): a row's
//     valid slots [lo, hi) are cut into splits of `per` slots (the wrapper
//     picks per and nsplit from the longest valid length the host knows
//     without a sync: the cache's S, or the window), so zamba2's decode
//     runs 8 splits of 64 slots, 1,024 blocks, ~7 per SM.  A block carries
//     the q-heads of its GQA group (up to 8; larger groups take several
//     blocks), so each K/V row is read once per group.  K and V tiles of
//     32 slots arrive by cp.async (16-byte copies where d % 4 == 0 and the
//     caches are aligned, else 4-byte) into a double-buffered ring; a split
//     of up to 64 slots has both its tiles in flight from the start.
//     Shared rows are DP + 4 floats (DP = d rounded up to 8, zero-filled):
//     (DP + 4) / 4 is odd, so the 8 lanes of a quarter warp reading one
//     16-byte chunk of 8 consecutive rows hit 8 distinct bank groups.
//     q.k takes one lane per slot: warp w sums its quarter of the head dim
//     for the tile's 32 slots (float4 reads of K, q broadcast from shared
//     memory), no shuffle per slot; the four quarters meet in shared memory
//     and every warp adds them in the same order, so all four run the same
//     online softmax (one max and one sum reduction per tile, not per slot)
//     and each updates the output columns of its own quarter.  The block
//     writes its split's (m, l, acc) to a float32 workspace.
//  2. decode_combine_kernel, grid (q-head, batch row): merges the splits
//     in split order (no atomics: bit-identical run to run); a split with
//     no slot (past a short row, outside its window) writes m = -inf only
//     and weighs nothing; a row whose splits are all empty gets the mean
//     of V.
//
// bf16 q and caches (vpaas_decode_attention_bf16): the same two kernels,
// templates over the element type.  The caches arrive by 16-byte cp.async
// (8 values) into bf16 rows of DP + 8 values and are widened as they are
// read (q.k reads 4 values, 8 bytes, at a time); q is widened as it is
// staged, every sum and the workspace stay f32, the combine writes bf16.
// A byte-bound kernel: bf16 halves its bytes (zamba2's decode: 22.5 MB,
// 6.7 us at 3.35 TB/s).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "primitives.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;                   // slots per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

// the head dim padded to 8 elements; shared K/V rows are row_len(DP)
// elements of the caches' type T: DP + 4 floats, DP + 8 bf16, both 16-byte
// multiples whose quarter-warp reads of one 16-byte chunk of 8 rows fall on
// 8 distinct bank groups (float) or 8 distinct 8-byte halves (bf16)
__host__ __device__ constexpr int pad_dim(int D) { return (D + 7) / 8 * 8; }
template <typename T>
__host__ __device__ constexpr int row_len(int DP) {
  return DP + 16 / (int)sizeof(T);
}

template <typename T>
size_t smem_bytes(int D, int G) {
  const int DP = pad_dim(D);
  return sizeof(T) * 4 * (size_t)kBK * row_len<T>(DP)   // K, V: two buffers
         + sizeof(float) * ((size_t)G * DP              // q
                            + (size_t)kWarps * G * kBK);  // partial q.k
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// one element global -> shared, or a zero where !ok: 4-byte cp.async for
// float, a plain load and store for bf16 (cp.async has no 2-byte copy)
__device__ __forceinline__ void copy_elem(float* s, const float* g, bool ok) {
  cp_async_4(s, g, ok);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* s,
                                          const __nv_bfloat16* g, bool ok) {
  *s = ok ? *g : from_f32<__nv_bfloat16>(0.f);
}

// four consecutive elements of a shared row (8- or 16-byte aligned) as
// floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Copy cache rows [t0, t0 + n) of K and V (row r at base + r * stride) into
// shared rows of RS elements; columns D .. DP - 1 become zeros.  16-byte
// cp.async where a row is whole 16-byte chunks and the caches are aligned
// (vec); else 4-byte cp.async for float, plain loads and stores for bf16.
template <typename T>
__device__ __forceinline__ void stage_tile(T* ks, T* vs, const T* kb,
                                           const T* vb, size_t stride, int t0,
                                           int n, int D, int DP, int RS,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);      // elements per 16-byte chunk
    const int CE = DP / E;
    for (int e = threadIdx.x; e < n * CE; e += kThreads) {
      const int r = e / CE;
      const int c = E * (e - r * CE);
      const bool ok = c < D;
      const size_t off = (size_t)(t0 + r) * stride + (ok ? c : 0);
      cp_async_16(ks + r * RS + c, kb + off, ok);
      cp_async_16(vs + r * RS + c, vb + off, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      const bool ok = c < D;
      const size_t off = (size_t)(t0 + r) * stride + (ok ? c : 0);
      copy_elem(ks + r * RS + c, kb + off, ok);
      copy_elem(vs + r * RS + c, vb + off, ok);
    }
  }
}

// G = q-heads per block (>= the heads it carries).  Workspace row of (b,
// q-head, split): acc[0, D), m at D, l at D + 1.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ cache_len,
                    float* __restrict__ ws, int S, int Hq, int Hkv, int D,
                    int group, int nsub, int per, int nsplit, int window,
                    float softcap, float scale) {
  extern __shared__ float4 smem4[];
  const int DP = pad_dim(D);
  const int RS = row_len<T>(DP);
  T* Ks = reinterpret_cast<T*>(smem4);           // [2][kBK][RS]
  T* Vs = Ks + 2 * kBK * RS;                     // [2][kBK][RS]
  float* Qs = reinterpret_cast<float*>(Vs + 2 * kBK * RS);   // [G][DP]
  float* part = Qs + G * DP;                     // [kWarps][G][kBK]

  const int hk = blockIdx.x / nsub;
  const int h0 = hk * group + (blockIdx.x % nsub) * G;   // first q-head
  const int nh = min(G, hk * group + group - h0);        // heads carried
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int clen = cache_len[b];
  const int lo = window > 0 ? max(0, clen - window) : 0;
  const int hi = min(clen, S);
  const int s_lo = lo + sp * per;          // this split: [s_lo, s_hi)
  const int s_hi = min(hi, s_lo + per);
  const size_t wrow = (size_t)nsplit * (D + 2);
  float* wsb = ws + ((size_t)b * Hq + h0) * wrow + (size_t)sp * (D + 2);

  if (s_lo >= s_hi) {                      // nothing here: weighs 0
    if (tid < nh) wsb[tid * wrow + D] = -INFINITY;
    return;
  }

  const bool vec = D % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * S * Hkv + hk) * D;
  const int ntiles = (s_hi - s_lo + kBK - 1) / kBK;
  stage_tile(Ks, Vs, kb, vb, stride, s_lo, min(kBK, s_hi - s_lo), D, DP, RS,
             vec);
  cp_async_commit();
  if (ntiles > 1)
    stage_tile(Ks + kBK * RS, Vs + kBK * RS, kb, vb, stride, s_lo + kBK,
               min(kBK, s_hi - s_lo - kBK), D, DP, RS, vec);
  cp_async_commit();
  for (int e = tid; e < G * DP; e += kThreads) {
    const int g = e / DP;
    const int c = e - g * DP;
    Qs[e] = (g < nh && c < D) ? to_f32(q[((size_t)b * Hq + h0 + g) * D + c])
                              : 0.f;
  }

  // this warp's quarter of the head dim: 16-byte chunks [ch0, ch1), output
  // columns [col0, col1), at most 64 (two per lane)
  const int nch = DP / 4;
  const int cw = (nch + kWarps - 1) / kWarps;
  const int ch0 = min(nch, warp * cw);
  const int ch1 = min(nch, ch0 + cw);
  const int col0 = 4 * ch0;
  const int col1 = min(D, 4 * ch1);

  float m[G], l[G], acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const int n = min(kBK, s_hi - s_lo - it * kBK);   // slots in the tile
    const T* Kt = Ks + buf * kBK * RS;
    const T* Vt = Vs + buf * kBK * RS;
    cp_async_wait<1>();                    // all groups but the newest
    __syncthreads();

    // q.k over this warp's quarter, one lane per slot
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (lane < n) {
      const T* kr = Kt + lane * RS;
      for (int ch = ch0; ch < ch1; ++ch) {
        const float4 kx = load4(kr + 4 * ch);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qx =
              *reinterpret_cast<const float4*>(Qs + g * DP + 4 * ch);
          s[g] = fmaf(qx.x, kx.x, s[g]);
          s[g] = fmaf(qx.y, kx.y, s[g]);
          s[g] = fmaf(qx.z, kx.z, s[g]);
          s[g] = fmaf(qx.w, kx.w, s[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) part[(warp * G + g) * kBK + lane] = s[g];
    __syncthreads();

    // every warp: the whole dot products in one order, then the same
    // online softmax step (the tile holds >= 1 valid slot: m_new finite)
    const bool ok = lane < n;
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float x = part[g * kBK + lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += part[(w * G + g) * kBK + lane];
      x *= scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = ok ? x : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float alpha = expf(m[g] - m_new);
      p[g] = ok ? expf(x - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
    }

    // p.v on this warp's columns
    for (int j = 0; j < n; ++j) {
      const T* vr = Vt + j * RS;
      float vx[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = col0 + lane + 32 * i;
        vx[i] = c < col1 ? to_f32(vr[c]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(kFull, p[g], j);
        acc[g][0] = fmaf(pj, vx[0], acc[g][0]);
        acc[g][1] = fmaf(pj, vx[1], acc[g][1]);
      }
    }
    __syncthreads();                       // every warp is done with buf
    if (it + 2 < ntiles)
      stage_tile(Ks + buf * kBK * RS, Vs + buf * kBK * RS, kb, vb, stride,
                 s_lo + (it + 2) * kBK,
                 min(kBK, s_hi - s_lo - (it + 2) * kBK), D, DP, RS, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();                      // no copy outlives the block

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < nh) {
      float* w = wsb + g * wrow;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = col0 + lane + 32 * i;
        if (c < col1) w[c] = acc[g][i];
      }
      if (tid == 0) {
        w[D] = m[g];
        w[D + 1] = l[g];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws,
                      const T* __restrict__ v, T* __restrict__ out,
                      int S, int Hq, int Hkv, int D, int group, int nsplit) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float* w = ws + ((size_t)b * Hq + h) * nsplit * (D + 2);
  T* o = out + ((size_t)b * Hq + h) * D;
  float mx = -INFINITY;
  for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, w[sp * (D + 2) + D]);
  if (mx == -INFINITY) {
    // no valid slot: the plain version's softmax over S equal -1e30
    // logits is uniform, so the head gets the mean of V
    const size_t stride = (size_t)Hkv * D;
    const T* vb = v + ((size_t)b * S * Hkv + h / group) * D;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float sum = 0.f;
      for (int j = 0; j < S; ++j) sum += to_f32(vb[j * stride + c]);
      o[c] = from_f32<T>(sum / (float)S);
    }
    return;
  }
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float num = 0.f, den = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float* r = w + sp * (D + 2);
      const float ms = r[D];
      if (ms == -INFINITY) continue;       // an empty split
      const float f = expf(ms - mx);
      num += r[c] * f;
      den += r[D + 1] * f;
    }
    o[c] = from_f32<T>(num / den);
  }
}

template <typename T, int G>
int launch(const T* q, const T* k, const T* v, const int32_t* cl,
           float* ws, T* out, int B, int S, int Hq, int Hkv, int D,
           int per, int nsplit, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int nsub = (group + G - 1) / G;
  const size_t smem = smem_bytes<T>(D, G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv * nsub, B, nsplit);
  decode_split_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      q, k, v, cl, ws, S, Hq, Hkv, D, group, nsub, per, nsplit, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2(Hq, B);
  decode_combine_kernel<T><<<grid2, kThreads, 0, stream>>>(
      ws, v, out, S, Hq, Hkv, D, group, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* q, const void* k, const void* v,
               const void* cache_len, void* ws, void* out, int B, int S,
               int Hq, int Hkv, int D, int per, int nsplit, int window,
               float softcap, float scale, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 ||
      per <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int32_t* cl = static_cast<const int32_t*>(cache_len);
  float* wf = static_cast<float*>(ws);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (group == 1)
    return launch<T, 1>(qt, kt, vt, cl, wf, ot, B, S, Hq, Hkv, D, per,
                        nsplit, window, softcap, scale, st);
  if (group == 2)
    return launch<T, 2>(qt, kt, vt, cl, wf, ot, B, S, Hq, Hkv, D, per,
                        nsplit, window, softcap, scale, st);
  if (group <= 4)
    return launch<T, 4>(qt, kt, vt, cl, wf, ot, B, S, Hq, Hkv, D, per,
                        nsplit, window, softcap, scale, st);
  return launch<T, 8>(qt, kt, vt, cl, wf, ot, B, S, Hq, Hkv, D, per, nsplit,
                      window, softcap, scale, st);
}

}  // namespace

// q (B, Hq, D), k and v caches (B, S, Hkv, D) f32, cache_len (B,) int32,
// workspace (B, Hq, nsplit, D + 2) f32 -> out (B, Hq, D).  A row's valid
// slots are cut into nsplit splits of `per` slots.  window <= 0: none;
// softcap <= 0: none.
extern "C" int vpaas_decode_attention(const void* q, const void* k,
                                      const void* v, const void* cache_len,
                                      void* ws, void* out, int B, int S,
                                      int Hq, int Hkv, int D, int per,
                                      int nsplit, int window, float softcap,
                                      float scale, void* stream) {
  return launch_any<float>(q, k, v, cache_len, ws, out, B, S, Hq, Hkv, D,
                           per, nsplit, window, softcap, scale, stream);
}

// The same with q, the caches and out in bf16 (the workspace stays f32).
extern "C" int vpaas_decode_attention_bf16(const void* q, const void* k,
                                           const void* v,
                                           const void* cache_len, void* ws,
                                           void* out, int B, int S, int Hq,
                                           int Hkv, int D, int per,
                                           int nsplit, int window,
                                           float softcap, float scale,
                                           void* stream) {
  return launch_any<__nv_bfloat16>(q, k, v, cache_len, ws, out, B, S, Hq,
                                   Hkv, D, per, nsplit, window, softcap,
                                   scale, stream);
}
