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
// bf16 q and caches (vpaas_decode_attention_bf16), the reference's launch
// path: a byte-bound kernel whose bytes bf16 halves (zamba2's decode_32k,
// 14 rows x 32,768 slots x 32 kv-heads x d = 112: 6.58 GB, 1.963 ms at
// 3.35 TB/s).  Designed for Hopper where d % 8 == 0, d <= 128 and the
// caches are 16-byte aligned (decode_tma_kernel, namespace tma):
//  - A block takes 4 consecutive kv-heads, one a warp.  TMA brings their
//    K and V rows of 16 slots (a 4-d tensor map over the caches as (B, H,
//    S, D), host.cuh; one 64-column box per 64 columns of d, 128-byte
//    swizzled, zeros past d) into a 64 KB ring with full and empty
//    mbarriers (2 stages of 32 KB at d = 112), thread 0 refilling a stage
//    as the warps release it; one block an SM.  The 4 heads' rows of a
//    slot lie side by side in the (B, S, H, D) caches, so a tile reads 896
//    contiguous bytes a slot: tiles of 64 slots of one head (224 bytes a
//    slot, 7 KB apart) ran 1.6x slower on the card (PERF.md, PR 27).
//  - Both products run on the tensor cores (mma.sync m16n8k16 bf16, f32
//    accumulation): S^T = Q K^T with the warp's q-heads (its kv-head's
//    GQA group, padded with zeros) as the mma's 16 rows and K's B
//    fragments by ldmatrix from the swizzled tile, and O += P V with P's
//    two bf16 halves (hi and the rest, ~16 bits of p, as K6) as the A
//    fragments straight from S's accumulators and V's by ldmatrix.trans.
//    q.k's bf16 x bf16 products are exact in f32, so there only the order
//    of the sums moves against the CUDA-core loop (q.k one lane a slot,
//    p.v a 32-step shuffle loop, p in f32).  p.v keeps about 16 of p's 24
//    bits (the lo half is cut, not rounded): each term loses up to 2^-16
//    of itself, far below a bf16 step of its row's largest output, but an
//    output much smaller than that (V's values cancelling in the sum) can
//    move by several of its own steps; the error is held per row, to
//    ATTN_BF16_RTOL of the row's largest value.
//  - Each warp runs its own online softmax over its head's slots: no
//    barrier inside the loop, no merge at the end; it writes the split's
//    workspace rows, which the float32 form's combine kernel merges in
//    split order (bit-identical run to run).
//  - The grid is sized to the card: the wrapper asks the library for the
//    SMs x resident blocks an SM of the instance
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and cuts each row's
//    longest possible length into whole tiles, as few splits as fill
//    whole waves to >= 90%; it reads no cache_len from the device.
// Other bf16 operands (d % 8 != 0, d > 128, an unaligned cache) take the
// float32 design as a template over the element type: the caches by
// 16-byte cp.async into bf16 rows of DP + 8 values, widened as they are
// read.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "host.cuh"
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
  record_launch_event(0, stream);
  decode_split_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      q, k, v, cl, ws, S, Hq, Hkv, D, group, nsub, per, nsplit, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  record_launch_event(1, stream);
  dim3 grid2(Hq, B);
  decode_combine_kernel<T><<<grid2, kThreads, 0, stream>>>(
      ws, v, out, S, Hq, Hkv, D, group, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return record_launch_event(2, stream);
}

// ---------------------------------------------------------------------------
// bf16, d % 8 == 0, d <= 128, k and v 16-byte aligned: TMA tiles, mma.sync
// ---------------------------------------------------------------------------
namespace tma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;        // one kv-head a warp
constexpr int kBlock = 32 * kWarps;   // threads a block
constexpr int kSlots = 16;       // slots a tile, of each of the block's heads
constexpr unsigned kRing = 64 << 10;     // bytes of K and V in flight a block
constexpr unsigned kOneBlock = 120 << 10;  // shared memory that holds an SM
constexpr int kHeads = 16;       // q-heads a warp: the mma's M
constexpr int kRow = 128;        // bytes of a swizzled box row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// NKT 16-column steps of the head dim (d <= 16 NKT, zeros past d).  Shared
// memory, 1024-byte aligned: STAGES stages of K then V, each NB boxes of
// kWarps heads x 16 slots x 64 columns (8 KB, 128-byte swizzled; warp w's
// 16 rows are rows 16 w ..), then the barriers: a 64 KB ring (2 stages at
// d > 64, 4 below), and the block asks for kOneBlock so that it holds its
// SM alone.  On the card at 14 x 32k, one block an SM with 64 KB in flight
// ran faster than two or three blocks an SM with 128-192 KB: the more
// streams of 896-byte rows 7 KB apart, the lower HBM's rate.
template <int NKT>
struct Tile {
  static constexpr int NB = (16 * NKT + 63) / 64;
  static constexpr unsigned BOX = kWarps * kSlots * kRow;
  static constexpr unsigned KV_BYTES = NB * BOX;      // K or V of a stage
  static constexpr unsigned STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = kRing / STAGE;
  static constexpr unsigned OFF_BAR = STAGES * STAGE;
  static constexpr unsigned SMEM = OFF_BAR + 8 * 2 * STAGES > kOneBlock
                                       ? OFF_BAR + 8 * 2 * STAGES
                                       : kOneBlock;
};

// the shared address of (row r, column c) of a tile's swizzled boxes
__device__ __forceinline__ const uint8_t* at(const uint8_t* tile, int r,
                                             int c) {
  return tile + (c / 64) * (kWarps * kSlots * kRow) + r * kRow +
         ((((c % 64) / 8) ^ (r % 8)) << 4);
}

// One block per (4 consecutive kv-heads, group of up to 16 q-heads of each,
// batch row, split of the row's valid slots [s_lo, s_hi)).  Thread 0 issues
// the TMA loads of K and V tiles -- the 4 heads' rows of 16 slots, which lie
// side by side in the (B, S, H, D) caches, so a tile reads 4 x 224 bytes a
// slot at d = 112 -- into the ring (Tile; full and empty mbarriers),
// refilling a stage once every warp has released it.  Warp w
// takes kv-head 4 blockIdx + w with its own online softmax: S^T = Q K^T as
// mma.sync m16n8k16 (its q-heads as the 16 rows, zero past them; two
// 8-slot blocks; K by ldmatrix), then O += P V (P's two bf16 halves as the
// A fragments straight from S's accumulators, V by ldmatrix.trans), and at
// the end writes its heads' (acc, m, l) to the split's workspace rows, as
// the float32 kernel's.
template <int NKT>
__global__ void __launch_bounds__(kBlock)
decode_tma_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const bf16* __restrict__ q,
                  const int32_t* __restrict__ cache_len,
                  float* __restrict__ ws, int S, int Hq, int Hkv, int D,
                  int group, int nsub, int per, int nsplit, int window,
                  float softcap, float scale) {
  using T = Tile<NKT>;
  extern __shared__ __align__(1024) uint8_t smem[];
  if (smem_u32(smem) % 1024 != 0) __trap();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  uint64_t* empty = full + T::STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int hk0 = blockIdx.x / nsub * kWarps;   // the block's first kv-head
  const int sub = blockIdx.x % nsub;
  const int hk = hk0 + warp;                    // this warp's
  const int h0 = hk * group + sub * kHeads;     // its first q-head
  const int nh = hk < Hkv ? min(kHeads, group - sub * kHeads) : 0;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int clen = cache_len[b];
  const int lo = window > 0 ? max(0, clen - window) : 0;
  const int hi = min(clen, S);
  const int s_lo = lo + sp * per;          // this split: [s_lo, s_hi)
  const int s_hi = min(hi, s_lo + per);
  const size_t wrow = (size_t)nsplit * (D + 2);
  float* wsb = ws + ((size_t)b * Hq + h0) * wrow + (size_t)sp * (D + 2);
  if (s_lo >= s_hi) {                      // nothing here: weighs 0
    if (lane < nh) wsb[lane * wrow + D] = -INFINITY;
    return;
  }
  const int ntiles = (s_hi - s_lo + kSlots - 1) / kSlots;

  auto load_tile = [&](int i) {
    const int st = i % T::STAGES;
    mbar_arrive_expect_tx(&full[st], T::STAGE);
    uint8_t* ks = smem + st * T::STAGE;
    const int t0 = s_lo + i * kSlots;
    for (int x = 0; x < T::NB; ++x) {
      tma_load_4d(ks + x * T::BOX, &tk, &full[st], 64 * x, t0, hk0, b);
      tma_load_4d(ks + T::KV_BYTES + x * T::BOX, &tv, &full[st], 64 * x, t0,
                  hk0, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < min(T::STAGES, ntiles); ++i) load_tile(i);

  // Q as the A fragments of S^T's k steps: rows g, g + 8 (q-heads),
  // columns 2t, 2t + 1 and 2t + 8, 2t + 9 of the step
  uint32_t qa[NKT][4];
  {
    const bf16* qb = q + ((size_t)b * Hq + h0) * D;
    auto qv = [&](int r, int c) -> uint32_t {
      return r < nh && c < D ? bf16_bits(qb[r * D + c]) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1);
        const int c = 16 * kk + 2 * t + 8 * (i >> 1);
        qa[kk][i] = qv(r, c) | (qv(r, c + 1) << 16);
      }
  }
  // ldmatrix's row addresses: lane l reads row l % 8 of matrix l / 8; for
  // K the matrices are (slots +0, columns +0), (+0, +8), (+8, +0),
  // (+8, +8), for V (+0, +0), (+8, +0), (+0, +8), (+8, +8); the warp's
  // rows are its head's 16 slots
  const int mi = lane / 8;
  const int r0 = kSlots * warp;
  const int k_row = r0 + 8 * (mi >> 1) + lane % 8;
  const int k_col = 8 * (mi & 1);
  const int v_row = r0 + 8 * (mi & 1) + lane % 8;
  const int v_col = 8 * (mi >> 1);

  float o[2 * NKT][4];                     // O: 16 q-heads x 16 NKT, f32
#pragma unroll
  for (int n = 0; n < 2 * NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};     // q-heads g, g + 8
  float l[2] = {0.f, 0.f};

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % T::STAGES;
    mbar_wait(&full[st], (i / T::STAGES) & 1);
    const uint8_t* Kt = smem + st * T::STAGE;
    const uint8_t* Vt = Kt + T::KV_BYTES;

    // S^T: sc[j][e] is q-head g + 8 (e / 2), slot 8 j + 2t + e % 2
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, at(Kt, k_row, 16 * kk + k_col));
      const uint32_t b0[2] = {kf[0], kf[1]};
      const uint32_t b1[2] = {kf[2], kf[3]};
      mma_bf16_m16n8k16(sc[0], qa[kk], b0);
      mma_bf16_m16n8k16(sc[1], qa[kk], b1);
    }

    // scale, softcap, the split's end; the online softmax of q-heads g and
    // g + 8 (logits scaled as the plain version's, exponentials by ex2)
    const int slot0 = s_lo + i * kSlots + 2 * t;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = slot0 + 8 * j + (e & 1) < s_hi ? x : -INFINITY;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float msc[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      msc[r] = m_new == -INFINITY ? 0.f : m_new * kLog2e;
      alpha[r] = m_new == m[r] ? 1.f
                               : ex2_approx(fmaf(m[r], kLog2e, -msc[r]));
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2_approx(fmaf(sc[j][e], kLog2e, -msc[e >> 1]));
        sc[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l[r] = fmaf(l[r], alpha[r], sum[r]);
    }
    if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < 2 * NKT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // P (16 q-heads x 16 slots) as A fragments, two bf16 halves
    uint32_t phi[4], plo[4];
    split_bf16x2(sc[0][0], sc[0][1], phi[0], plo[0]);   // head g, slots 2t
    split_bf16x2(sc[0][2], sc[0][3], phi[1], plo[1]);   // head g + 8
    split_bf16x2(sc[1][0], sc[1][1], phi[2], plo[2]);   // slots 2t + 8
    split_bf16x2(sc[1][2], sc[1][3], phi[3], plo[3]);
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, at(Vt, v_row, 16 * kk + v_col));
      const uint32_t b0[2] = {vf[0], vf[1]};
      const uint32_t b1[2] = {vf[2], vf[3]};
      mma_bf16_m16n8k16(o[2 * kk], plo, b0);
      mma_bf16_m16n8k16(o[2 * kk + 1], plo, b1);
      mma_bf16_m16n8k16(o[2 * kk], phi, b0);
      mma_bf16_m16n8k16(o[2 * kk + 1], phi, b1);
    }

    // release the stage; thread 0 refills it once every warp has
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && i + T::STAGES < ntiles) {
      mbar_wait(&empty[st], (i / T::STAGES) & 1);
      load_tile(i + T::STAGES);
    }
  }

  // this warp's q-heads' workspace rows: (acc over d, m, l)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int head = g + 8 * r;
    if (head >= nh) continue;
    float* w = wsb + head * wrow;
#pragma unroll
    for (int n = 0; n < 2 * NKT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e;
        if (c < D) w[c] = o[n][2 * r + e];
      }
    if (t == 0) {
      w[D] = m[r];
      w[D + 1] = l[r];
    }
  }
}

template <int NKT>
int launch(const bf16* q, const bf16* k, const bf16* v, const int32_t* cl,
           float* ws, bf16* out, int B, int S, int Hq, int Hkv, int D,
           int per, int nsplit, int window, float softcap, float scale,
           cudaStream_t stream) {
  using T = Tile<NKT>;
  CUtensorMap tk, tv;
  int err = tensor_map_heads(&tk, k, D, Hkv, S, B, kSlots, kWarps);
  if (err == 0) err = tensor_map_heads(&tv, v, D, Hkv, S, B, kSlots, kWarps);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(decode_tma_kernel<NKT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)T::SMEM);
  if (err != 0) return err;
  const int group = Hq / Hkv;
  const int nsub = (group + kHeads - 1) / kHeads;
  dim3 grid((Hkv + kWarps - 1) / kWarps * nsub, B, nsplit);
  record_launch_event(0, stream);
  decode_tma_kernel<NKT><<<grid, kBlock, T::SMEM, stream>>>(
      tk, tv, q, cl, ws, S, Hq, Hkv, D, group, nsub, per, nsplit, window,
      softcap, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  record_launch_event(1, stream);
  dim3 grid2(Hq, B);
  decode_combine_kernel<bf16><<<grid2, kThreads, 0, stream>>>(
      ws, v, out, S, Hq, Hkv, D, group, nsplit);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return record_launch_event(2, stream);
}

// whether the launcher takes these operands on this kernel
bool takes(int D, const void* k, const void* v) {
  return D % 8 == 0 && D <= 128 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// the instance: NKT by the head dim (32, 64, 96, 112, 128)
#define VPAAS_TMA_INSTANCES(X) \
  if (D <= 32) X(2);           \
  if (D <= 64) X(4);           \
  if (D <= 96) X(6);           \
  if (D <= 112) X(7);          \
  X(8)

int dispatch(const bf16* q, const bf16* k, const bf16* v, const int32_t* cl,
             float* ws, bf16* out, int B, int S, int Hq, int Hkv, int D,
             int per, int nsplit, int window, float softcap, float scale,
             cudaStream_t st) {
#define VPAAS_TMA(NKT)                                                     \
  return launch<NKT>(q, k, v, cl, ws, out, B, S, Hq, Hkv, D, per, nsplit, \
                     window, softcap, scale, st)
  VPAAS_TMA_INSTANCES(VPAAS_TMA);
#undef VPAAS_TMA
}

// blocks of the instance for head dim D resident on the whole card (the
// blocks an SM, asked once an instance, times the device's SMs)
int resident(int D) {
  static int per_sm[9] = {0};              // by NKT
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0)
    return 0;
#define VPAAS_TMA(NKT)                                                      \
  do {                                                                      \
    if (per_sm[NKT] == 0 &&                                                 \
        (cudaFuncSetAttribute(decode_tma_kernel<NKT>,                       \
                              cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                              (int)Tile<NKT>::SMEM) != 0 ||                 \
         cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
             &per_sm[NKT], decode_tma_kernel<NKT>, kBlock,                  \
             Tile<NKT>::SMEM) != 0))                                        \
      return 0;                                                             \
    return sms * per_sm[NKT];                                               \
  } while (0)
  VPAAS_TMA_INSTANCES(VPAAS_TMA);
#undef VPAAS_TMA
}
#undef VPAAS_TMA_INSTANCES

}  // namespace tma

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
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
  if constexpr (sizeof(T) == 2) {
    if (tma::takes(D, k, v))
      return tma::dispatch(qt, kt, vt, cl, wf, ot, B, S, Hq, Hkv, D, per,
                           nsplit, window, softcap, scale, st);
  }
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

template <typename T>
int launch_any(const void* q, const void* k, const void* v,
               const void* cache_len, void* ws, void* out, int B, int S,
               int Hq, int Hkv, int D, int per, int nsplit, int window,
               float softcap, float scale, void* stream) {
  const int err = dispatch<T>(q, k, v, cache_len, ws, out, B, S, Hq, Hkv, D,
                              per, nsplit, window, softcap, scale, stream);
  end_launch_events();
  return err;
}

}  // namespace

// Launch timing (host.cuh): the next launch of K7's or K8's launcher
// records n (<= 8) of these events, one before each of its device kernels
// and one after the last.
extern "C" int vpaas_time_next_launch(void* const* events, int n) {
  if (n < 0 || n > kMaxLaunchEvents) return (int)cudaErrorInvalidValue;
  LaunchEvents& e = launch_events();
  for (int i = 0; i < n; ++i) e.ev[i] = static_cast<cudaEvent_t>(events[i]);
  e.n = n;
  e.recorded = 0;
  return 0;
}

// the events the last timed launch recorded
extern "C" int vpaas_launch_events_recorded() {
  return launch_events().recorded;
}

// SMs x resident blocks a SM of the bf16 TMA kernel for head dim D (what
// the wrapper sizes its splits by), or 0 where the launcher runs the bf16
// operands of head dim D on the other kernel.
extern "C" int vpaas_decode_attention_bf16_resident(int D) {
  return D % 8 == 0 && D <= 128 ? tma::resident(D) : 0;
}

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
