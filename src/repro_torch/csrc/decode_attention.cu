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
// The first float32 design (d <= 128, or d % 4 != 0, or unaligned
// caches): two kernels from one launcher.
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
// float32 at 128 < d <= 256, d % 4 == 0, aligned caches (gemma2-9b's
// serving decode: 4 slots at 385-399 of 512, 16 q-heads over 8 kv-heads,
// 25.7 MB of K and V a call, 7.7 us at 3.35 TB/s), decode_bulk_kernel,
// namespace bulk.  The split kernel there was bound by how it read: 8
// splits of 64 slots, 256 blocks of 136 KB (one an SM: 1.94 waves, split 7
// empty and split 6 nearly so at every row), each streaming one kv-head's
// 1 KB rows, 8 KB apart in the (B, S, H, D) caches, then a second launch
// to combine.  The design mends each:
//  - A block takes 4 consecutive kv-heads, one a warp: a slot's K (and V)
//    rows of the 4 lie side by side, 4 KB contiguous, and one
//    cp.async.bulk copies them (no tensor map: a row is one contiguous
//    run).  Lanes of warp 0 issue a tile's 8 slots of K and of V at once
//    into a ring of three 64 KB stages with full and empty mbarriers; 192
//    KB asked, one block an SM.
//  - The splits fill one wave of the card's resident blocks (the wrapper
//    plans by the library's occupancy answer, decode_attention.bulk_splits:
//    a row's merge waits for its last split, so a second wave would hold
//    it back): 16 splits of 32 slots at gemma2's decode, 128 blocks on 132
//    SMs, each with three of its four tiles in flight from its start.
//  - q.k and p.v stay on the CUDA cores in exact fp32 FMAs: at a GQA
//    group of 2 the function does half an FMA a byte, so bytes bound it.
//    Lane l holds 8 of d's columns; a tile's 8 slots x G heads of partial
//    dot products are reduce-scattered across the warp (16 shuffles at G
//    = 2, where a sum into every lane took 80), so each logit is capped
//    and exponentiated by its own lanes, not by all 32, and p goes to the
//    lanes by a shuffle.  The slot loops have no branch: a branch a slot
//    left the logits in local memory and each load waiting on the last
//    slot's products, several times as long a tile (a globaltimer trace
//    of each block's steps, on the card).
//  - One launch: each block writes its split's (acc, m, l) as the split
//    kernel does, then counts itself in (one acq_rel atomic on a counter
//    of its (row, block column) in device memory, by thread 0 after a
//    barrier, where a fence in every thread held each block up); the
//    block that
//    completes the count merges the row's splits in split order, as the
//    combine kernel does, and sets the counter back to 0 for the next
//    launch.  Its thread 0 asks for the splits' rows at once: one
//    cp.async.bulk a head into the free ring (16-byte rows of d + 4
//    floats), one trip to L2 where a load a split had each wait for the
//    last.  The merge's loops of run-time length stay rolled and
//    the mean of V is out of line: it runs once a block on cold code.
//    The merge's order never depends on which block is last, so the
//    result is bit-identical run to run, and the counters start every
//    launch at 0 (a CUDA graph replays it as it is); calls on one device
//    share the counters, so they must not run on two streams at once.
//
// bf16 q and caches (vpaas_decode_attention_bf16), the reference's launch
// path: a byte-bound kernel whose bytes bf16 halves (zamba2's decode_32k,
// 14 rows x 32,768 slots x 32 kv-heads x d = 112: 6.58 GB, 1.963 ms at
// 3.35 TB/s).  Designed for Hopper where d % 8 == 0, d <= 256 and the
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
//  - At d = 256 (gemma2-9b: decode_32k at 5 slots, 16 q-heads over 8
//    kv-heads, a global layer reading 1.34 GB of K and V, 0.40 ms at HBM's
//    rate) a stage of 16 slots of 4 heads is 64 KB of K and V, and the
//    ring holds three; O takes 128 registers a lane (16 padded q-heads x 256
//    columns, of which gemma2's group of 2 fills 2 rows), so Q's fragments
//    wait in shared memory, not in 64 more registers.
// Other bf16 operands (d % 8 != 0, d > 256, an unaligned cache) take the
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
// bf16, d % 8 == 0, d <= 256, k and v 16-byte aligned: TMA tiles, mma.sync
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
// streams of 896-byte rows 7 KB apart, the lower HBM's rate.  At d = 256
// (NKT 16) a stage is 64 KB: the ring holds three (192 KB), and Q's A
// fragments (Q_SHARED: kWarps x NKT x 32 lanes x 16 bytes, 32 KB) follow
// the barriers, one 16-byte read a lane a k step: in registers they would
// be 64 a lane beside O's 128.
template <int NKT>
struct Tile {
  static constexpr int NB = (16 * NKT + 63) / 64;
  static constexpr unsigned BOX = kWarps * kSlots * kRow;
  static constexpr unsigned KV_BYTES = NB * BOX;      // K or V of a stage
  static constexpr unsigned STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = STAGE < kRing ? kRing / STAGE : 3;
  static constexpr unsigned OFF_BAR = STAGES * STAGE;
  static constexpr bool Q_SHARED = NKT > 8;
  static constexpr unsigned OFF_Q = OFF_BAR + 16 * STAGES;   // 16-aligned
  static constexpr unsigned END =
      OFF_Q + (Q_SHARED ? kWarps * NKT * 32 * 16 : 0);
  static constexpr unsigned SMEM = END > kOneBlock ? END : kOneBlock;
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
  // columns 2t, 2t + 1 and 2t + 8, 2t + 9 of the step; in registers, or
  // past d = 128 in this warp's shared rows, a lane's four 16 bytes apart
  // from the next lane's
  uint32_t qa[T::Q_SHARED ? 1 : NKT][4];
  uint4* qs = reinterpret_cast<uint4*>(smem + T::OFF_Q) + warp * NKT * 32;
  {
    const bf16* qb = q + ((size_t)b * Hq + h0) * D;
    auto qv = [&](int r, int c) -> uint32_t {
      return r < nh && c < D ? bf16_bits(qb[r * D + c]) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i & 1);
        const int c = 16 * kk + 2 * t + 8 * (i >> 1);
        f[i] = qv(r, c) | (qv(r, c + 1) << 16);
      }
      if constexpr (T::Q_SHARED) {
        qs[kk * 32 + lane] = make_uint4(f[0], f[1], f[2], f[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[kk][i] = f[i];
      }
    }
    if constexpr (T::Q_SHARED) __syncwarp();
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
      if constexpr (T::Q_SHARED) {
        const uint4 u = qs[kk * 32 + lane];
        const uint32_t a[4] = {u.x, u.y, u.z, u.w};
        mma_bf16_m16n8k16(sc[0], a, b0);
        mma_bf16_m16n8k16(sc[1], a, b1);
      } else {
        mma_bf16_m16n8k16(sc[0], qa[kk], b0);
        mma_bf16_m16n8k16(sc[1], qa[kk], b1);
      }
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
  return D % 8 == 0 && D <= 256 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// the instance: NKT by the head dim (32, 64, 96, 112, 128, 256)
#define VPAAS_TMA_INSTANCES(X) \
  if (D <= 32) X(2);           \
  if (D <= 64) X(4);           \
  if (D <= 96) X(6);           \
  if (D <= 112) X(7);          \
  if (D <= 128) X(8);          \
  X(16)

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
  static int per_sm[17] = {0};             // by NKT
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

// ---------------------------------------------------------------------------
// float32, 128 < d <= 256, d % 4 == 0, aligned caches: bulk copies of
// contiguous multi-head tiles, the combine in the split's last block
// ---------------------------------------------------------------------------
namespace bulk {

constexpr int kWarps = 4;        // one kv-head a warp
constexpr int kBlock = 32 * kWarps;
constexpr int kSlots = 8;        // slots a tile, of each of the block's heads
constexpr int kStages = 3;       // tiles in flight
constexpr int kMaxD = 256;
constexpr int kCols = 2;         // float4 column chunks a lane: 8 columns
constexpr int kMaxCounters = 1 << 16;

// arrivals a (batch row, block column) of the grid, zero between launches:
// the block whose arrival completes its row's splits merges them and sets
// the count back to 0
__device__ unsigned arrivals[kMaxCounters];

// shared memory: kStages stages of K then V, each kSlots x kWarps rows of D
// floats (slot-major, the heads of a slot side by side, as in the cache;
// the merge's workspace rows once they are read), then a full and an empty
// mbarrier a stage, the merge's mbarrier and the last-block flag
constexpr unsigned kStageFloats = 2 * kSlots * kWarps * kMaxD;
constexpr unsigned kOffBar = kStages * kStageFloats * 4;
constexpr unsigned kSmem = kOffBar + 16 * kStages + 16;

// A warp sum of N values a lane, reduce-scattered (V values at the start):
// at the step of offset O = 16 N / V a lane keeps the half of its values
// whose index bit matches its lane bit O and adds its partner's half, so
// after log2(V) steps s[0] is value lane >> (5 - log2 V) summed over the
// lanes of those bits.  Values are picked by value (two loads, then a
// select): a select of array elements kept s in local memory.
template <int N, int V>
__device__ __forceinline__ void reduce_scatter(float* s, int lane) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    constexpr int O = 16 * N / V;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const float lo = s[u], hi = s[u + H];
      const float theirs = __shfl_xor_sync(kFull, upper ? lo : hi, O);
      s[u] = (upper ? hi : lo) + theirs;
    }
    reduce_scatter<H, V>(s, lane);
  }
}

// a float4 of a shared row, or zeros where ok is false (no branch: the
// address is read either way, so it must lie inside the ring)
__device__ __forceinline__ float4 load4_or_zero(const float* p, bool ok) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  return make_float4(ok ? x.x : 0.f, ok ? x.y : 0.f, ok ? x.z : 0.f,
                     ok ? x.w : 0.f);
}

// A head with no valid slot: the plain version's softmax over S equal
// -1e30 logits is uniform, so it gets the mean of V (the lane's columns;
// out of line: no path has such a row, and its loops unrolled into the
// merge made the code that runs cold much longer)
__device__ __noinline__ void mean_of_v(float* o, const float* __restrict__ v,
                                       int b, int S, int Hkv, int D, int hk,
                                       const int (&col)[kCols]) {
#pragma unroll 1
  for (int c = 0; c < kCols; ++c)
#pragma unroll 1
    for (int e = 0; e < 4; ++e) {
      if (col[c] >= D) continue;
      const float* vc = v + ((size_t)b * S * Hkv + hk) * D + col[c] + e;
      float sum = 0.f;
#pragma unroll 1
      for (int j = 0; j < S; ++j) sum += vc[(size_t)j * Hkv * D];
      o[col[c] + e] = sum / (float)S;
    }
}

// The workspace rows of splits [x0, x0 + ch) of the block's q-heads into
// the ring, by one cp.async.bulk a head (a head's splits are contiguous),
// delivered to bar (one thread)
__device__ __forceinline__ void merge_load(float* smem, uint64_t* bar,
                                           const float* __restrict__ ws,
                                           int b, int Hq, int D, int group,
                                           int hk0, int nkv, int sub, int nh,
                                           int G, int nsplit, int x0, int ch,
                                           int ch_max) {
  const int W = D + 4;
  mbar_arrive_expect_tx(bar, 4u * nkv * nh * ch * W);
#pragma unroll 1
  for (int u = 0; u < nkv; ++u)
#pragma unroll 1
    for (int g = 0; g < nh; ++g)
      bulk_load(smem + (size_t)((u * G + g) * ch_max) * W,
                ws + (((size_t)b * Hq + (hk0 + u) * group + sub * G + g) *
                      nsplit + x0) * W,
                4u * ch * W, bar);
}

// The merge of a row's splits for the block's q-heads, by every thread of
// the row's last block: each split weighted by exp(m - max m), in split
// order, as decode_combine_kernel (bit-identical run to run).  The splits'
// workspace rows (acc, m, l and two floats of padding: 16-byte rows) come
// into the free ring a chunk of splits at a time (merge_load: one trip to
// L2; thread 0 issued the first chunk's as soon as its atomic said the
// block is last).  Then warp w takes its kv-head's q-heads: lane x reads
// split x's m for the chunk's max and leaves the split's weight in the
// row's padding, and every lane adds its 8 columns split by split, its
// heads side by side and the shared reads of several splits in flight.
// Where a later chunk raises the max, the sums so far are scaled down to
// it first.
template <int G>
__device__ __forceinline__ void merge(float* smem, uint64_t* bar,
                                      const float* __restrict__ ws,
                                      const float* __restrict__ v,
                                      float* __restrict__ out, int b, int S,
                                      int Hq, int Hkv, int D, int group,
                                      int hk0, int nkv, int sub, int nh,
                                      int nsplit, const int (&col)[kCols]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int W = D + 4;                            // a workspace row
  const int ch_max = kStages * kStageFloats / (kWarps * G * W);
  const int hk = hk0 + warp;
  const int h0 = hk * group + sub * G;
  float mx[G], num[G][4 * kCols], den[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = -INFINITY;
    den[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kCols; ++e) num[g][e] = 0.f;
  }
  const float* r0[G];
  for (int x0 = 0, phase = 0; x0 < nsplit; x0 += ch_max, phase ^= 1) {
    const int ch = min(ch_max, nsplit - x0);
    if (x0 > 0) {
      __syncthreads();                 // the last chunk is read
      if (threadIdx.x == 0)
        merge_load(smem, bar, ws, b, Hq, D, group, hk0, nkv, sub, nh, G,
                   nsplit, x0, ch, ch_max);
    }
    mbar_wait(bar, phase);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* r = smem + (size_t)((warp * G + g) * ch_max) * W;
      r0[g] = r;
      if (g >= nh) continue;
      // (loops of a run-time length stay rolled: the merge runs once a
      // block, and unrolled code is fetched cold)
      float cmx = -INFINITY;
#pragma unroll 1
      for (int x = lane; x < ch; x += 32) cmx = fmaxf(cmx, r[x * W + D]);
      const float m_new = fmaxf(mx[g], warp_max(cmx));
      if (m_new != mx[g] && mx[g] != -INFINITY) {
        const float scale = expf(mx[g] - m_new);
#pragma unroll
        for (int e = 0; e < 4 * kCols; ++e) num[g][e] *= scale;
        den[g] *= scale;
      }
      mx[g] = m_new;
      // split x's weight (0 where empty) into its row's padding
#pragma unroll 1
      for (int x = lane; x < ch; x += 32) {
        const float ms = r[x * W + D];
        r[x * W + D + 2] = ms == -INFINITY ? 0.f : expf(ms - m_new);
      }
    }
    __syncwarp();
#pragma unroll 2
    for (int x = 0; x < ch; ++x) {
      float f[G], l[G];
      float4 a[G][kCols];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* r = r0[g] + x * W;
        f[g] = g < nh ? r[D + 2] : 0.f;
        l[g] = r[D + 1];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          // zeros for an empty split's stale acc (its weight is 0, and 0
          // times a stale inf or NaN is not), and column 0 where the
          // lane's columns pass d: past the last row lies the end of
          // shared memory
          a[g][c] = load4_or_zero(r + (col[c] < D ? col[c] : 0),
                                  col[c] < D && f[g] != 0.f);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          num[g][4 * c] += a[g][c].x * f[g];
          num[g][4 * c + 1] += a[g][c].y * f[g];
          num[g][4 * c + 2] += a[g][c].z * f[g];
          num[g][4 * c + 3] += a[g][c].w * f[g];
        }
        den[g] += f[g] != 0.f ? l[g] * f[g] : 0.f;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= nh) continue;
    float* o = out + ((size_t)b * Hq + h0 + g) * D;
    if (mx[g] == -INFINITY) {
      mean_of_v(o, v, b, S, Hkv, D, hk, col);
      continue;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col[c] < D) o[col[c] + e] = num[g][4 * c + e] / den[g];
  }
}

// G = q-heads a warp carries (its kv-head's group, or a part of it).  One
// block per (kWarps consecutive kv-heads, group part, batch row, split of
// the row's valid slots [s_lo, s_hi)).  Lanes 0 .. n - 1 of warp 0 copy
// slot j's K row of the block's heads (nkv x D floats, contiguous in the
// (B, S, H, D) cache) by one cp.async.bulk each, lanes 8 .. 8 + n - 1 its
// V row, into a ring of kStages tiles with full and empty mbarriers.  Warp
// w takes kv-head hk0 + w: lane l holds columns [4 l, 4 l + 4) and [128 +
// 4 l, 128 + 4 l + 4) of q, K, V and O.  A tile's kSlots x G dot products
// are the lanes' partial sums reduce-scattered (reduce_scatter): each ends
// in the lanes of one value, which cap, mask and exponentiate it once, and
// each lane takes the p it needs for p.v by a shuffle.  Slots past the
// tile's end are read and masked, not branched around.  The split's (acc,
// m, l) go to the workspace, as the split kernel's; then the block counts
// itself in, and the one that completes its (row, block column)'s nsplit
// arrivals merges the splits in split order for the block's q-heads
// (merge), as decode_combine_kernel does (bit-identical run to run: the
// order does not depend on which block is last).
template <int G>
__global__ void __launch_bounds__(kBlock, 1)
decode_bulk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const int32_t* __restrict__ cache_len,
                   float* __restrict__ ws, float* __restrict__ out, int S,
                   int Hq, int Hkv, int D, int group, int nsub, int per,
                   int nsplit, int window, float softcap, float scale) {
  // a tile's (slot, head) logits, kSlots * G of them, and the lane bits
  // below a value's index once they are reduce-scattered (see below)
  constexpr int V = kSlots * G;
  constexpr int LV = V == 8 ? 3 : V == 16 ? 4 : 5;
  constexpr int SH = 5 - LV;
  constexpr int LG = G == 1 ? 0 : G == 2 ? 1 : 2;
  static_assert(V == 1 << LV && G == 1 << LG, "whole lane bits");
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(smem) + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* merged = empty + kStages;             // the merge's loads
  int* last = reinterpret_cast<int*>(merged + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hk0 = blockIdx.x / nsub * kWarps;     // the block's first kv-head
  const int sub = blockIdx.x % nsub;
  const int nkv = min(kWarps, Hkv - hk0);         // kv-heads it loads
  const int hk = hk0 + warp;                      // this warp's
  const int h0 = hk * group + sub * G;            // its first q-head
  const int nh = warp < nkv ? min(G, group - sub * G) : 0;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;

  // this lane's columns of q (zeros past D and past the warp's heads),
  // asked before cache_len so that the two loads overlap
  const int col[kCols] = {4 * lane, 128 + 4 * lane};
  float qr[G][4 * kCols];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qr[g][4 * c + e] =
            g < nh && col[c] < D
                ? q[((size_t)b * Hq + h0 + g) * D + col[c] + e] : 0.f;

  const int clen = cache_len[b];
  const int lo = window > 0 ? max(0, clen - window) : 0;
  const int hi = min(clen, S);
  const int s_lo = lo + sp * per;                 // this split
  const int s_hi = min(hi, s_lo + per);
  const int ntiles = s_lo < s_hi ? (s_hi - s_lo + kSlots - 1) / kSlots : 0;
  const size_t wrow = (size_t)nsplit * (D + 4);
  const unsigned row_bytes = 4u * nkv * D;        // a slot of the block

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);
    }
    mbar_init(merged, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // tile i into stage i % kStages (warp 0)
  auto load_tile = [&](int i) {
    const int st = i % kStages;
    const int t0 = s_lo + i * kSlots;
    const int n = min(kSlots, s_hi - t0);
    if (lane == 0) mbar_arrive_expect_tx(&full[st], 2 * n * row_bytes);
    __syncwarp();
    const int j = lane % kSlots;
    if (lane < 2 * kSlots && j < n) {
      const float* src = (lane < kSlots ? k : v) +
                         (((size_t)b * S + t0 + j) * Hkv + hk0) * D;
      float* dst = smem + st * kStageFloats +
                   (lane < kSlots ? 0 : kStageFloats / 2) +
                   j * kWarps * D;
      bulk_load(dst, src, row_bytes, &full[st]);
    }
  };
  if (warp == 0)
    for (int i = 0; i < min(kStages, ntiles); ++i) load_tile(i);

  // the running max and sum of this lane's head (g_own, below), which the
  // lanes of one head hold alike; acc the lane's columns of every head
  const int idx = lane >> SH;                     // its (slot, head) value
  const int j_own = idx >> LG;
  const int g_own = idx & (G - 1);
  float m_own = -INFINITY, l_own = 0.f;
  float acc[G][4 * kCols];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4 * kCols; ++e) acc[g][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const int n = min(kSlots, s_hi - s_lo - i * kSlots);   // slots in it
    mbar_wait(&full[st], (i / kStages) & 1);
    if (nh > 0) {                        // warp-uniform
      const float* Kt = smem + st * kStageFloats + warp * D;
      const float* Vt = Kt + kStageFloats / 2;
      // q.k of each (slot j, head g) as s[G j + g]: the lane's 8 products.
      // Every slot of the tile is read, with no branch a slot (branches
      // kept s in local memory and each load behind the last slot's
      // products): slots past n read what the stage held before, and the
      // softmax masks their logits
      float s[V];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[G * j + g] = 0.f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 kx = load4_or_zero(Kt + j * kWarps * D + col[c],
                                          col[c] < D);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float& x = s[G * j + g];
            x = fmaf(qr[g][4 * c], kx.x, x);
            x = fmaf(qr[g][4 * c + 1], kx.y, x);
            x = fmaf(qr[g][4 * c + 2], kx.z, x);
            x = fmaf(qr[g][4 * c + 3], kx.w, x);
          }
        }
      }
      // the warp sums, reduce-scattered (value idx = lane >> SH), then
      // the last SH steps add the lanes below (lanes of one value agree
      // bit for bit)
      reduce_scatter<V, V>(s, lane);
#pragma unroll
      for (int o = (1 << SH) >> 1; o > 0; o >>= 1)
        s[0] += __shfl_xor_sync(kFull, s[0], o);
      // the online softmax step of head g_own over the tile's slots (one
      // logit a lane: capped and exponentiated once), across the lane bits
      // of the slot index
      float x = s[0] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool valid = j_own < n;
      x = valid ? x : -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = 1 << (SH + LG); o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m_own, mx);    // finite: slot 0 is valid
      const float alpha = expf(m_own - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 1 << (SH + LG); o < 32; o <<= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l_own = l_own * alpha + sum;
      m_own = m_new;
      // p.v on the lane's columns, slots in order: each head's factor and
      // p from a lane that holds it
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a = __shfl_sync(kFull, alpha, g << SH);
#pragma unroll
        for (int e = 0; e < 4 * kCols; ++e) acc[g][e] *= a;
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        float pj[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          pj[g] = __shfl_sync(kFull, p, (G * j + g) << SH);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // a slot past n holds what the stage held before: zeros instead
          // (p is 0 there, and 0 times a stale inf or NaN is not)
          const float4 vx = load4_or_zero(Vt + j * kWarps * D + col[c],
                                          col[c] < D && j < n);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][4 * c] = fmaf(pj[g], vx.x, acc[g][4 * c]);
            acc[g][4 * c + 1] = fmaf(pj[g], vx.y, acc[g][4 * c + 1]);
            acc[g][4 * c + 2] = fmaf(pj[g], vx.z, acc[g][4 * c + 2]);
            acc[g][4 * c + 3] = fmaf(pj[g], vx.w, acc[g][4 * c + 3]);
          }
        }
      }
    }
    // release the stage; warp 0 refills it once every warp has
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (warp == 0 && i + kStages < ntiles) {
      mbar_wait(&empty[st], (i / kStages) & 1);
      load_tile(i + kStages);
    }
  }

  // the split's workspace rows: (acc over d, m, l); m = -inf where empty
  float* wsb = ws + ((size_t)b * Hq + h0) * wrow + (size_t)sp * (D + 4);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mg = __shfl_sync(kFull, m_own, g << SH);
    const float lg = __shfl_sync(kFull, l_own, g << SH);
    if (g >= nh) continue;
    float* w = wsb + g * wrow;
    if (ntiles > 0)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col[c] < D) w[col[c] + e] = acc[g][4 * c + e];
    if (lane == 0) {
      w[D] = mg;
      w[D + 1] = lg;
    }
  }

  // count the block in; the last of the row's nsplit merges.  The block's
  // rows are released by its thread 0 after the barrier (an acq_rel atomic
  // at device scope, where a fence in every thread was slower), and the
  // last block's thread 0 acquires the others' by the same atomic, orders
  // its bulk copies after them and asks for the first chunk at once
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* cnt = &arrivals[(size_t)b * gridDim.x + blockIdx.x];
    *last = atomic_add_acq_rel_gpu(cnt, 1u) == (unsigned)nsplit - 1;
    if (*last) {
      *cnt = 0;
      fence_proxy_async_global();
      const int ch_max = kStages * kStageFloats / (kWarps * G * (D + 4));
      merge_load(smem, merged, ws, b, Hq, D, group, hk0, nkv, sub, nh, G,
                 nsplit, 0, min(nsplit, ch_max), ch_max);
    }
  }
  __syncthreads();
  if (!*last) return;
  merge<G>(smem, merged, ws, v, out, b, S, Hq, Hkv, D, group, hk0, nkv, sub,
           nh, nsplit, col);
}

template <int G>
int launch_g(const float* q, const float* k, const float* v,
             const int32_t* cl, float* ws, float* out, int B, int S, int Hq,
             int Hkv, int D, int per, int nsplit, int window, float softcap,
             float scale, cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int nsub = (group + G - 1) / G;
  dim3 grid((Hkv + kWarps - 1) / kWarps * nsub, B, nsplit);
  if ((size_t)B * grid.x > (size_t)kMaxCounters)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      decode_bulk_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != 0) return err;
  record_launch_event(0, stream);
  decode_bulk_kernel<G><<<grid, kBlock, kSmem, stream>>>(
      q, k, v, cl, ws, out, S, Hq, Hkv, D, group, nsub, per, nsplit, window,
      softcap, scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return record_launch_event(1, stream);
}

// q-heads a warp carries: the kv-head's whole group up to 2, else 4 a
// block of the grid's group parts
int launch(const float* q, const float* k, const float* v, const int32_t* cl,
           float* ws, float* out, int B, int S, int Hq, int Hkv, int D,
           int per, int nsplit, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int group = Hq / Hkv;
  if (group == 1)
    return launch_g<1>(q, k, v, cl, ws, out, B, S, Hq, Hkv, D, per, nsplit,
                       window, softcap, scale, stream);
  if (group == 2)
    return launch_g<2>(q, k, v, cl, ws, out, B, S, Hq, Hkv, D, per, nsplit,
                       window, softcap, scale, stream);
  return launch_g<4>(q, k, v, cl, ws, out, B, S, Hq, Hkv, D, per, nsplit,
                     window, softcap, scale, stream);
}


// whether the launcher takes these float32 operands on this kernel
bool takes(int D, const void* k, const void* v) {
  return D > 128 && D <= kMaxD && D % 4 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// blocks of the kernel resident on the whole card (as tma::resident)
int resident() {
  static int per_sm = 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0)
    return 0;
  if (per_sm == 0 &&
      (cudaFuncSetAttribute(decode_bulk_kernel<4>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)kSmem) != 0 ||
       cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_bulk_kernel<4>, kBlock, kSmem) != 0))
    return 0;
  return sms * per_sm;
}

}  // namespace bulk

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
  } else {
    if (bulk::takes(D, k, v))
      return bulk::launch(qt, kt, vt, cl, wf, ot, B, S, Hq, Hkv, D, per,
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
  return D % 8 == 0 && D <= 256 ? tma::resident(D) : 0;
}

// SMs x resident blocks an SM of the float32 bulk kernel (what the wrapper
// sizes its splits by), or 0 where the launcher runs float32 operands of
// head dim D on the split kernel.
extern "C" int vpaas_decode_attention_resident(int D) {
  return D > 128 && D <= 256 && D % 4 == 0 ? bulk::resident() : 0;
}

// q (B, Hq, D), k and v caches (B, S, Hkv, D) f32, cache_len (B,) int32,
// workspace (B, Hq, nsplit, D + 2) f32 (D + 4 where the bulk kernel takes
// the operands) -> out (B, Hq, D).  A row's valid
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
