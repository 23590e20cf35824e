// K6: flash attention (prefill), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (kernel body _kernel): GQA attention with an online
// softmax, causal mask, optional sliding window and logit softcap, in
// float32.  The query offset (q_pos = q_offset[b] + row) is a device array,
// one entry per batch row, read at run time: the Pallas kernel baked it in
// as a static int, but the cache prefill passes the cache index, which
// differs per row under continuous batching.
//
// Semantics follow the plain version (repro_torch/kernels/ref.py
// flash_attention): logits are scaled by d^-0.5, soft-capped
// (c * tanh(s / c)) and then masked (k_pos < s_kv, causal q_pos >= k_pos,
// window q_pos - k_pos < window).  Masked logits there are the finite
// -1e30, so a row that has no valid key at all averages V uniformly over
// all s_kv keys; both kernels give that row the same mean (a loop over V
// at the end) instead of a NaN.
//
// What bounds it on the card: at the LLM path's prefill (s_q = 384 against
// a 512-slot cache, 32 heads, d = 112) the causal work is ~1.1 GFLOP
// against ~20 MB of Q/K/V/O, so operations bound it: ~16 us at fp32's
// 67 TFLOP/s on the CUDA cores, ~7 us with the products' 3 x 1.1 GFLOP at
// the tensor cores' 495 TFLOP/s dense TF32.
//
// Design (d = d_v <= 128): both products run on the tensor cores with
// mma.sync m16n8k8 tf32 in 3xTF32 split precision, the arithmetic of
// PyTorch's own fp32 attention on sm80+: each fp32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), and each 16x8x8 step sums lo*hi and
// hi*lo, then hi*hi, in fp32, which keeps the products about as accurate
// as fp32 FMAs (the dropped lo*lo is ~2^-22 of |a b|); plain TF32's ~1e-3
// would miss the 1e-5 tolerance.  For S the cross terms go to their own
// accumulator and join the hi*hi sum once per tile.  A block takes 64
// query rows of one (batch row, q-head) with 8 warps: 4 row warps of 16
// rows, times 2 key groups that take the two 32-key halves of each 64-key
// tile and keep their own online softmax, merged through shared memory at
// the end: with one key group a block has one warp per scheduler, too few
// to hide the latency of the dependent mma.sync and split instructions.
// K and V come through
// cp.async (16-byte copies where d % 4 == 0 and the operands are aligned,
// else 4-byte) into a double-buffered ring in shared memory, so tile j+1
// loads while tile j is computed.  The head dim is padded with zeros to
// DP = 8 * NDT; shared rows are DP + 4 floats, which keeps every fragment
// load of Q, K and V free of bank conflicts and every row 16-byte aligned.
// S = QK^T lands in accumulator fragments; the online softmax runs on them
// (row max and sum across the 4-lane quad that holds a row; exponentials
// by ex2.approx), and P goes back into the PV product as the A operand
// straight from registers: the key order inside each 8-key step is
// permuted so that a lane's accumulator pair (keys 2t, 2t+1) is its
// A-fragment pair (cols t, t+4), and V's B fragments are read in the same
// order.  The mmas of one term are issued over independent accumulators
// back to back.  Key halves that the causal mask or the window close for
// every row of a warp are skipped.  The grid puts the query tile in its
// slow dimension and launches the heaviest causal tiles (the last rows)
// first: 6 x 32 = 192 blocks at the zamba2 prefill, one per SM at a time
// (148,480 B of Q and the K/V ring at d = 112), so SMs that finish light
// tiles take the rest.
//
// d > 128 (gemma2's 256) and every value head dim of its own (d_v != d:
// MLA's prefill, d = 192 and d_v = 128 at deepseek-v2-lite's width, 96 and
// 64 in its smoke config) take the CUDA-core kernel below, chosen by the
// shapes: one block per (32-row query tile, q-head, batch row), four warps
// of eight rows, K/V tiles of 32 keys staged in shared memory, one key per
// lane for QK^T over d, NC = ceil(d_v/32) output columns per lane for PV
// (NC = 2, 4 or 8).  Its O accumulator would need 128 registers a lane in
// the tensor-core layout at d = 256, and the tensor-core kernel's Q tile
// and K/V ring take 250,880 B of shared memory at d = 192, past the 227 KB
// a block may have.  At MLA's prefill (384 queries against the 512-slot
// cache, 16 heads, 73,920 causal pairs a head) the work is ~0.76 GFLOP
// for ~5.5 us of bytes: operations bound it, ~11 us at fp32's 67 TFLOP/s.
//
// bf16 operands (vpaas_flash_attention_bf16: the reference's launch path
// computes in bf16, and its Pallas kernel loads bf16 and sums in f32).
// d = d_v <= 128 takes flash_attention_bf16_kernel, the float32 kernel's
// blocks, warps, key groups, ring and merge with bf16 tiles in shared
// memory (rows of DP + 8 values: 76,800 B at d = 112, half the float32
// kernel's): q.k is one mma.sync m16n8k16 bf16 per step -- the product of
// two bf16 values is exact in f32, so this is the Pallas kernel's f32 dot
// of the upcast operands; scale and softcap apply to the f32 logits. The
// softmax stays f32, and P V takes p as two bf16 halves (hi = bf16(p),
// lo = bf16(p - hi), two mmas): p keeps ~16 bits, as the Pallas kernel
// keeps it f32, where one bf16 would round it (as jnp's ref does). The
// accumulators are P's A fragments as they stand (two 8-key groups make
// a 16-key step); V's B fragment pairs two rows of a column, two 16-bit
// loads. The output is rounded to bf16 once. The CUDA-core kernel is a
// template over the element type: bf16 widens to f32 as it is staged.
// At the zamba2 prefill the bf16 products take ~1.1 us at 989.4 TFLOP/s,
// so the softmax on the CUDA cores and the 10 MB of bytes bound it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "primitives.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// tensor-core kernel, d = d_v <= 128
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRowWarps = 4;             // 16 query rows each
constexpr int kGroups = 2;                // key groups: halves of a tile
constexpr int kBQ = 16 * kRowWarps;       // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr int kBKG = kBK / kGroups;       // keys per tile of one group
constexpr int kNJ = kBKG / 8;             // a warp's 8-key steps per tile
constexpr int kThreads = 32 * kRowWarps * kGroups;

// shared row stride for a padded head dim DP (a multiple of 8): DP + 4 is
// 4 mod 8, so the 8 rows g x 4 columns t of a Q/K fragment and the 4 row
// pairs 2t, 2t+1 x 8 columns g of a V fragment hit 32 distinct banks
__host__ __device__ constexpr int row_stride(int DP) { return DP + 4; }

size_t smem_bytes(int DP) {
  return sizeof(float) * (size_t)row_stride(DP) * (kBQ + 4 * kBK);
}

// Copy rows [0, nrows) of a slab (row r at src + r * stride, D floats) into
// shared rows of row_stride(DP) floats through cp.async; rows >= valid and
// columns >= D are filled with zeros.  Every thread of the block calls it.
template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int valid,
                                           int nrows, int D, bool vec) {
  constexpr int S = row_stride(DP);
  if (vec) {                       // D % 4 == 0, 16-byte aligned operands
    constexpr int C4 = DP / 4;
    for (int e = threadIdx.x; e < nrows * C4; e += kThreads) {
      const int r = e / C4;
      const int c = 4 * (e - r * C4);
      const bool ok = r < valid && c < D;
      cp_async_16(dst + r * S + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      const bool ok = r < valid && c < D;
      cp_async_4(dst + r * S + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// NDT = the padded head dim's 8-column tiles: D <= 8 * NDT <= 128.
template <int NDT>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int32_t* __restrict__ q_offset,
                           float* __restrict__ out, int Sq, int Skv, int Hq,
                           int Hkv, int D, int causal, int window,
                           float softcap, float scale) {
  constexpr int DP = 8 * NDT;
  constexpr int S = row_stride(DP);
  constexpr int kDG = 2;                 // d-tiles per group of PV mmas
  static_assert(NDT % kDG == 0, "PV groups split the d-tiles evenly");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][S]
  float* Ks = Qs + kBQ * S;                      // [2][kBK][S]
  float* Vs = Ks + 2 * kBK * S;                  // [2][kBK][S]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32 % kRowWarps;   // the rows it takes
  const int grp = threadIdx.x / 32 / kRowWarps;    // the keys it takes
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                  // fragment row group
  const int t = lane % 4;                  // thread in the group
  const int off = q_offset[b];
  const int qrows = min(kBQ, Sq - q0);

  // the keys some row of this tile may attend: [kv_lo, kv_hi)
  const int pos_lo = off + q0;
  const int pos_hi = off + q0 + qrows - 1;
  int kv_lo = 0;
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, pos_hi + 1);
  if (window > 0) kv_lo = max(0, pos_lo - window + 1);

  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t kv_stride = (size_t)Hkv * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;     // key 0
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  stage_rows<DP>(Qs, q + (((size_t)b * Sq + q0) * Hq + h) * D,
                 (size_t)Hq * D, qrows, kBQ, D, vec);
  if (kv_lo < kv_hi) {
    const int n = min(kBK, kv_hi - kv_lo);
    stage_rows<DP>(Ks, kb + kv_lo * kv_stride, kv_stride, n, kBK, D, vec);
    stage_rows<DP>(Vs, vb + kv_lo * kv_stride, kv_stride, n, kBK, D, vec);
  }
  cp_async_commit();

  const int wr0 = warp * 16;                       // the warp's first row
  const int wpos_lo = off + q0 + wr0;              // its query positions
  const int wpos_hi = wpos_lo + 15;
  const int qp[2] = {wpos_lo + g, wpos_lo + g + 8};  // this lane's rows

  float o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  int buf = 0;
  for (int kt = kv_lo; kt < kv_hi; kt += kBK, buf ^= 1) {
    const int nxt = kt + kBK;
    if (nxt < kv_hi) {             // the next tile loads during this one
      const int n = min(kBK, kv_hi - nxt);
      float* kd = Ks + (buf ^ 1) * kBK * S;
      float* vd = Vs + (buf ^ 1) * kBK * S;
      stage_rows<DP>(kd, kb + nxt * kv_stride, kv_stride, n, kBK, D, vec);
      stage_rows<DP>(vd, vb + nxt * kv_stride, kv_stride, n, kBK, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();            // every group but the newest: this tile
    __syncthreads();

    // this warp's half of the tile: keys kg .. kg + kBKG - 1; skipped
    // when the mask closes it for all the warp's rows (warp-uniform)
    const int kg = kt + grp * kBKG;
    const bool closed = kg >= kv_hi || (causal && wpos_hi < kg) ||
                        (window > 0 && wpos_lo - (kg + kBKG - 1) >= window);
    if (!closed) {
      const float* Kt = Ks + (buf * kBK + grp * kBKG) * S;
      const float* Vt = Vs + (buf * kBK + grp * kBKG) * S;

      // S = Q K^T: 16 rows x kNJ key groups of 8 (accumulator fragments);
      // the cross terms sum apart (sc) and join the hi*hi sum (s) at the
      // end: twice the independent mma chains, and the cross terms are not
      // rounded against the large partial sums step by step
      float s[kNJ][4], sc[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NDT; ++kk) {
        uint32_t ahi[4], alo[4];
        const float* qa = Qs + (wr0 + g) * S + kk * 8 + t;
        split_tf32(qa[0], ahi[0], alo[0]);            // Q[g][t]
        split_tf32(qa[8 * S], ahi[1], alo[1]);        // Q[g + 8][t]
        split_tf32(qa[4], ahi[2], alo[2]);            // Q[g][t + 4]
        split_tf32(qa[8 * S + 4], ahi[3], alo[3]);    // Q[g + 8][t + 4]
        uint32_t bhi[kNJ][2], blo[kNJ][2];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float* ka = Kt + (j * 8 + g) * S + kk * 8 + t;
          split_tf32(ka[0], bhi[j][0], blo[j][0]);    // K[key g][t]
          split_tf32(ka[4], bhi[j][1], blo[j][1]);    // K[key g][t + 4]
        }
        // one pass per term over the key groups, so that no mma waits on
        // the one issued just before it
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mma_tf32_m16n8k8(sc[j], alo, bhi[j]);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mma_tf32_m16n8k8(s[j], ahi, bhi[j]);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mma_tf32_m16n8k8(sc[j], ahi, blo[j]);
      }

      // scale, softcap, mask; s[j][e] is row qp[e / 2], key
      // kg + 8 j + 2 t + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (s[j][e] + sc[j][e]) * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const int key = kg + j * 8 + 2 * t + (e & 1);
          const int p = qp[e >> 1];
          const bool ok = key < kv_hi && (!causal || p >= key) &&
                          (window <= 0 || p - key < window);
          s[j][e] = ok ? x : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        m_new[i] = fmaxf(m[i], mx[i]);
        alpha[i] = m_new[i] == -INFINITY ? 1.f : __expf(m[i] - m_new[i]);
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p =
              m_new[i] == -INFINITY ? 0.f : __expf(s[j][e] - m_new[i]);
          s[j][e] = p;
          sum[i] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
        sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
        m[i] = m_new[i];
      }
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }

      // O += P V, key step j: A-fragment column t is key 2t, column t + 4
      // key 2t + 1 (the accumulator's own pair), and V's B fragment rows
      // follow the same order
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        uint32_t ahi[4], alo[4];
        split_tf32(s[j][0], ahi[0], alo[0]);          // P[g][2t]
        split_tf32(s[j][2], ahi[1], alo[1]);          // P[g + 8][2t]
        split_tf32(s[j][1], ahi[2], alo[2]);          // P[g][2t + 1]
        split_tf32(s[j][3], ahi[3], alo[3]);          // P[g + 8][2t + 1]
        const float* va = Vt + (j * 8 + 2 * t) * S + g;
#pragma unroll
        for (int d0 = 0; d0 < NDT; d0 += kDG) {
          uint32_t bhi[kDG][2], blo[kDG][2];
#pragma unroll
          for (int u = 0; u < kDG; ++u) {
            const float* vu = va + (d0 + u) * 8;
            split_tf32(vu[0], bhi[u][0], blo[u][0]);  // V[key 2t][col g]
            split_tf32(vu[S], bhi[u][1], blo[u][1]);  // V[key 2t + 1][g]
          }
          // lo*hi, hi*lo, then hi*hi, each over kDG independent d-tiles
#pragma unroll
          for (int u = 0; u < kDG; ++u)
            mma_tf32_m16n8k8(o[d0 + u], alo, bhi[u]);
#pragma unroll
          for (int u = 0; u < kDG; ++u)
            mma_tf32_m16n8k8(o[d0 + u], ahi, blo[u]);
#pragma unroll
          for (int u = 0; u < kDG; ++u)
            mma_tf32_m16n8k8(o[d0 + u], ahi, bhi[u]);
        }
      }
    }
    __syncthreads();               // this buffer refills two tiles on
  }
  cp_async_wait<0>();              // no copy outlives the block

  // merge the key groups: group 1 leaves (m, l, O) in shared memory (the
  // K ring, free now), group 0 joins them to its own and writes the rows
  constexpr int kXS = NDT * 4 + 4;                 // floats per lane
  float* xs = Ks + (size_t)warp * kXS * 32 + lane;   // [warp][kXS][lane]
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(dt * 4 + e) * 32] = o[dt][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs[(NDT * 4 + i) * 32] = m[i];
      xs[(NDT * 4 + 2 + i) * 32] = l[i];
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xs[(NDT * 4 + i) * 32];
    const float mm = fmaxf(m[i], m1);
    const float a0 = m[i] == -INFINITY ? 0.f : __expf(m[i] - mm);
    const float a1 = m1 == -INFINITY ? 0.f : __expf(m1 - mm);
    l[i] = l[i] * a0 + xs[(NDT * 4 + 2 + i) * 32] * a1;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[dt][2 * i + e] =
            o[dt][2 * i + e] * a0 + xs[(dt * 4 + 2 * i + e) * 32] * a1;
    m[i] = mm;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= qrows) continue;
    float* orow = out + (((size_t)b * Sq + q0 + row) * Hq + h) * D;
    if (m[i] == -INFINITY) {
      // no valid key: the plain version's softmax over Skv equal -1e30
      // logits is uniform, so the row is the mean of V
      for (int c = 2 * t; c < D; c += 8)
        for (int e = 0; e < 2 && c + e < D; ++e) {
          float acc = 0.f;
          for (int j = 0; j < Skv; ++j) acc += vb[j * kv_stride + c + e];
          orow[c + e] = acc / (float)Skv;
        }
    } else {
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = dt * 8 + 2 * t + e;
          if (c < D) orow[c] = o[dt][2 * i + e] / l[i];
        }
    }
  }
}

template <int NDT>
int launch(const float* q, const float* k, const float* v, const int32_t* qo,
           float* out, int B, int Sq, int Skv, int Hq, int Hkv, int D,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(8 * NDT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<NDT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, (Sq + kBQ - 1) / kBQ, B);
  flash_attention_mma_kernel<NDT><<<grid, kThreads, smem, stream>>>(
      q, k, v, qo, out, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// tensor-core kernel on bf16 operands, d = d_v <= 128
// ---------------------------------------------------------------------------
namespace tc16 {

using bf16 = __nv_bfloat16;

constexpr int kRowWarps = tc::kRowWarps;
constexpr int kGroups = tc::kGroups;
constexpr int kBQ = tc::kBQ;
constexpr int kBK = tc::kBK;
constexpr int kBKG = tc::kBKG;
constexpr int kNJ = tc::kNJ;
constexpr int kThreads = tc::kThreads;

// shared row stride in bf16 for a padded head dim DP (a multiple of 16):
// DP + 8 values are 4 mod 8 32-bit words, so the 8 rows g x 4 words t of a
// Q or K fragment hit 32 distinct banks; rows stay 16-byte aligned
__host__ __device__ constexpr int row_stride(int DP) { return DP + 8; }

size_t smem_bytes(int DP) {
  return sizeof(bf16) * (size_t)row_stride(DP) * (kBQ + 4 * kBK);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair(bf16 lo, bf16 hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// two fp32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): P V as
// hi V + lo V keeps about 16 bits of each probability, where one bf16
// would keep 8 (the Pallas kernel's p is fp32)
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = from_f32<bf16>(x0);
  const bf16 h1 = from_f32<bf16>(x1);
  hi = pair(h0, h1);
  lo = pack_bf16x2(x0 - to_f32(h0), x1 - to_f32(h1));
}

// Copy rows [0, nrows) of a slab (row r at src + r * stride, D values) into
// shared rows of row_stride(DP) values; rows >= valid and columns >= D are
// zeros.  16-byte cp.async where D % 8 == 0 and the operands are aligned,
// else plain loads and stores.  Every thread of the block calls it.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int valid,
                                           int nrows, int D, bool vec) {
  constexpr int S = row_stride(DP);
  if (vec) {
    constexpr int C8 = DP / 8;
    for (int e = threadIdx.x; e < nrows * C8; e += kThreads) {
      const int r = e / C8;
      const int c = 8 * (e - r * C8);
      const bool ok = r < valid && c < D;
      cp_async_16(dst + r * S + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      dst[r * S + c] = (r < valid && c < D) ? src[r * stride + c]
                                             : from_f32<bf16>(0.f);
    }
  }
}

// NKT = the padded head dim's 16-column steps: D <= 16 * NKT <= 128.  The
// block, warp and tile layout is the float32 kernel's; q.k is one bf16
// mma per 16 x 8 x 16 step (exact products, fp32 sums), P V two (hi, lo).
template <int NKT>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int32_t* __restrict__ q_offset,
                            bf16* __restrict__ out, int Sq, int Skv, int Hq,
                            int Hkv, int D, int causal, int window,
                            float softcap, float scale) {
  constexpr int DP = 16 * NKT;
  constexpr int NDT = DP / 8;              // 8-column output tiles
  constexpr int S = row_stride(DP);
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);     // [kBQ][S]
  bf16* Ks = Qs + kBQ * S;                       // [2][kBK][S]
  bf16* Vs = Ks + 2 * kBK * S;                   // [2][kBK][S]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32 % kRowWarps;
  const int grp = threadIdx.x / 32 / kRowWarps;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int off = q_offset[b];
  const int qrows = min(kBQ, Sq - q0);

  const int pos_lo = off + q0;
  const int pos_hi = off + q0 + qrows - 1;
  int kv_lo = 0;
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, pos_hi + 1);
  if (window > 0) kv_lo = max(0, pos_lo - window + 1);

  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  stage_rows<DP>(Qs, q + (((size_t)b * Sq + q0) * Hq + h) * D,
                 (size_t)Hq * D, qrows, kBQ, D, vec);
  if (kv_lo < kv_hi) {
    const int n = min(kBK, kv_hi - kv_lo);
    stage_rows<DP>(Ks, kb + kv_lo * kv_stride, kv_stride, n, kBK, D, vec);
    stage_rows<DP>(Vs, vb + kv_lo * kv_stride, kv_stride, n, kBK, D, vec);
  }
  cp_async_commit();

  const int wr0 = warp * 16;
  const int wpos_lo = off + q0 + wr0;
  const int wpos_hi = wpos_lo + 15;
  const int qp[2] = {wpos_lo + g, wpos_lo + g + 8};

  float o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  int buf = 0;
  for (int kt = kv_lo; kt < kv_hi; kt += kBK, buf ^= 1) {
    const int nxt = kt + kBK;
    if (nxt < kv_hi) {
      const int n = min(kBK, kv_hi - nxt);
      bf16* kd = Ks + (buf ^ 1) * kBK * S;
      bf16* vd = Vs + (buf ^ 1) * kBK * S;
      stage_rows<DP>(kd, kb + nxt * kv_stride, kv_stride, n, kBK, D, vec);
      stage_rows<DP>(vd, vb + nxt * kv_stride, kv_stride, n, kBK, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int kg = kt + grp * kBKG;
    const bool closed = kg >= kv_hi || (causal && wpos_hi < kg) ||
                        (window > 0 && wpos_lo - (kg + kBKG - 1) >= window);
    if (!closed) {
      const bf16* Kt = Ks + (buf * kBK + grp * kBKG) * S;
      const bf16* Vt = Vs + (buf * kBK + grp * kBKG) * S;

      // S = Q K^T: 16 rows x kNJ key groups of 8
      float s[kNJ][4];
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) {
        uint32_t a[4];
        const bf16* qa = Qs + (wr0 + g) * S + kk * 16 + 2 * t;
        a[0] = ld_pair(qa);                  // Q[g][2t, 2t+1]
        a[1] = ld_pair(qa + 8 * S);          // Q[g+8][2t, 2t+1]
        a[2] = ld_pair(qa + 8);              // Q[g][2t+8, 2t+9]
        a[3] = ld_pair(qa + 8 * S + 8);      // Q[g+8][2t+8, 2t+9]
        uint32_t bk[kNJ][2];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const bf16* ka = Kt + (j * 8 + g) * S + kk * 16 + 2 * t;
          bk[j][0] = ld_pair(ka);            // K[key g][2t, 2t+1]
          bk[j][1] = ld_pair(ka + 8);        // K[key g][2t+8, 2t+9]
        }
#pragma unroll
        for (int j = 0; j < kNJ; ++j) mma_bf16_m16n8k16(s[j], a, bk[j]);
      }

      // scale, softcap, mask; s[j][e] is row qp[e / 2], key
      // kg + 8 j + 2 t + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const int key = kg + j * 8 + 2 * t + (e & 1);
          const int p = qp[e >> 1];
          const bool ok = key < kv_hi && (!causal || p >= key) &&
                          (window <= 0 || p - key < window);
          s[j][e] = ok ? x : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        m_new[i] = fmaxf(m[i], mx[i]);
        alpha[i] = m_new[i] == -INFINITY ? 1.f : __expf(m[i] - m_new[i]);
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p =
              m_new[i] == -INFINITY ? 0.f : __expf(s[j][e] - m_new[i]);
          s[j][e] = p;
          sum[i] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
        sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
        m[i] = m_new[i];
      }
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }

      // O += P V over 16-key steps: the accumulator pairs of key groups
      // 2 m2 and 2 m2 + 1 are the A fragment as they stand; V's B
      // fragment pairs two rows of one column (two 16-bit loads)
#pragma unroll
      for (int m2 = 0; m2 < kNJ / 2; ++m2) {
        const int j0 = 2 * m2;
        const int j1 = j0 + 1;
        uint32_t ahi[4], alo[4];
        split_bf16x2(s[j0][0], s[j0][1], ahi[0], alo[0]);  // P[g][2t, 2t+1]
        split_bf16x2(s[j0][2], s[j0][3], ahi[1], alo[1]);  // P[g+8][2t, ..]
        split_bf16x2(s[j1][0], s[j1][1], ahi[2], alo[2]);  // P[g][2t+8, ..]
        split_bf16x2(s[j1][2], s[j1][3], ahi[3], alo[3]);  // P[g+8][2t+8..]
        const bf16* va = Vt + (16 * m2 + 2 * t) * S + g;
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
          const bf16* vd = va + dt * 8;
          const uint32_t bv[2] = {pair(vd[0], vd[S]),        // V[2t, 2t+1][g]
                                  pair(vd[8 * S], vd[9 * S])};  // [2t+8, ..]
          mma_bf16_m16n8k16(o[dt], alo, bv);
          mma_bf16_m16n8k16(o[dt], ahi, bv);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // merge the key groups through shared memory (the K ring, free now:
  // exactly the kRowWarps x (4 NDT + 4) x 32 floats it needs)
  constexpr int kXS = NDT * 4 + 4;
  float* xs = reinterpret_cast<float*>(Ks) + (size_t)warp * kXS * 32 + lane;
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(dt * 4 + e) * 32] = o[dt][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs[(NDT * 4 + i) * 32] = m[i];
      xs[(NDT * 4 + 2 + i) * 32] = l[i];
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xs[(NDT * 4 + i) * 32];
    const float mm = fmaxf(m[i], m1);
    const float a0 = m[i] == -INFINITY ? 0.f : __expf(m[i] - mm);
    const float a1 = m1 == -INFINITY ? 0.f : __expf(m1 - mm);
    l[i] = l[i] * a0 + xs[(NDT * 4 + 2 + i) * 32] * a1;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[dt][2 * i + e] =
            o[dt][2 * i + e] * a0 + xs[(dt * 4 + 2 * i + e) * 32] * a1;
    m[i] = mm;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= qrows) continue;
    bf16* orow = out + (((size_t)b * Sq + q0 + row) * Hq + h) * D;
    if (m[i] == -INFINITY) {
      // no valid key: the mean of V, as the plain version's uniform softmax
      for (int c = 2 * t; c < D; c += 8)
        for (int e = 0; e < 2 && c + e < D; ++e) {
          float acc = 0.f;
          for (int j = 0; j < Skv; ++j)
            acc += to_f32(vb[j * kv_stride + c + e]);
          orow[c + e] = from_f32<bf16>(acc / (float)Skv);
        }
    } else {
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = dt * 8 + 2 * t + e;
          if (c < D) orow[c] = from_f32<bf16>(o[dt][2 * i + e] / l[i]);
        }
    }
  }
}

template <int NKT>
int launch(const bf16* q, const bf16* k, const bf16* v, const int32_t* qo,
           bf16* out, int B, int Sq, int Skv, int Hq, int Hkv, int D,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(16 * NKT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<NKT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, (Sq + kBQ - 1) / kBQ, B);
  flash_attention_bf16_kernel<NKT><<<grid, kThreads, smem, stream>>>(
      q, k, v, qo, out, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc16

// ---------------------------------------------------------------------------
// CUDA-core kernel: 128 < d <= 256, or a value head dim d_v < d
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // query rows per block
constexpr int kBK = 32;                   // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) +
                          (size_t)kBK * Dv + (size_t)kWarps * kRows * kBK);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// T = the operands' element type (float or bf16, converted to float as
// it is staged); NC = output columns per lane: d_v <= 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const T* __restrict__ q,
                            const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ q_offset,
                            T* __restrict__ out, int Sq, int Skv, int Hq,
                            int Hkv, int D, int Dv, int causal, int window,
                            float softcap, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kBQ][D]
  float* Ks = Qs + kBQ * D;                // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);          // [kBK][Dv]
  float* Ps = Vs + kBK * Dv;               // [kWarps][kRows][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int off = q_offset[b];
  const int qrows = min(kBQ, Sq - q0);
  const int r0 = warp * kRows;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int t = e - r * D;
    Qs[e] = r < qrows
                ? to_f32(q[(((size_t)b * Sq + q0 + r) * Hq + h) * D + t])
                : 0.f;
  }

  // the keys some row of this tile may attend: [kv_lo, kv_hi)
  const int pos_lo = off + q0;
  const int pos_hi = off + q0 + qrows - 1;
  int kv_lo = 0;
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, pos_hi + 1);
  if (window > 0) kv_lo = max(0, pos_lo - window + 1);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }
  float* pw = Ps + warp * kRows * kBK;

  for (int kt = kv_lo; kt < kv_hi; kt += kBK) {
    __syncthreads();                 // Q staged; last tile's readers done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D;
      const int t = e - j * D;
      const int key = kt + j;
      Ks[j * (D + 1) + t] =
          key < kv_hi
              ? to_f32(k[(((size_t)b * Skv + key) * Hkv + hk) * D + t])
              : 0.f;
    }
    for (int e = tid; e < kBK * Dv; e += kThreads) {
      const int j = e / Dv;
      const int t = e - j * Dv;
      const int key = kt + j;
      Vs[j * Dv + t] =
          key < kv_hi
              ? to_f32(v[(((size_t)b * Skv + key) * Hkv + hk) * Dv + t])
              : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    for (int t = 0; t < D; ++t) {
      const float kx = kr[t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(Qs[(r0 + r) * D + t], kx, s[r]);
    }

    const int key = kt + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int qp = off + q0 + r0 + r;
      const bool ok = key < kv_hi && (!causal || qp >= key) &&
                      (window <= 0 || qp - key < window);
      const float m_new = fmaxf(m[r], warp_max(ok ? x : -INFINITY));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {      // warp-uniform: m is replicated
        alpha = expf(m[r] - m_new);
        p = ok ? expf(x - m_new) : 0.f;
      }
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();
    for (int j = 0; j < kBK; ++j) {
      float vx[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        vx[i] = c < Dv ? Vs[j * Dv + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBK + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(p, vx[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + r;
    if (row >= qrows) continue;
    T* o = out + (((size_t)b * Sq + q0 + row) * Hq + h) * Dv;
    if (m[r] == -INFINITY) {
      // no valid key: the plain version's softmax over Skv equal -1e30
      // logits is uniform, so the row is the mean of V
      float sum[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) sum[i] = 0.f;
      for (int j = 0; j < Skv; ++j) {
        const T* vr = v + (((size_t)b * Skv + j) * Hkv + hk) * Dv;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = lane + 32 * i;
          if (c < Dv) sum[i] += to_f32(vr[c]);
        }
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c < Dv) o[c] = from_f32<T>(sum[i] / (float)Skv);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c < Dv) o[c] = from_f32<T>(acc[r][i] / l[r]);
      }
    }
  }
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v,
              const int32_t* qo, T* out, int B, int Sq, int Skv, int Hq,
              int Hkv, int D, int Dv, int causal, int window, float softcap,
              float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_simt_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_simt_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, qo, out, Sq, Skv, Hq, Hkv, D, Dv, causal, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

// output columns per lane: the fewest that cover d_v
template <typename T>
int launch(const T* q, const T* k, const T* v, const int32_t* qo, T* out,
           int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  if (Dv <= 64)
    return launch_nc<T, 2>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D, Dv,
                           causal, window, softcap, scale, stream);
  if (Dv <= 128)
    return launch_nc<T, 4>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D, Dv,
                           causal, window, softcap, scale, stream);
  return launch_nc<T, 8>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D, Dv,
                         causal, window, softcap, scale, stream);
}

}  // namespace simt

}  // namespace

// 1 where vpaas_flash_attention runs these head dims on the tensor cores
// (Dv == D <= 128), 0 where it runs them on the CUDA cores
extern "C" int vpaas_flash_attention_on_tensor_cores(int D, int Dv) {
  return Dv == D && D <= 128;
}

// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv) f32, q_offset
// (B,) int32 -> out (B, Sq, Hq, Dv), Dv <= D <= 256.  window <= 0: none;
// softcap <= 0: none.  vpaas_flash_attention_bf16 (below) takes the same
// arguments with q, k, v and out in bf16.
extern "C" int vpaas_flash_attention(const void* q, const void* k,
                                     const void* v, const void* q_offset,
                                     void* out, int B, int Sq, int Skv, int Hq,
                                     int Hkv, int D, int Dv, int causal,
                                     int window, float softcap, float scale,
                                     void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 ||
      Dv <= 0 || Dv > D)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int32_t* qo = static_cast<const int32_t*>(q_offset);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vpaas_flash_attention_on_tensor_cores(D, Dv))
    return simt::launch(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D, Dv,
                        causal, window, softcap, scale, st);
  if (D <= 32)
    return tc::launch<4>(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D, causal,
                          window, softcap, scale, st);
  if (D <= 64)
    return tc::launch<8>(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D, causal,
                          window, softcap, scale, st);
  if (D <= 96)
    return tc::launch<12>(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, softcap, scale, st);
  if (D <= 112)
    return tc::launch<14>(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, softcap, scale, st);
  return tc::launch<16>(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D, causal,
                        window, softcap, scale, st);
}

extern "C" int vpaas_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, const void* q_offset,
                                          void* out, int B, int Sq, int Skv,
                                          int Hq, int Hkv, int D, int Dv,
                                          int causal, int window,
                                          float softcap, float scale,
                                          void* stream) {
  using tc16::bf16;
  if (B == 0 || Sq == 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 ||
      Dv <= 0 || Dv > D)
    return (int)cudaErrorInvalidValue;
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
  const int32_t* qo = static_cast<const int32_t*>(q_offset);
  bf16* oh = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vpaas_flash_attention_on_tensor_cores(D, Dv))
    return simt::launch(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D, Dv,
                        causal, window, softcap, scale, st);
  if (D <= 32)
    return tc16::launch<2>(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, softcap, scale, st);
  if (D <= 64)
    return tc16::launch<4>(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, softcap, scale, st);
  if (D <= 96)
    return tc16::launch<6>(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, softcap, scale, st);
  if (D <= 112)
    return tc16::launch<7>(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D,
                           causal, window, softcap, scale, st);
  return tc16::launch<8>(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D, causal,
                         window, softcap, scale, st);
}
