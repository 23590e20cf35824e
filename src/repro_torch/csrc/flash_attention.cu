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
// Design (float32, d <= 192, d_v <= 128): both products run on the tensor
// cores with mma.sync m16n8k8 tf32 in 3xTF32 split precision, the
// arithmetic of PyTorch's own fp32 attention on sm80+: each fp32 operand x
// is split into hi = tf32(x) and lo = tf32(x - hi), and each 16x8x8 step
// sums lo*hi and hi*lo, then hi*hi, in fp32, which keeps the products
// about as accurate as fp32 FMAs (the dropped lo*lo is ~2^-22 of |a b|);
// plain TF32's ~1e-3 would miss the 1e-5 tolerance.  For S the cross terms
// go to their own accumulator and join the hi*hi sum once per tile.  A
// block takes 64 query rows of one (batch row, q-head) with 8 warps: 4 row
// warps of 16 rows, times 2 key groups that take the two 32-key halves of
// each 64-key tile and keep their own online softmax, merged through shared
// memory at the end: with one key group a block has one warp per
// scheduler, too few to hide the latency of the dependent mma.sync and
// split instructions.  K and V come through cp.async (16-byte copies where
// d % 4 == 0 and the operands are aligned, else 4-byte) into a
// double-buffered ring in shared memory, so tile j+1 loads while tile j is
// computed.  The QK head dim is padded with zeros to DP = 8 * NDT and the
// value head dim to DV = 8 * NVT, each stored at its own row stride (DP + 4
// and DV + 4 floats: 4 mod 8, so every fragment load of Q, K and V is free
// of bank conflicts and every row 16-byte aligned).  MLA's d = 192, d_v =
// 128 takes Q 50,176 B + the K ring 100,352 B + the V ring 67,584 B =
// 218,112 B of the 227 KB a block may have (with V at d's row stride the
// tiles would take 250,880 B).  S = QK^T
// lands in accumulator fragments; the online softmax runs on them (row max
// and sum across the 4-lane quad that holds a row; exponentials by
// ex2.approx), and P goes back into the PV product as the A operand
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
// bf16 operands, d = d_v <= 128 (vpaas_flash_attention_bf16: the
// reference's launch path computes in bf16, and its Pallas kernel loads
// bf16 and sums in f32): flash_attention_wgmma_kernel, Hopper's shape of a
// flash attention.  A block is NWG consumer warpgroups of 64 query rows of
// one (batch row, q-head).  Loads are TMA's (cp.async.bulk.tensor with a
// 4-d tensor map per operand, (d, heads, seq, batch), so GQA's kv-head,
// the batch row and the ragged ends of seq and d are the map's coordinates
// and bounds, read as zeros outside): Q once, then K and V tiles of 96 keys
// into a ring of 4 stages (2 at NWG = 1) with full and empty mbarriers;
// every operand row is 128-byte swizzled in 64-column boxes (d = 112: two
// boxes, the second zero past column 112).  Thread 0 issues them, each
// refill once every warp has released the stage: a ninth warp as producer
// puts three warps on one scheduler, whose register file then holds 168
// registers a thread (and a producer warpgroup of 384 threads was held to
// 168 as well, setmaxnreg notwithstanding), where a consumer needs ~210.
// A consumer warpgroup computes S = Q K^T (64 x 96) with wgmma m64n96k16
// from shared memory (both operands K-major; the product of two bf16
// values is exact in f32, so this is the Pallas kernel's f32 dot of the
// upcast operands), then the online softmax in f32 in the accumulator
// registers (row max and sum across the 4 lanes of a row, ex2.approx with
// explicit fmaf: -fmad=false contracts nothing), then O += P V with wgmma
// from registers (P) and shared memory (V, head dim contiguous: the
// transposed-B bit), p as two bf16 halves (hi = bf16(p), lo cut from
// p - hi: p keeps ~16 bits, as the Pallas kernel keeps it f32, where one
// bf16 would round it as jnp's ref does), so PV is two wgmmas a 16-key
// step (N = d, across both 64-column boxes).  The products are software-
// pipelined: tile i's S is issued together with tile i - 1's P V, and
// tile i's softmax and P fragments (two register buffers, swapped tile
// by tile) are made while that P V is on the tensor cores.  The softmax
// is what bounds it: the common tile's loop carries no branch (a
// per-element softcap or mask test, predicated, issued its tanhf for
// every element), and O's rescale is skipped where no row of a warp
// raised its running max.  Tiles the mask closes for a warpgroup's 64
// rows are skipped; only tiles the mask or the end of the keys cut are
// masked.  The grid (query tile, q-head, batch row) runs a head's query
// tiles together, heaviest causal tiles first, so the blocks in flight
// share that head's K and V in L2.  NWG = 2 (128 rows) unless the 128-row
// grid would not put a block on every SM, then NWG = 1 (zamba2's 384-token
// prefill: 96 blocks of 128 rows on 132 SMs, 192 of 64).  Shared memory
// at d > 64: Q 32 KB + 4 stages x (K + V) 48 KB, 224 KB, one block an SM
// at 128 rows; Q 16 KB + 2 stages, 112 KB, two blocks an SM at 64.  The
// output is rounded to bf16 once.  At 6 x 32k (32 heads, d 112, causal)
// its products, with P V twice, are 6.9e13 flop: ~70 ms at the bf16
// tensor-core rate; its bound (the products once) is 54.4 ms.
//
// d > 192 or d_v > 128 (gemma2's 256) in float32, and every d > 128 or
// d_v != d in bf16 (MLA's 192 / 128: its Q tile and 128-key K/V ring,
// 48 + 2 x (48 + 32) KB, would fit, but the kernel's 64-column boxes and
// PV's N do not reach 192; queued), take the CUDA-core kernel below,
// chosen by the shapes: one block per (32-row query tile, q-head, batch
// row), four warps of eight rows, K/V tiles of 32 keys staged in shared
// memory, one key per lane for QK^T over d, NC = ceil(d_v/32) output
// columns per lane for PV (NC = 2, 4 or 8).  It is a template over the
// element type: bf16 widens to f32 as it is staged.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "host.cuh"
#include "primitives.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// tensor-core kernel, d = d_v <= 128
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 8;                 // row warps x key groups
constexpr int kBK = 64;                   // keys per tile
constexpr int kThreads = 32 * kWarps;

// shared row stride for a padded head dim DP (a multiple of 8): DP + 4 is
// 4 mod 8, so the 8 rows g x 4 columns t of a Q/K fragment and the 4 row
// pairs 2t, 2t+1 x 8 columns g of a V fragment hit 32 distinct banks
__host__ __device__ constexpr int row_stride(int DP) { return DP + 4; }

// Q (BQ rows) and the K ring at the padded QK head dim DP, the V ring at
// DV
size_t smem_bytes(int DP, int DV, int BQ) {
  return sizeof(float) * ((size_t)row_stride(DP) * (BQ + 2 * kBK) +
                          (size_t)row_stride(DV) * 2 * kBK);
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

// NDT = the padded QK head dim's 8-column tiles (D <= 8 * NDT <= 192),
// NVT = the padded value head dim's (Dv <= 8 * NVT <= 128); RW row warps
// of 16 query rows (a block's rows: 16 RW), each with 8 / RW key groups
// that split every 64-key tile
template <int NDT, int NVT, int RW>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int32_t* __restrict__ q_offset,
                           float* __restrict__ out, int Sq, int Skv, int Hq,
                           int Hkv, int D, int Dv, int causal, int window,
                           float softcap, float scale) {
  constexpr int DP = 8 * NDT;
  constexpr int DV = 8 * NVT;
  constexpr int S = row_stride(DP);
  constexpr int SV = row_stride(DV);
  constexpr int kGroups = kWarps / RW;   // key groups
  constexpr int kBQ = 16 * RW;           // query rows per block
  constexpr int kBKG = kBK / kGroups;    // keys per tile of one group
  constexpr int kNJ = kBKG / 8;          // a warp's 8-key steps per tile
  constexpr int kDG = 2;                 // d-tiles per group of PV mmas
  static_assert(NVT % kDG == 0, "PV groups split the d-tiles evenly");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][S]
  float* Ks = Qs + kBQ * S;                      // [2][kBK][S]
  float* Vs = Ks + 2 * kBK * S;                  // [2][kBK][SV]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32 % RW;          // the rows it takes
  const int grp = threadIdx.x / 32 / RW;           // the keys it takes
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

  const bool vec = D % 4 == 0 && Dv % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t v_stride = (size_t)Hkv * Dv;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;     // key 0
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * Dv;

  stage_rows<DP>(Qs, q + (((size_t)b * Sq + q0) * Hq + h) * D,
                 (size_t)Hq * D, qrows, kBQ, D, vec);
  if (kv_lo < kv_hi) {
    const int n = min(kBK, kv_hi - kv_lo);
    stage_rows<DP>(Ks, kb + kv_lo * kv_stride, kv_stride, n, kBK, D, vec);
    stage_rows<DV>(Vs, vb + kv_lo * v_stride, v_stride, n, kBK, Dv, vec);
  }
  cp_async_commit();

  const int wr0 = warp * 16;                       // the warp's first row
  const int wpos_lo = off + q0 + wr0;              // its query positions
  const int wpos_hi = wpos_lo + 15;
  const int qp[2] = {wpos_lo + g, wpos_lo + g + 8};  // this lane's rows

  float o[NVT][4];
#pragma unroll
  for (int dt = 0; dt < NVT; ++dt)
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
      float* vd = Vs + (buf ^ 1) * kBK * SV;
      stage_rows<DP>(kd, kb + nxt * kv_stride, kv_stride, n, kBK, D, vec);
      stage_rows<DV>(vd, vb + nxt * v_stride, v_stride, n, kBK, Dv, vec);
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
      const float* Vt = Vs + (buf * kBK + grp * kBKG) * SV;

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
      for (int dt = 0; dt < NVT; ++dt) {
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
        const float* va = Vt + (j * 8 + 2 * t) * SV + g;
#pragma unroll
        for (int d0 = 0; d0 < NVT; d0 += kDG) {
          uint32_t bhi[kDG][2], blo[kDG][2];
#pragma unroll
          for (int u = 0; u < kDG; ++u) {
            const float* vu = va + (d0 + u) * 8;
            split_tf32(vu[0], bhi[u][0], blo[u][0]);  // V[key 2t][col g]
            split_tf32(vu[SV], bhi[u][1], blo[u][1]); // V[key 2t + 1][g]
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

  // merge the key groups: groups 1 .. kGroups - 1 leave (m, l, O) in
  // shared memory (the K ring, free now), group 0 joins them to its own in
  // group order and writes the rows
  constexpr int kXS = NVT * 4 + 4;                 // floats per lane
  static_assert((kGroups - 1) * RW * kXS * 32 <= 2 * kBK * S,
                "fits the K ring");
  __syncthreads();
  if (grp > 0) {
    // [group - 1][warp][kXS][lane]
    float* xs = Ks + ((size_t)(grp - 1) * RW + warp) * kXS * 32 + lane;
#pragma unroll
    for (int dt = 0; dt < NVT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(dt * 4 + e) * 32] = o[dt][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs[(NVT * 4 + i) * 32] = m[i];
      xs[(NVT * 4 + 2 + i) * 32] = l[i];
    }
  }
  __syncthreads();
  if (grp > 0) return;
  for (int src = 1; src < kGroups; ++src) {
    const float* xs = Ks + ((size_t)(src - 1) * RW + warp) * kXS * 32 + lane;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = xs[(NVT * 4 + i) * 32];
      const float mm = fmaxf(m[i], m1);
      const float a0 = m[i] == -INFINITY ? 0.f : __expf(m[i] - mm);
      const float a1 = m1 == -INFINITY ? 0.f : __expf(m1 - mm);
      l[i] = l[i] * a0 + xs[(NVT * 4 + 2 + i) * 32] * a1;
#pragma unroll
      for (int dt = 0; dt < NVT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[dt][2 * i + e] =
              o[dt][2 * i + e] * a0 + xs[(dt * 4 + 2 * i + e) * 32] * a1;
      m[i] = mm;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= qrows) continue;
    float* orow = out + (((size_t)b * Sq + q0 + row) * Hq + h) * Dv;
    if (m[i] == -INFINITY) {
      // no valid key: the plain version's softmax over Skv equal -1e30
      // logits is uniform, so the row is the mean of V
      for (int c = 2 * t; c < Dv; c += 8)
        for (int e = 0; e < 2 && c + e < Dv; ++e) {
          float acc = 0.f;
          for (int j = 0; j < Skv; ++j) acc += vb[j * v_stride + c + e];
          orow[c + e] = acc / (float)Skv;
        }
    } else {
#pragma unroll
      for (int dt = 0; dt < NVT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = dt * 8 + 2 * t + e;
          if (c < Dv) orow[c] = o[dt][2 * i + e] / l[i];
        }
    }
  }
}

template <int NDT, int NVT, int RW = 4>
int launch(const float* q, const float* k, const float* v, const int32_t* qo,
           float* out, int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  constexpr int BQ = 16 * RW;
  const size_t smem = smem_bytes(8 * NDT, 8 * NVT, BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<NDT, NVT, RW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, (Sq + BQ - 1) / BQ, B);
  flash_attention_mma_kernel<NDT, NVT, RW><<<grid, kThreads, smem, stream>>>(
      q, k, v, qo, out, Sq, Skv, Hq, Hkv, D, Dv, causal, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

// the instance for these head dims: d = d_v at the widths of the LLM
// paths (32, 64, 96, 112, 128), a value head dim of its own at 64 or 128
// (QK at 64, 96, 128 or 192: MLA's 192 / 128 and 96 / 64).  d > 128 takes
// blocks of 32 query rows, 2 row warps x 4 key groups: MLA's prefill has
// 16 heads, and 64-row blocks (6 a head at 384 queries) left a third of
// the SMs idle behind the heaviest causal tiles
int dispatch(const float* q, const float* k, const float* v,
             const int32_t* qo, float* out, int B, int Sq, int Skv, int Hq,
             int Hkv, int D, int Dv, int causal, int window, float softcap,
             float scale, cudaStream_t st) {
#define VPAAS_TC(NDT, NVT)                                                  \
  return launch<NDT, NVT>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D, Dv,     \
                          causal, window, softcap, scale, st)
  if (Dv == D) {
    if (D <= 32) VPAAS_TC(4, 4);
    if (D <= 64) VPAAS_TC(8, 8);
    if (D <= 96) VPAAS_TC(12, 12);
    if (D <= 112) VPAAS_TC(14, 14);
    VPAAS_TC(16, 16);
  }
  if (Dv <= 64) {
    if (D <= 64) VPAAS_TC(8, 8);
    if (D <= 96) VPAAS_TC(12, 8);
    if (D <= 128) VPAAS_TC(16, 8);
      return launch<24, 8, 2>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D, Dv,
                            causal, window, softcap, scale, st);
  }
  if (D <= 96) VPAAS_TC(12, 16);
  if (D <= 128) VPAAS_TC(16, 16);
  return launch<24, 16, 2>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D, Dv,
                           causal, window, softcap, scale, st);
#undef VPAAS_TC
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 operands, d = d_v <= 128: wgmma on TMA tiles (sm_90a)
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRowsWG = 64;      // query rows of one consumer warpgroup
constexpr int kBN = 96;          // keys a tile
constexpr int kRow = 128;        // bytes of a swizzled row: 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

// NWG consumer warpgroups (64 query rows each) and NKT 16-column steps of
// the head dim (padded with zeros to DP = 16 NKT: QK's k steps, PV's N).
// Shared memory, 1024-byte aligned: Q [NB][BM][64], then the ring's K and
// V stages, each [NB][kBN][64], then the barriers; NB 64-column boxes.
template <int NWG, int NKT>
struct Tile {
  static constexpr int DP = 16 * NKT;
  static constexpr int NB = (DP + 63) / 64;
  static constexpr int BM = kRowsWG * NWG;
  static constexpr int kThreads = 128 * NWG;
  // K/V tiles in flight: 4 for one block an SM (224 KB), 2 for 64-row
  // blocks, two of which share an SM (2 x 112 KB)
  static constexpr int STAGES = NWG == 2 ? 4 : 2;
  static constexpr unsigned Q_BYTES = NB * BM * kRow;
  static constexpr unsigned KV_BYTES = NB * kBN * kRow;  // K or V, a stage
  static constexpr unsigned OFF_K = Q_BYTES;
  static constexpr unsigned OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr unsigned OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr unsigned SMEM = OFF_BAR + 8 * (1 + 2 * STAGES);
};

// P V takes p as two bf16 halves (split_bf16x2, primitives.cuh), one
// packed conversion a pair: conversions run on the special-function unit
// beside ex2, and with one a value they held it longer than the products
// held the tensor cores

// S = Q K^T for one 96-key tile, issued (not waited): sc[4 J + e] is the
// warpgroup's row 16 warp + g + 8 (e / 2), key 8 J + 2 t + e % 2; one
// m64n96k16 wgmma a 16-column step (128-key tiles, 3 stages, measured no
// faster at 32k)
template <int NKT, int BM>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2],
                                         const uint8_t* Qc,
                                         const uint8_t* Kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) {
    const uint64_t da =
        wgmma_desc(Qc + (kk / 4) * BM * kRow + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        wgmma_desc(Kt + (kk / 4) * kBN * kRow + (kk % 4) * 32, 16, 1024);
    wgmma_m64n96k16_ss(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for one tile, issued (not waited): P's two bf16 halves are the
// A fragments of the 16-key steps (the accumulator pairs of S as they
// stand); V (keys x head dim, head dim contiguous) is B with the
// transposed bit, its two 64-column boxes one 64 x DP product a half
// (the descriptor's leading byte offset steps from box to box)
template <int DP>
__device__ __forceinline__ void issue_pv(float* o,
                                         const uint32_t (&phi)[kBN / 4],
                                         const uint32_t (&plo)[kBN / 4],
                                         const uint8_t* Vt) {
  fence_regs<DP / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = wgmma_desc(Vt + kk * 16 * kRow, kBN * kRow, 1024);
    wgmma_m64nNk16_rs<DP>(o, plo + 4 * kk, db);
    wgmma_m64nNk16_rs<DP>(o, phi + 4 * kk, db);
  }
  wgmma_commit();
}

template <int NWG, int NKT>
__global__ void __launch_bounds__(Tile<NWG, NKT>::kThreads, 3 - NWG)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const bf16* __restrict__ v,
                             const int32_t* __restrict__ q_offset,
                             bf16* __restrict__ out, int Sq, int Skv, int Hq,
                             int Hkv, int D, int causal, int window,
                             float softcap, float scale) {
  using T = Tile<NWG, NKT>;
  // the 128-byte swizzle repeats every 1024 bytes: TMA and wgmma address
  // the tiles from a 1024-byte aligned base
  extern __shared__ __align__(1024) uint8_t smem[];
  if (smem_u32(smem) % 1024 != 0) __trap();
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  uint64_t* full = q_full + 1;            // [STAGES]: K and V landed
  uint64_t* empty = full + T::STAGES;     // [STAGES]: every warp done

  // query tiles vary fastest, heaviest first, so that the blocks in flight
  // read one head's K and V from L2
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = q_offset[b];
  const int qrows = min(T::BM, Sq - q0);

  // the keys some row of this block may attend: [kv_lo, kv_hi)
  const int pos_lo = off + q0;
  const int pos_hi = off + q0 + qrows - 1;
  int kv_lo = 0;
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, pos_hi + 1);
  if (window > 0) kv_lo = max(0, pos_lo - window + 1);
  const int ntiles = kv_lo < kv_hi ? (kv_hi - kv_lo + kBN - 1) / kBN : 0;

  // thread 0 issues every TMA load: Q and the first STAGES tiles now,
  // each later tile into the stage whose tile every warp has released
  auto load_tile = [&](int i) {
    const int s = i % T::STAGES;
    mbar_arrive_expect_tx(&full[s], 2 * T::KV_BYTES);
    const int k0 = kv_lo + i * kBN;
    uint8_t* ks = smem + T::OFF_K + s * T::KV_BYTES;
    uint8_t* vs = smem + T::OFF_V + s * T::KV_BYTES;
    for (int x = 0; x < T::NB; ++x) {
      tma_load_4d(ks + x * kBN * kRow, &tk, &full[s], 64 * x, hk, k0, b);
      tma_load_4d(vs + x * kBN * kRow, &tv, &full[s], 64 * x, hk, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_full, T::Q_BYTES);
    for (int x = 0; x < T::NB; ++x)
      tma_load_4d(smem + x * T::BM * kRow, &tq, q_full, 64 * x, h, q0, b);
    for (int i = 0; i < min(T::STAGES, ntiles); ++i) load_tile(i);
  }

  // consumer warpgroup c: query rows 64 c .. 64 c + 63 of the block
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = kRowsWG * c;
  const int wpos_lo = off + q0 + r0;                 // its positions
  const int wpos_hi = wpos_lo + kRowsWG - 1;
  const int qp[2] = {wpos_lo + 16 * warp + g, wpos_lo + 16 * warp + g + 8};
  // the logit's factor inside 2^(.): raw q.k scaled, or a capped logit
  const float mult = softcap > 0.f ? kLog2e : scale * kLog2e;
  const uint8_t* Qc = smem + r0 * kRow;
  auto k_tile = [&](int i) {
    return smem + T::OFF_K + (i % T::STAGES) * T::KV_BYTES;
  };
  auto v_tile = [&](int i) {
    return smem + T::OFF_V + (i % T::STAGES) * T::KV_BYTES;
  };
  // the tiles the mask leaves open to some of these 64 rows: [i_lo, i_hi)
  // (a window closes a prefix, causality a suffix); the others are
  // released as they land
  int i_lo = 0, i_hi = ntiles;
  while (i_lo < i_hi && window > 0 &&
         wpos_lo - (kv_lo + i_lo * kBN + kBN - 1) >= window)
    ++i_lo;
  while (i_hi > i_lo && causal && wpos_hi < kv_lo + (i_hi - 1) * kBN)
    --i_hi;

  float o[T::DP / 2];                    // O: 64 rows x DP, fp32
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  float sc[kBN / 2];                     // S, then P, of one tile
  // P's two halves as A fragments, two buffers: tile i's are made while
  // tile i - 1's feed the tensor cores
  uint32_t phi0[kBN / 4], plo0[kBN / 4], phi1[kBN / 4], plo1[kBN / 4];

  // softcap, mask (only tiles the mask or the end of the keys cut) and the
  // online softmax of tile i's S, in place: sc becomes p; alpha the factor
  // of the running O and l
  auto softmax = [&](int i) {
    const int k0 = kv_lo + i * kBN;
    const bool cut = k0 + kBN > Skv || (causal && k0 + kBN - 1 > wpos_lo) ||
                     (window > 0 && wpos_hi - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (softcap > 0.f || cut) {
      // the branches stay out of the common tile's loop: ptxas predicates
      // them, and a predicated tanhf is issued for every element
#pragma unroll
      for (int J = 0; J < kBN / 8; ++J)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * J + e];
          if (softcap > 0.f) x = softcap * tanhf(x * scale / softcap);
          if (cut) {
            const int key = k0 + 8 * J + 2 * t + (e & 1);
            const int p = qp[e >> 1];
            const bool ok = key < Skv && (!causal || p >= key) &&
                            (window <= 0 || p - key < window);
            x = ok ? x : -INFINITY;
          }
          sc[4 * J + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    } else {
#pragma unroll
      for (int J = 0; J < kBN / 8; ++J)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * J + e]);
    }
    float msc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      msc[r] = m_new == -INFINITY ? 0.f : m_new * mult;
      alpha[r] = m_new == m[r] ? 1.f : ex2_approx(fmaf(m[r], mult, -msc[r]));
      m[r] = m_new;
    }
#pragma unroll
    for (int J = 0; J < kBN / 8; ++J)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2_approx(fmaf(sc[4 * J + e], mult, -msc[e >> 1]));
        sc[4 * J + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l[r] = fmaf(l[r], alpha[r], sum[r]);
    }
  };
  // p (in sc) as the PV product's A fragments, two bf16 halves
  auto to_fragments = [&](uint32_t (&phi)[kBN / 4],
                          uint32_t (&plo)[kBN / 4]) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const float* p = sc + 8 * kk;
      split_bf16x2(p[0], p[1], phi[4 * kk], plo[4 * kk]);          // row g
      split_bf16x2(p[2], p[3], phi[4 * kk + 1], plo[4 * kk + 1]);  // g + 8
      split_bf16x2(p[4], p[5], phi[4 * kk + 2], plo[4 * kk + 2]);  // + 8 keys
      split_bf16x2(p[6], p[7], phi[4 * kk + 3], plo[4 * kk + 3]);
    }
  };
  // O *= alpha, skipped where no row of the warp raised its running max
  // (alpha is then exactly 1: most tiles of a long row)
  auto rescale = [&]() {
    if (!__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
    for (int J = 0; J < T::DP / 8; ++J) {
      o[4 * J] *= alpha[0];
      o[4 * J + 1] *= alpha[0];
      o[4 * J + 2] *= alpha[1];
      o[4 * J + 3] *= alpha[1];
    }
  };
  auto land = [&](int i) {
    mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
  };
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(&empty[i % T::STAGES]);
    if (threadIdx.x == 0 && i + T::STAGES < ntiles) {
      mbar_wait(&empty[i % T::STAGES], (i / T::STAGES) & 1);
      load_tile(i + T::STAGES);
    }
  };

  mbar_wait(q_full, 0);
  for (int i = 0; i < i_lo; ++i) {
    land(i);
    release(i);
  }
  // software pipeline: tile i's S is issued with tile i - 1's P V, and
  // its softmax and P's fragments are made while that product is on the
  // tensor cores
  auto step = [&](int i, uint32_t (&phi)[kBN / 4], uint32_t (&plo)[kBN / 4],
                  uint32_t (&prev_hi)[kBN / 4],
                  uint32_t (&prev_lo)[kBN / 4]) {
    land(i);
    issue_qk<NKT, T::BM>(sc, Qc, k_tile(i));
    rescale();                        // O to tile i - 1's running max
    issue_pv<T::DP>(o, prev_hi, prev_lo, v_tile(i - 1));
    wgmma_wait<1>();                  // S of tile i
    fence_regs<kBN / 2>(sc);
    softmax(i);
    to_fragments(phi, plo);
    wgmma_wait<0>();                  // P V of tile i - 1
    fence_regs<T::DP / 2>(o);
    release(i - 1);
  };
  auto last_pv = [&](uint32_t (&phi)[kBN / 4], uint32_t (&plo)[kBN / 4]) {
    rescale();
    issue_pv<T::DP>(o, phi, plo, v_tile(i_hi - 1));
    wgmma_wait<0>();
    fence_regs<T::DP / 2>(o);
    release(i_hi - 1);
  };
  if (i_lo < i_hi) {
    land(i_lo);
    issue_qk<NKT, T::BM>(sc, Qc, k_tile(i_lo));
    wgmma_wait<0>();
    fence_regs<kBN / 2>(sc);
    softmax(i_lo);
    to_fragments(phi0, plo0);
    int i = i_lo + 1;
    for (; i + 1 < i_hi; i += 2) {    // two tiles a turn: the buffers swap
      step(i, phi1, plo1, phi0, plo0);
      step(i + 1, phi0, plo0, phi1, plo1);
    }
    if (i < i_hi) {
      step(i, phi1, plo1, phi0, plo0);
      last_pv(phi1, plo1);
    } else {
      last_pv(phi0, plo0);
    }
  }
  for (int i = i_hi; i < ntiles; ++i) {
    land(i);
    release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + g + 8 * r;
    if (row >= qrows) continue;
    bf16* orow = out + (((size_t)b * Sq + q0 + row) * Hq + h) * D;
    if (m[r] == -INFINITY) {
      // no valid key: the mean of V, as the plain version's uniform
      // softmax over Skv equal -1e30 logits
      const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
      for (int col = 2 * t; col < D; col += 8)
        for (int e = 0; e < 2 && col + e < D; ++e) {
          float acc = 0.f;
          for (int j = 0; j < Skv; ++j)
            acc += to_f32(vb[(size_t)j * Hkv * D + col + e]);
          orow[col + e] = from_f32<bf16>(acc / (float)Skv);
        }
    } else {
#pragma unroll
      for (int J = 0; J < T::DP / 8; ++J) {
        const int col = 8 * J + 2 * t;          // D is even
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16x2(
              o[4 * J + 2 * r] / l[r], o[4 * J + 2 * r + 1] / l[r]);
      }
    }
  }
}

// (tensor_map: host.cuh)

// consumer warpgroups a block: two (128 query rows) unless the grid of
// 128-row blocks would leave SMs without a block, then one (64 rows)
int warpgroups(int B, int Sq, int Hq) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0)
    sms = 132;
  return (long)Hq * B * ((Sq + 127) / 128) < sms ? 1 : 2;
}

template <int NWG, int NKT>
int launch(const bf16* q, const bf16* k, const bf16* v, const int32_t* qo,
           bf16* out, int B, int Sq, int Skv, int Hq, int Hkv, int D,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  using T = Tile<NWG, NKT>;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, D, Hq, Sq, B, T::BM);
  if (err == 0) err = tensor_map(&tk, k, D, Hkv, Skv, B, kBN);
  if (err == 0) err = tensor_map(&tv, v, D, Hkv, Skv, B, kBN);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(flash_attention_wgmma_kernel<NWG, NKT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)T::SMEM);
  if (err != 0) return err;
  dim3 grid((Sq + T::BM - 1) / T::BM, Hq, B);
  flash_attention_wgmma_kernel<NWG, NKT><<<grid, T::kThreads, T::SMEM,
                                           stream>>>(
      tq, tk, tv, v, qo, out, Sq, Skv, Hq, Hkv, D, causal, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

// the instance: NKT by the head dim (32, 64, 96, 112, 128), NWG by the grid
int dispatch(const bf16* q, const bf16* k, const bf16* v, const int32_t* qo,
             bf16* out, int B, int Sq, int Skv, int Hq, int Hkv, int D,
             int causal, int window, float softcap, float scale,
             cudaStream_t st) {
#define VPAAS_WG(NKT)                                                      \
  return warpgroups(B, Sq, Hq) == 1                                        \
             ? launch<1, NKT>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D,    \
                              causal, window, softcap, scale, st)          \
             : launch<2, NKT>(q, k, v, qo, out, B, Sq, Skv, Hq, Hkv, D,    \
                              causal, window, softcap, scale, st)
  if (D <= 32) VPAAS_WG(2);
  if (D <= 64) VPAAS_WG(4);
  if (D <= 96) VPAAS_WG(6);
  if (D <= 112) VPAAS_WG(7);
  VPAAS_WG(8);
#undef VPAAS_WG
}

}  // namespace wg

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

// 1 where the launcher runs these head dims on the tensor cores, 0 where
// on the CUDA cores: float32 (bf16 = 0) up to d = 192 and d_v = 128, bf16
// where d = d_v <= 128
extern "C" int vpaas_flash_attention_on_tensor_cores(int D, int Dv,
                                                     int bf16) {
  return bf16 ? Dv == D && D <= 128 : D <= 192 && Dv <= 128 && Dv <= D;
}

// the query rows of a block of the bf16 tensor-core kernel at this grid
extern "C" int vpaas_flash_attention_bf16_block_rows(int B, int Sq, int Hq) {
  return wg::kRowsWG * wg::warpgroups(B, Sq, Hq);
}

// q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv) f32, q_offset
// (B,) int32 -> out (B, Sq, Hq, Dv), Dv <= D <= 256.  window <= 0: none;
// softcap <= 0: none.  vpaas_flash_attention_bf16 (below) takes the same
// arguments with q, k, v and out in bf16; on its tensor-core kernel D is a
// multiple of 8 and every operand 16-byte aligned (TMA's strides), which
// the wrapper arranges.
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
  if (!vpaas_flash_attention_on_tensor_cores(D, Dv, 0))
    return simt::launch(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D, Dv,
                        causal, window, softcap, scale, st);
  return tc::dispatch(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D, Dv, causal,
                      window, softcap, scale, st);
}

extern "C" int vpaas_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, const void* q_offset,
                                          void* out, int B, int Sq, int Skv,
                                          int Hq, int Hkv, int D, int Dv,
                                          int causal, int window,
                                          float softcap, float scale,
                                          void* stream) {
  using wg::bf16;
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
  if (!vpaas_flash_attention_on_tensor_cores(D, Dv, 1))
    return simt::launch(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D, Dv,
                        causal, window, softcap, scale, st);
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  return wg::dispatch(qh, kh, vh, qo, oh, B, Sq, Skv, Hq, Hkv, D, causal,
                      window, softcap, scale, st);
}
