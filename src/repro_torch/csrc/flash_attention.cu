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
// the tensor cores' 495 TFLOP/s dense TF32.  gemma2-9b's float32 serving
// prefill (1 x 384 over 512, 16 q-heads over 8, d = 256, softcap 50) is
// 1.21 GFLOP: 18.2 us on the CUDA cores, 7.5 us in 3xTF32.
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
// float32 at 128 < d = d_v <= 256 (gemma2's 256): flash_attention_cols_kernel,
// the same 3xTF32 arithmetic with the work cut by columns.  The kernel
// above cannot take it: at 64-key tiles Q (33 KB) and K and V rings of 133
// KB each pass the 227 KB a block may have, and a warp of 16 rows holding
// O's 16 x 256 floats (128 registers a lane) beside S, Q's and K's split
// fragments would spill; the CUDA-core kernel it fell to ran the products
// as scalar FMAs with a shared load each, staged K and V with plain loads
// between two barriers a tile, and ran at 17x its bound (0.312 ms on an
// H100 80GB HBM3 at 700 W, PERF.md).  Here a block
// takes 32 query rows of one (batch row, q-head) with 8 warps: two row
// groups of 16 rows x four column warps, and column warp cw owns head-dim
// columns [64 cw, 64 cw + 64) of Q, K, V and O.  Q's split halves for its
// 16 rows x 64 columns live in registers for the whole block (64 a lane),
// O's slice is 32 a lane.  K and V come in 32-key tiles by cp.async into
// a double-buffered ring at the row stride above: Q 33,280 B + 2 x 33,280
// (K) + 2 x 33,280 (V) = 166,400 B, one block an SM, 12 x 16 = 192 blocks
// at the serving prefill, heaviest causal tiles first.  A tile takes three
// steps inside a row group (its 4 warps meet at a named barrier, bar.sync
// 1 + group, 128 threads, so the two row groups do not wait for each
// other): (1) each warp sums S over its 64 columns for all 32 keys (four
// 8-key groups, hi*hi and the cross terms in accumulators of their own,
// eight independent mma chains) and leaves the partials in shared memory
// (over Q's rows, free once Q is in registers); (2) column warp cw adds
// key group cw's four partials in warp order, scales, caps (tanhf: each
// logit is capped once in the block, 4 a lane a tile) and masks them;
// (3) every warp reads the tile's 16 x 32 logits, runs the online softmax
// on them (the same values in the same order in all four warps, so m and
// l agree bit for bit; exponentials by ex2.approx with explicit fmaf) and
// adds P V for its 64 columns with p split into hi / lo, key groups the
// mask closes for all 16 rows skipped, a tile closed to the row group
// skipped whole.  Every product runs once: S's K-dimension and P V's
// N-dimension are both split by column, so no warp repeats another's
// mma.  What bounds it is latency: with 188 registers a thread and 166 KB
// a block it holds one block (two warps a scheduler) an SM, and a tile's
// steps wait on each other: the exchange, the capped softmax and the
// tile's barrier and copies leave the tensor cores idle for much of each
// tile (a clock64 trace of one warp a block, on the card).  Rounding hi
// by an integer add instead of cvt.rna ran faster at a larger error and
// was not kept.
//
// bf16 operands, d = d_v <= 256 (vpaas_flash_attention_bf16: the
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
// per-element softcap or mask test, predicated, issued its tanh for
// every element), a softcap's tanh is two special-function operations
// (tanh_fast: ex2 and rcp, ~1e-7 absolute, where tanhf is a longer
// sequence), and O's rescale is skipped where no row of a warp raised
// its running max.  Tiles the mask closes for a warpgroup's 64
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
// 128 < d <= 256 (gemma2's 256: NKT = 16, four 64-column boxes, P V's N
// 256, the largest wgmma takes) changes four things.  A 96-key stage of
// K and V would be 96 KB, so tiles are 64 keys (S by m64n64k16), 64 KB a
// stage, two stages: Q 64 KB + 128 KB at 128 rows, one block an SM.  With
// two stages a refill issued once every warp is done with a tile's K and
// V comes just before the tile is needed (131 ms a global layer at
// gemma2's prefill_32k on an H100), so K and V have rings of their own
// (SPLIT), each
// stage with a full mbarrier and a release count: the warp whose release
// completes the count refills the stage, K once its S is computed, V once
// its P V is, and each load leads its use by about a tile (79 ms).  O's
// 64 x 256 floats are 128 registers a thread, so p's fragments have one
// buffer, not two: tile i's softmax still runs while tile i - 1's P V is
// on the tensor cores, but its fragments are made after that product has
// read the buffer.  At gemma2's prefill_32k (3 x 32,768, 16 q-heads, 8
// kv-heads, causal, softcap 50) a global layer's products are 2.64e13
// flop, 26.7 ms at the bf16 rate (P V twice: 40.0).
//
// A float32 value head dim of its own past d = 192 or d_v = 128 (no path
// has one), and d_v != d in bf16 (MLA's 192 / 128: its Q tile and 128-key
// K/V ring, 48 + 2 x (48 + 32) KB, would fit, but the kernel's PV takes
// N = d; queued), take the CUDA-core kernel below,
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
// tensor-core kernels, float32: d <= 192 and d_v <= 128; d = d_v <= 256
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

// ---------------------------------------------------------------------------
// 128 < d = d_v <= 256: O's columns split across warps
// ---------------------------------------------------------------------------
constexpr int kColWarps = 4;                 // warps a row group
constexpr int kColRows = 32;                 // query rows a block: 2 x 16
constexpr int kColKeys = 32;                 // keys a tile: 4 groups of 8
constexpr int kColDP = 256;                  // the padded head dim
constexpr int kColDQ = kColDP / kColWarps;   // a warp's quarter of it
constexpr int kColNK = kColDQ / 8;           // its 8-column steps
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kColWarps * 2 * 32 == kThreads, "two row groups of 4 warps");

// Q's rows (the partial-S and S exchange once Q is in registers), then the
// K and V rings, each row at row_stride(kColDP) floats
size_t cols_smem_bytes() {
  return sizeof(float) * (size_t)row_stride(kColDP) *
         (kColRows + 4 * kColKeys);
}

// A block: 32 query rows of one (batch row, q-head), 8 warps.  Warp w is
// row group rg = w / 4 (rows 16 rg ..) and column warp cw = w % 4, which
// owns head-dim columns [64 cw, 64 cw + 64) of Q, K, V and O.  A 32-key
// tile: (1) each warp sums S over its columns for the tile's 32 keys
// (Q's split halves in registers, K's split from shared memory) and
// leaves the partial sums in X; (2) after its row group's named barrier,
// warp cw adds the four partials of key group cw in warp order, scales,
// caps and masks them into Y; (3) after the next, every warp of the row
// group reads the whole tile's S from Y, runs the same online softmax on
// it (so m and l agree bit for bit across the four) and adds P V for its
// 64 columns.  The two row groups meet only at the tile's __syncthreads.
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_cols_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int32_t* __restrict__ q_offset,
                            float* __restrict__ out, int Sq, int Skv, int Hq,
                            int Hkv, int D, int causal, int window,
                            float softcap, float scale) {
  constexpr int S = row_stride(kColDP);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);            // [kColRows][S]
  float* Ks = Qs + kColRows * S;                          // [2][kColKeys][S]
  float* Vs = Ks + 2 * kColKeys * S;                      // [2][kColKeys][S]
  // over Q's rows once they are in registers: X [2][4 cw][4 j][32] and Y
  // [2][4 j][32], float4 a lane (a fragment of 4 accumulators)
  float4* X = smem4;
  float4* Y = X + 2 * kColWarps * 4 * 32;
  static_assert(2 * kColWarps * 5 * 32 * 4 <= kColRows * S, "fits Q's rows");

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kColRows;   // heaviest first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int rg = warp / kColWarps;
  const int cw = warp % kColWarps;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int c0 = kColDQ * cw;                 // the warp's first column
  const int off = q_offset[b];
  const int qrows = min(kColRows, Sq - q0);

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

  stage_rows<kColDP>(Qs, q + (((size_t)b * Sq + q0) * Hq + h) * D,
                     (size_t)Hq * D, qrows, kColRows, D, vec);
  if (kv_lo < kv_hi) {
    const int n = min(kColKeys, kv_hi - kv_lo);
    stage_rows<kColDP>(Ks, kb + kv_lo * kv_stride, kv_stride, n, kColKeys, D,
                       vec);
    stage_rows<kColDP>(Vs, vb + kv_lo * kv_stride, kv_stride, n, kColKeys, D,
                       vec);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q's A fragments of this warp's rows and columns, split once: rows g and
  // g + 8 of the row group, columns c0 + 8 kk + t and + 4
  const int r0 = 16 * rg;
  uint32_t qhi[kColNK][4], qlo[kColNK][4];
#pragma unroll
  for (int kk = 0; kk < kColNK; ++kk) {
    const float* qa = Qs + (r0 + g) * S + c0 + 8 * kk + t;
    split_tf32(qa[0], qhi[kk][0], qlo[kk][0]);
    split_tf32(qa[8 * S], qhi[kk][1], qlo[kk][1]);
    split_tf32(qa[4], qhi[kk][2], qlo[kk][2]);
    split_tf32(qa[8 * S + 4], qhi[kk][3], qlo[kk][3]);
  }

  const int wpos_lo = off + q0 + r0;               // the row group's
  const int wpos_hi = wpos_lo + 15;                // query positions
  const int qp[2] = {wpos_lo + g, wpos_lo + g + 8};  // this lane's rows
  float o[kColNK][4];
#pragma unroll
  for (int dt = 0; dt < kColNK; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float4* xs = X + rg * kColWarps * 4 * 32;        // the row group's X, Y
  float4* ys = Y + rg * 4 * 32;

  int buf = 0;
  for (int kt = kv_lo; kt < kv_hi; kt += kColKeys, buf ^= 1) {
    const int nxt = kt + kColKeys;
    if (nxt < kv_hi) {             // the next tile loads during this one
      const int n = min(kColKeys, kv_hi - nxt);
      stage_rows<kColDP>(Ks + (buf ^ 1) * kColKeys * S,
                         kb + nxt * kv_stride, kv_stride, n, kColKeys, D,
                         vec);
      stage_rows<kColDP>(Vs + (buf ^ 1) * kColKeys * S,
                         vb + nxt * kv_stride, kv_stride, n, kColKeys, D,
                         vec);
    }
    cp_async_commit();
    cp_async_wait<1>();            // every group but the newest: this tile
    __syncthreads();

    // key group j (keys kt + 8 j ..) seen by some row of the row group;
    // a tile none of its rows sees is skipped by all four warps
    auto open = [&](int j) {
      const int kg = kt + 8 * j;
      return kg < kv_hi && !(causal && wpos_hi < kg) &&
             !(window > 0 && wpos_lo - (kg + 7) >= window);
    };
    if (open(0) || open(1) || open(2) || open(3)) {
      const float* Kt = Ks + buf * kColKeys * S + c0;
      const float* Vt = Vs + buf * kColKeys * S + c0;

      // (1) S over this warp's columns: sp the hi*hi terms, sx the cross
      // terms, each key group its own accumulators
      float sp[4][4], sx[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] = sx[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kColNK; ++kk) {
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* ka = Kt + (8 * j + g) * S + 8 * kk + t;
          split_tf32(ka[0], bhi[j][0], blo[j][0]);    // K[key g][t]
          split_tf32(ka[4], bhi[j][1], blo[j][1]);    // K[key g][t + 4]
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_m16n8k8(sx[j], qlo[kk], bhi[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_m16n8k8(sp[j], qhi[kk], bhi[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_m16n8k8(sx[j], qhi[kk], blo[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xs[(cw * 4 + j) * 32 + lane] =
            make_float4(sp[j][0] + sx[j][0], sp[j][1] + sx[j][1],
                        sp[j][2] + sx[j][2], sp[j][3] + sx[j][3]);
      bar_sync(1 + rg, 32 * kColWarps);

      // (2) key group cw's S: the four partials in warp order, scaled,
      // capped (each logit once in the block: tanhf), masked
      if (open(cw)) {
        float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int w = 0; w < kColWarps; ++w) {
          const float4 p = xs[(w * 4 + cw) * 32 + lane];
          x[0] += p.x;
          x[1] += p.y;
          x[2] += p.z;
          x[3] += p.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float y = x[e] * scale;
          if (softcap > 0.f) y = softcap * tanhf(y / softcap);
          const int key = kt + 8 * cw + 2 * t + (e & 1);
          const int p = qp[e >> 1];
          const bool ok = key < kv_hi && (!causal || p >= key) &&
                          (window <= 0 || p - key < window);
          x[e] = ok ? y : -INFINITY;
        }
        ys[cw * 32 + lane] = make_float4(x[0], x[1], x[2], x[3]);
      }
      bar_sync(1 + rg, 32 * kColWarps);

      // (3) the tile's S, the online softmax, O += P V on this warp's
      // columns; s[j][e] is row qp[e / 2], key kt + 8 j + 2 t + e % 2
      float s[4][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 y = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if (open(j)) y = ys[j * 32 + lane];
        s[j][0] = y.x;
        s[j][1] = y.y;
        s[j][2] = y.z;
        s[j][3] = y.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
      float msc[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        msc[i] = m_new == -INFINITY ? 0.f : m_new * kLog2e;
        alpha[i] = m_new == m[i] ? 1.f
                                 : ex2_approx(fmaf(m[i], kLog2e, -msc[i]));
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2_approx(fmaf(s[j][e], kLog2e, -msc[e >> 1]));
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
        sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
        l[i] = fmaf(l[i], alpha[i], sum[i]);
      }
      if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int dt = 0; dt < kColNK; ++dt) {
          o[dt][0] *= alpha[0];
          o[dt][1] *= alpha[0];
          o[dt][2] *= alpha[1];
          o[dt][3] *= alpha[1];
        }
      }

      // O += P V, key step j: A-fragment column t is key 2t, column t + 4
      // key 2t + 1 (the accumulator's own pair), and V's B fragment rows
      // follow the same order; four of the warp's 8-column tiles a batch
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!open(j)) continue;
        uint32_t ahi[4], alo[4];
        split_tf32(s[j][0], ahi[0], alo[0]);          // P[g][2t]
        split_tf32(s[j][2], ahi[1], alo[1]);          // P[g + 8][2t]
        split_tf32(s[j][1], ahi[2], alo[2]);          // P[g][2t + 1]
        split_tf32(s[j][3], ahi[3], alo[3]);          // P[g + 8][2t + 1]
        const float* va = Vt + (8 * j + 2 * t) * S + g;
#pragma unroll
        for (int d0 = 0; d0 < kColNK; d0 += 4) {
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* vu = va + (d0 + u) * 8;
            split_tf32(vu[0], bhi[u][0], blo[u][0]);  // V[key 2t][col g]
            split_tf32(vu[S], bhi[u][1], blo[u][1]);  // V[key 2t + 1][g]
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mma_tf32_m16n8k8(o[d0 + u], alo, bhi[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mma_tf32_m16n8k8(o[d0 + u], ahi, blo[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mma_tf32_m16n8k8(o[d0 + u], ahi, bhi[u]);
        }
      }
    }
    __syncthreads();               // this buffer, X and Y refill next
  }
  cp_async_wait<0>();              // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= qrows) continue;
    float* orow = out + (((size_t)b * Sq + q0 + row) * Hq + h) * D;
    if (m[i] == -INFINITY) {
      // no valid key: the plain version's softmax over Skv equal -1e30
      // logits is uniform, so the row is the mean of V
      for (int dt = 0; dt < kColNK; ++dt)
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * dt + 2 * t + e;
          if (c >= D) continue;
          float acc = 0.f;
          for (int j = 0; j < Skv; ++j) acc += vb[j * kv_stride + c];
          orow[c] = acc / (float)Skv;
        }
    } else {
#pragma unroll
      for (int dt = 0; dt < kColNK; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * dt + 2 * t + e;
          if (c < D) orow[c] = o[dt][2 * i + e] / l[i];
        }
    }
  }
}

int launch_cols(const float* q, const float* k, const float* v,
                const int32_t* qo, float* out, int B, int Sq, int Skv, int Hq,
                int Hkv, int D, int causal, int window, float softcap,
                float scale, cudaStream_t stream) {
  const size_t smem = cols_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_cols_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, (Sq + kColRows - 1) / kColRows, B);
  flash_attention_cols_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, qo, out, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale);
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
// bf16 operands, d = d_v <= 256: wgmma on TMA tiles (sm_90a)
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRowsWG = 64;      // query rows of one consumer warpgroup
constexpr int kRow = 128;        // bytes of a swizzled row: 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

// NWG consumer warpgroups (64 query rows each) and NKT 16-column steps of
// the head dim (padded with zeros to DP = 16 NKT: QK's k steps, PV's N).
// Shared memory, 1024-byte aligned: Q [NB][BM][64], then the K and V
// stages, each [NB][BN][64], then the barriers (Q's, then two a stage:
// K's and V's full, or its full and its empty) and the release counts;
// NB 64-column boxes.
template <int NWG, int NKT>
struct Tile {
  static constexpr int DP = 16 * NKT;
  static constexpr int NB = (DP + 63) / 64;
  static constexpr int BM = kRowsWG * NWG;
  static constexpr int kThreads = 128 * NWG;
  // keys a tile: 96 up to d = 128; 64 past it, where a 96-key stage of K
  // and V (96 KB at d = 256) would leave no room for two beside Q
  static constexpr int BN = DP <= 128 ? 96 : 64;
  // K/V tiles in flight: 4 for one block an SM (224 KB), 2 for 64-row
  // blocks, two of which share an SM (2 x 112 KB); past d = 128 two, one
  // block an SM (Q 64 KB + 2 x 64 KB at 128 rows, 32 KB + 128 KB at 64)
  static constexpr int STAGES = NWG == 2 && DP <= 128 ? 4 : 2;
  // past d = 128 K and V have rings of their own, released by count (the
  // kernel below); up to it a stage holds a tile's K and V, refilled by
  // thread 0 (split rings ran 7% slower at 6 x 32k, d = 112)
  static constexpr bool SPLIT = DP > 128;
  static constexpr unsigned Q_BYTES = NB * BM * kRow;
  static constexpr unsigned KV_BYTES = NB * BN * kRow;   // K or V, a stage
  static constexpr unsigned OFF_K = Q_BYTES;
  static constexpr unsigned OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr unsigned OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr unsigned OFF_CNT = OFF_BAR + 8 * (1 + 2 * STAGES);
  static constexpr unsigned SMEM = OFF_CNT + 4 * 2 * STAGES;
};

// P V takes p as two bf16 halves (split_bf16x2, primitives.cuh), one
// packed conversion a pair: conversions run on the special-function unit
// beside ex2, and with one a value they held it longer than the products
// held the tensor cores

// S = Q K^T for one BN-key tile, issued (not waited): sc[4 J + e] is the
// warpgroup's row 16 warp + g + 8 (e / 2), key 8 J + 2 t + e % 2; one
// m64nBNk16 wgmma a 16-column step (128-key tiles, 3 stages, measured no
// faster at 32k and d = 112)
template <int NKT, int BM, int BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2],
                                         const uint8_t* Qc,
                                         const uint8_t* Kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) {
    const uint64_t da =
        wgmma_desc(Qc + (kk / 4) * BM * kRow + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        wgmma_desc(Kt + (kk / 4) * BN * kRow + (kk % 4) * 32, 16, 1024);
    if constexpr (BN == 96)
      wgmma_m64n96k16_ss(sc, da, db, kk > 0);
    else
      wgmma_m64n64k16_ss(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for one tile, issued (not waited): P's two bf16 halves are the
// A fragments of the 16-key steps (the accumulator pairs of S as they
// stand); V (keys x head dim, head dim contiguous) is B with the
// transposed bit, its 64-column boxes (two at d <= 128, four at 256) one
// 64 x DP product a half (the descriptor's leading byte offset, a box's
// BN rows, steps from box to box)
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float* o,
                                         const uint32_t (&phi)[BN / 4],
                                         const uint32_t (&plo)[BN / 4],
                                         const uint8_t* Vt) {
  fence_regs<DP / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = wgmma_desc(Vt + kk * 16 * kRow, BN * kRow, 1024);
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
  constexpr int BN = T::BN;
  // the 128-byte swizzle repeats every 1024 bytes: TMA and wgmma address
  // the tiles from a 1024-byte aligned base
  extern __shared__ __align__(1024) uint8_t smem[];
  if (smem_u32(smem) % 1024 != 0) __trap();
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::OFF_BAR);
  // [STAGES] each: SPLIT, a K tile and a V tile landed; else a tile's K
  // and V landed, and every warp done with it
  uint64_t* kfull = q_full + 1;
  uint64_t* vfull = kfull + T::STAGES;
  // [STAGES] each (SPLIT): the warps' releases of a K (V) stage, counted
  // up ever
  uint32_t* kcnt = reinterpret_cast<uint32_t*>(smem + T::OFF_CNT);
  uint32_t* vcnt = kcnt + T::STAGES;

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
  const int ntiles = kv_lo < kv_hi ? (kv_hi - kv_lo + BN - 1) / BN : 0;

  // tile i's K (k), V (v) or both into stage i % STAGES by TMA, landing on
  // the stage's K (or, SPLIT, V) full barrier: thread 0 loads Q and the
  // first STAGES tiles, then each stage is refilled as release says
  auto load = [&](int i, bool k, bool v) {
    const int s = i % T::STAGES;
    uint64_t* bar = (T::SPLIT && v ? vfull : kfull) + s;
    mbar_arrive_expect_tx(bar, (k + v) * T::KV_BYTES);
    for (int x = 0; x < T::NB; ++x) {
      const int at = s * T::KV_BYTES + x * BN * kRow;
      if (k)
        tma_load_4d(smem + T::OFF_K + at, &tk, bar, 64 * x, hk,
                    kv_lo + i * BN, b);
      if (v)
        tma_load_4d(smem + T::OFF_V + at, &tv, bar, 64 * x, hk,
                    kv_lo + i * BN, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], T::SPLIT ? 1 : 4 * NWG);
      kcnt[s] = vcnt[s] = 0;
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(q_full, T::Q_BYTES);
    for (int x = 0; x < T::NB; ++x)
      tma_load_4d(smem + x * T::BM * kRow, &tq, q_full, 64 * x, h, q0, b);
    for (int i = 0; i < min(T::STAGES, ntiles); ++i) {
      if constexpr (T::SPLIT) {
        load(i, true, false);
        load(i, false, true);
      } else {
        load(i, true, true);
      }
    }
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
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
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
         wpos_lo - (kv_lo + i_lo * BN + BN - 1) >= window)
    ++i_lo;
  while (i_hi > i_lo && causal && wpos_hi < kv_lo + (i_hi - 1) * BN)
    --i_hi;

  float o[T::DP / 2];                    // O: 64 rows x DP, fp32
#pragma unroll
  for (int i = 0; i < T::DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  float sc[BN / 2];                     // S, then P, of one tile
  // P's two halves as A fragments, two buffers up to d = 128: tile i's
  // are made while tile i - 1's feed the tensor cores.  Past it one: O's
  // 64 x 256 floats take 128 registers a thread, and a second buffer
  // would pass the 255 a thread may have
  constexpr bool kTwoBuffers = T::DP <= 128;
  uint32_t phi0[BN / 4], plo0[BN / 4], phi1[BN / 4], plo1[BN / 4];

  // softcap, mask (only tiles the mask or the end of the keys cut) and the
  // online softmax of tile i's S, in place: sc becomes p; alpha the factor
  // of the running O and l
  auto softmax = [&](int i) {
    const int k0 = kv_lo + i * BN;
    const bool cut = k0 + BN > Skv || (causal && k0 + BN - 1 > wpos_lo) ||
                     (window > 0 && wpos_hi - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (softcap > 0.f || cut) {
      // the branches stay out of the common tile's loop: ptxas predicates
      // them, and a predicated tanh is issued for every element
#pragma unroll
      for (int J = 0; J < BN / 8; ++J)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * J + e];
          if (softcap > 0.f) x = softcap * tanh_fast(x * cap_in);
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
      for (int J = 0; J < BN / 8; ++J)
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
    for (int J = 0; J < BN / 8; ++J)
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
  auto to_fragments = [&](uint32_t (&phi)[BN / 4],
                          uint32_t (&plo)[BN / 4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
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
  // tile i's K (is_v false) or V has landed; without SPLIT, V landed
  // with K
  auto land = [&](int i, bool is_v) {
    if (T::SPLIT || !is_v)
      mbar_wait((is_v ? vfull : kfull) + i % T::STAGES,
                (i / T::STAGES) & 1);
  };
  // this warp is done with tile i's K (V: S and P V are done with the
  // tile).  SPLIT: it counts itself out of the stage, and the warp that
  // brings the count to the block's 4 NWG warps (the counts only grow: no
  // reset to order) refills the stage with tile i + STAGES; its
  // wgmma_wait has completed every read of the stage, and the load is
  // issued only after the count is read.  No warp waits for another, and
  // K is released once S is computed, V once P V is, so each load leads
  // its use by about a tile.  Else thread 0 refills a stage once every
  // warp has released its V
  auto release = [&](int i, bool is_v) {
    const int s = i % T::STAGES;
    if constexpr (T::SPLIT) {
      __syncwarp();
      if (lane == 0 &&
          (atomicAdd((is_v ? vcnt : kcnt) + s, 1u) + 1) % (4 * NWG) == 0 &&
          i + T::STAGES < ntiles)
        load(i + T::STAGES, !is_v, is_v);
    } else if (is_v) {
      if (lane == 0) mbar_arrive(&vfull[s]);
      if (threadIdx.x == 0 && i + T::STAGES < ntiles) {
        mbar_wait(&vfull[s], (i / T::STAGES) & 1);
        load(i + T::STAGES, true, true);
      }
    }
  };
  auto skip = [&](int i) {          // a tile no row of this warpgroup sees
    land(i, false);
    release(i, false);
    land(i, true);
    release(i, true);
  };

  mbar_wait(q_full, 0);
  for (int i = 0; i < i_lo; ++i) skip(i);
  // software pipeline: tile i's S is issued with tile i - 1's P V, and
  // its softmax and P's fragments are made while that product is on the
  // tensor cores
  auto step = [&](int i, uint32_t (&phi)[BN / 4], uint32_t (&plo)[BN / 4],
                  uint32_t (&prev_hi)[BN / 4],
                  uint32_t (&prev_lo)[BN / 4]) {
    land(i, false);
    issue_qk<NKT, T::BM, BN>(sc, Qc, k_tile(i));
    rescale();                        // O to tile i - 1's running max
    land(i - 1, true);
    issue_pv<T::DP, BN>(o, prev_hi, prev_lo, v_tile(i - 1));
    wgmma_wait<1>();                  // S of tile i
    fence_regs<BN / 2>(sc);
    release(i, false);
    softmax(i);
    to_fragments(phi, plo);
    wgmma_wait<0>();                  // P V of tile i - 1
    fence_regs<T::DP / 2>(o);
    release(i - 1, true);
  };
  auto last_pv = [&](uint32_t (&phi)[BN / 4], uint32_t (&plo)[BN / 4]) {
    rescale();
    land(i_hi - 1, true);
    issue_pv<T::DP, BN>(o, phi, plo, v_tile(i_hi - 1));
    wgmma_wait<0>();
    fence_regs<T::DP / 2>(o);
    release(i_hi - 1, true);
  };
  // one buffer: tile i's softmax runs while tile i - 1's P V is on the
  // tensor cores, its fragments are made once that product has read p
  auto step1 = [&](int i) {
    land(i, false);
    issue_qk<NKT, T::BM, BN>(sc, Qc, k_tile(i));
    rescale();
    land(i - 1, true);
    issue_pv<T::DP, BN>(o, phi0, plo0, v_tile(i - 1));
    wgmma_wait<1>();
    fence_regs<BN / 2>(sc);
    release(i, false);
    softmax(i);
    wgmma_wait<0>();
    fence_regs<T::DP / 2>(o);
    to_fragments(phi0, plo0);
    release(i - 1, true);
  };
  if (i_lo < i_hi) {
    land(i_lo, false);
    issue_qk<NKT, T::BM, BN>(sc, Qc, k_tile(i_lo));
    wgmma_wait<0>();
    fence_regs<BN / 2>(sc);
    release(i_lo, false);
    softmax(i_lo);
    to_fragments(phi0, plo0);
    int i = i_lo + 1;
    if constexpr (kTwoBuffers) {
      for (; i + 1 < i_hi; i += 2) {  // two tiles a turn: the buffers swap
        step(i, phi1, plo1, phi0, plo0);
        step(i + 1, phi0, plo0, phi1, plo1);
      }
      if (i < i_hi) {
        step(i, phi1, plo1, phi0, plo0);
        last_pv(phi1, plo1);
      } else {
        last_pv(phi0, plo0);
      }
    } else {
      for (; i < i_hi; ++i) step1(i);
      last_pv(phi0, plo0);
    }
  }
  for (int i = i_hi; i < ntiles; ++i) skip(i);

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
  if (err == 0) err = tensor_map(&tk, k, D, Hkv, Skv, B, T::BN);
  if (err == 0) err = tensor_map(&tv, v, D, Hkv, Skv, B, T::BN);
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

// the instance: NKT by the head dim (32, 64, 96, 112, 128, 256), NWG by
// the grid
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
  if (D <= 128) VPAAS_WG(8);
  VPAAS_WG(16);
#undef VPAAS_WG
}

}  // namespace wg

// ---------------------------------------------------------------------------
// CUDA-core kernel: float32 d_v != d past d = 192 or d_v = 128, bf16 with
// d_v < d
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

// the float32 column-warp kernel's head dims: 128 < d = d_v <= 256
static bool on_cols(int D, int Dv) { return Dv == D && D > 128 && D <= 256; }

// 1 where the launcher runs these head dims on the tensor cores, 0 where
// on the CUDA cores: float32 (bf16 = 0) up to d = 192 and d_v = 128, and
// d = d_v up to 256; bf16 where d = d_v <= 256
extern "C" int vpaas_flash_attention_on_tensor_cores(int D, int Dv,
                                                     int bf16) {
  return bf16 ? Dv == D && D <= 256
              : (D <= 192 && Dv <= 128 && Dv <= D) || on_cols(D, Dv);
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
  if (on_cols(D, Dv))
    return tc::launch_cols(qf, kf, vf, qo, of, B, Sq, Skv, Hq, Hkv, D, causal,
                           window, softcap, scale, st);
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
