// K8: the Mamba2 SSD (state-space duality) chunked scan, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py ssd_scan
// (kernel body _kernel).  For one (batch row, head) the sequence is cut
// into chunks of Q steps.  With a = dt * A, cum the in-chunk inclusive
// cumulative sum of a, u_j = dt_j * x_j and the (p, n) state S carried
// from chunk to chunk:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) u_j      (intra-chunk)
//        + exp(cum_i) C_i . S                                    (incoming)
//   S   <- exp(cum_last) S + sum_j exp(cum_last - cum_j) u_j B_j^T
// The tail past s acts as dt = 0, x = B = C = 0, as the plain version's
// zero padding does, so the final state is unchanged by it; nothing is
// padded in device memory.  Float32 throughout; cum is accumulated in
// double and rounded once per step, as PyTorch's CPU cumsum does.
//
// What bounds it on the card.  The function's own recurrence (per step and
// head: the decay, u, S <- exp(a) S + u B^T, y = C S) costs 0.88 GFLOP at
// the LLM path's prefill (zamba2: 112 heads, p = n = 64, s = 384): 13.2 us
// at fp32's 67 TFLOP/s, above its 24.2 MB (7.2 us at 3.35 TB/s); that is
// the bound PERF.md and chip_smoke.ssd_ops report.  The chunked form run
// here (Q = 256: one full and one 128-step chunk) does 1.89 GFLOP of
// matrix products (C B^T and W U on the causal triangle, the chunk states
// U^T (B o decay), the incoming C S^T); as three TF32 products each on the
// tensor cores (495 TFLOP/s) plus the decays on the CUDA cores that is
// 11.8 us (chip_smoke.ssd_tc_ops), against 6.6 us for x and y alone.  One
// block per head walking the chunks in order on the CUDA cores (the
// previous design) filled 112 of 132 SMs and ran every product as fp32
// FMA from shared memory.  On mma.sync the instructions around each mma
// (loads, splits, the decays) bound it: cutting them moved it most.
//
// The design: the SSD's own decomposition (arXiv:2405.21060, the chunked
// algorithm) as three kernels from one launcher, with no float atomics
// (y and the final state are bit-identical run to run):
//  1. ssd_state_kernel, grid (64-source tile x chunk, head, row): the
//     chunk's cum and decay exp(cum_last), and the tile's part of the
//     chunk's state, sum_j (u_j exp(cum_last - cum_j)) B_j^T, into a
//     workspace (672 blocks at zamba2).
//  2. ssd_state_pass_kernel, one thread per state element: the only
//     sequential step, S_c = exp(cum_last,c) S_{c-1} + (chunk c's parts
//     summed in tile order), leaving in the workspace the state entering
//     each chunk; the final state goes to `fin`.
//  3. ssd_output_kernel, grid (head, 64-row tile x chunk, row), the
//     heaviest tiles (the last rows of a chunk, which see the most source
//     tiles) first: y_i = sum_{j <= i} W_ij u_j + exp(cum_i) C_i . S_{c-1}
//     for 64 rows; 112 heads x 6 live tiles = 672 blocks at zamba2.
// Every product is mma.sync m16n8k8 tf32 in 3xTF32 (csrc/primitives.cuh;
// lo*hi and hi*lo, then hi*hi, over independent accumulators), each
// operand split by split_tf32_trunc: hi is the float itself, which the
// tensor core truncates to tf32, and lo = x - trunc(x), two instructions
// where rounding took three (~3 x 2^-20 |a b| of error per product, far
// inside SSD_RTOL).  C B^T lands in accumulator fragments, W_ij = (C_i .
// B_j) exp(cum_i - cum_j) is formed there (zero above the diagonal; the
// exponential as ex2.approx, as K6's softmax) and goes back into W U as
// the A operand straight from registers, the source order inside each
// 8-source step permuted as in K6's P V.  Kernel 3's 8 warps are 4 row
// warps (16 rows) x 2 source groups (the two 32-source halves of each
// source tile, merged at the end; group 1 also takes the incoming term),
// at <= 128 registers so two 107 KB blocks share an SM; kernel 1's are 4
// warps of 16 state rows x 2 groups of the n columns.  p = 64 with n = 64
// or 128 compiles to loops of fixed length with no run-time guards around
// the mmas.  Tiles arrive by cp.async (16-byte copies when the operands
// are aligned) into a double-buffered ring; shared row strides keep the
// fragment loads free of bank conflicts.  cum is a block-wide scan (one
// step per thread at Q = 256), not one warp's while the others wait.
//
// p or n not a multiple of 8 keeps the CUDA-core kernel below (ssd_simt),
// chosen by shape: one block per (head, batch row), 256 threads walking
// the chunks in order with the state in shared memory, 64 x 64 weight
// tiles formed on the fly.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "primitives.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// tensor-core path: p % 8 == 0 and n % 8 == 0
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kT = 64;                    // rows (or sources) per tile
constexpr int kRowWarps = 4;              // 16 rows each
constexpr int kGroups = 2;                // source halves / column groups
constexpr int kThreads = 32 * kRowWarps * kGroups;
constexpr int kMaxPT = 8;                 // p / 8
constexpr int kMaxNT = 16;                // n / 8
constexpr int kNG = kMaxNT / kGroups;     // n-tiles of one column group
constexpr int kHalfPT = kMaxPT / 2;

// Shared row strides.  A fragment reads 8 rows g x 4 columns t: a stride
// of 4 mod 8 floats puts the 32 lanes on 32 banks (rows_stride).  Kernel 1
// reads its tiles transposed, 4 rows t x 8 columns g: a stride of 8 mod 16
// does it there (cols_stride).  Both keep rows 16-byte aligned.
__host__ __device__ constexpr int rows_stride(int w) { return w + 4; }
__host__ __device__ constexpr int cols_stride(int w) {
  return w % 16 ? w : w + 8;
}
__host__ __device__ constexpr int padded_chunk(int Q) {
  return (Q + kT - 1) / kT * kT;
}

size_t state_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * ((size_t)kT * (cols_stride(P) + cols_stride(N))
                          + 2 * (size_t)padded_chunk(Q) + 2 * kT) +
         sizeof(double) * (kThreads / 32);
}

size_t output_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * (3 * (size_t)kT * rows_stride(N)
                          + 2 * (size_t)kT * rows_stride(P)
                          + (size_t)P * rows_stride(N)
                          + 2 * (size_t)padded_chunk(Q)) +
         sizeof(double) * (kThreads / 32);
}

// Copy rows [0, nrows) of a slab (row r at src + r * stride, W floats,
// W % 4 == 0) into shared rows of RS floats by cp.async; rows >= valid
// become zeros.  Every thread of the block calls it; valid >= 1.
__device__ __forceinline__ void stage_rows(float* dst, int RS,
                                           const float* src, size_t stride,
                                           int valid, int nrows, int W,
                                           bool vec) {
  if (vec) {
    const int C4 = W / 4;
    for (int e = threadIdx.x; e < nrows * C4; e += kThreads) {
      const int r = e / C4;
      const int c = 4 * (e - r * C4);
      const bool ok = r < valid;
      cp_async_16(dst + r * RS + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * W; e += kThreads) {
      const int r = e / W;
      const int c = e - r * W;
      const bool ok = r < valid;
      cp_async_4(dst + r * RS + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// cum[t] = sum_{t' <= t} dts[t'] * a for t < QP, accumulated in double and
// rounded once per step.  Each thread sums a run of consecutive steps, the
// runs' totals are scanned across the warp and then across the warps.
// Every thread of the block calls it; it ends with a barrier.
__device__ void chunk_cumsum(const float* dts, float a, float* cum,
                             double* wsum, int QP) {
  const int per = (QP + kThreads - 1) / kThreads;
  const int t0 = min(QP, (int)threadIdx.x * per);
  const int t1 = min(QP, t0 + per);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  double run = 0.0;
  for (int t = t0; t < t1; ++t) run += (double)(dts[t] * a);
  double incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const double other = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += other;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  double acc = incl - run;                 // exclusive prefix in the warp
  for (int w = 0; w < warp; ++w) acc += wsum[w];
  for (int t = t0; t < t1; ++t) {
    acc += (double)(dts[t] * a);
    cum[t] = (float)acc;
  }
  __syncthreads();
}

// 1. One 64-source tile's part of its chunk's state: partial[b][c][tile][h]
// (p x n) = sum over the tile's sources j of (u_j exp(cum_last - cum_j))
// B_j^T; the tile-0 block also writes clast[b][c][h] = cum_last.
// P8, N8 = p / 8, n / 8 as constants (0: read P, N at run time).
template <int P8, int N8>
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ clast,
                 int S, int H, int P, int N, int Q, int nc, int vec) {
  if (P8) P = 8 * P8;
  if (N8) N = 8 * N8;
  extern __shared__ float4 smem4[];
  const int XS = cols_stride(P);
  const int BS = cols_stride(N);
  const int QP = padded_chunk(Q);
  const int T = QP / kT;                   // source tiles per chunk
  float* Xs = reinterpret_cast<float*>(smem4);             // [kT][XS]
  float* Bs = Xs + kT * XS;                                // [kT][BS]
  double* wsum = reinterpret_cast<double*>(Bs + kT * BS);
  float* dts = reinterpret_cast<float*>(wsum + kThreads / 32);   // [QP]
  float* cum = dts + QP;                                   // [QP]
  float* wts = cum + QP;                    // [kT] dt_j of this tile
  float* dec = wts + kT;                    // [kT] exp(cum_last - cum_j)

  const int c = blockIdx.x / T;
  const int tile = blockIdx.x % T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = c * Q;
  const int L = min(Q, S - c0);            // real steps in this chunk
  const int j0 = tile * kT;
  if (j0 >= L) return;
  const size_t bs = (size_t)b * S;
  const size_t xstride = (size_t)H * P;
  stage_rows(Xs, XS, x + ((bs + c0 + j0) * H + h) * P, xstride, L - j0, kT,
             P, vec);
  stage_rows(Bs, BS, Bm + (bs + c0 + j0) * N, N, L - j0, kT, N, vec);
  cp_async_commit();
  for (int t = threadIdx.x; t < QP; t += kThreads)
    dts[t] = t < L ? dt[(bs + c0 + t) * H + h] : 0.f;
  __syncthreads();
  chunk_cumsum(dts, A[h], cum, wsum, QP);
  const float last = cum[L - 1];
  for (int t = threadIdx.x; t < kT; t += kThreads)
    wts[t] = j0 + t < L ? dts[j0 + t] : 0.f;
  for (int t = threadIdx.x; t < kT; t += kThreads)
    dec[t] = j0 + t < L ? expf(last - cum[j0 + t]) : 0.f;
  if (tile == 0 && threadIdx.x == 0)
    clast[((size_t)b * nc + c) * H + h] = last;
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wr0 = 16 * (warp % kRowWarps);  // this warp's state rows (p)
  const int grp = warp / kRowWarps;         // n-tiles grp, grp + 2, ...
  const int NT = N / 8;
  if (wr0 >= P) return;                     // no barrier follows
  const bool hi8 = wr0 + 8 < P;             // rows g + 8 exist

  float acc[kNG][4];
#pragma unroll
  for (int i = 0; i < kNG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kT / 8; ++kk) {
    if (j0 + kk * 8 >= L) break;           // zeros past the chunk
    // A[pp][j] = (x_j[pp] dt_j) decay_j, read transposed from X
    const int ja = kk * 8 + t;
    const int jb = ja + 4;
    const float* xa = Xs + ja * XS + wr0 + g;
    const float* xb = Xs + jb * XS + wr0 + g;
    const float da = wts[ja], ea = dec[ja];
    const float db = wts[jb], eb = dec[jb];
    uint32_t ahi[4], alo[4];
    split_tf32_trunc(xa[0] * da * ea, ahi[0], alo[0]);                 // A[g][t]
    split_tf32_trunc(hi8 ? xa[8] * da * ea : 0.f, ahi[1], alo[1]);      // [g+8][t]
    split_tf32_trunc(xb[0] * db * eb, ahi[2], alo[2]);                 // [g][t+4]
    split_tf32_trunc(hi8 ? xb[8] * db * eb : 0.f, ahi[3], alo[3]);
    uint32_t bhi[kNG][2], blo[kNG][2];
#pragma unroll
    for (int i = 0; i < kNG; ++i) {
      const int nt = grp + kGroups * i;
      if (nt < NT) {
        split_tf32_trunc(Bs[ja * BS + nt * 8 + g], bhi[i][0], blo[i][0]);
        split_tf32_trunc(Bs[jb * BS + nt * 8 + g], bhi[i][1], blo[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kNG; ++i)
      if (grp + kGroups * i < NT) mma_tf32_m16n8k8(acc[i], alo, bhi[i]);
#pragma unroll
    for (int i = 0; i < kNG; ++i)
      if (grp + kGroups * i < NT) mma_tf32_m16n8k8(acc[i], ahi, blo[i]);
#pragma unroll
    for (int i = 0; i < kNG; ++i)
      if (grp + kGroups * i < NT) mma_tf32_m16n8k8(acc[i], ahi, bhi[i]);
  }

  float* st = states + ((((size_t)b * nc + c) * T + tile) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < kNG; ++i) {
    const int nt = grp + kGroups * i;
    if (nt < NT) {
      const int col = nt * 8 + 2 * t;
      st[(wr0 + g) * N + col] = acc[i][0];
      st[(wr0 + g) * N + col + 1] = acc[i][1];
      if (hi8) {
        st[(wr0 + g + 8) * N + col] = acc[i][2];
        st[(wr0 + g + 8) * N + col + 1] = acc[i][3];
      }
    }
  }
}

// 2. The recurrence across chunks, one state element per thread: chunk
// c's state is the sum of its tiles' parts (in tile order), and its tile-0
// slot becomes the state entering chunk c.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const float* __restrict__ init,
                      float* __restrict__ states,
                      const float* __restrict__ clast, float* __restrict__ fin,
                      int S, int H, int P, int N, int Q, int nc) {
  const int PN = P * N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = padded_chunk(Q) / kT;
  const size_t tstride = (size_t)H * PN;   // from one tile's part to the next
  float st = init ? init[((size_t)b * H + h) * PN + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int nt = (min(Q, S - c * Q) + kT - 1) / kT;   // tiles with sources
    float* slot = states + (((size_t)b * nc + c) * T * H + h) * PN + e;
    float sum = slot[0];
    for (int tl = 1; tl < nt; ++tl) sum += slot[tl * tstride];
    slot[0] = st;
    st = st * expf(clast[((size_t)b * nc + c) * H + h]) + sum;
  }
  fin[((size_t)b * H + h) * PN + e] = st;
}

// 3. 64 output rows of one chunk: the intra-chunk sum over the source
// tiles at or below them, plus the incoming state's term.  Two blocks per
// SM (<= 128 registers a thread).
template <int P8, int N8>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm,
                  const float* __restrict__ states, float* __restrict__ y,
                  int S, int H, int P, int N, int Q, int nc, int vec) {
  if (P8) P = 8 * P8;
  if (N8) N = 8 * N8;
  extern __shared__ float4 smem4[];
  const int CS = rows_stride(N);
  const int XS = rows_stride(P);
  const int QP = padded_chunk(Q);
  float* Cs = reinterpret_cast<float*>(smem4);   // [kT][CS] this tile's C
  float* Bs = Cs + kT * CS;                      // [2][kT][CS]
  float* Xs = Bs + 2 * kT * CS;                  // [2][kT][XS]
  float* Ss = Xs + 2 * kT * XS;                  // [P][CS] entering state
  double* wsum = reinterpret_cast<double*>(Ss + P * CS);
  float* dts = reinterpret_cast<float*>(wsum + kThreads / 32);   // [QP]
  float* cum = dts + QP;                                         // [QP]

  const int T = QP / kT;                   // row tiles per chunk
  const int h = blockIdx.x;
  const int ti = T - 1 - (int)blockIdx.y / nc;   // heaviest first
  const int c = blockIdx.y % nc;
  const int b = blockIdx.z;
  const int c0 = c * Q;
  const int L = min(Q, S - c0);
  const int i0 = ti * kT;
  if (i0 >= L) return;
  const size_t bs = (size_t)b * S;
  const size_t xstride = (size_t)H * P;
  const float* xc = x + ((bs + c0) * H + h) * P;
  const float* bc = Bm + (bs + c0) * N;

  stage_rows(Cs, CS, Cm + (bs + c0 + i0) * N, N, L - i0, kT, N, vec);
  stage_rows(Ss, CS, states + (((size_t)b * nc + c) * T * H + h) * P * N, N,
             P, P, N, vec);
  stage_rows(Bs, CS, bc, N, L, kT, N, vec);
  stage_rows(Xs, XS, xc, xstride, L, kT, P, vec);
  cp_async_commit();
  if (ti > 0) {
    stage_rows(Bs + kT * CS, CS, bc + (size_t)kT * N, N, L - kT, kT, N, vec);
    stage_rows(Xs + kT * XS, XS, xc + kT * xstride, xstride, L - kT, kT, P,
               vec);
  }
  cp_async_commit();
  for (int t = threadIdx.x; t < QP; t += kThreads)
    dts[t] = t < L ? dt[(bs + c0 + t) * H + h] : 0.f;
  __syncthreads();
  chunk_cumsum(dts, A[h], cum, wsum, QP);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wr0 = 16 * (warp % kRowWarps);  // this warp's rows in the tile
  const int grp = warp / kRowWarps;         // its half of each source tile
  const int NPT = P / 8;
  const int NKN = N / 8;
  const int ra = i0 + wr0 + g;              // this lane's rows (chunk
  const int rb = ra + 8;                    // positions)
  const bool rows_live = i0 + wr0 < L;

  float acc[kMaxPT][4];
#pragma unroll
  for (int pt = 0; pt < kMaxPT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;

  for (int tj = 0; tj <= ti; ++tj) {
    const int buf = tj & 1;
    const int kg = tj * kT + grp * 32;     // this warp's first source
    cp_async_wait<1>();                    // all groups but the newest
    __syncthreads();
    // skipped when every source follows every row of the warp, or the
    // warp has no valid row or source (warp-uniform)
    const bool closed = !rows_live || kg > i0 + wr0 + 15 || kg >= L;
    if (!closed) {
      const float* Bt = Bs + (buf * kT + grp * 32) * CS;
      const float* Xt = Xs + (buf * kT + grp * 32) * XS;

      // C B^T: 16 rows x 4 source groups of 8 (accumulator fragments); the
      // cross terms sum apart (sc) and join the hi*hi sum (s) at the end
      float s[4][4], sc[4][4];
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j4][e] = sc[j4][e] = 0.f;
      for (int kk = 0; kk < NKN; ++kk) {
        uint32_t ahi[4], alo[4];
        const float* ca = Cs + (wr0 + g) * CS + kk * 8 + t;
        split_tf32_trunc(ca[0], ahi[0], alo[0]);               // C[g][t]
        split_tf32_trunc(ca[8 * CS], ahi[1], alo[1]);          // C[g + 8][t]
        split_tf32_trunc(ca[4], ahi[2], alo[2]);               // C[g][t + 4]
        split_tf32_trunc(ca[8 * CS + 4], ahi[3], alo[3]);      // C[g + 8][t + 4]
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          const float* ba = Bt + (j4 * 8 + g) * CS + kk * 8 + t;
          split_tf32_trunc(ba[0], bhi[j4][0], blo[j4][0]);     // B[src g][t]
          split_tf32_trunc(ba[4], bhi[j4][1], blo[j4][1]);     // B[src g][t + 4]
        }
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) mma_tf32_m16n8k8(sc[j4], alo, bhi[j4]);
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) mma_tf32_m16n8k8(s[j4], ahi, bhi[j4]);
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) mma_tf32_m16n8k8(sc[j4], ahi, blo[j4]);
      }

      // W_ij = (C_i . B_j) exp(cum_i - cum_j) for j <= i < L, else 0;
      // s[j4][e] is row (e < 2 ? ra : rb), source kg + 8 j4 + 2t + e % 2
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ra : rb;
          const int j = kg + j4 * 8 + 2 * t + (e & 1);
          s[j4][e] = (j <= i && i < L)
                         ? (s[j4][e] + sc[j4][e]) * __expf(cum[i] - cum[j])
                         : 0.f;
        }

      // y += W U, source step j4: A-fragment column t is source 2t, column
      // t + 4 source 2t + 1 (the accumulator's own pair); U's B fragment
      // rows follow the same order; u = x dt
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        uint32_t ahi[4], alo[4];
        split_tf32_trunc(s[j4][0], ahi[0], alo[0]);            // W[g][2t]
        split_tf32_trunc(s[j4][2], ahi[1], alo[1]);            // W[g + 8][2t]
        split_tf32_trunc(s[j4][1], ahi[2], alo[2]);            // W[g][2t + 1]
        split_tf32_trunc(s[j4][3], ahi[3], alo[3]);            // W[g + 8][2t + 1]
        const int sa = kg + j4 * 8 + 2 * t;              // source 2t
        const float ua = dts[sa];
        const float ub = dts[sa + 1];
        const float* xa = Xt + (j4 * 8 + 2 * t) * XS + g;
        // the p-tiles in two halves: half the B fragments live at a time
#pragma unroll
        for (int p0 = 0; p0 < kMaxPT; p0 += kHalfPT) {
          uint32_t bhi[kHalfPT][2], blo[kHalfPT][2];
#pragma unroll
          for (int u = 0; u < kHalfPT; ++u) {
            if (p0 + u < NPT) {
              split_tf32_trunc(xa[(p0 + u) * 8] * ua, bhi[u][0], blo[u][0]);
              split_tf32_trunc(xa[XS + (p0 + u) * 8] * ub, bhi[u][1], blo[u][1]);
            }
          }
#pragma unroll
          for (int u = 0; u < kHalfPT; ++u)
            if (p0 + u < NPT) mma_tf32_m16n8k8(acc[p0 + u], alo, bhi[u]);
#pragma unroll
          for (int u = 0; u < kHalfPT; ++u)
            if (p0 + u < NPT) mma_tf32_m16n8k8(acc[p0 + u], ahi, blo[u]);
#pragma unroll
          for (int u = 0; u < kHalfPT; ++u)
            if (p0 + u < NPT) mma_tf32_m16n8k8(acc[p0 + u], ahi, bhi[u]);
        }
      }
    }
    __syncthreads();                       // every warp is done with buf
    if (tj + 2 <= ti) {
      const int j2 = (tj + 2) * kT;
      stage_rows(Bs + buf * kT * CS, CS, bc + (size_t)j2 * N, N, L - j2, kT,
                 N, vec);
      stage_rows(Xs + buf * kT * XS, XS, xc + j2 * xstride, xstride, L - j2,
                 kT, P, vec);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();                      // no copy outlives the block

  // group 1 adds the incoming state's term exp(cum_i) C_i . S to its sum
  // and leaves it in shared memory (the B/X ring, free now); group 0 adds
  // it to its own and writes the rows
  if (grp == 1 && rows_live) {
    const float din[2] = {expf(cum[ra]), expf(cum[rb])};
#pragma unroll
    for (int p0 = 0; p0 < kMaxPT; p0 += kHalfPT) {
      if (p0 >= NPT) break;
      float off[kHalfPT][4];
#pragma unroll
      for (int u = 0; u < kHalfPT; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) off[u][e] = 0.f;
      for (int kk = 0; kk < NKN; ++kk) {
        uint32_t ahi[4], alo[4];
        const float* ca = Cs + (wr0 + g) * CS + kk * 8 + t;
        split_tf32_trunc(ca[0], ahi[0], alo[0]);
        split_tf32_trunc(ca[8 * CS], ahi[1], alo[1]);
        split_tf32_trunc(ca[4], ahi[2], alo[2]);
        split_tf32_trunc(ca[8 * CS + 4], ahi[3], alo[3]);
        uint32_t bhi[kHalfPT][2], blo[kHalfPT][2];
#pragma unroll
        for (int u = 0; u < kHalfPT; ++u) {
          if (p0 + u < NPT) {
            const float* sa = Ss + ((p0 + u) * 8 + g) * CS + kk * 8 + t;
            split_tf32_trunc(sa[0], bhi[u][0], blo[u][0]);     // S[p g][n t]
            split_tf32_trunc(sa[4], bhi[u][1], blo[u][1]);     // S[p g][n t + 4]
          }
        }
#pragma unroll
        for (int u = 0; u < kHalfPT; ++u)
          if (p0 + u < NPT) mma_tf32_m16n8k8(off[u], alo, bhi[u]);
#pragma unroll
        for (int u = 0; u < kHalfPT; ++u)
          if (p0 + u < NPT) mma_tf32_m16n8k8(off[u], ahi, blo[u]);
#pragma unroll
        for (int u = 0; u < kHalfPT; ++u)
          if (p0 + u < NPT) mma_tf32_m16n8k8(off[u], ahi, bhi[u]);
      }
#pragma unroll
      for (int u = 0; u < kHalfPT; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (p0 + u < NPT) acc[p0 + u][e] += din[e >> 1] * off[u][e];
    }
  }
  float* xs = Bs + (size_t)(warp % kRowWarps) * NPT * 4 * 32 + lane;
  if (grp == 1) {
#pragma unroll
    for (int pt = 0; pt < kMaxPT; ++pt)
      if (pt < NPT)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(pt * 4 + e) * 32] = acc[pt][e];
  }
  __syncthreads();
  if (grp == 1 || !rows_live) return;
#pragma unroll
  for (int pt = 0; pt < kMaxPT; ++pt) {
    if (pt >= NPT) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? ra : rb;
      if (i < L)
        y[((bs + c0 + i) * H + h) * P + pt * 8 + 2 * t + (e & 1)] =
            acc[pt][e] + xs[(pt * 4 + e) * 32];
    }
  }
}

template <int P8, int N8>
int run(const float* x, const float* dt, const float* A, const float* Bm,
        const float* Cm, const float* init, float* y, float* fin, float* ws,
        int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int T = padded_chunk(Q) / kT;              // 64-row tiles per chunk
  float* states = ws;                              // (B, nc, T, H, P, N)
  float* clast = ws + (size_t)B * nc * T * H * P * N;   // (B, nc, H)
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(Cm) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  cudaError_t err;
  if (nc > 0) {
    const size_t smem = state_smem_bytes(P, N, Q);
    err = cudaFuncSetAttribute(ssd_state_kernel<P8, N8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(nc * T, H, B);
    ssd_state_kernel<P8, N8><<<grid, kThreads, smem, stream>>>(
        x, dt, A, Bm, states, clast, S, H, P, N, Q, nc, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 pass_grid((P * N + kThreads - 1) / kThreads, H, B);
  ssd_state_pass_kernel<<<pass_grid, kThreads, 0, stream>>>(
      init, states, clast, fin, S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return (int)err;
  const size_t smem = output_smem_bytes(P, N, Q);
  err = cudaFuncSetAttribute(ssd_output_kernel<P8, N8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, T * nc, B);
  ssd_output_kernel<P8, N8><<<grid, kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, states, y, S, H, P, N, Q, nc, vec);
  return (int)cudaGetLastError();
}

// Mamba2's p = 64 at n = 64 (zamba2) and n = 128 take kernels compiled for
// those shapes (loops of fixed length, no run-time guards); other multiples
// of 8 take the same code with p and n read at run time.
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* init, float* y, float* fin,
           float* ws, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  if (P == 64 && N == 64)
    return run<8, 8>(x, dt, A, Bm, Cm, init, y, fin, ws, B, S, H, P, N, Q,
                     stream);
  if (P == 64 && N == 128)
    return run<8, 16>(x, dt, A, Bm, Cm, init, y, fin, ws, B, S, H, P, N, Q,
                      stream);
  return run<0, 0>(x, dt, A, Bm, Cm, init, y, fin, ws, B, S, H, P, N, Q,
                   stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA-core kernel: p or n not a multiple of 8
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kT = 64;                    // rows per tile
constexpr int kThreads = 256;             // 16 x 16
constexpr int kMaxP = 64;                 // head dim (4 x 16 per thread)
constexpr int kMaxN = 128;                // state dim (8 x 16 per thread)

size_t smem_floats(int P, int N, int Q) {
  return (size_t)P * (N + 1)              // state
         + 2 * (size_t)kT * (N + 1)       // C rows, B rows
         + (size_t)kT * P                 // u rows
         + (size_t)kT * (kT + 1)          // weight tile
         + 2 * (size_t)Q;                 // cum, dt (then the state decay)
}

__global__ void __launch_bounds__(kThreads)
ssd_simt_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ fin, int S, int H,
                int P, int N, int Q) {
  extern __shared__ float smem[];
  float* st = smem;                        // [P][N + 1]
  float* Cs = st + P * (N + 1);            // [kT][N + 1]
  float* Bs = Cs + kT * (N + 1);           // [kT][N + 1]
  float* Us = Bs + kT * (N + 1);           // [kT][P]
  float* Ws = Us + kT * P;                 // [kT][kT + 1]
  float* cum = Ws + kT * (kT + 1);         // [Q]
  float* dts = cum + Q;                    // [Q]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float a_h = A[h];
  const size_t bs = (size_t)b * S;

  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N;
    const int nn = e - pp * N;
    st[pp * (N + 1) + nn] =
        init ? init[(((size_t)b * H + h) * P + pp) * N + nn] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);          // real steps in this chunk
    for (int t = tid; t < Q; t += kThreads)
      dts[t] = t < L ? dt[(bs + c0 + t) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) {
      // inclusive cumsum of dt * A over the chunk: each lane sums a run of
      // consecutive steps in double, then the lanes' totals are scanned
      const int per = (Q + 31) / 32;
      const int t0 = tid * per;
      double run = 0.0;
      for (int t = t0; t < min(t0 + per, Q); ++t)
        run += (double)(dts[t] * a_h);
      double incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const double other = __shfl_up_sync(kFull, incl, o);
        if (tid >= o) incl += other;
      }
      double acc = incl - run;             // exclusive prefix of this run
      for (int t = t0; t < min(t0 + per, Q); ++t) {
        acc += (double)(dts[t] * a_h);
        cum[t] = (float)acc;
      }
    }
    __syncthreads();

    const int ntiles = (L + kT - 1) / kT;
    for (int ti = 0; ti < ntiles; ++ti) {
      const int i0 = ti * kT;
      __syncthreads();                     // last tile's readers of Cs done
      for (int e = tid; e < kT * N; e += kThreads) {
        const int i = e / N;
        const int nn = e - i * N;
        Cs[i * (N + 1) + nn] =
            i0 + i < L ? Cm[(bs + c0 + i0 + i) * N + nn] : 0.f;
      }
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

      for (int tj = 0; tj <= ti; ++tj) {
        const int j0 = tj * kT;
        __syncthreads();                   // last users of Bs/Us/Ws done
        for (int e = tid; e < kT * N; e += kThreads) {
          const int j = e / N;
          const int nn = e - j * N;
          Bs[j * (N + 1) + nn] =
              j0 + j < L ? Bm[(bs + c0 + j0 + j) * N + nn] : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int j = e / P;
          const int pp = e - j * P;
          Us[e] = j0 + j < L
                      ? x[((bs + c0 + j0 + j) * H + h) * P + pp] * dts[j0 + j]
                      : 0.f;
        }
        __syncthreads();
        // weight tile: W_ij = (C_i . B_j) exp(cum_i - cum_j), j <= i
        float dot[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[a][c] = 0.f;
        for (int nn = 0; nn < N; ++nn) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * (N + 1) + nn];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * (N + 1) + nn];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[a][c] = fmaf(cv[a], bv[c], dot[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx + 16 * c;
            const bool live = i0 + i < L && j0 + j <= i0 + i;
            Ws[i * (kT + 1) + j] =
                live ? dot[a][c] * expf(cum[i0 + i] - cum[j0 + j]) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          float u[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int pp = tx + 16 * c;
            u[c] = pp < P ? Us[j * P + pp] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = Ws[(ty + 16 * a) * (kT + 1) + j];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(w, u[c], acc[a][c]);
          }
        }
      }

      // the incoming state's term, then write the tile's outputs
      float cs[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) cs[a][c] = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * (N + 1) + nn];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx + 16 * c;
          sv[c] = pp < P ? st[pp * (N + 1) + nn] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) cs[a][c] = fmaf(cv[a], sv[c], cs[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i0 + i >= L) continue;
        const float din = expf(cum[i0 + i]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx + 16 * c;
          if (pp < P)
            y[((bs + c0 + i0 + i) * H + h) * P + pp] =
                acc[a][c] + din * cs[a][c];
        }
      }
    }

    // state update: S <- exp(cum_last) S + sum_j exp(cum_last - cum_j) u_j B_j
    const float last = cum[L - 1];
    __syncthreads();                       // every reader of st / dts done
    for (int t = tid; t < Q; t += kThreads)
      dts[t] = t < L ? expf(last - cum[t]) : 0.f;   // now the state decay
    const float chunk_decay = expf(last);
    float ns[4][kMaxN / 16];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int pp = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < kMaxN / 16; ++c) {
        const int nn = tx + 16 * c;
        ns[a][c] = (pp < P && nn < N) ? st[pp * (N + 1) + nn] * chunk_decay
                                      : 0.f;
      }
    }
    for (int tj = 0; tj < ntiles; ++tj) {
      const int j0 = tj * kT;
      __syncthreads();
      for (int e = tid; e < kT * N; e += kThreads) {
        const int j = e / N;
        const int nn = e - j * N;
        Bs[j * (N + 1) + nn] =
            j0 + j < L ? Bm[(bs + c0 + j0 + j) * N + nn] : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int j = e / P;
        const int pp = e - j * P;
        Us[e] = j0 + j < L ? x[((bs + c0 + j0 + j) * H + h) * P + pp] *
                                 (dt[(bs + c0 + j0 + j) * H + h]) *
                                 dts[j0 + j]
                           : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        float bv[kMaxN / 16];
#pragma unroll
        for (int c = 0; c < kMaxN / 16; ++c) {
          const int nn = tx + 16 * c;
          bv[c] = nn < N ? Bs[j * (N + 1) + nn] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int pp = ty + 16 * a;
          const float uw = pp < P ? Us[j * P + pp] : 0.f;
#pragma unroll
          for (int c = 0; c < kMaxN / 16; ++c)
            ns[a][c] = fmaf(uw, bv[c], ns[a][c]);
        }
      }
    }
    __syncthreads();                       // last reads of st above
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int pp = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < kMaxN / 16; ++c) {
        const int nn = tx + 16 * c;
        if (pp < P && nn < N) st[pp * (N + 1) + nn] = ns[a][c];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N;
    const int nn = e - pp * N;
    fin[(((size_t)b * H + h) * P + pp) * N + nn] = st[pp * (N + 1) + nn];
  }
}


}  // namespace simt

}  // namespace

// x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N) f32, init
// (B, H, P, N) f32 or null (zeros) -> y (B, S, H, P), fin (B, H, P, N).
// ws: B * nc * H * (T * P * N + 1) floats (nc = ceil(S / Q), T =
// ceil(Q / 64)) for the tensor-core path, which takes p % 8 == 0 and n % 8 == 0; unused (may be
// null) by the CUDA-core kernel, which takes the other shapes.
extern "C" int vpaas_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* init,
                              void* y, void* fin, void* ws, int B, int S,
                              int H, int P, int N, int Q, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (P <= 0 || P > simt::kMaxP || N <= 0 || N > simt::kMaxN || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* initf = static_cast<const float*>(init);
  float* yf = static_cast<float*>(y);
  float* finf = static_cast<float*>(fin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 8 == 0 && N % 8 == 0)
    return tc::launch(xf, dtf, Af, Bf, Cf, initf, yf, finf,
                      static_cast<float*>(ws), B, S, H, P, N, Q, st);
  const size_t smem = sizeof(float) * simt::smem_floats(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      simt::ssd_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  simt::ssd_simt_kernel<<<dim3(H, B), simt::kThreads, smem, st>>>(
      xf, dtf, Af, Bf, Cf, initf, yf, finf, S, H, P, N, Q);
  return (int)cudaGetLastError();
}
