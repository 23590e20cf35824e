// Greedy non-maximum suppression over a given IoU matrix, hand-written for
// Hopper (sm_90a): the second half of repro_torch.kernels.ops.nms_mask, after
// K4a (csrc/iou_filter.cu) has written the matrix.
//
// It replaces no Pallas kernel.  The JAX package runs the greedy loop as one
// jax.lax.fori_loop (src/repro/kernels/ref.py:293 nms_mask), which XLA
// compiles into a single loop on the device; the port's plain version
// (kernels/ref.py nms_greedy) is an eager loop of N steps of ~10 ops each.
//
// The loop, per frame: alive = valid; a step selects the first index of the
// maximum of where(alive, score, -1e30), a NaN counting as the maximum; if
// that maximum is not > -1e30 nothing changes from then on; else the index
// is kept and alive[j] cleared wherever iou[idx, j] >= thr or j == idx.
// So, as this kernel computes it:
//   - a valid NaN score is selected at the first step and ends the frame:
//     nothing is kept;
//   - otherwise the steps select the candidates (valid, score > -1e30) in
//     the order (score descending, index ascending; -0.0 ties 0.0), each
//     kept unless the row of a candidate kept before it reaches thr at it;
//   - a NaN IoU never reaches thr (the comparison is made in float32).
//
// What bounds it: the bytes are the candidate rows of the matrix (4N bytes
// each, at most 8.4 MB at F = 32, N = 256: 2.5 us at 3.35 TB/s), but a
// frame's keeps are a dependent chain, one decision per candidate, and a
// frame is one block, so the rows stream into one SM.  The design, one
// block of 16 warps per frame:
//   1. Candidates: each thread tests its boxes, flags a valid NaN score,
//      marks the candidates alive (a bit each, shared atomicOr) and
//      compacts their keys (the score's bits made orderable, descending,
//      then the index) with a warp ballot, __popc offsets and one shared
//      atomic a warp.  Non-candidates are written 0 here.
//   2. Ranks: a candidate's rank is the number of keys below its own (the
//      keys are distinct), so order[rank] lists the candidates in the
//      loop's order without a sort.
//   3. Bit rows: each candidate's row as bits (iou >= thr).  A warp takes
//      eight rows and reads 128 columns of each at a time, one coalesced
//      float4 a lane (where N % 4 == 0), eight loads in flight, then four
//      ballots a row.  Column c is bit (c / 4) % 32 of word 4 (c / 128) +
//      c % 4.
//   4. Diagonal words: for each rank p, the bits of its row at the ranks
//      after it in its own group of 32.
//   5. The sweep, one warp, 32 ranks at a time: the group's alive ranks by
//      a ballot over the alive bits, the 32 diagonal words broadcast by
//      shuffles, then a 32-step chain in registers (keep rank b if still
//      alive, then clear what its row reaches in the group); the keeps'
//      rows then clear the alive bits of every later column by one warp
//      OR-reduction (redux.sync) a word.  The chain stops after the last
//      candidate: the loop's first step with nothing left to select.
//   6. keep[order[rank]] = the rank's bit.
// The bit rows lie in shared memory up to N = kSharedN (~14 KB at
// N = 256); past it they go to a global workspace the wrapper allocates,
// read through L1, in the same passes.
#include <cuda_runtime.h>
#include <stdint.h>

// The launcher's sizes and threshold (kernels/nms.py's NmsArgs mirrors it).
struct VpaasNmsArgs {
  int F, N;             // frames, boxes a frame
  float iou_threshold;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;               // rows a warp reads at once
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e30f;          // the plain loop's NEG_INF
constexpr int kSharedN = 512;           // kernels/nms.py SHARED_N
constexpr int kMaxN = 2048;             // kernels/nms.py MAX_N

__host__ __device__ constexpr int words(int n) { return (n + 31) / 32; }
// a bit row's words: four per 128 columns
__host__ __device__ constexpr int row_words(int n) {
  return 4 * ((n + 127) / 128);
}
// a bit row's stride: odd, so 32 consecutive ranks read one word of their
// rows on 32 banks
__host__ __device__ constexpr int bit_stride(int n) {
  return row_words(n) | 1;
}
// keys, order, diagonal words, alive and keep words, two counters
__host__ __device__ constexpr size_t base_bytes(int n) {
  return 16 * (size_t)n + 4 * (size_t)(row_words(n) + words(n)) + 8;
}
// the bit rows of a frame, in 32-bit words
__host__ __device__ constexpr size_t frame_words(int n) {
  return (size_t)n * bit_stride(n);
}
static_assert(base_bytes(kSharedN) + 4 * frame_words(kSharedN) <= 48 * 1024,
              "the rows of N = kSharedN fit the default shared memory");
static_assert(base_bytes(kMaxN) <= 48 * 1024,
              "the keys of N = kMaxN fit the default shared memory");

// column c's word and bit in a bit row
__device__ __forceinline__ int col_word(int c) { return 4 * (c >> 7) + (c & 3); }
__device__ __forceinline__ int col_bit(int c) { return (c >> 2) & 31; }

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float* __restrict__ iou,
                  const float* __restrict__ score,
                  const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, uint32_t* __restrict__ workspace,
                  const VpaasNmsArgs a) {
  extern __shared__ uint64_t smem[];
  const int n = a.N, nrw = row_words(n), stride = bit_stride(n);
  const float thr = a.iou_threshold;
  uint64_t* s_key = smem;
  int* s_order = reinterpret_cast<int*>(s_key + n);
  uint32_t* s_diag = reinterpret_cast<uint32_t*>(s_order + n);
  uint32_t* s_alive = s_diag + n;       // over the original columns
  uint32_t* s_keep = s_alive + nrw;     // over the ranks
  int* s_count = reinterpret_cast<int*>(s_keep + words(n));  // cands, NaN
  uint32_t* bits = workspace != nullptr
      ? workspace + blockIdx.x * frame_words(n)
      : reinterpret_cast<uint32_t*>(s_count + 2);

  const size_t f = blockIdx.x;
  const float* sc = score + f * n;
  const uint8_t* va = valid + f * n;
  uint8_t* kp = keep + f * n;
  const float* m = iou + f * n * (size_t)n;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;

  for (int w = t; w < nrw; w += kThreads) s_alive[w] = 0;
  if (t < 2) s_count[t] = 0;
  __syncthreads();
  // 1. candidates
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + t;
    bool cand = false;
    uint64_t key = 0;
    if (j < n) {
      const float s = sc[j];
      const bool v = va[j];
      if (v && s != s) s_count[1] = 1;
      cand = v && s > kNeg;
      if (cand) atomicOr(&s_alive[col_word(j)], 1u << col_bit(j));
      else kp[j] = 0;
      // the score's bits, ascending with it (-0.0 as 0.0), then inverted:
      // the smallest key is the highest score, the lowest index on a tie
      uint32_t u = s == 0.f ? 0u : __float_as_uint(s);
      u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      key = (uint64_t)~u << 32 | (uint32_t)j;
    }
    const unsigned votes = __ballot_sync(kAll, cand);
    int base = 0;
    if (lane == 0 && votes) base = atomicAdd(&s_count[0], __popc(votes));
    base = __shfl_sync(kAll, base, 0);
    if (cand) s_key[base + __popc(votes & ((1u << lane) - 1u))] = key;
  }
  __syncthreads();
  const int c = s_count[0];
  if (s_count[1]) {               // a valid NaN score: the loop keeps nothing
    for (int j = t; j < n; j += kThreads) kp[j] = 0;
    return;
  }

  // 2. ranks
  for (int k = t; k < c; k += kThreads) {
    const uint64_t key = s_key[k];
    int r = 0;
#pragma unroll 8
    for (int i = 0; i < c; ++i) r += s_key[i] < key;
    s_order[r] = (int)(uint32_t)key;
  }
  __syncthreads();

  // 3. bit rows of the candidates, rank p's at bits[p * stride]: a warp
  // takes kBatch rows and reads 128 columns of each at a time, a float4 a
  // lane; every load is unconditional (a row or column past the end reads
  // a valid address, and its bits are masked), so all kBatch are in
  // flight before the first ballot
  const bool vec = n % 4 == 0;
  for (int p0 = warp * kBatch; p0 < c; p0 += kWarps * kBatch) {
    const float* rows[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      rows[k] = m + (size_t)s_order[min(p0 + k, c - 1)] * n;
    for (int col0 = 0; col0 < n; col0 += 128) {
      const int col = col0 + 4 * lane;
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float* r = rows[k];
        v[k] = vec ? *reinterpret_cast<const float4*>(r + min(col, n - 4))
                   : make_float4(r[min(col, n - 1)], r[min(col + 1, n - 1)],
                                 r[min(col + 2, n - 1)],
                                 r[min(col + 3, n - 1)]);
      }
      uint32_t* out = bits + (size_t)p0 * stride + col0 / 32 + lane;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (p0 + k >= c) break;                 // the same in every lane
        const unsigned b0 = __ballot_sync(kAll, col < n && v[k].x >= thr);
        const unsigned b1 = __ballot_sync(kAll, col + 1 < n && v[k].y >= thr);
        const unsigned b2 = __ballot_sync(kAll, col + 2 < n && v[k].z >= thr);
        const unsigned b3 = __ballot_sync(kAll, col + 3 < n && v[k].w >= thr);
        if (lane < 4)
          out[(size_t)k * stride] =
              lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2 : b3;
      }
    }
  }
  __syncthreads();

  // 4. diagonal words: bit b of rank p's is whether its row reaches thr at
  // rank 32 (p / 32) + b > p (a warp's ranks read one order[] entry)
  for (int p = t; p < c; p += kThreads) {
    const int q0 = p & ~31, qn = min(32, c - q0);
    const uint32_t* brow = bits + (size_t)p * stride;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int o = s_order[min(q0 + b, c - 1)];
      word |= (brow[col_word(o)] >> col_bit(o) & 1u) << b;
    }
    const int after = p - q0 + 1;             // 1..32
    word &= after == 32 ? 0u : kAll << after;
    word &= qn == 32 ? kAll : (1u << qn) - 1u;
    s_diag[p] = word;
  }
  __syncthreads();

  // 5. the sweep, 32 ranks at a time; s_keep[w] becomes group w's keeps
  if (warp == 0) {
    for (int w = 0; w < words(c); ++w) {
      const int p = 32 * w + lane;
      const bool in = p < c;
      const int o = in ? s_order[p] : 0;
      const uint32_t d = in ? s_diag[p] : 0u;
      uint32_t alive = __ballot_sync(
          kAll, in && (s_alive[col_word(o)] >> col_bit(o) & 1u));
      uint32_t db[32];
#pragma unroll
      for (int b = 0; b < 32; ++b) db[b] = __shfl_sync(kAll, d, b);
      // rank b is kept if still alive; its row then clears the group's
      // later ranks
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (alive >> b & 1u) alive &= ~db[b];
      if (lane == 0) s_keep[w] = alive;
      // the keeps' rows clear every column they reach, 8 words at a time
      const bool kept = alive >> lane & 1u;
      const uint32_t* brow = bits + (size_t)p * stride;
      for (int v0 = 0; v0 < nrw; v0 += 8) {
        uint32_t r[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          r[k] = kept && v0 + k < nrw ? brow[v0 + k] : 0u;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t hit = __reduce_or_sync(kAll, r[k]);
          if (lane == (v0 + k) % 32 && v0 + k < nrw) s_alive[v0 + k] &= ~hit;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 6. the candidates' keeps
  for (int p = t; p < c; p += kThreads)
    kp[s_order[p]] = s_keep[p >> 5] >> (p & 31) & 1u;
}

}  // namespace

// iou (F, N, N) f32, scores (F, N) f32, valid (F, N) bool -> keep (F, N)
// bool; workspace: F * frame_words(N) 32-bit words where N > kSharedN,
// else null.
extern "C" int vpaas_nms_greedy(const void* iou, const void* scores,
                                const void* valid, void* keep,
                                void* workspace, const VpaasNmsArgs* a,
                                void* stream) {
  if (a->F == 0 || a->N == 0) return 0;
  if (a->N > kMaxN || (a->N > kSharedN) != (workspace != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = base_bytes(a->N) +
                      (workspace != nullptr ? 0 : 4 * frame_words(a->N));
  nms_greedy_kernel<<<a->F, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
      static_cast<uint32_t*>(workspace), *a);
  return static_cast<int>(cudaGetLastError());
}
