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
// What bounds it on the card: at the LLM path's prefill (zamba2: 112 heads,
// p = n = 64, Q = 256, s = 384) the intra-chunk products cost ~2 GFLOP of
// fp32 against ~26 MB of x, y, B, C and states, so operations bound it
// (~35 us at 67 TFLOP/s).  The design: one block per (head, batch row),
// 256 threads walking the chunks in order with the state in shared memory
// (p x (n+1) floats).  The (Q, Q) decay matrix (256 KB at Q = 256) is never
// staged: for each 64-row output tile and each 64-column source tile at or
// below it, the block forms the 64 x 64 weight tile
// W_ij = (C_i . B_j) exp(cum_i - cum_j) on the fly in shared memory and
// accumulates W @ U into a 4 x 4 register tile per thread; tiles above the
// diagonal are skipped.  CUDA cores only (no tensor cores yet): a later
// PR's work, as is more than one block per head for short sequences.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;                    // rows per tile
constexpr int kThreads = 256;             // 16 x 16
constexpr int kMaxP = 64;                 // head dim (4 x 16 per thread)
constexpr int kMaxN = 128;                // state dim (8 x 16 per thread)
constexpr unsigned kFull = 0xffffffffu;

size_t smem_floats(int P, int N, int Q) {
  return (size_t)P * (N + 1)              // state
         + 2 * (size_t)kT * (N + 1)       // C rows, B rows
         + (size_t)kT * P                 // u rows
         + (size_t)kT * (kT + 1)          // weight tile
         + 2 * (size_t)Q;                 // cum, dt (then the state decay)
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
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

}  // namespace

// x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N) f32, init
// (B, H, P, N) f32 or null (zeros) -> y (B, S, H, P), fin (B, H, P, N).
extern "C" int vpaas_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* init,
                              void* y, void* fin, int B, int S, int H, int P,
                              int N, int Q, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (P <= 0 || P > kMaxP || N <= 0 || N > kMaxN || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(fin), S, H, P, N, Q);
  return (int)cudaGetLastError();
}
