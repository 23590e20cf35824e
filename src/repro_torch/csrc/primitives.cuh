// Tensor-core and asynchronous-copy primitives for sm_80 and later, as thin
// wrappers over one PTX instruction each.
//
// mma_tf32_m16n8k8: D += A (16x8, row) * B (8x8, col), tf32 in, fp32
// accumulate.  Per lane (group g = lane / 4, thread t = lane % 4), from the
// PTX ISA's fragment layout for mma.m16n8k8 .tf32:
//   a[0] A[g][t]      a[1] A[g+8][t]    a[2] A[g][t+4]    a[3] A[g+8][t+4]
//   b[0] B[t][g]      b[1] B[t+4][g]
//   d[0] D[g][2t]     d[1] D[g][2t+1]   d[2] D[g+8][2t]   d[3] D[g+8][2t+1]
// The tensor core reads only the tf32 bits (sign, 8 exponent bits, the top
// 10 mantissa bits) of each operand.
//
// tf32_rna: cvt.rna.tf32.f32, fp32 -> tf32 rounded to nearest, ties away
// from zero, as a float bit pattern with the low 13 mantissa bits zero.
// split_tf32: x as hi = tf32(x) and lo = tf32(x - hi), the two halves of
// 3xTF32 (a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b,
// about as accurate as an fp32 FMA; the dropped lo_a lo_b is ~2^-22 |a b|).
// split_tf32_trunc: the same halves without rounding: hi is x itself,
// which the tensor core truncates to its tf32 bits, and lo = x - trunc(x)
// is exact in fp32 (and truncated in turn); two instructions instead of
// three, at ~3 x 2^-20 |a b| of error per product instead of ~2^-22.
//
// cp_async_16 / cp_async_4: cp.async of 16 or 4 bytes from global to shared
// memory; with ``pred`` false nothing is read and the destination is filled
// with zeros (src-size 0).  16-byte copies need 16-byte aligned addresses.
// cp_async_commit closes a group of copies, cp_async_wait<N> waits until at
// most N groups are still in flight (the caller then needs __syncthreads
// before other threads read what this thread copied).
//
// mma_bf16_m16n8k16: D += A (16x16, row) * B (16x8, col), bf16 in, fp32
// accumulate.  Each 32-bit register holds two bf16 values, the lower index
// in the low half.  Per lane (g = lane / 4, t = lane % 4), from the PTX
// ISA's fragment layout for mma.m16n8k16 .bf16:
//   a[0] A[g][2t, 2t+1]      a[1] A[g+8][2t, 2t+1]
//   a[2] A[g][2t+8, 2t+9]    a[3] A[g+8][2t+8, 2t+9]
//   b[0] B[2t, 2t+1][g]      b[1] B[2t+8, 2t+9][g]
//   d as for m16n8k8 above.
// The product of two bf16 values is exact in fp32.
//
// to_f32 / from_f32<T>: a float or __nv_bfloat16 element as float, and a
// float as T (bf16: rounded to nearest even, as torch's and XLA's casts
// do).  pack_bf16x2(lo, hi): two floats rounded to bf16 in one register,
// lo in the low half, by one conversion instruction.  The kernels that take bf16 operands are templates
// over the element type T and read and write their operands only through
// these.
//
// split_bf16x2(x0, x1, hi, lo): two floats as bf16 pairs hi = bf16(x) and
// lo = bf16(x - hi): a product P V taken as hi V + lo V keeps about 16 bits
// of each p, where one bf16 would keep 8.  hi is rounded to nearest (one
// packed conversion a pair), lo, below half an ulp of hi, is cut to its
// upper 16 bits (one byte permute): p keeps ~16 bits, within 2^-16 of
// itself.
//
// ldsm_x4(r, p) / ldsm_x4_trans(r, p): ldmatrix.sync.aligned.m8n8.x4 of
// four 8 x 8 b16 matrices from shared memory.  Lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes); r[i] receives matrix
// i's row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (the A/B fragment
// layout of mma.m16n8k16), or with .trans its column l / 4, rows 2 (l % 4)
// and 2 (l % 4) + 1 (the B fragment of a row-major K x N operand).
//
// fmin_nan / fmax_nan: min.NaN.f32 / max.NaN.f32 (sm_80 and later), the
// smaller or larger operand, or a NaN when either operand is NaN: the
// semantics of torch.minimum / torch.maximum / clamp_min and of
// jnp.minimum / jnp.maximum.  fminf / fmaxf (min.f32 / max.f32) return the
// other operand instead; on operands without a NaN the two give the same
// bits.
//
// Hopper (sm_90a) primitives of the bf16 flash attention kernel:
//
// smem_u32(p): the shared-window address of a generic pointer into shared
// memory (what every PTX operand below that names shared memory takes).
//
// mbar_*: an mbarrier, 8 bytes of shared memory.  mbar_init(bar, n) arms it
// for n arrivals (one thread, then mbar_init_fence and __syncthreads);
// mbar_arrive counts one; mbar_arrive_expect_tx counts one and adds bytes
// that asynchronous copies must still deliver.  A phase completes when its
// arrivals are in and its bytes delivered; mbar_wait(bar, parity) returns
// once the phase of that parity has completed (the phase before the first
// counts as complete for parity 1, so a producer's first wait on an empty
// slot passes).
//
// tma_load_4d(dst, map, bar, c0..c3): cp.async.bulk.tensor of one box of a
// 4-d tensor map (built on the host by cuTensorMapEncodeTiled) at element
// coordinates c0..c3, innermost first, into shared memory at dst (1024-byte
// aligned for the 128-byte swizzle); elements outside the tensor are
// zeros; the box's bytes are delivered to bar.  With the 128-byte swizzle
// a box row is 128 bytes, stored with its 16-byte chunk c at chunk
// c ^ (row % 8): the address bits [4, 7) are XORed with bits [7, 10).
//
// wgmma_desc(p, lbo, sbo): a wgmma shared-memory matrix descriptor for the
// 128-byte swizzle: start address p, leading and stride byte offsets.  The
// tensor core reads the unswizzled address it computes through the same
// XOR, so a K-major operand (rows of 128 bytes, 8-row groups sbo apart)
// advances along K by adding bytes to p within a row, and an MN-major one
// (B[k][n] at k's 128-byte row, n's 64-element block lbo apart, 8-row k
// groups sbo apart) advances along K by whole rows.
//
// wgmma_m64n96k16_ss(d, da, db, acc): D (64 x 96, fp32) = A (64 x 16,
// bf16, K-major, descriptor da) * B (16 x 96, bf16, stored as B^T:
// K-major, descriptor db), plus D if acc; wgmma_m64n64k16_ss the same
// with N = 64.  wgmma_m64nNk16_rs<N>(d, a, db): D (64 x N) += A
// (registers) * B (descriptor, MN-major: the transposed-B bit), N = 32,
// 64, 96, 112, 128 or 256 (past 64, B's next 64-column block is lbo bytes
// on: N = 256 reads four).  wgmma_m64n64k16_rs_k(d, a, db, acc): D = A
// (registers) * B (64 columns, descriptor, K-major, as the _ss forms read
// it), plus D if acc.
// Both are warpgroup-wide (4 warps) and asynchronous: wgmma_fence before
// the first of a batch (after the registers they read were written),
// wgmma_commit after it, wgmma_wait<0> before D is read; fence_regs (float
// or uint32_t registers) keeps the compiler from moving register reads and
// writes across those: a value fenced before a wait or a barrier is
// computed before it.  Per
// thread t of the warpgroup (warp w = t / 32, g = t % 32 / 4, q = t % 4):
//   d[4j + e]: D[16 w + g + 8 (e / 2)][8 j + 2 q + e % 2], j < N / 8
//   a[0] A[16 w + g][2q, 2q+1]      a[1] A[16 w + g + 8][2q, 2q+1]
//   a[2] A[16 w + g][2q+8, 2q+9]    a[3] A[16 w + g + 8][2q+8, 2q+9]
// (the accumulator of one 64 x 16 slice of D is the A fragment of the next
// product's 16-wide k step as it stands).
//
// ex2_approx: ex2.approx.ftz.f32, 2^x.  tanh_fast(y): 1 - 2 / (1 +
// e^(2y)) from ex2.approx and rcp.approx (two special-function operations
// where tanhf takes a longer sequence): within ~1e-7 of tanh(y) absolutely
// (the cancellation near 0 costs relative digits there, not absolute
// ones), +-1 at the ends.
//
// bar_sync(id, n): bar.sync on named barrier id (1-15; 0 is
// __syncthreads'), which completes once n threads (whole warps) have
// reached it: a group of warps meets without stopping the block's others.
//
// setmaxnreg_dec<N>() / setmaxnreg_inc<N>(): setmaxnreg.dec / .inc
// .sync.aligned (sm_90a), executed by every thread of a warpgroup: the
// warpgroup's registers a thread drop to N (returned to the block's pool)
// or rise to N (taken from it, waiting until they are free); N a multiple
// of 8 in [24, 256].
//
// bulk_load(dst, src, bytes, bar): cp.async.bulk of `bytes` contiguous
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, delivered to mbarrier bar (sm_90): one instruction a copy,
// no tensor map.  atomic_add_acq_rel_gpu(p, v): atomicAdd as
// atom.acq_rel.gpu: it releases the calling thread's earlier writes (and,
// after a __syncthreads, its block's, as a semaphore's release does) to the
// device, and acquires what other threads released before the value it
// reads.  fence_proxy_async_global: fence.proxy.async.global, which
// orders this thread's view of global memory (written by other blocks, made
// visible to it by fences and an atomic) before its bulk copies read it.
//
// tests/test_torch_kernel_emulation.py replaces this header with host
// versions of the same functions.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma_tf32_m16n8k8(float d[4],
                                                 const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16_m16n8k16(float d[4],
                                                  const uint32_t a[4],
                                                  const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x);
}

// one cvt.rn.bf16x2.f32 (its first source goes to the upper half)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the upper 16 bits of lo and of hi in one register (prmt): two floats
// cut to bf16 toward zero, lo's in the low half
__device__ __forceinline__ uint32_t upper_halves(float lo, float hi) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0x7632;"
      : "=r"(r)
      : "r"(__float_as_uint(lo)), "r"(__float_as_uint(hi)));
  return r;
}

__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  lo = upper_halves(x0 - __uint_as_float(hi << 16),
                    x1 - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float tanh_fast(float y) {
  return 1.f - 2.f * rcp_approx(1.f + ex2_approx(y * 2.8853900817779268f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// a wait of 2^35 cycles (~19 s) is a deadlock: trap, so that the launch
// fails with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ unsigned atomic_add_acq_rel_gpu(unsigned* p,
                                                           unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3ffffu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);                  // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define VPAAS_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_m64n96k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24),
        VPAAS_F8(d, 32), VPAAS_F8(d, 40)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs_k(float* d,
                                                     const uint32_t a[4],
                                                     uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_rs(float* d,
                                                  const uint32_t a[4],
                                                  uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs<32>(float* d,
                                                      const uint32_t a[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs<64>(float* d,
                                                      const uint32_t a[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs<96>(float* d,
                                                       const uint32_t a[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, "
      "1, 1, 1;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24),
        VPAAS_F8(d, 32), VPAAS_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs<112>(float* d,
                                                       const uint32_t a[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24),
        VPAAS_F8(d, 32), VPAAS_F8(d, 40), VPAAS_F8(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs<128>(float* d,
                                                       const uint32_t a[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24),
        VPAAS_F8(d, 32), VPAAS_F8(d, 40), VPAAS_F8(d, 48), VPAAS_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_rs<256>(float* d,
                                                       const uint32_t a[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, "
      "%131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : VPAAS_F8(d, 0), VPAAS_F8(d, 8), VPAAS_F8(d, 16), VPAAS_F8(d, 24),
        VPAAS_F8(d, 32), VPAAS_F8(d, 40), VPAAS_F8(d, 48), VPAAS_F8(d, 56),
        VPAAS_F8(d, 64), VPAAS_F8(d, 72), VPAAS_F8(d, 80), VPAAS_F8(d, 88),
        VPAAS_F8(d, 96), VPAAS_F8(d, 104), VPAAS_F8(d, 112), VPAAS_F8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef VPAAS_F8
