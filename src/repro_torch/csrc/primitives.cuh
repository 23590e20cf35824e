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
// tests/test_torch_kernel_emulation.py replaces this header with host
// versions of the same functions.
#pragma once
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
