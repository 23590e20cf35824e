"""The port's CUDA kernel sources, run on the CPU.

Each ``src/repro_torch/csrc/*.cu`` compiles with the host C++ compiler
against a small emulation of the CUDA runtime written below: a block's
threads run as fibers on one host thread, each running until it reaches
``__syncthreads``/``__syncwarp`` (so a thread that reads what a later
thread writes without a barrier between them reads it too early), warp
shuffles, votes and OR reductions go through a per-warp buffer, a shared
``atomicAdd`` or ``atomicOr`` is a plain read-modify-write (nothing
switches inside it), shared memory starts as NaNs (so
a read before a write shows), and each ``<<<...>>>`` launch becomes a call
that runs the grid's blocks, several host threads at a time. The
primitives of ``csrc/primitives.cuh`` have host versions here:
``mma.sync`` m16n8k8 tf32 and m16n8k16 bf16 gather the warp's fragments
through a per-warp buffer in the PTX ISA's layout and sum each output's
exact products in double, ``cvt.rna.tf32`` rounds the bits, bf16 is its
16 bits with round-to-nearest-even conversions, ``cp.async`` copies at once
(commit and wait do nothing), ``min.NaN``/``max.NaN`` return a NaN for a
NaN operand. The Python wrappers then call the C launchers exactly as on
the card, on CPU tensors, and the results are held against the plain
versions with the on-card tolerances. This checks each kernel's indexing,
masking and arithmetic here; what only ``nvcc`` and the card can show
(compile errors, registers, shared-memory limits, races between threads
that run at once, speed) stays with
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import crop_gather as cg
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import iou_filter as ik
from repro_torch.kernels import iou_matrix as im
from repro_torch.kernels import nms as nm
from repro_torch.kernels import onevsall as ov
from repro_torch.kernels import onevsall_update as ou
from repro_torch.kernels import region_filter_mask as rf
from repro_torch.kernels import ssd_scan as sk
from repro_torch.testing import (ATTN_ATOL, ATTN_BF16_RTOL, DECODE_CASES,
                                 DECODE_WIDE_CASES, FILTER_KW,
                                 FLASH_WIDE_CASES, SSD_BF16_RTOL,
                                 FLASH_CASES, FLASH_DV_CASES,
                                 FLASH_EDGE_CASES,
                                 FLASH_RAGGED_CASES, IOU_CASES,
                                 LEARN_RTOL, ONEVSALL_ATOL, SSD_CASES,
                                 SSD_RTOL, UPDATE_ETA, UPDATE_RTOL,
                                 attention_case, bf16_err, crop_cases,
                                 crop_tile_cases,
                                 decode_case, filter_case,
                                 filter_corner_cases, frame_filter_case,
                                 iou_case, iou_nan_case, nms_corner_cases,
                                 onevsall_case, rand_boxes, rel_err,
                                 ssd_case, update_case)

EMU_HEADER = r"""
#pragma once
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
using std::max; using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return float2{a, b}; }
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d}; }
// cuda_bf16.h: the bits of a bf16, float conversions rounded to nearest
// even (a NaN stays a quiet NaN), as the card's and torch's
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.x << 16; float f; std::memcpy(&f, &u, 4);
  return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return __nv_bfloat16{(uint16_t)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)}; }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
typedef int cudaError_t; typedef void* cudaStream_t; typedef void* cudaEvent_t;
// a launcher's timing events (csrc/host.cuh) record nothing here
inline int cudaEventRecord(cudaEvent_t, cudaStream_t) { return 0; }
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
template <class T> int cudaFuncSetAttribute(T*, int, int) { return 0; }
template <class T> T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
// ex2.approx of the rounded product, as the card computes __expf
inline float __expf(float x) { return std::exp2(x * 1.44269504f); }
[[noreturn]] inline void __trap() {
  std::fprintf(stderr, "kernel trapped\n"); std::abort(); }
// A block's threads are fibers on one host thread, switched only at the
// barriers (emu_swap saves the callee-saved registers and the stack
// pointer, x86-64 System V): a warp's 32 threads meet twice per emulated
// mma or shuffle, and an OS thread per GPU thread made each meeting a
// round of futex sleeps and wake-ups.  Independent blocks of a grid run on
// several host threads at once.
extern "C" void emu_swap(void** save_sp, void* new_sp);
asm(".text\n.p2align 4\n.globl emu_swap\n.hidden emu_swap\n"
    ".type emu_swap,@function\nemu_swap:\n"
    "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n"
    "  pushq %r14\n  pushq %r15\n  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n"
    "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n  popq %rbx\n"
    "  popq %rbp\n  ret\n.size emu_swap, .-emu_swap\n");
struct EmuFiber { void* sp = nullptr; std::unique_ptr<char[]> stack;
  const unsigned* wait_gen = nullptr; unsigned wait_val = 0; bool done = false; };
struct EmuWorker { void* sched_sp = nullptr; EmuFiber* cur = nullptr;
  const std::function<void()>* fn = nullptr; std::vector<EmuFiber> fibers; };
inline thread_local EmuWorker* emu_w;
struct EmuBarrier { int n; int count = 0; unsigned gen = 0;
  explicit EmuBarrier(int n) : n(n) {}
  void arrive_and_wait() {
    if (++count == n) { count = 0; ++gen; return; }
    EmuFiber* f = emu_w->cur; f->wait_gen = &gen; f->wait_val = gen;
    emu_swap(&f->sp, emu_w->sched_sp); } };
struct EmuBlock { EmuBarrier* bar;
  std::vector<std::unique_ptr<EmuBarrier>> warp_bar, wg_bar, named_bar;
  std::vector<double> xchg; std::vector<uint32_t> mma, wgx;
  std::vector<char> dyn; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local EmuBlock* emu_blk;
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_blk->warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
// bar.sync id, n: named barrier id of the block, completed by n threads
inline void bar_sync(int id, int n) {
  auto& bars = emu_blk->named_bar;
  if ((int)bars.size() <= id) bars.resize(id + 1);
  if (!bars[id]) bars[id].reset(new EmuBarrier(n));
  if (bars[id]->n != n) { std::fprintf(stderr, "named barrier %d: %d threads"
                          " then %d\n", id, bars[id]->n, n); std::abort(); }
  bars[id]->arrive_and_wait(); }
template <class T> T emu_xchg(T v, int src) {
  double* buf = emu_blk->xchg.data() + (threadIdx.x / 32) * 32;
  double d = 0; std::memcpy(&d, &v, sizeof(T)); buf[threadIdx.x % 32] = d;
  __syncwarp();
  double r = buf[src & 31]; T out; std::memcpy(&out, &r, sizeof(T));
  __syncwarp();
  return out; }
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
  return emu_xchg(v, (threadIdx.x % 32) ^ m); }
template <class T> T __shfl_sync(unsigned, T v, int s) {
  return emu_xchg(v, s); }
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  int s = (int)(threadIdx.x % 32) - d;
  T r = emu_xchg(v, s < 0 ? (int)(threadIdx.x % 32) : s);
  return s < 0 ? v : r; }
inline unsigned __ballot_sync(unsigned, int p) {
  double* buf = emu_blk->xchg.data() + (threadIdx.x / 32) * 32;
  buf[threadIdx.x % 32] = p ? 1.0 : 0.0;
  __syncwarp();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (buf[i] != 0.0 ? 1u : 0u) << i;
  __syncwarp();
  return r; }
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= emu_xchg(v, i);
  return r; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// a block's threads share a host thread and switch only at barriers, so a
// read-modify-write of shared memory is atomic as it stands; the blocks of
// a grid run on several host threads, so one of global memory is a host
// atomic (and a fence a host fence)
inline int atomicAdd(int* a, int v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* a, unsigned v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline unsigned atomic_add_acq_rel_gpu(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_ACQ_REL); }
template <class T> T __ldcg(const T* p) { return *p; }
inline unsigned atomicOr(unsigned* a, unsigned v) {
  unsigned old = *a; *a = old | v; return old; }
// a fiber that waits on an mbarrier gives the others a turn
inline void emu_yield() {
  EmuFiber* f = emu_w->cur; emu_swap(&f->sp, emu_w->sched_sp); }
inline void emu_fiber_main() {
  EmuWorker* w = emu_w; (*w->fn)(); w->cur->done = true;
  emu_swap(&w->cur->sp, w->sched_sp);
  __builtin_unreachable(); }
constexpr size_t kEmuStack = 128 << 10;
// Run one block: every fiber until it blocks at a barrier or ends, round
// and round; a round in which none can run is a deadlock.
inline void emu_run_block(EmuWorker& w, int nt) {
  for (int t = 0; t < nt; ++t) {
    EmuFiber& f = w.fibers[t];
    if (!f.stack) f.stack.reset(new char[kEmuStack]);
    uintptr_t top = (reinterpret_cast<uintptr_t>(f.stack.get()) + kEmuStack)
                    & ~uintptr_t(15);
    void** sp = reinterpret_cast<void**>(top);
    *--sp = nullptr;                       // entry sees rsp = 8 mod 16
    *--sp = reinterpret_cast<void*>(&emu_fiber_main);
    for (int r = 0; r < 6; ++r) *--sp = nullptr;
    f.sp = sp; f.wait_gen = nullptr; f.done = false; }
  for (int live = nt; live > 0;) {
    bool ran = false;
    for (int t = 0; t < nt; ++t) {
      EmuFiber& f = w.fibers[t];
      if (f.done || (f.wait_gen && *f.wait_gen == f.wait_val)) continue;
      f.wait_gen = nullptr; w.cur = &f; threadIdx = dim3(t);
      emu_swap(&w.sched_sp, f.sp);
      ran = true;
      if (f.done) --live; }
    if (!ran) { std::fprintf(stderr, "emulated block deadlocked\n");
                std::abort(); } } }
inline void emu_launch(dim3 g, dim3 b, size_t smem, std::function<void()> fn) {
  const int nt = b.x * b.y * b.z;
  const long nblocks = (long)g.x * g.y * g.z;
  std::atomic<long> next{0};
  auto work = [&] {
    EmuWorker w; w.fn = &fn; w.fibers.resize(nt); emu_w = &w;
    EmuBlock blk; EmuBarrier bar(nt); blk.bar = &bar;
    for (int i = 0; i < (nt + 31) / 32; ++i)
      blk.warp_bar.emplace_back(new EmuBarrier(32));
    for (int i = 0; i < (nt + 127) / 128; ++i)
      blk.wg_bar.emplace_back(new EmuBarrier(std::min(128, nt - 128 * i)));
    blk.wgx.assign(((nt + 127) / 128) * 128 * 4, 0u);
    blk.xchg.assign(((nt + 31) / 32) * 32, 0.0);
    blk.mma.assign(((nt + 31) / 32) * 32 * 6, 0u);
    blk.dyn.resize(smem + 16);
    blk.named_bar.clear();
    emu_blk = &blk; blockDim = b; gridDim = g;
    for (long i; (i = next++) < nblocks;) {
      float nan = NAN;
      for (size_t k = 0; k + 4 <= blk.dyn.size(); k += 4)
        std::memcpy(&blk.dyn[k], &nan, 4);
      blockIdx = dim3(i % g.x, i / g.x % g.y, i / ((long)g.x * g.y));
      emu_run_block(w, nt); } };
  const long nw = std::min<long>(nblocks, 8);
  std::vector<std::thread> ts;
  for (long i = 1; i < nw; ++i) ts.emplace_back(work);
  if (nblocks > 0) work();
  for (auto& th : ts) th.join(); }
#define EMU_DYN_SMEM(T, name) T* name = reinterpret_cast<T*>(emu_blk->dyn.data())
// csrc/primitives.cuh
inline float __uint_as_float(uint32_t u) {
  float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) {
  uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline uint32_t tf32_rna(float x) {       // round half away from zero
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;          // inf, nan
  return (u + 0x1000u) & 0xffffe000u; }
inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x); lo = tf32_rna(x - __uint_as_float(hi)); }
inline void split_tf32_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)); }
inline void mma_tf32_m16n8k8(float d[4], const uint32_t a[4],
                             const uint32_t b[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t* buf = emu_blk->mma.data() + (threadIdx.x / 32) * 32 * 6;
  for (int i = 0; i < 4; ++i) buf[lane * 6 + i] = a[i];
  buf[lane * 6 + 4] = b[0]; buf[lane * 6 + 5] = b[1];
  __syncwarp();
  // A[r][k] lives in lane (r % 8) * 4 + k % 4, register r / 8 + 2 (k / 4);
  // B[k][n] in lane n * 4 + k % 4, register k / 4; the tensor core reads
  // only the tf32 bits of each
  auto tf = [](uint32_t u) {
    return (double)__uint_as_float(u & 0xffffe000u); };
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * t + i % 2;
    double acc = d[i];
    for (int k = 0; k < 8; ++k)
      acc += tf(buf[((r % 8) * 4 + k % 4) * 6 + r / 8 + 2 * (k / 4)]) *
             tf(buf[(c * 4 + k % 4) * 6 + 4 + k / 4]);
    d[i] = (float)acc;
  }
  __syncwarp(); }
// mma.m16n8k16 bf16: A[r][k] in lane (r % 8) * 4 + (k % 8) / 2, register
// r / 8 + 2 (k / 8); B[k][n] in lane n * 4 + (k % 8) / 2, register k / 8;
// each value in the low (even k) or high (odd k) half of its register;
// the products are exact, summed in double
inline void mma_bf16_m16n8k16(float d[4], const uint32_t a[4],
                              const uint32_t b[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t* buf = emu_blk->mma.data() + (threadIdx.x / 32) * 32 * 6;
  for (int i = 0; i < 4; ++i) buf[lane * 6 + i] = a[i];
  buf[lane * 6 + 4] = b[0]; buf[lane * 6 + 5] = b[1];
  __syncwarp();
  auto half = [](uint32_t u, int k) {
    return (double)__uint_as_float(k % 2 ? (u & 0xffff0000u) : (u << 16)); };
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * t + i % 2;
    double acc = d[i];
    for (int k = 0; k < 16; ++k)
      acc += half(buf[((r % 8) * 4 + (k % 8) / 2) * 6 + r / 8 + 2 * (k / 8)],
                  k) *
             half(buf[(c * 4 + (k % 8) / 2) * 6 + 4 + k / 8], k);
    d[i] = (float)acc;
  }
  __syncwarp(); }
inline float to_f32(float x) { return x; }
inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class T> T from_f32(float x);
template <> inline float from_f32<float>(float x) { return x; }
template <> inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x); }
inline uint32_t bf16_bits(__nv_bfloat16 x) { return x.x; }
inline uint32_t upper_halves(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u); }
inline uint32_t pack_bf16x2(float lo, float hi) {
  return bf16_bits(__float2bfloat16_rn(lo)) |
         (bf16_bits(__float2bfloat16_rn(hi)) << 16); }
inline void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  lo = upper_halves(x0 - __uint_as_float(hi << 16),
                    x1 - __uint_as_float(hi & 0xffff0000u)); }
// ldmatrix x4: the warp's 32 row addresses through the per-warp buffer;
// register i of lane l is matrix i's row l / 4, columns 2 (l % 4), +1, or
// with .trans its column l / 4, rows 2 (l % 4), +1
inline uint32_t emu_smem_addr(const void* p);
inline void emu_ldsm(uint32_t r[4], const void* p, bool trans) {
  const int lane = threadIdx.x % 32;
  uint32_t* buf = emu_blk->mma.data() + (threadIdx.x / 32) * 32 * 6;
  buf[lane * 6] = emu_smem_addr(p);
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
    for (int e = 0; e < 2; ++e) {
      const int row = trans ? 2 * (lane % 4) + e : lane / 4;
      const int col = trans ? lane / 4 : 2 * (lane % 4) + e;
      uint16_t h; std::memcpy(&h, emu_blk->dyn.data() +
                              buf[(i * 8 + row) * 6] + 2 * col, 2);
      v |= (uint32_t)h << (16 * e); }
    r[i] = v; }
  __syncwarp(); }
inline void ldsm_x4(uint32_t r[4], const void* p) { emu_ldsm(r, p, false); }
inline void ldsm_x4_trans(uint32_t r[4], const void* p) {
  emu_ldsm(r, p, true); }
// min.NaN / max.NaN: a NaN operand gives a NaN, else fminf / fmaxf
inline float fmin_nan(float a, float b) {
  return (a != a || b != b) ? NAN : std::fmin(a, b); }
inline float fmax_nan(float a, float b) {
  return (a != a || b != b) ? NAN : std::fmax(a, b); }
inline void cp_async_16(void* s, const void* g, bool pred) {
  if (pred) std::memcpy(s, g, 16); else std::memset(s, 0, 16); }
inline void cp_async_4(void* s, const void* g, bool pred) {
  if (pred) std::memcpy(s, g, 4); else std::memset(s, 0, 4); }
inline void cp_async_commit() {}
template <int N> void cp_async_wait() {}
// Hopper: shared memory is the block's dynamic buffer and a shared address
// is an offset into it
inline float ex2_approx(float x) { return std::exp2(x); }
inline float rcp_approx(float x) { return 1.f / x; }
inline float tanh_fast(float y) {
  return 1.f - 2.f * rcp_approx(1.f + ex2_approx(y * 2.8853900817779268f)); }
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)((const char*)p - emu_blk->dyn.data()); }
inline uint32_t emu_smem_addr(const void* p) { return smem_u32(p); }
inline char* emu_smem(uint32_t a) { return emu_blk->dyn.data() + a; }
inline uint32_t emu_swz128(uint32_t a) { return a ^ (((a >> 7) & 7u) << 4); }
// an mbarrier: its arrivals a phase, those still missing, bytes still due
// and the phase's parity (in the 8 bytes of the card's object)
struct EmuMbar { uint16_t expected; uint16_t pending; int32_t tx : 31;
                 uint32_t phase : 1; };
static_assert(sizeof(EmuMbar) == 8, "an mbarrier is 8 bytes");
inline EmuMbar* emu_mbar(uint64_t* bar) {
  return reinterpret_cast<EmuMbar*>(bar); }
inline void emu_mbar_settle(EmuMbar* b) {
  if (b->pending == 0 && b->tx == 0) {
    b->phase ^= 1u; b->pending = b->expected; } }
inline void mbar_init(uint64_t* bar, unsigned n) {
  EmuMbar* b = emu_mbar(bar); b->expected = b->pending = (uint16_t)n;
  b->tx = 0; b->phase = 0; }
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  EmuMbar* b = emu_mbar(bar);
  if (b->pending == 0) { std::fprintf(stderr, "mbarrier over-arrived\n");
                         std::abort(); }
  --b->pending; emu_mbar_settle(b); }
inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  emu_mbar(bar)->tx += (int32_t)bytes; mbar_arrive(bar); }
inline void emu_mbar_complete_tx(uint64_t* bar, unsigned bytes) {
  EmuMbar* b = emu_mbar(bar); b->tx -= (int32_t)bytes; emu_mbar_settle(b); }
inline void fence_proxy_async_global() {}
// cp.async.bulk: the bytes at once, delivered to the barrier
inline void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  if (smem_u32(dst) % 16 || (uintptr_t)src % 16 || bytes % 16) {
    std::fprintf(stderr, "cp.async.bulk not 16-byte aligned\n");
    std::abort(); }
  std::memcpy(dst, src, bytes); emu_mbar_complete_tx(bar, bytes); }
inline void mbar_wait(uint64_t* bar, int parity) {
  for (long spins = 0; (int)emu_mbar(bar)->phase == parity; ++spins) {
    if (spins > (1L << 20)) {
      std::fprintf(stderr, "emulated mbarrier wait never completed\n");
      std::abort(); }
    emu_yield(); } }
// cuda.h's tensor map, filled by the emulated cuTensorMapEncodeTiled with
// its own arguments, after the checks cuTensorMapEncodeTiled makes
typedef int CUresult; enum { CUDA_SUCCESS = 0 };
typedef uint32_t cuuint32_t; typedef uint64_t cuuint64_t;
struct alignas(64) CUtensorMap { unsigned long long opaque[16]; };
typedef int CUtensorMapDataType; typedef int CUtensorMapInterleave;
typedef int CUtensorMapSwizzle; typedef int CUtensorMapL2promotion;
typedef int CUtensorMapFloatOOBfill;
enum { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9, CU_TENSOR_MAP_INTERLEAVE_NONE = 0,
       CU_TENSOR_MAP_SWIZZLE_128B = 3, CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2,
       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct EmuMap { const char* base; int rank, elem, swizzle;
  uint32_t box[4]; uint64_t dim[4], stride[4]; };
static_assert(sizeof(EmuMap) <= sizeof(CUtensorMap), "fits the map");
inline CUresult emu_encode_tiled(
    CUtensorMap* map, CUtensorMapDataType dt, cuuint32_t rank, void* addr,
    const cuuint64_t* dim, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* estr, CUtensorMapInterleave il, CUtensorMapSwizzle sw,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill fill) {
  if (dt != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank < 1 || rank > 4 ||
      il != CU_TENSOR_MAP_INTERLEAVE_NONE || fill != 0 ||
      (uintptr_t)addr % 16 != 0) return 1;
  EmuMap m{}; m.base = (const char*)addr; m.rank = (int)rank; m.elem = 2;
  m.swizzle = sw;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (box[i] < 1 || box[i] > 256 || estr[i] != 1)
      return 1;
    m.box[i] = box[i]; m.dim[i] = dim[i];
    m.stride[i] = i ? strides[i - 1] : 2;
    if (i && (strides[i - 1] % 16 != 0 || strides[i - 1] >= (1ull << 40)))
      return 1; }
  if (sw == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * 2 != 128) return 1;
  std::memcpy(map, &m, sizeof m);
  return CUDA_SUCCESS; }
typedef int cudaDriverEntryPointQueryResult;
enum { cudaEnableDefault = 0, cudaDriverEntryPointSuccess = 0,
       cudaDevAttrMultiProcessorCount = 16, cudaErrorNotSupported = 801 };
#define CUDART_VERSION 12080
inline int cudaGetDriverEntryPointByVersion(
    const char* sym, void** fn, unsigned, unsigned long long,
    cudaDriverEntryPointQueryResult* res) {
  *fn = std::strcmp(sym, "cuTensorMapEncodeTiled") == 0
            ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  if (res) *res = *fn ? 0 : 1;
  return *fn ? 0 : 1; }
// the card's SM count, which K6's launcher reads to size its blocks
// (emu_set_sm_count changes it for a test)
inline int emu_sm_count = 132;
extern "C" void emu_set_sm_count(int n) { emu_sm_count = n; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// an SM's 228 KB of shared memory (1 KB of it reserved a block) and 2,048
// threads, shared by the resident blocks
template <class T>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T*, int threads,
                                                  size_t smem) {
  *n = std::max(1, std::min(2048 / threads, (int)(233472 / (smem + 1024))));
  return 0; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? emu_sm_count : 0;
  return 0; }
// the box at coordinates c, row-major with dimension 0 innermost, stored
// through the 128-byte swizzle; outside the tensor, zeros
inline void tma_load_4d(void* dst, const void* map, uint64_t* bar, int c0,
                        int c1, int c2, int c3) {
  const EmuMap& m = *static_cast<const EmuMap*>(map);
  const uint32_t a0 = smem_u32(dst);
  if (m.swizzle == CU_TENSOR_MAP_SWIZZLE_128B && a0 % 1024 != 0) {
    std::fprintf(stderr, "swizzled TMA box not 1024-byte aligned\n");
    std::abort(); }
  const long c[4] = {c0, c1, c2, c3};
  uint32_t box[4] = {1, 1, 1, 1}; uint64_t dim[4] = {1, 1, 1, 1};
  for (int i = 0; i < m.rank; ++i) { box[i] = m.box[i]; dim[i] = m.dim[i]; }
  uint32_t e = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0, ++e) {
          const long g[4] = {c[0] + i0, c[1] + i1, c[2] + i2, c[3] + i3};
          bool in = true; size_t off = 0;
          for (int i = 0; i < 4; ++i) {
            in = in && g[i] >= 0 && (uint64_t)g[i] < dim[i];
            if (i < m.rank) off += (size_t)g[i] * m.stride[i]; }
          uint32_t a = a0 + e * 2;
          if (m.swizzle == CU_TENSOR_MAP_SWIZZLE_128B) a = emu_swz128(a);
          if (in) std::memcpy(emu_smem(a), m.base + off, 2);
          else std::memset(emu_smem(a), 0, 2); }
  emu_mbar_complete_tx(bar, e * 2); }
inline uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3ffffu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62); }
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> void wgmma_wait() {}
template <int N> void fence_regs(float*) {}
// one bf16 of shared memory as the tensor core reads it through a 128-byte
// swizzle descriptor: K-major (row r at its 128-byte row of an 8-row group
// sbo apart, k within it) or MN-major (k at its row, n's 64-element block
// lbo apart)
inline double emu_desc_at(uint64_t desc, int mn, int k, bool mn_major) {
  if ((desc >> 62) != 1 || ((desc >> 49) & 7) != 0) {
    std::fprintf(stderr, "wgmma descriptor is not 128-byte swizzled\n");
    std::abort(); }
  const uint32_t start = (uint32_t)(desc & 0x3fff) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3fff) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3fff) << 4;
  const uint32_t a = mn_major
      ? start + (mn / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 + 2 * (mn % 64)
      : start + (mn / 8) * sbo + (mn % 8) * 128 + 2 * k;
  __nv_bfloat16 h; std::memcpy(&h, emu_smem(emu_swz128(a)), 2);
  return (double)__bfloat162float(h); }
// D (64 x N) = [D +] A B over k < 16, each product exact and summed in
// double; A from descriptor da (K-major) or from the warpgroup's registers
// (exchanged through a per-warpgroup buffer in the fragment layout)
template <int N>
inline void emu_wgmma(float* d, const uint32_t* a, uint64_t da, uint64_t db,
                      bool b_mn_major, bool acc) {
  const int t = threadIdx.x % 128, w = t / 32, g = t % 32 / 4, q = t % 4;
  uint32_t* buf = emu_blk->wgx.data() + (threadIdx.x / 128) * 128 * 4;
  EmuBarrier* bar = emu_blk->wg_bar[threadIdx.x / 128].get();
  if (a) { for (int i = 0; i < 4; ++i) buf[t * 4 + i] = a[i];
           bar->arrive_and_wait(); }
  auto A = [&](int r, int k) {
    if (!a) return emu_desc_at(da, r, k, false);
    const uint32_t u = buf[((r / 16) * 32 + (r % 8) * 4 + (k % 8) / 2) * 4 +
                           (r % 16) / 8 + 2 * (k / 8)];
    return (double)__uint_as_float(k % 2 ? (u & 0xffff0000u) : (u << 16)); };
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 8 * (e / 2), c = 8 * j + 2 * q + e % 2;
      double s = acc ? d[4 * j + e] : 0.0;
      for (int k = 0; k < 16; ++k)
        s += A(r, k) * emu_desc_at(db, c, k, b_mn_major);
      d[4 * j + e] = (float)s; }
  if (a) bar->arrive_and_wait(); }
inline void wgmma_m64n96k16_ss(float* d, uint64_t da, uint64_t db, int acc) {
  emu_wgmma<96>(d, nullptr, da, db, false, acc != 0); }
inline void wgmma_m64n64k16_ss(float* d, uint64_t da, uint64_t db, int acc) {
  emu_wgmma<64>(d, nullptr, da, db, false, acc != 0); }
template <int N>
void wgmma_m64nNk16_rs(float* d, const uint32_t a[4], uint64_t db) {
  emu_wgmma<N>(d, a, 0, db, true, true); }
"""


def _to_cpp(src: str) -> str:
    """A .cu source as C++ for the emulation header."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace('#include "primitives.cuh"', "")   # in cuda_emu.h
    src = src.replace("#include <cuda.h>", "")            # in cuda_emu.h
    src = src.replace("__grid_constant__ ", "")
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"EMU_DYN_SMEM(\1, \2);", src)
    # a block's threads share their host thread
    src = src.replace("__shared__", "static thread_local")

    def launch(m):
        cfg = [p.strip() for p in re.split(r",(?![^()]*\))", m.group(2))]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"emu_launch(dim3({cfg[0]}), dim3({cfg[1]}), {smem}, "
                f"[&]{{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"([\w:<>, ]+?)<<<(.*?)>>>\((.*?)\);", launch, src,
                  flags=re.S)


def _compile(cxx, out, name, source):
    """Start g++ on one .cu source against the emulation header."""
    header = out / "cuda_emu.h"
    if not header.exists():        # other compiles may be reading it
        header.write_text(EMU_HEADER)
        # the sources' other headers (host code), as C++ for this header
        for cuh in _build.CSRC.glob("*.cuh"):
            if cuh.name != "primitives.cuh":
                (out / cuh.name).write_text(_to_cpp(cuh.read_text()))
    cpp = out / name.replace(".cu", ".cpp")
    cpp.write_text(_to_cpp(source))
    lib = out / ("lib" + name.replace(".cu", ".so"))
    return name, lib, subprocess.Popen(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-I", str(out), "-o", str(lib), str(cpp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(name, lib, proc):
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"{name} does not compile:\n{log}"
    return ctypes.CDLL(str(lib))


def _cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to emulate the CUDA kernels")
    return cxx


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Compile every source; patch the wrappers' launch, query and operand
    check to the emulated launchers for CPU tensors."""
    cxx = _cxx()
    out = tmp_path_factory.mktemp("cuda_emu")
    procs = [_compile(cxx, out, name, (_build.CSRC / name).read_text())
             for name in _build.SOURCES]
    libs = [_load(*p) for p in procs]
    fns = {}
    for fn, argtypes in {**_build.SIGNATURES, **_build.QUERIES}.items():
        lib = next(lib for lib in libs if hasattr(lib, fn))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        fns[fn] = getattr(lib, fn)

    def launch(fn, *args):
        rc = fns[fn](*args, None)
        assert rc == 0, f"{fn} returned {rc}"

    # the SM count K6's bf16 launcher sizes its blocks by and K7's bf16
    # wrapper its splits (the card's 132 unless a test sets it)
    for lib in libs:
        lib.emu_set_sm_count.argtypes = [ctypes.c_int]

    def set_sm_count(n):
        for lib in libs:
            lib.emu_set_sm_count(n)
        da.resident_blocks.cache_clear()      # asked once a head dim

    def query(fn, *args):
        return fns[fn](*args)

    def check(*operands, same=()):
        # _build.check_operands without the device checks (CPU tensors)
        _build.check_dtypes(operands, same)
        for name, t, dtype, shape in operands:
            if shape is not None and tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: expected shape {tuple(shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous tensor")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "launch", launch)
        mp.setattr(_build, "query", query)
        mp.setattr(_build, "check_operands", check)
        yield set_sm_count
        set_sm_count(132)


MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "primitives.cuh"
// one warp: fragments of row-major A (16x8), B (8x8), C (16x8) loaded in
// the layout csrc/primitives.cuh states, D = C + A B stored row-major
__global__ void mma_probe_kernel(const float* A, const float* B,
                                 const float* C, float* D, uint32_t* R) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const uint32_t a[4] = {tf32_rna(A[g * 8 + t]), tf32_rna(A[(g + 8) * 8 + t]),
                         tf32_rna(A[g * 8 + t + 4]),
                         tf32_rna(A[(g + 8) * 8 + t + 4])};
  const uint32_t b[2] = {tf32_rna(B[t * 8 + g]), tf32_rna(B[(t + 4) * 8 + g])};
  float d[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  mma_tf32_m16n8k8(d, a, b);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
  for (int i = lane; i < 128; i += 32) R[i] = tf32_rna(A[i]);
}
extern "C" int mma_probe(const float* A, const float* B, const float* C,
                         float* D, uint32_t* R) {
  mma_probe_kernel<<<1, 32>>>(A, B, C, D, R);
  return 0;
}
"""


def _tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 in numpy: round the 13 low mantissa bits off, ties
    away from zero (the bits are sign-magnitude)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_emulated_mma_tf32_matches_numpy(tmp_path):
    lib = _load(*_compile(_cxx(), tmp_path, "mma_probe.cu", MMA_PROBE))
    rng = np.random.default_rng(3)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    a[0, :4] = [1 + 2.0 ** -11, -(1 + 2.0 ** -11),       # ties: away
                1 + 2.0 ** -11 - 2.0 ** -23, 3.0]        # below: down
    b = _tf32(rng.normal(size=(8, 8)).astype(np.float32))
    c = rng.normal(size=(16, 8)).astype(np.float32)
    d = np.empty((16, 8), np.float32)
    r = np.empty((16, 8), np.uint32)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)     # noqa: E731
    assert lib.mma_probe(ptr(a), ptr(b), ptr(c), ptr(d), ptr(r)) == 0
    assert np.array_equal(r.view(np.float32), _tf32(a))
    assert list(r.view(np.float32)[0, :4]) == [1 + 2.0 ** -10,
                                               -(1 + 2.0 ** -10), 1.0, 3.0]
    want = c.astype(np.float64) + _tf32(a).astype(np.float64) @ b
    np.testing.assert_allclose(d, want.astype(np.float32), rtol=0, atol=1e-6)


MMA_BF16_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "primitives.cuh"
// one warp: bf16 pairs of row-major A (16x16) and B (16x8) packed in the
// layout csrc/primitives.cuh states, D = C + A B stored row-major
__global__ void mma_bf16_probe_kernel(const float* A, const float* B,
                                      const float* C, float* D) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const uint32_t a[4] = {
      pack_bf16x2(A[g * 16 + 2 * t], A[g * 16 + 2 * t + 1]),
      pack_bf16x2(A[(g + 8) * 16 + 2 * t], A[(g + 8) * 16 + 2 * t + 1]),
      pack_bf16x2(A[g * 16 + 2 * t + 8], A[g * 16 + 2 * t + 9]),
      pack_bf16x2(A[(g + 8) * 16 + 2 * t + 8], A[(g + 8) * 16 + 2 * t + 9])};
  const uint32_t b[2] = {
      pack_bf16x2(B[(2 * t) * 8 + g], B[(2 * t + 1) * 8 + g]),
      pack_bf16x2(B[(2 * t + 8) * 8 + g], B[(2 * t + 9) * 8 + g])};
  float d[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  mma_bf16_m16n8k16(d, a, b);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}
extern "C" int mma_bf16_probe(const float* A, const float* B,
                              const float* C, float* D) {
  mma_bf16_probe_kernel<<<1, 32>>>(A, B, C, D);
  return 0;
}
"""


def test_emulated_mma_bf16_matches_numpy(tmp_path):
    # the operands rounded to bf16 (nearest even) by pack_bf16x2, their
    # products summed exactly onto C
    lib = _load(*_compile(_cxx(), tmp_path, "mma_bf16_probe.cu",
                          MMA_BF16_PROBE))
    rng = np.random.default_rng(4)
    a = rng.normal(size=(16, 16)).astype(np.float32)
    b = rng.normal(size=(16, 8)).astype(np.float32)
    c = rng.normal(size=(16, 8)).astype(np.float32)
    d = np.empty((16, 8), np.float32)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)     # noqa: E731
    assert lib.mma_bf16_probe(ptr(a), ptr(b), ptr(c), ptr(d)) == 0
    bf = lambda x: torch.as_tensor(x).to(torch.bfloat16).double().numpy()  # noqa: E731,E501
    want = c.astype(np.float64) + bf(a) @ bf(b)
    np.testing.assert_allclose(d, want.astype(np.float32), rtol=0, atol=1e-6)


def _t(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("f,n,m", [(1, 64, 64), (3, 64, 32), (2, 130, 70)])
def test_region_filter_source_matches_plain(emulated, f, n, m):
    args = _t(filter_case(f, n, m))
    assert torch.equal(ik.region_filter_mask_batch(*args, **FILTER_KW),
                       ik.region_filter_mask_batch_ref(*args, **FILTER_KW))


@pytest.mark.parametrize("b,n,m", IOU_CASES)
def test_iou_matrix_source_matches_plain(emulated, b, n, m):
    a, c = _t(iou_case(b, n, m))
    assert torch.equal(im.iou_matrix(a, c), im.iou_matrix_ref(a, c))
    if b == 1:                             # the JAX kernel's 2-D form
        assert torch.equal(im.iou_matrix(a[0], c[0]),
                           im.iou_matrix_ref(a[0], c[0]))


@pytest.mark.parametrize("n,m", [(64, 32), (130, 70), (256, 256)])
def test_frame_filter_source_matches_plain(emulated, n, m):
    args = _t(frame_filter_case(n, m))
    got = rf.region_filter_mask(*args, **FILTER_KW)
    assert got.shape == (n,)
    assert torch.equal(got, rf.region_filter_mask_ref(*args, **FILTER_KW))


FILTER_CORNERS = filter_corner_cases()


@pytest.mark.parametrize("case", sorted(FILTER_CORNERS))
def test_region_filter_source_corners(emulated, case):
    # every exactness corner: K1 over the case, and K4b (the same kernel
    # on one frame) frame by frame, bit for bit
    arrays, kw = FILTER_CORNERS[case]
    args = _t(arrays)
    want = ik.region_filter_mask_batch_ref(*args, **kw)
    assert torch.equal(ik.region_filter_mask_batch(*args, **kw), want)
    for f in range(want.shape[0]):
        frame = [a[f] for a in args]
        assert torch.equal(rf.region_filter_mask(*frame, **kw), want[f])


@pytest.mark.parametrize("b,n,m", [(2, 40, 30), (1, 13, 7), (2, 40, 32)])
def test_iou_matrix_source_propagates_nan(emulated, b, n, m):
    # a NaN coordinate gives a NaN IoU in every pair that holds it, as in
    # the plain version (min and max that drop a NaN gave finite values)
    a, c = _t(iou_nan_case(b, n, m))
    want = im.iou_matrix_ref(a, c)
    assert torch.isnan(want).any() and not torch.isnan(want).all()
    torch.testing.assert_close(im.iou_matrix(a, c), want, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("b,n,m", [(3, 130, 70), (2, 9, 131), (1, 17, 5),
                                   (2, 20, 256)])
def test_iou_matrix_source_ragged_tiles(emulated, b, n, m):
    # M % 4 != 0 (every store scalar) and M % 4 == 0 (float4 stores), rows
    # and columns that are not whole 8 x 128 tiles; a (..., N, 4) batch of
    # two leading dimensions
    a, c = _t(iou_case(b, n, m, seed=4))
    assert torch.equal(im.iou_matrix(a, c), im.iou_matrix_ref(a, c))
    a4, c4 = a.reshape(1, b, n, 4), c.reshape(1, b, m, 4)
    assert torch.equal(im.iou_matrix(a4, c4), im.iou_matrix_ref(a4, c4))


NMS_CORNERS = nms_corner_cases()


def _nms_on_source(boxes, scores, valid, thr=0.45):
    """K4a, then the NMS kernel on its matrix: ops.nms_mask's card route."""
    return nm.nms_greedy(im.iou_matrix(boxes, boxes), scores, valid, thr)


@pytest.mark.parametrize("case", sorted(NMS_CORNERS))
def test_nms_source_corners(emulated, case):
    # every corner of the greedy loop, mask for mask against the plain loop
    boxes, scores, valid, thr = _t(NMS_CORNERS[case][:3]) + [
        NMS_CORNERS[case][3]]
    want = ref.nms_mask(boxes, scores, valid, thr)
    nm.launches = im.launches = 0
    assert torch.equal(_nms_on_source(boxes, scores, valid, thr), want)
    assert nm.launches == im.launches == 1


@pytest.mark.parametrize("f,n,valid_frac", [
    (3, 256, 0.5),              # the flush's shape at half density
    (2, 100, 1.0),              # N % 32 != 0, every box a candidate
    (2, 600, 0.6),              # past SHARED_N: rows in the workspace
    (1, 33, 0.9)])              # N % 4 != 0: scalar row reads
def test_nms_source_matches_plain(emulated, f, n, valid_frac):
    rng = np.random.default_rng(f * 1000 + n)
    boxes = rand_boxes(rng, (f, n)) * 0.6
    scores = rng.random((f, n), dtype=np.float32)
    # equal scores side by side: ties go to the lower index
    scores[:, 1::7] = scores[:, ::7][:, :len(range(1, n, 7))]
    valid = rng.random((f, n)) < valid_frac
    args = _t((boxes, scores, valid))
    assert (nm.workspace_words(n) > 0) == (n > nm.SHARED_N)
    want = ref.nms_mask(*args)
    got = _nms_on_source(*args)
    assert torch.equal(got, want)
    # a (..., N) batch of two leading dimensions
    got4 = _nms_on_source(*[a.reshape(1, *a.shape) for a in args])
    assert torch.equal(got4[0], want)


def test_nms_source_rejects_bad_operands(emulated):
    boxes, scores, valid, thr = _t(NMS_CORNERS["n37"][:3]) + [0.45]
    iou = im.iou_matrix(boxes, boxes)
    for args, match in [((iou, scores.double(), valid), "float32"),
                        ((iou, scores, valid.to(torch.uint8)), "bool"),
                        ((iou[:, :, :5], scores, valid), "expected iou"),
                        ((iou, scores[:, :5], valid), "expected iou")]:
        with pytest.raises(ValueError, match=match):
            nm.nms_greedy(*args, thr)


CROP_CASES = {**crop_cases(), **crop_tile_cases()}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_crop_gather_source_matches_plain(emulated, case):
    # every crop case, pad rows included, and crops that are not a whole
    # number of 128-pixel tiles (aligned and unaligned output rows, 5
    # channels in two tap passes): bit for bit
    frames, boxes, idxs, out_hw = CROP_CASES[case]
    args = _t((frames, boxes, idxs))
    assert torch.equal(cg.crop_gather(*args, out_hw=out_hw),
                       cg.crop_gather_ref(*args, out_hw=out_hw))


@pytest.mark.parametrize("b,d,c,g", [
    (64, 17, 10, 1), (40, 129, 8, 9),
    (13, 129, 8, 1),            # B not a multiple of a block's 8 rows
    (0, 129, 8, 1),             # no rows: no launch
    (37, 33, 21, 1), (21, 33, 21, 5),    # C = 21: three class chunks
    (50, 129, 8, 320)])         # G = 320 readouts (the ensemble's G x T)
def test_onevsall_source_matches_plain(emulated, b, d, c, g):
    x, ws, widx = _t(onevsall_case(b, d, c, g))
    widx = None if g == 1 else widx
    got = ov.onevsall_scores(x, ws, widx)
    assert got.shape == (b, c)
    if b:
        assert float((got - ov.onevsall_scores_ref(x, ws, widx)).abs()
                     .max()) <= ONEVSALL_ATOL


@pytest.mark.parametrize("b", [1, 130, 300])
@pytest.mark.parametrize("d1,c", [(129, 8), (17, 10)])
def test_onevsall_update_source_matches_plain(emulated, b, d1, c):
    # the learner's single-row step (one block, a warp per residual) and
    # batches split into 32-row tiles with a ragged last tile (130 = 4 x 32
    # + 2), their parts added by the combine kernel
    assert ou.tile_rows(d1, c) == 32
    x, y, w = _t(update_case(b, d1, c))
    got = ou.onevsall_update(x, y, w, eta=UPDATE_ETA)
    want = ou.onevsall_update_ref(x, y, w, eta=UPDATE_ETA)
    assert rel_err(got, want) <= UPDATE_RTOL
    # the same bits on a second launch: no atomics, fixed summation order
    assert torch.equal(ou.onevsall_update(x, y, w, eta=UPDATE_ETA), got)


@pytest.mark.parametrize("b,d1,c", [
    (3, 129, 8),                # one tile, a warp per row of 8 classes
    (45, 33, 21),               # ragged D1 and C: three class chunks
    (2048, 129, 8),             # the trainer's max_buffer: 64 tiles
    (70, 129, 100)])            # W past shared memory: read from global
def test_onevsall_update_source_shapes(emulated, b, d1, c):
    x, y, w = _t(update_case(b, d1, c, seed=4))
    got = ou.onevsall_update(x, y, w, eta=UPDATE_ETA)
    assert rel_err(got, ou.onevsall_update_ref(x, y, w, eta=UPDATE_ETA)) \
        <= UPDATE_RTOL
    assert torch.equal(ou.onevsall_update(x, y, w, eta=UPDATE_ETA), got)


@pytest.mark.parametrize("n,d1,c,passes,one_block", [
    (37, 17, 10, 3, True), (50, 129, 8, 2, True), (1, 129, 8, 1, True),
    (5, 65, 40, 2, True),       # five classes a warp
    (6, 129, 100, 2, False)],   # W past the block's shared memory
    ids=["ragged", "learner", "one-step", "wide", "past-smem"])
def test_onevsall_replay_source_equals_single_steps(emulated, n, d1, c,
                                                   passes, one_block):
    # one launch of the replay gives the bits of a loop of one-row launches
    # of the step kernel (the same residual and update arithmetic), and
    # stays within the tolerance of the plain loop
    assert ou.replay_in_one_block(d1, c) == one_block
    xs, ys, w = _t(update_case(n, d1, c, seed=5))
    ou.launches = ou.steps = 0
    got = ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA, passes=passes)
    assert (ou.launches, ou.steps) == (1, n * passes)
    loop = w
    for _ in range(passes):
        for i in range(n):
            loop = ou.onevsall_update(xs[i:i + 1], ys[i:i + 1], loop,
                                      eta=UPDATE_ETA)
    assert torch.equal(got, loop)
    want = ou.onevsall_replay_ref(xs, ys, w, eta=UPDATE_ETA, passes=passes)
    assert rel_err(got, want) <= LEARN_RTOL
    assert torch.equal(ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA,
                                          passes=passes), got)


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_RAGGED_CASES,
                         ids=[f"flash{i}" for i in range(
                             len(FLASH_CASES) + len(FLASH_RAGGED_CASES))])
def test_flash_attention_source_matches_plain(emulated, case):
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    # float32 with d = d_v: the 3xTF32 kernels at every head dim up to 256
    # (the column-warp kernel past 128)
    assert fa.on_tensor_cores(d, d)
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    got = fa.flash_attention(q, k, v, **kw)
    assert float((got - ref.flash_attention(q, k, v, **kw)).abs().max()) \
        <= ATTN_ATOL


@pytest.mark.parametrize("case", FLASH_DV_CASES,
                         ids=[f"dv{c[5]}-{c[6]}" for c in FLASH_DV_CASES])
def test_flash_attention_source_takes_a_value_head_dim(emulated, case):
    # MLA's prefill: v's head dim below q's and k's, on the 3xTF32 tensor-
    # core kernel (QK and V each at its own padded width)
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v))
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off))
    assert fa.on_tensor_cores(d, d_v)
    got = fa.flash_attention(q, k, v, **kw)
    assert got.shape == (b, s_q, n_q, d_v)
    assert float((got - ref.flash_attention(q, k, v, **kw)).abs().max()) \
        <= ATTN_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES,
                         ids=[f"edge{i}" for i in range(len(FLASH_EDGE_CASES))])
def test_flash_attention_source_at_tile_edges(emulated, case, dtype):
    # float32 on the 3xTF32 kernels up to d = 192 and d_v = 128 and where
    # d = d_v up to 256 (gemma2's 256 on the column-warp kernel), bf16 on
    # the wgmma kernel where d = d_v (the CUDA-core kernel for MLA's dims),
    # each within its card tolerance
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = (t.to(dtype) for t in
               _t(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v)))
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off))
    assert fa.on_tensor_cores(d, d_v, dtype) == (
        (d <= 192 and d_v <= 128) or d == d_v if dtype == torch.float32
        else d == d_v)
    got = fa.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    assert got.shape == (b, s_q, n_q, d_v) and got.dtype == dtype
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= ATTN_ATOL
    else:
        assert bf16_err(got, want) <= ATTN_BF16_RTOL


def test_flash_attention_source_takes_per_row_offsets(emulated):
    q, k, v = _t(attention_case(3, 24, 64, 4, 2, 64, seed=5))
    kw = dict(causal=True, window=20, softcap=30.0,
              q_offset=torch.tensor([0, 17, 40]))
    got = fa.flash_attention(q, k, v, **kw)
    assert float((got - ref.flash_attention(q, k, v, **kw)).abs().max()) \
        <= ATTN_ATOL


@pytest.mark.parametrize("case", FLASH_WIDE_CASES,
                         ids=[f"wide{i}" for i in range(len(FLASH_WIDE_CASES))])
def test_flash_attention_source_column_warps(emulated, case):
    # float32 past d = 128 on the column-warp kernel: every case within
    # ATTN_ATOL of the plain version, one launch, the same bits again
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    assert fa.on_tensor_cores(d, d_v)
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d, seed=7))
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off))
    fa.launches = 0
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == 1 and got.shape == (b, s_q, n_q, d)
    assert float((got - ref.flash_attention(q, k, v, **kw)).abs().max()) \
        <= ATTN_ATOL
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("case", DECODE_CASES + [
    (2, 96, 16, 1, 64, [96, 40], None, None)],         # a group of 16
    ids=[f"decode{i}" for i in range(len(DECODE_CASES) + 1)])
def test_decode_attention_source_matches_plain(emulated, case):
    b, S, n_q, n_kv, d, clen, window, cap = case
    q, kc, vc = _t(decode_case(b, S, n_q, n_kv, d))
    cl = torch.as_tensor(np.asarray(clen, np.int32))
    kw = dict(window=window, softcap=cap)
    got = da.decode_attention(q, kc, vc, cl, **kw)
    want = ref.decode_attention(q, kc, vc, cl, **kw)
    assert float((got - want).abs().max()) <= ATTN_ATOL


@pytest.mark.parametrize("case,sms", DECODE_WIDE_CASES,
                         ids=[f"wide{i}" for i in range(len(DECODE_WIDE_CASES))])
def test_decode_attention_source_bulk_tiles(emulated, case, sms):
    # float32 past d = 128 on the bulk kernel, splits in whole waves of the
    # emulated card's resident blocks (one an SM), the splits merged by
    # each row's last block: within ATTN_ATOL, one launch, and the same
    # bits on a second launch (which also needs the arrival counts back
    # at 0)
    b, S, n_q, n_kv, d, clen, window, cap = case
    emulated(sms)
    q, kc, vc = _t(decode_case(b, S, n_q, n_kv, d, seed=8))
    assert da.on_bulk(q, kc, vc) and not da.on_tma(q, kc, vc)
    assert da.resident_blocks(d, -1, torch.float32) == sms
    cl = torch.as_tensor(np.asarray(clen, np.int32))
    kw = dict(window=window, softcap=cap)
    da.launches = 0
    got = da.decode_attention(q, kc, vc, cl, **kw)
    assert da.launches == 1 and got.shape == q.shape
    assert float((got - ref.decode_attention(q, kc, vc, cl, **kw))
                 .abs().max()) <= ATTN_ATOL
    assert torch.equal(da.decode_attention(q, kc, vc, cl, **kw), got)


def test_decode_attention_source_bulk_routes():
    # the bulk kernel takes float32 at 128 < d <= 256 with d % 4 == 0 and
    # aligned caches; the rest keeps the split kernel, chosen by shape and
    # address, and asks no residency of the library
    def ops(d, shift=0):
        q, kc, vc = _t(decode_case(1, 32, 2, 1, d))
        if shift:
            kc = torch.cat([kc.new_zeros(shift), kc.flatten()])[shift:] \
                .view(kc.shape)
        return q, kc, vc
    assert da.on_bulk(*ops(256)) and da.on_bulk(*ops(132))
    assert not da.on_bulk(*ops(128)) and not da.on_bulk(*ops(130))
    assert not da.on_bulk(*ops(256, shift=1))
    q, kc, vc = ops(256)
    assert not da.on_bulk(q.to(torch.bfloat16), kc.to(torch.bfloat16),
                          vc.to(torch.bfloat16))
    assert da.plan(*ops(112), None) == da.splits(1, 32, 1, None)


@pytest.mark.parametrize("args,want", [
    # gemma2's serving decode: 4 rows x 2 blocks of 4 kv-heads, one wave of
    # 16 splits of 32 slots (128 blocks on 132 SMs)
    ((4, 512, 8, None, 132), (32, 16)),
    # its decode_32k at 5 slots: 13 splits of 2,528 (130 blocks)
    ((5, 32768, 8, None, 132), (2528, 13)),
    # a window of 100: 13 tiles of 8 slots, one split each
    ((2, 4096, 8, 100, 132), (8, 13)),
    # more (row, block) pairs than resident blocks: one split
    ((200, 512, 8, None, 132), (512, 1)),
    # group parts: 2 a kv-head halve the splits
    ((2, 512, 8, None, 132, 2), (32, 16))])
def test_decode_attention_bulk_splits_take_one_wave(args, want):
    # the float32 bulk kernel's plan: whole 8-slot tiles, as many splits
    # as one wave of resident blocks holds (a row's merge waits for its
    # last split)
    per, nsplit = da.bulk_splits(*args)
    assert (per, nsplit) == want
    b, S, n_kv, window, resident = args[:5]
    nsub = args[5] if len(args) > 5 else 1
    longest = min(S, window or S)
    assert per % da.BULK_TILE == 0
    assert per * nsplit >= longest > per * (nsplit - 1)
    assert b * -(-n_kv // 4) * nsub * nsplit <= max(resident,
                                                    b * -(-n_kv // 4) * nsub)


@pytest.mark.parametrize("d,sms", [(256, 132), (192, 7), (132, 1)])
def test_decode_attention_source_bulk_resident_blocks(emulated, d, sms):
    # the float32 kernel asks for 192 KB: one block an SM; none below
    # d = 129 or at d % 4 != 0
    emulated(sms)
    assert da.resident_blocks(d, -1, torch.float32) == sms
    assert _build.query("vpaas_decode_attention_resident", 128) == 0
    assert _build.query("vpaas_decode_attention_resident", 130) == 0


@pytest.mark.parametrize("case", SSD_CASES + [(1, 70, 1, 32, 128, 64, True, False)],
                         ids=[f"ssd{i}" for i in range(len(SSD_CASES) + 1)])
def test_ssd_scan_source_matches_plain(emulated, case):
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = _t(ssd_case(b, s, h, p, n, init, weak=weak))
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    y_ref, fin_ref = ref.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                  initial_state=st)
    assert rel_err(y, y_ref) <= SSD_RTOL
    assert rel_err(fin, fin_ref) <= SSD_RTOL


def _bf16(arrays):
    return [None if a is None else torch.as_tensor(a).to(torch.bfloat16)
            for a in arrays]


@pytest.mark.parametrize("sms", [132, 1], ids=["sms132", "sms1"])
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_RAGGED_CASES,
                         ids=[f"flash{i}" for i in range(
                             len(FLASH_CASES) + len(FLASH_RAGGED_CASES))])
def test_flash_attention_source_takes_bf16(emulated, case, sms):
    # the bf16 launcher: the wgmma kernel on TMA tiles for every d = d_v
    # up to 256 (p split into two bf16 halves; d = 18 and 36 padded to a
    # multiple of 8 by the wrapper; 64-key tiles and one buffer of p's
    # fragments at d = 256); out in bf16.  On the card's 132 SMs these
    # small grids take 64-row blocks (one consumer warpgroup), on 1 SM
    # 128-row blocks (two)
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    emulated(sms)
    assert fa.on_tensor_cores(d, d, torch.bfloat16)
    assert fa.block_rows(b, s_q, n_q) == (64 if sms == 132 else 128)
    q, k, v = _bf16(attention_case(b, s_q, s_kv, n_q, n_kv, d))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    fa.launches = 0
    got = fa.flash_attention(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s_q, n_q, d)
    assert fa.launches == 1
    assert bf16_err(got, ref.flash_attention(q, k, v, **kw)) \
        <= ATTN_BF16_RTOL


@pytest.mark.parametrize("case", FLASH_DV_CASES,
                         ids=[f"dv{c[5]}-{c[6]}" for c in FLASH_DV_CASES])
def test_flash_attention_source_takes_bf16_value_head_dims(emulated, case):
    # bf16 with d_v != d stays on the CUDA-core kernel
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    assert not fa.on_tensor_cores(d, d_v, torch.bfloat16)
    q, k, v = _bf16(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v))
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off))
    got = fa.flash_attention(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s_q, n_q, d_v)
    assert rel_err(got.float(), ref.flash_attention(q, k, v, **kw).float()) \
        <= ATTN_BF16_RTOL


@pytest.mark.parametrize("case", DECODE_CASES + [
    (2, 96, 16, 1, 36, [96, 40], None, None)],    # d % 8 != 0: plain copies
    ids=[f"decode{i}" for i in range(len(DECODE_CASES) + 1)])
def test_decode_attention_source_takes_bf16(emulated, case):
    b, S, n_q, n_kv, d, clen, window, cap = case
    q, kc, vc = _bf16(decode_case(b, S, n_q, n_kv, d))
    cl = torch.as_tensor(np.asarray(clen, np.int32))
    kw = dict(window=window, softcap=cap)
    got = da.decode_attention(q, kc, vc, cl, **kw)
    assert got.dtype == torch.bfloat16
    want = ref.decode_attention(q, kc, vc, cl, **kw)
    assert rel_err(got.float(), want.float()) <= ATTN_BF16_RTOL


@pytest.mark.parametrize("case", SSD_CASES + [(1, 70, 1, 32, 128, 64, True, False)],
                         ids=[f"ssd{i}" for i in range(len(SSD_CASES) + 1)])
def test_ssd_scan_source_takes_bf16(emulated, case):
    # x, B and C bf16 (y comes out bf16); dt, A and the states float32
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = _t(ssd_case(b, s, h, p, n, init, weak=weak))
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    y_ref, fin_ref = ref.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                  initial_state=st)
    assert rel_err(y.float(), y_ref.float()) <= SSD_BF16_RTOL
    assert rel_err(fin, fin_ref) <= SSD_RTOL


def test_llm_sources_refuse_float16_and_mixed_dtypes(emulated):
    q, k, v = _t(attention_case(1, 16, 16, 2, 1, 32))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_attention(q.to(torch.bfloat16), k, v)
    qd, kc, vc = _t(decode_case(1, 32, 2, 1, 32))
    with pytest.raises(ValueError, match="share one dtype"):
        da.decode_attention(qd, kc.to(torch.bfloat16), vc, 8)
    x, dt, A, B, C, st = _t(ssd_case(1, 32, 2, 8, 8, True))
    with pytest.raises(ValueError, match="share one dtype"):
        sk.ssd_scan(x.to(torch.bfloat16), dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="float32"):
        sk.ssd_scan(x, dt.to(torch.bfloat16), A, B, C, chunk=16)


# (case, splits of each row's valid slots): the wrapper cuts the longest
# valid length it knows (S, or the window) into splits of >= 64 slots
@pytest.mark.parametrize("case,nsplit", [
    # a full row over four splits
    ((1, 256, 4, 2, 64, [256], None, None), 4),
    # a window of 150: row 0's 40 slots leave splits 1 and 2 empty, row 1
    # reads [106, 256) in three
    ((2, 256, 4, 2, 64, [40, 256], 150, None), 3),
    # cache_len 0 (the mean of V) beside a full row
    ((2, 128, 4, 4, 32, [0, 128], None, None), 2),
    # a group of 16: two blocks of 8 q-heads per kv-head
    ((2, 96, 16, 1, 64, [96, 40], None, None), 2),
    # d = 36, padded to 40 in shared memory
    ((2, 100, 6, 2, 36, [100, 77], None, 20.0), 2),
    # d = 37: 4-byte copies
    ((1, 140, 3, 3, 37, [130], None, None), 3),
    # 256 (row, kv-head) pairs: splits of 128 slots, four tiles each, so
    # the double-buffered ring refills
    ((4, 512, 64, 64, 8, [512, 300, 1, 130], None, None), 4)],
    ids=["three-plus-splits", "window-empty-splits", "empty-row", "group16",
         "d36", "d37", "ring-refills"])
def test_decode_attention_source_splits_rows(emulated, case, nsplit):
    b, S, n_q, n_kv, d, clen, window, cap = case
    assert da.splits(b, S, n_kv, window)[1] == nsplit
    q, kc, vc = _t(decode_case(b, S, n_q, n_kv, d, seed=1))
    cl = torch.as_tensor(np.asarray(clen, np.int32))
    kw = dict(window=window, softcap=cap)
    got = da.decode_attention(q, kc, vc, cl, **kw)
    want = ref.decode_attention(q, kc, vc, cl, **kw)
    assert float((got - want).abs().max()) <= ATTN_ATOL
    # the splits merge in a fixed order: the same bits on a second launch
    assert torch.equal(da.decode_attention(q, kc, vc, cl, **kw), got)


@pytest.mark.parametrize("case,path", [
    ((1, 200, 3, 16, 32, 64, True, False), "tensor cores"),    # 4 chunks
    ((1, 150, 2, 64, 64, 64, True, False), "tensor cores"),    # zamba2's p, n
    ((1, 250, 2, 16, 16, 100, True, True), "tensor cores"),    # Q = 100
    ((1, 100, 2, 64, 128, 64, True, False), "tensor cores"),   # mamba2's n
    ((2, 37, 4, 4, 4, 16, True, False), "CUDA cores"),
    ((1, 90, 2, 12, 20, 32, True, False), "CUDA cores")],
    ids=["four-chunks", "p64-n64-chunk64", "chunk100", "p64-n128", "p4-n4",
         "p12-n20"])
def test_ssd_scan_source_paths(emulated, case, path):
    b, s, h, p, n, chunk, init, weak = case
    assert sk.path(p, n) == path
    x, dt, A, B, C, st = _t(ssd_case(b, s, h, p, n, init, seed=2,
                                     weak=weak))
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    y_ref, fin_ref = ref.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                  initial_state=st)
    assert rel_err(y, y_ref) <= SSD_RTOL
    assert rel_err(fin, fin_ref) <= SSD_RTOL
    # no atomics: the same bits on a second launch
    y2, fin2 = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    assert torch.equal(y2, y) and torch.equal(fin2, fin)


# K7's bf16 kernel on TMA tiles: (case, SMs of the emulated card).  A
# 64 KB ring of tiles of 16 slots of each of a block's 4 kv-heads (4
# stages at d <= 64, 2 above); a warp carries up to 16 q-heads of its
# kv-head
@pytest.mark.parametrize("case,sms", [
    # one split of 40 tiles: the ring wraps ten times
    ((1, 640, 4, 4, 64, [640], None, None), 1),
    # 36 tiles and 14 slots: a partial last tile in a partial last stage
    ((2, 590, 8, 2, 112, [590, 333], None, None), 1),
    # a window of 150 in three splits: row 0's 40 slots leave two empty
    ((2, 512, 4, 2, 64, [40, 512], 150, None), 132),
    # softcap, a row of one slot, d = 32
    ((3, 200, 6, 3, 32, [1, 150, 200], None, 30.0), 132),
    # d = 128 (two 64-column boxes), a window that starts mid-tile
    ((2, 300, 8, 2, 128, [300, 150], 70, None), 2),
    # an empty row (the mean of V) beside a full one
    ((2, 96, 4, 2, 64, [0, 96], None, None), 132),
    # GQA groups of 1, 2, 4, 8, 16 (one block) and 32 (two blocks)
    ((2, 160, 2, 2, 112, [160, 77], None, None), 1),
    ((2, 160, 4, 2, 112, [160, 77], None, None), 1),
    ((1, 130, 8, 2, 64, [130], None, None), 132),
    ((1, 130, 16, 2, 64, [130], None, 20.0), 132),
    ((2, 96, 16, 1, 64, [96, 40], None, None), 132),
    ((1, 70, 32, 1, 64, [70], None, None), 132),
    # gemma2-9b's d = 256 (two 64 KB stages, Q's fragments in shared
    # memory), GQA 2, softcap 50, a window shorter than the cache; on 1 SM
    # a split's tiles wrap the ring
    ((2, 150, 16, 8, 256, [150, 61], 48, 50.0), 1),
    ((1, 200, 16, 8, 256, [200], None, 50.0), 132)],
    ids=["ring-wraps", "partial-last-stage", "window-empty-splits",
         "softcap-d32", "d128-window", "empty-row", "group1", "group2",
         "group4", "group8", "group16", "group32", "d256-window",
         "d256-global"])
def test_decode_attention_source_bf16_tma(emulated, case, sms):
    b, S, n_q, n_kv, d, clen, window, cap = case
    emulated(sms)
    q, kc, vc = _bf16(decode_case(b, S, n_q, n_kv, d, seed=3))
    assert da.on_tma(q, kc, vc)
    cl = torch.as_tensor(np.asarray(clen, np.int32))
    kw = dict(window=window, softcap=cap)
    da.launches = da.launches_bf16 = 0
    got = da.decode_attention(q, kc, vc, cl, **kw)
    assert da.launches == da.launches_bf16 == 1 and got.dtype == torch.bfloat16
    assert bf16_err(got, ref.decode_attention(q, kc, vc, cl, **kw)) \
        <= ATTN_BF16_RTOL
    # the splits merge in a fixed order: the same bits on a second launch
    assert torch.equal(da.decode_attention(q, kc, vc, cl, **kw), got)


def test_decode_attention_source_bf16_keeps_the_other_kernel(emulated):
    # d % 8 != 0 (TMA's 16-byte rows) and caches that are not 16-byte
    # aligned stay on the float32 design with bf16 widened as it loads,
    # chosen by shape and address
    for b, S, n_q, n_kv, d, clen, cap, shift in [
            (2, 96, 16, 1, 36, [96, 40], None, 0),
            (1, 64, 4, 2, 256, [64], 50.0, 1),
            (2, 80, 4, 2, 64, [80, 33], None, 1)]:
        q, kc, vc = _bf16(decode_case(b, S, n_q, n_kv, d, seed=4))
        if shift:                 # the same values 2 bytes off alignment
            kc, vc = (torch.cat([t.new_zeros(shift), t.flatten()])[shift:]
                      .view(t.shape) for t in (kc, vc))
            assert kc.data_ptr() % 16 and vc.data_ptr() % 16
        assert not da.on_tma(q, kc, vc)
        cl = torch.as_tensor(np.asarray(clen, np.int32))
        got = da.decode_attention(q, kc, vc, cl, softcap=cap)
        assert bf16_err(got, ref.decode_attention(q, kc, vc, cl,
                                                  softcap=cap)) \
            <= ATTN_BF16_RTOL
        assert torch.equal(da.decode_attention(q, kc, vc, cl, softcap=cap),
                           got)


@pytest.mark.parametrize("d,sms,per_sm", [(112, 132, 1), (64, 132, 1),
                                          (128, 1, 1), (32, 7, 1),
                                          (256, 132, 1)])
def test_decode_attention_source_bf16_resident_blocks(emulated, d, sms,
                                                      per_sm):
    # the wrapper's residency query: SMs x the blocks of one SM's shared
    # memory (the emulated occupancy: 228 KB, 1 KB reserved a block); the
    # kernel asks for 120 KB (160 KB at d = 256), so one block holds an SM
    emulated(sms)
    assert da.resident_blocks(d) == sms * per_sm
    assert _build.query("vpaas_decode_attention_bf16_resident", 36) == 0


# (case, path): x, B and C bf16 through the tensor-core kernels (each
# chunk's source tiles summed on chip), or the CUDA-core kernel
@pytest.mark.parametrize("case", [
    (1, 200, 3, 16, 32, 64, True, False),       # 4 chunks
    (1, 150, 2, 64, 64, 64, True, False),       # zamba2's p, n
    (1, 250, 2, 16, 16, 100, True, True),       # chunk 100
    (2, 300, 2, 64, 64, 256, True, True),       # 4 source tiles a chunk
    (1, 100, 2, 64, 128, 64, True, False),      # mamba2's n
    (1, 130, 2, 64, 128, 256, False, True),     # n 128, 3 tiles, no state
    (1, 90, 2, 16, 24, 32, True, False)],       # n % 16 == 8
    ids=["four-chunks", "p64-n64-chunk64", "chunk100", "four-tiles",
         "p64-n128", "p64-n128-3tiles", "n24"])
def test_ssd_scan_source_bf16_tensor_cores(emulated, case):
    b, s, h, p, n, chunk, init, weak = case
    assert sk.path(p, n) == "tensor cores"
    x, dt, A, B, C, st = _t(ssd_case(b, s, h, p, n, init, seed=5,
                                     weak=weak))
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    y_ref, fin_ref = ref.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                  initial_state=st)
    assert bf16_err(y, y_ref) <= SSD_BF16_RTOL
    assert rel_err(fin, fin_ref) <= SSD_RTOL
    # no atomics: the same bits on a second launch
    y2, fin2 = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    assert torch.equal(y2, y) and torch.equal(fin2, fin)


def test_ssd_scan_source_pass_takes_unaligned_states(emulated):
    # an initial state 4 bytes off a 16-byte boundary takes the pass's
    # one-element loads: the same bits as the aligned state's 16-byte ones
    b, s, h, p, n, chunk = 1, 300, 2, 64, 64, 256
    x, dt, A, B, C, st = _t(ssd_case(b, s, h, p, n, True, seed=6))
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    off = torch.cat([st.new_zeros(1), st.flatten()])[1:].view(st.shape)
    assert off.data_ptr() % 16 and torch.equal(off, st)
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    y2, fin2 = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=off)
    assert torch.equal(y2, y) and torch.equal(fin2, fin)


def test_ssd_scan_workspace_holds_one_state_a_chunk():
    # the chunk's source tiles are summed on chip: one p x n float32 state
    # and one decay a (row, chunk, head); none on the CUDA cores
    x, B = (torch.empty(shape, device="meta")
            for shape in ((6, 32768, 112, 64), (6, 32768, 64)))
    assert sk.workspace_bytes(x, B, 256) == 4 * 6 * 128 * 112 * (64 * 64 + 1)
    assert sk.workspace_bytes(x, B, 256) < 1.5e9
    assert sk.workspace_bytes(torch.empty(1, 10, 2, 4),
                              torch.empty(1, 10, 4), 4) == 0

