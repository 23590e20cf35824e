"""The port's CUDA kernel sources, run on the CPU.

Each ``src/repro_torch/csrc/*.cu`` compiles with the host C++ compiler
against a small emulation of the CUDA runtime written below: a block's
threads run as fibers on one host thread, each running until it reaches
``__syncthreads``/``__syncwarp`` (so a thread that reads what a later
thread writes without a barrier between them reads it too early), warp
shuffles go through a per-warp buffer, shared memory starts as NaNs (so a
read before a write shows), and each ``<<<...>>>`` launch becomes a call
that runs the grid's blocks, several host threads at a time.  The
primitives of ``csrc/primitives.cuh`` have host versions here:
``mma.sync`` m16n8k8 tf32 gathers the warp's fragments through a per-warp
buffer in the PTX ISA's layout and sums each output's eight exact products
in double, ``cvt.rna.tf32`` rounds the bits, ``cp.async`` copies at once
(commit and wait do nothing).  The Python wrappers then call the C
launchers exactly as on the card, on CPU tensors, and the results are held
against the plain versions with the on-card tolerances.  This checks each
kernel's indexing, masking and arithmetic here; what only ``nvcc`` and the
card can show (compile errors, registers, shared-memory limits, races
between threads that run at once, speed) stays with
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
from repro_torch.kernels import onevsall as ov
from repro_torch.kernels import onevsall_update as ou
from repro_torch.kernels import region_filter_mask as rf
from repro_torch.kernels import ssd_scan as sk
from repro_torch.testing import (ATTN_ATOL, DECODE_CASES, FILTER_KW,
                                 FLASH_CASES, FLASH_RAGGED_CASES, IOU_CASES,
                                 LEARN_RTOL, ONEVSALL_ATOL, SSD_CASES,
                                 SSD_RTOL, UPDATE_ETA, UPDATE_RTOL,
                                 attention_case, crop_cases, crop_tile_cases,
                                 decode_case, filter_case, frame_filter_case,
                                 iou_case, onevsall_case, rel_err, ssd_case,
                                 update_case)

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
#define __restrict__
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d}; }
typedef int cudaError_t; typedef void* cudaStream_t;
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
  std::vector<std::unique_ptr<EmuBarrier>> warp_bar;
  std::vector<double> xchg; std::vector<uint32_t> mma;
  std::vector<char> dyn; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local EmuBlock* emu_blk;
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_blk->warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
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
    blk.xchg.assign(((nt + 31) / 32) * 32, 0.0);
    blk.mma.assign(((nt + 31) / 32) * 32 * 6, 0u);
    blk.dyn.resize(smem + 16);
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
inline void cp_async_16(void* s, const void* g, bool pred) {
  if (pred) std::memcpy(s, g, 16); else std::memset(s, 0, 16); }
inline void cp_async_4(void* s, const void* g, bool pred) {
  if (pred) std::memcpy(s, g, 4); else std::memset(s, 0, 4); }
inline void cp_async_commit() {}
template <int N> void cp_async_wait() {}
"""


def _to_cpp(src: str) -> str:
    """A .cu source as C++ for the emulation header."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace('#include "primitives.cuh"', "")   # in cuda_emu.h
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
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
    """Compile every source; patch the wrappers' launch and operand check
    to the emulated launchers for CPU tensors."""
    cxx = _cxx()
    out = tmp_path_factory.mktemp("cuda_emu")
    procs = [_compile(cxx, out, name, (_build.CSRC / name).read_text())
             for name in _build.SOURCES]
    libs = [_load(*p) for p in procs]
    fns = {}
    for fn, argtypes in _build.SIGNATURES.items():
        lib = next(lib for lib in libs if hasattr(lib, fn))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        fns[fn] = getattr(lib, fn)

    def launch(fn, *args):
        rc = fns[fn](*args, None)
        assert rc == 0, f"{fn} returned {rc}"

    def check(*operands):
        # _build.check_operands without the device checks (CPU tensors)
        for name, t, dtype, shape in operands:
            if t.dtype != dtype:
                raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
            if shape is not None and tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: expected shape {tuple(shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous tensor")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "launch", launch)
        mp.setattr(_build, "check_operands", check)
        yield


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
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    got = fa.flash_attention(q, k, v, **kw)
    assert float((got - ref.flash_attention(q, k, v, **kw)).abs().max()) \
        <= ATTN_ATOL


def test_flash_attention_source_takes_per_row_offsets(emulated):
    q, k, v = _t(attention_case(3, 24, 64, 4, 2, 64, seed=5))
    kw = dict(causal=True, window=20, softcap=30.0,
              q_offset=torch.tensor([0, 17, 40]))
    got = fa.flash_attention(q, k, v, **kw)
    assert float((got - ref.flash_attention(q, k, v, **kw)).abs().max()) \
        <= ATTN_ATOL


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
