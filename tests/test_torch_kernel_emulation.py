"""The port's CUDA kernel sources, run on the CPU.

Each ``src/repro_torch/csrc/*.cu`` compiles with the host C++ compiler
against a small emulation of the CUDA runtime written below: a block's
threads run as ``std::thread``s, ``__syncthreads``/``__syncwarp`` are
barriers, warp shuffles go through a per-warp buffer, shared memory starts
as NaNs (so a read before a write shows), and each ``<<<...>>>`` launch
becomes a call that runs the grid block by block.  The Python wrappers then
call the C launchers exactly as on the card, on CPU tensors, and the
results are held against the plain versions with the on-card tolerances.
This checks each kernel's indexing, masking and arithmetic here (a
missing barrier shows only when the threads happen to race); what only
``nvcc`` and the card can show (compile errors, registers, shared-memory
limits, races, speed) stays with tests/test_torch_cuda.py and
``chip_smoke.py``.
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
from repro_torch.kernels import onevsall as ov
from repro_torch.kernels import onevsall_update as ou
from repro_torch.kernels import ssd_scan as sk
from repro_torch.testing import (ATTN_ATOL, DECODE_CASES, FILTER_KW,
                                 FLASH_CASES, ONEVSALL_ATOL, SSD_CASES,
                                 SSD_RTOL, UPDATE_ETA, UPDATE_RTOL,
                                 attention_case, crop_cases, decode_case,
                                 filter_case, onevsall_case, rel_err,
                                 ssd_case, update_case)

EMU_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
using std::max; using std::min;
#define __global__
#define __device__
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
struct EmuBlock { std::barrier<>* bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<double> xchg; std::vector<char> dyn; };
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
inline void emu_launch(dim3 g, dim3 b, size_t smem, std::function<void()> fn) {
  int nt = b.x * b.y * b.z;
  for (unsigned bz = 0; bz < g.z; ++bz)
  for (unsigned by = 0; by < g.y; ++by)
  for (unsigned bx = 0; bx < g.x; ++bx) {
    EmuBlock blk; std::barrier<> bar(nt); blk.bar = &bar;
    for (int w = 0; w < (nt + 31) / 32; ++w)
      blk.warp_bar.emplace_back(new std::barrier<>(32));
    blk.xchg.assign(((nt + 31) / 32) * 32, 0.0);
    blk.dyn.assign(smem + 16, 0);
    float nan = NAN;
    for (size_t i = 0; i + 4 <= blk.dyn.size(); i += 4)
      std::memcpy(&blk.dyn[i], &nan, 4);
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, t, bx, by, bz] {
        threadIdx = dim3(t); blockIdx = dim3(bx, by, bz); blockDim = b;
        gridDim = g; emu_blk = &blk; fn(); });
    for (auto& th : ts) th.join();
  } }
#define EMU_DYN_SMEM(T, name) T* name = reinterpret_cast<T*>(emu_blk->dyn.data())
"""


def _to_cpp(src: str) -> str:
    """A .cu source as C++ for the emulation header."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"EMU_DYN_SMEM(\1, \2);", src)
    src = src.replace("__shared__", "static")   # one block runs at a time

    def launch(m):
        cfg = [p.strip() for p in re.split(r",(?![^()]*\))", m.group(2))]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"emu_launch(dim3({cfg[0]}), dim3({cfg[1]}), {smem}, "
                f"[&]{{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"([\w:<>, ]+?)<<<(.*?)>>>\((.*?)\);", launch, src,
                  flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Compile every source; patch the wrappers' launch and operand check
    to the emulated launchers for CPU tensors."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to emulate the CUDA kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "cuda_emu.h").write_text(EMU_HEADER)
    procs = []
    for name in _build.SOURCES:
        cpp = out / name.replace(".cu", ".cpp")
        cpp.write_text(_to_cpp((_build.CSRC / name).read_text()))
        lib = out / ("lib" + name.replace(".cu", ".so"))
        procs.append((name, lib, subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread", "-I", str(out), "-o", str(lib),
             str(cpp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for name, lib, proc in procs:
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name} does not compile:\n{log}"
        libs.append(ctypes.CDLL(str(lib)))
    fns = {}
    for fn, argtypes in _build.SIGNATURES.items():
        lib = next(lib for lib in libs if hasattr(lib, fn))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        fns[fn] = getattr(lib, fn)

    def launch(fn, *args):
        rc = fns[fn](*args, None)
        assert rc == 0, f"{fn} returned {rc}"

    def check(name, t, dtype, shape=None):
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "launch", launch)
        mp.setattr(_build, "check_cuda", check)
        yield


def _t(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("f,n,m", [(1, 64, 64), (3, 64, 32), (2, 130, 70)])
def test_region_filter_source_matches_plain(emulated, f, n, m):
    args = _t(filter_case(f, n, m))
    assert torch.equal(ik.region_filter_mask_batch(*args, **FILTER_KW),
                       ik.region_filter_mask_batch_ref(*args, **FILTER_KW))


@pytest.mark.parametrize("case", ["sweep-6x9", "oob-pad-rows", "bucket-5"])
def test_crop_gather_source_matches_plain(emulated, case):
    frames, boxes, idxs, out_hw = crop_cases()[case]
    args = _t((frames, boxes, idxs))
    assert torch.equal(cg.crop_gather(*args, out_hw=out_hw),
                       cg.crop_gather_ref(*args, out_hw=out_hw))


@pytest.mark.parametrize("b,d,c,g", [(64, 17, 10, 1), (40, 129, 8, 9)])
def test_onevsall_source_matches_plain(emulated, b, d, c, g):
    x, ws, widx = _t(onevsall_case(b, d, c, g))
    widx = None if g == 1 else widx
    got = ov.onevsall_scores(x, ws, widx)
    assert float((got - ov.onevsall_scores_ref(x, ws, widx)).abs().max()) \
        <= ONEVSALL_ATOL


@pytest.mark.parametrize("b", [1, 130, 300])
@pytest.mark.parametrize("d1,c", [(129, 8), (17, 10)])
def test_onevsall_update_source_matches_plain(emulated, b, d1, c):
    # the learner's single-row step, a ragged row tile (130 = 4 x 32 + 2 at
    # C = 8; 25-row tiles at C = 10) and more rows than one tile
    x, y, w = _t(update_case(b, d1, c))
    got = ou.onevsall_update(x, y, w, eta=UPDATE_ETA)
    want = ou.onevsall_update_ref(x, y, w, eta=UPDATE_ETA)
    assert rel_err(got, want) <= UPDATE_RTOL
    # the same bits on a second launch: no atomics, fixed summation order
    assert torch.equal(ou.onevsall_update(x, y, w, eta=UPDATE_ETA), got)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"flash{i}" for i in range(len(FLASH_CASES))])
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
