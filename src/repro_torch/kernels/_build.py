"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source file has a plain C launcher (``extern "C" int ...``) that takes
raw device pointers, ``int`` sizes, ``float`` thresholds and the CUDA stream,
launches its kernel and returns ``cudaGetLastError()``.  At first use the
sources are compiled by ``nvcc`` for ``sm_90a`` -- one ``nvcc`` process per
source, all started together -- linked into one shared library named by a
hash of every file under ``csrc/`` (sources and headers) and the flags, and
loaded with :mod:`ctypes`.

The launch path is short because the small kernels' calls are host-bound:
each launcher's ctypes function is bound once, when the library loads;
:func:`check_operands` validates all of a kernel's operands in one pass;
:func:`current_stream` reads the current stream's raw handle anew on every
launch without building a ``torch.cuda.Stream`` object.

``-fmad=false`` (and no ``--use_fast_math``) keeps every multiply and add
separately rounded and every division correctly rounded, which is what lets
the region filter and the crop gather equal their plain PyTorch versions on
the card bit for bit.

A missing ``nvcc``, a failed build or a nonzero launch return code raises;
nothing here falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("iou_filter.cu", "crop_gather.cu", "onevsall.cu",
           "onevsall_update.cu", "flash_attention.cu", "decode_attention.cu",
           "ssd_scan.cu", "nms.cu")
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# launcher name -> argtypes (pointers and the stream as c_void_p: a bare
# Python int would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "vpaas_region_filter_mask_batch":
        [_P, _P, _P, _P, _P, _P, _P, _P],
    "vpaas_region_filter_mask":
        [_P, _P, _P, _P, _P, _P, _P, _P],
    "vpaas_iou_matrix":
        [_P, _P, _P, _P, _P],
    "vpaas_nms_greedy":
        [_P, _P, _P, _P, _P, _P, _P],
    "vpaas_crop_gather":
        [_P, _P, _P, _P, _P, _P],
    "vpaas_onevsall_scores":
        [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vpaas_onevsall_update":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vpaas_onevsall_replay":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vpaas_flash_attention":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
         _P],
    "vpaas_flash_attention_bf16":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
         _P],
    "vpaas_decode_attention":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
         _P],
    "vpaas_decode_attention_bf16":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
         _P],
    "vpaas_ssd_scan":
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vpaas_ssd_scan_bf16":
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

# query name -> argtypes: host functions of the sources that answer what a
# launcher would do (no stream, no launch)
QUERIES = {
    "vpaas_flash_attention_on_tensor_cores": [_I, _I, _I],
    "vpaas_flash_attention_bf16_block_rows": [_I, _I, _I],
    "vpaas_decode_attention_bf16_resident": [_I],
    "vpaas_decode_attention_resident": [_I],
    "vpaas_time_next_launch": [_P, _I],
    "vpaas_launch_events_recorded": [],
}

_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}   # launcher name -> bound function
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from src/repro_torch/csrc at first use")
    return path


def _digest(csrc: Path = CSRC) -> str:
    """A hash of the flags and of every source and header under ``csrc``:
    a changed ``.cuh`` rebuilds the library as a changed ``.cu`` does."""
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    files = sorted(p for p in csrc.rglob("*") if p.suffix in (".cu", ".cuh"))
    for path in files:
        h.update(str(path.relative_to(csrc)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the .so."""
    global build_log
    out = BUILD_DIR / f"libvpaas_kernels-{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}-{tag}.o"
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *ARCH, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {name}\n{text}")
        if p.returncode != 0:
            failed.append(name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"libvpaas_kernels-{tag}.so.tmp"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)             # atomic: concurrent builds agree
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), every launcher's
    ctypes function bound once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in {**SIGNATURES, **QUERIES}.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _fns[fn] = f
        lib.vpaas_error_string.argtypes = [ctypes.c_int]
        lib.vpaas_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def current_stream() -> int:
    """The raw handle of the current device's current CUDA stream, read on
    every call (nothing is cached across streams or devices): what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    Stream object, read as PyTorch's own Triton launcher reads it."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(fn: str, *args) -> None:
    """Call one C launcher on the current stream; raise on a nonzero code.

    ``args`` excludes the trailing stream argument."""
    if _lib is None:
        library()
    rc = _fns[fn](*args, current_stream())
    if rc != 0:
        msg = _lib.vpaas_error_string(rc).decode()
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc} ({msg})")


def query(fn: str, *args) -> int:
    """Call one of the library's host queries (``QUERIES``)."""
    if _lib is None:
        library()
    return _fns[fn](*args)


def time_next_launch(events: Sequence) -> None:
    """Hand the next launch of K7's or K8's launcher these CUDA events
    (``torch.cuda.Event(enable_timing=True)``, each recorded once so that
    it has its handle): it records one before each of its device kernels
    and one after the last (``csrc/host.cuh``), so the gaps between them
    are its kernels' device times.  :func:`launch_events_recorded` then
    says how many it recorded."""
    handles = (ctypes.c_void_p * len(events))(*(e.cuda_event
                                                 for e in events))
    if query("vpaas_time_next_launch", handles, len(events)) != 0:
        raise ValueError(f"at most 8 launch events, got {len(events)}")


def launch_events_recorded() -> int:
    """The events the last launch handed some by :func:`time_next_launch`
    recorded."""
    return query("vpaas_launch_events_recorded")


MAX_CACHED = 256      # argument structs kept per cache


def struct_address(cache: Dict[tuple, tuple], struct, *values) -> int:
    """The address of a launcher's argument struct ``struct(*values)``,
    built on first use of these values and kept in ``cache`` (cleared past
    ``MAX_CACHED`` keys): a run's sizes and thresholds repeat, so a few
    entries serve it, and the struct outlives the launches that read it."""
    cached = cache.get(values)
    if cached is None:
        if len(cache) >= MAX_CACHED:
            cache.clear()
        args = struct(*values)
        cached = cache[values] = (ctypes.addressof(args), args)
    return cached[0]


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data is not 16-byte aligned: the box kernels
    load boxes as ``float4``, and a view at an odd offset is not."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


Operand = Sequence      # (name, tensor, dtype(s), shape or None)


def check_dtypes(operands: Sequence[Operand],
                 same: Sequence[Sequence[str]] = ()) -> None:
    """The dtype half of :func:`check_operands`: each operand's dtype is
    its ``dtype``, or one of them where that is a tuple of the dtypes the
    kernel takes; the operands named in each group of ``same`` share one
    dtype.  Nothing is converted: anything else raises."""
    for name, t, dtype, _ in operands:
        if isinstance(dtype, tuple):
            if t.dtype not in dtype:
                raise ValueError(f"{name}: expected one of "
                                 f"{', '.join(map(str, dtype))}, got "
                                 f"{t.dtype}")
        elif t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if same:
        by_name = {op[0]: op[1].dtype for op in operands}
        for group in same:
            got = {n: by_name[n] for n in group if n in by_name}
            if len(set(got.values())) > 1:
                raise ValueError("operands " + ", ".join(
                    f"{n} ({d})" for n, d in got.items())
                    + " must share one dtype")


# the operand dtypes the LLM kernels (K6, K7, K8) take, and each one's
# launcher suffix
DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def launcher(name: str, dtype: torch.dtype) -> str:
    """The C launcher of kernel ``name`` for operands of ``dtype``."""
    return name + _SUFFIX[dtype]


def check_operands(*operands: Operand,
                   same: Sequence[Sequence[str]] = ()) -> None:
    """Validate a kernel's operands, in one pass, before their pointers go
    to native code: each ``(name, tensor, dtype, shape or None)`` must be a
    contiguous CUDA tensor of that dtype (or of one of a tuple of dtypes;
    ``same`` names groups that share one: :func:`check_dtypes`), and shape,
    on the current device, the device whose current stream :func:`launch`
    launches on."""
    device = None
    for name, t, dtype, shape in operands:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if device is None:
            device = torch.cuda.current_device()
        if t.get_device() != device:
            raise ValueError(f"{name}: on cuda:{t.get_device()}, expected "
                             f"the current device cuda:{device}")
    check_dtypes(operands, same)
