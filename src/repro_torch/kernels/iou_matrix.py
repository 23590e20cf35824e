"""K4a: the pairwise IoU matrix as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.iou_filter.iou_matrix``
(source: ``csrc/iou_filter.cu``, launcher ``vpaas_iou_matrix``).  Greedy
NMS (``ops.nms_mask``) runs it on every call with a CUDA tensor and hands
its matrix to the NMS kernel (``kernels/nms.py``): the serving path's split
does so twice per flush, every baseline once per detector pass.  Leading
dimensions are flattened into one batch; the JAX kernel's 2-D form is a
batch of one.  The plain PyTorch version is :func:`iou_matrix_ref`; the
kernel equals it bit for bit.

The call is host-bound, so the wrapper does little per call: a (B, N, 4)
operand is taken as it is (no reshape, no copy where it is contiguous and
16-byte aligned), one validation pass, the launcher's size struct from a
cache, the output from ``new_empty``, then a four-argument launch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)

iou_matrix_ref = ref.iou_matrix


class IouArgs(ctypes.Structure):
    """``VpaasIouArgs`` of ``csrc/iou_filter.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in ("B", "N", "M")]


# (B, N, M) -> (the struct's address, the struct)
_args: Dict[tuple, tuple] = {}


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) float32 on the card -> (..., N, M)."""
    global launches
    lead = boxes_a.shape[:-2]
    if boxes_b.shape[:-2] != lead:
        raise ValueError(f"leading dims differ: {tuple(lead)} vs "
                         f"{tuple(boxes_b.shape[:-2])}")
    n, m = boxes_a.shape[-2], boxes_b.shape[-2]
    a, c = boxes_a, boxes_b
    if a.dim() != 3:
        b = math.prod(lead)
        a, c = a.reshape(b, n, a.shape[-1]), c.reshape(b, m, c.shape[-1])
    b = a.shape[0]
    a = _build.aligned16(a.contiguous())
    c = _build.aligned16(c.contiguous())
    _build.check_operands(("boxes_a", a, torch.float32, (b, n, 4)),
                          ("boxes_b", c, torch.float32, (b, m, 4)))
    out = a.new_empty((b, n, m))
    if b and n and m:
        _build.launch("vpaas_iou_matrix", a.data_ptr(), c.data_ptr(),
                      out.data_ptr(),
                      _build.struct_address(_args, IouArgs, b, n, m))
        launches += 1
    return out if boxes_a.dim() == 3 else out.reshape(*lead, n, m)
