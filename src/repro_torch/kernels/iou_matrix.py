"""K4a: the pairwise IoU matrix as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.iou_filter.iou_matrix``
(source: ``csrc/iou_filter.cu``, launcher ``vpaas_iou_matrix``).  Greedy
NMS (``ops.nms_mask``) runs it on every call with a CUDA tensor: the
serving path's split does so twice per flush, every baseline once per
detector pass.  Leading dimensions are flattened into one batch; the JAX
kernel's 2-D form is a batch of one.  The plain PyTorch version is
:func:`iou_matrix_ref`; the kernel equals it bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)

iou_matrix_ref = ref.iou_matrix


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) float32 on the card -> (..., N, M)."""
    global launches
    lead = boxes_a.shape[:-2]
    if boxes_b.shape[:-2] != lead:
        raise ValueError(f"leading dims differ: {tuple(lead)} vs "
                         f"{tuple(boxes_b.shape[:-2])}")
    n, m = boxes_a.shape[-2], boxes_b.shape[-2]
    b = math.prod(lead)
    a = _build.aligned16(boxes_a.reshape(b, n, boxes_a.shape[-1])
                         .contiguous())
    c = _build.aligned16(boxes_b.reshape(b, m, boxes_b.shape[-1])
                         .contiguous())
    _build.check_operands(("boxes_a", a, torch.float32, (b, n, 4)),
                          ("boxes_b", c, torch.float32, (b, m, 4)))
    out = torch.empty((b, n, m), dtype=torch.float32, device=a.device)
    if b and n and m:
        _build.launch("vpaas_iou_matrix", a.data_ptr(), c.data_ptr(),
                      out.data_ptr(), b, n, m)
        launches += 1
    return out.reshape(*lead, n, m)
