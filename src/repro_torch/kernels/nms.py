"""Greedy NMS over a given IoU matrix as a hand-written CUDA kernel.

The second half of ``ops.nms_mask`` on the card, after K4a
(``kernels/iou_matrix.py``) has written the matrix (source:
``csrc/nms.cu``, launcher ``vpaas_nms_greedy``).  It has no Pallas
counterpart: the JAX package runs the greedy loop as one
``jax.lax.fori_loop`` (``repro.kernels.ref.nms_mask``).  The plain PyTorch
version is :func:`nms_greedy_ref` (``ref.nms_greedy``, an eager loop of N
steps); the kernel equals it mask for mask.

One block takes one frame (the leading dimensions flattened).  Up to
``SHARED_N`` boxes a frame its bit rows lie in shared memory; past it the
wrapper allocates a global workspace for them; past ``MAX_N`` it raises
(the keys, ranks and diagonal words stay in shared memory).  The
detectors' grids give 256 and 64 boxes a frame, so every served path runs
the shared-memory rows.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)

nms_greedy_ref = ref.nms_greedy

SHARED_N = 512        # csrc/nms.cu kSharedN
MAX_N = 2048          # csrc/nms.cu kMaxN


class NmsArgs(ctypes.Structure):
    """``VpaasNmsArgs`` of ``csrc/nms.cu``."""
    _fields_ = [("F", ctypes.c_int), ("N", ctypes.c_int),
                ("iou_threshold", ctypes.c_float)]


# (F, N, threshold) -> (the struct's address, the struct)
_args: Dict[tuple, tuple] = {}


def workspace_words(n: int) -> int:
    """32-bit words of a frame's bit rows in the global workspace
    (csrc/nms.cu ``frame_words``: N rows of 4 words per 128 columns, an odd
    stride), 0 where they fit shared memory."""
    if n <= SHARED_N:
        return 0
    return n * ((4 * ((n + 127) // 128)) | 1)


def nms_greedy(iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float = 0.45) -> torch.Tensor:
    """iou (..., N, N) float32, scores (..., N) float32, valid (..., N)
    bool, on the card -> keep (..., N) bool."""
    global launches
    lead, n = scores.shape[:-1], scores.shape[-1]
    if iou.shape != (*lead, n, n) or valid.shape != scores.shape:
        raise ValueError(f"expected iou (..., N, N), scores and valid "
                         f"(..., N) of one shape; got {tuple(iou.shape)}, "
                         f"{tuple(scores.shape)}, {tuple(valid.shape)}")
    if n > MAX_N:
        raise ValueError(f"N = {n} boxes a frame; the kernel takes at most "
                         f"{MAX_N}")
    f = math.prod(lead)
    flat = scores.dim() == 2
    if not flat:
        iou = iou.reshape(f, n, n)
        scores, valid = scores.reshape(f, n), valid.reshape(f, n)
    iou = _build.aligned16(iou.contiguous())
    scores, valid = scores.contiguous(), valid.contiguous()
    _build.check_operands(("iou", iou, torch.float32, (f, n, n)),
                          ("scores", scores, torch.float32, (f, n)),
                          ("valid", valid, torch.bool, (f, n)))
    keep = valid.new_empty((f, n))
    if f and n:
        words = workspace_words(n)
        ws = (torch.empty(f * words, dtype=torch.int32, device=iou.device)
              if words else None)
        _build.launch("vpaas_nms_greedy", iou.data_ptr(), scores.data_ptr(),
                      valid.data_ptr(), keep.data_ptr(),
                      None if ws is None else ws.data_ptr(),
                      _build.struct_address(_args, NmsArgs, f, n,
                                            float(iou_threshold)))
        launches += 1
    return keep if flat else keep.reshape(lead + (n,))
