"""K2: the compacted bilinear crop gather as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.crop_gather.crop_gather`` (source:
``csrc/crop_gather.cu``): given the flush's frames (F, H, W, C), proposal
boxes (F, N, 4) and the (>=2, B) compaction indices, emit the (B, oh, ow, C)
crop batch directly -- only the B bucket rows pay crop cost.  Pad rows
(frame index F) clip to the last frame.  The plain PyTorch version is
:func:`crop_gather_ref` (``ref.crop_gather``); the kernel equals it bit for
bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)

crop_gather_ref = ref.crop_gather


def crop_gather(frames: torch.Tensor, boxes: torch.Tensor,
                idxs: torch.Tensor, *,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, oh, ow, C) bucketed crop batch; see the module docstring."""
    global launches
    f, h, w, ch = frames.shape
    n = boxes.shape[1]
    b = idxs.shape[1]
    oh, ow = out_hw
    frames = frames.contiguous()
    boxes = boxes.contiguous()
    idxs = idxs.contiguous()
    _build.check_operands(("frames", frames, torch.float32, None),
                          ("boxes", boxes, torch.float32, (f, n, 4)),
                          ("idxs", idxs, torch.int32, None))
    if idxs.dim() != 2 or idxs.shape[0] < 2:
        raise ValueError(f"idxs: expected (>=2, B), got {tuple(idxs.shape)}")
    if f == 0 or n == 0:
        raise ValueError("crop_gather needs at least one frame and one box")
    lin_y = ref.crop_lin(oh, frames.device)
    lin_x = ref.crop_lin(ow, frames.device)
    out = torch.empty((b, oh, ow, ch), dtype=frames.dtype,
                      device=frames.device)
    if b:
        _build.launch("vpaas_crop_gather", frames.data_ptr(),
                      boxes.data_ptr(), idxs.data_ptr(), lin_y.data_ptr(),
                      lin_x.data_ptr(), out.data_ptr(), b, f, h, w, ch, n,
                      oh, ow)
        launches += 1
    return out
