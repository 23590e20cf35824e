"""K1: the whole-flush §IV.B region filter as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.iou_filter.region_filter_mask_batch``
(source: ``csrc/iou_filter.cu``).  The thresholds are runtime arguments, so
per-site thresholds take the same kernel.  The plain PyTorch version is
:func:`region_filter_mask_batch_ref` (``ref.region_filter_mask``, whose
leading axes broadcast over frames); the kernel equals it bit for bit.

The call is host-bound (the kernel takes a few microseconds on the card),
so the wrapper does little per call: one validation pass over the five
operands, one lookup of the launcher's argument struct (the sizes and the
thresholds, kept per key by :func:`filter_args`, which K4b's wrapper
shares), the output from ``new_empty``, then a seven-argument launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)

region_filter_mask_batch_ref = ref.region_filter_mask


class FilterArgs(ctypes.Structure):
    """``VpaasFilterArgs`` of ``csrc/iou_filter.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in ("F", "N", "M")] + [
        (name, ctypes.c_float) for name in ("theta_loc", "theta_iou",
                                            "theta_back", "frame_area")]


# (F, N, M, the four thresholds) -> (the struct's address, the struct)
_args: Dict[tuple, tuple] = {}


def filter_args(f: int, n: int, m: int, theta_loc: float, theta_iou: float,
                theta_back: float, frame_area: float) -> int:
    """The address of the launchers' ``VpaasFilterArgs`` for these sizes
    and thresholds, built on first use of the key."""
    return _build.struct_address(_args, FilterArgs, f, n, m, theta_loc,
                                 theta_iou, theta_back, frame_area)


def region_filter_mask_batch(proposals: torch.Tensor,
                             prop_valid: torch.Tensor,
                             accepted: torch.Tensor, acc_valid: torch.Tensor,
                             loc_scores: torch.Tensor, *, theta_loc: float,
                             theta_iou: float, theta_back: float,
                             frame_area: float = 1.0) -> torch.Tensor:
    """(F, N, 4) proposals vs (F, M, 4) accepted boxes -> (F, N) bool keep."""
    global launches
    f, n = proposals.shape[0], proposals.shape[1]
    m = accepted.shape[1]
    proposals = _build.aligned16(proposals.contiguous())
    accepted = _build.aligned16(accepted.contiguous())
    prop_valid = prop_valid.contiguous()
    acc_valid = acc_valid.contiguous()
    loc_scores = loc_scores.contiguous()
    _build.check_operands(
        ("proposals", proposals, torch.float32, (f, n, 4)),
        ("prop_valid", prop_valid, torch.bool, (f, n)),
        ("accepted", accepted, torch.float32, (f, m, 4)),
        ("acc_valid", acc_valid, torch.bool, (f, m)),
        ("loc_scores", loc_scores, torch.float32, (f, n)))
    keep = prop_valid.new_empty((f, n))
    if f and n:
        args = filter_args(f, n, m, float(theta_loc), float(theta_iou),
                           float(theta_back), float(frame_area))
        _build.launch("vpaas_region_filter_mask_batch",
                      proposals.data_ptr(), prop_valid.data_ptr(),
                      accepted.data_ptr(), acc_valid.data_ptr(),
                      loc_scores.data_ptr(), keep.data_ptr(), args)
        launches += 1
    return keep
