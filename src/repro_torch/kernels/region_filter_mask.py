"""K4b: the single-frame §IV.B region filter as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.iou_filter.region_filter_mask``
(source: ``csrc/iou_filter.cu``, launcher ``vpaas_region_filter_mask``).
It launches K1's kernel on one frame, with K1's argument struct
(``iou_filter.filter_args`` at F = 1); the framewise split
(``core.regions.split_regions_framewise``, the DDS baseline's round 1)
launches it once per frame.  The thresholds are runtime arguments.  The
plain PyTorch version is :func:`region_filter_mask_ref`; the kernel equals
it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.iou_filter import filter_args

launches = 0          # kernel launches since the last reset (ops.py)

region_filter_mask_ref = ref.region_filter_mask


def region_filter_mask(proposals: torch.Tensor, prop_valid: torch.Tensor,
                       accepted: torch.Tensor, acc_valid: torch.Tensor,
                       loc_scores: torch.Tensor, *, theta_loc: float,
                       theta_iou: float, theta_back: float,
                       frame_area: float = 1.0) -> torch.Tensor:
    """(N, 4) proposals vs (M, 4) accepted boxes on the card -> (N,) bool."""
    global launches
    n, m = proposals.shape[0], accepted.shape[0]
    proposals = _build.aligned16(proposals.contiguous())
    accepted = _build.aligned16(accepted.contiguous())
    prop_valid = prop_valid.contiguous()
    acc_valid = acc_valid.contiguous()
    loc_scores = loc_scores.contiguous()
    _build.check_operands(
        ("proposals", proposals, torch.float32, (n, 4)),
        ("prop_valid", prop_valid, torch.bool, (n,)),
        ("accepted", accepted, torch.float32, (m, 4)),
        ("acc_valid", acc_valid, torch.bool, (m,)),
        ("loc_scores", loc_scores, torch.float32, (n,)))
    keep = prop_valid.new_empty((n,))
    if n:
        args = filter_args(1, n, m, float(theta_loc), float(theta_iou),
                           float(theta_back), float(frame_area))
        _build.launch("vpaas_region_filter_mask", proposals.data_ptr(),
                      prop_valid.data_ptr(), accepted.data_ptr(),
                      acc_valid.data_ptr(), loc_scores.data_ptr(),
                      keep.data_ptr(), args)
        launches += 1
    return keep
