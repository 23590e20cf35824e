"""K1: the whole-flush §IV.B region filter as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.iou_filter.region_filter_mask_batch``
(source: ``csrc/iou_filter.cu``).  The thresholds are runtime arguments, so
per-site thresholds take the same kernel.  The plain PyTorch version is
:func:`region_filter_mask_batch_ref` (``ref.region_filter_mask``, whose
leading axes broadcast over frames); the kernel equals it bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)

region_filter_mask_batch_ref = ref.region_filter_mask


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
    keep = torch.empty((f, n), dtype=torch.bool, device=proposals.device)
    if f and n:
        _build.launch("vpaas_region_filter_mask_batch",
                      proposals.data_ptr(), prop_valid.data_ptr(),
                      accepted.data_ptr(), acc_valid.data_ptr(),
                      loc_scores.data_ptr(), keep.data_ptr(), f, n, m,
                      float(theta_loc), float(theta_iou), float(theta_back),
                      float(frame_area))
        launches += 1
    return keep
