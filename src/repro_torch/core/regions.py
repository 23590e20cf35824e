"""Region selection, the §IV.B three-stage filter, and HQ crop extraction;
PyTorch port of ``repro.core.regions``.

Everything is fixed-shape: each frame carries a constant region budget N
with validity masks, so a whole flush is filtered in one pass.  The filter
runs the whole-flush region-filter kernel (K1), or the single-frame one
(K4b) once per frame in :func:`split_regions_framewise`, and every crop
runs the crop-gather kernel (K2), all through
:mod:`repro_torch.kernels.ops`.  Greedy NMS (``ops.nms_mask``) is two
kernels on the card: the IoU matrix (K4a), then the greedy loop over it
(``csrc/nms.cu``, which the reference runs as one ``jax.lax.fori_loop``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

NMS_IOU = 0.45


class RegionSplit(NamedTuple):
    # accepted: cloud-confident detections, used directly as labels (RQ1)
    acc_boxes: torch.Tensor     # (F, N, 4)
    acc_labels: torch.Tensor    # (F, N) int32
    acc_valid: torch.Tensor     # (F, N) bool
    # uncertain: only coordinates travel back to the fog (RQ3)
    prop_boxes: torch.Tensor    # (F, N, 4)
    prop_valid: torch.Tensor    # (F, N) bool


def split_regions(
    det: Dict[str, torch.Tensor],  # detector output on LOW-quality frames
    *,
    theta_cls: float,           # classification confidence to accept directly
    theta_loc: float,           # §IV.B location-confidence threshold
    theta_iou: float,           # §IV.B overlap threshold
    theta_back: float,          # §IV.B background-area threshold (fraction)
) -> RegionSplit:
    boxes, loc, probs = det["boxes"], det["loc_scores"], det["cls_probs"]
    cls_conf = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1).to(torch.int32)    # first max, as jnp

    acc_raw = (loc >= theta_loc) & (cls_conf >= theta_cls)
    acc_valid = ops.nms_mask(boxes, loc * cls_conf, acc_raw,
                             iou_threshold=NMS_IOU)
    # ONE whole-flush filter pass over the (F, N) grid
    keep = ops.region_filter_mask_batch(
        boxes, loc >= theta_loc, boxes, acc_valid, loc,
        theta_loc=theta_loc, theta_iou=theta_iou, theta_back=theta_back)
    keep = keep & ~acc_valid       # accepted regions don't go to the fog
    prop_valid = ops.nms_mask(boxes, loc, keep, iou_threshold=NMS_IOU)
    return RegionSplit(boxes, labels, acc_valid, boxes, prop_valid)


def split_regions_framewise(
    det: Dict[str, torch.Tensor],
    *,
    theta_cls: float,
    theta_loc: float,
    theta_iou: float,
    theta_back: float,
) -> RegionSplit:
    """:func:`split_regions` with the §IV.B filter run frame by frame.

    The ``impl="ref"`` branch of ``repro.core.regions.split_regions``: the
    accepted-set NMS runs over the chunk (one K4a launch), each frame is
    filtered by the single-frame kernel (K4b, one launch per frame), then
    the proposal NMS runs over the chunk (one K4a launch), as JAX's
    ``vmap`` batches it.  The masks equal :func:`split_regions`'s bit for
    bit."""
    boxes, loc, probs = det["boxes"], det["loc_scores"], det["cls_probs"]
    cls_conf = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1).to(torch.int32)    # first max, as jnp

    acc_raw = (loc >= theta_loc) & (cls_conf >= theta_cls)
    acc_valid = ops.nms_mask(boxes, loc * cls_conf, acc_raw,
                             iou_threshold=NMS_IOU)
    keep = torch.stack([ops.region_filter_mask(
        boxes[t], loc[t] >= theta_loc, boxes[t], acc_valid[t], loc[t],
        theta_loc=theta_loc, theta_iou=theta_iou, theta_back=theta_back)
        for t in range(boxes.shape[0])])
    keep = keep & ~acc_valid       # accepted regions don't go to the fog
    prop_valid = ops.nms_mask(boxes, loc, keep, iou_threshold=NMS_IOU)
    return RegionSplit(boxes, labels, acc_valid, boxes, prop_valid)


def split_regions_dynamic(
    det: Dict[str, torch.Tensor],
    *,
    theta_cls: torch.Tensor,    # (F,) per-frame (per-site) thresholds
    theta_loc: torch.Tensor,    # (F,)
    theta_iou: float,
    theta_back: float,
) -> RegionSplit:
    """§IV.B split with per-frame acceptance thresholds.

    Per-site threshold adaptation packs streams with different
    ``theta_cls`` / ``theta_loc`` into one fused flush, so the thresholds
    arrive as (F,) tensors.  The per-frame location test is folded into the
    proposal-validity mask the filter kernel receives, and the kernel's own
    location test is disabled (``theta_loc = -inf``): the kernel takes its
    thresholds at run time, so this path needs no separate filter.  With
    every frame at the global defaults this returns the same masks as
    :func:`split_regions`."""
    boxes, loc, probs = det["boxes"], det["loc_scores"], det["cls_probs"]
    cls_conf = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1).to(torch.int32)    # first max, as jnp
    tc = theta_cls.to(loc.device)[:, None]
    tl = theta_loc.to(loc.device)[:, None]

    acc_raw = (loc >= tl) & (cls_conf >= tc)
    acc_valid = ops.nms_mask(boxes, loc * cls_conf, acc_raw,
                             iou_threshold=NMS_IOU)
    keep = ops.region_filter_mask_batch(
        boxes, loc >= tl, boxes, acc_valid, loc, theta_loc=float("-inf"),
        theta_iou=theta_iou, theta_back=theta_back)
    keep = keep & ~acc_valid       # accepted regions don't go to the fog
    prop_valid = ops.nms_mask(boxes, loc, keep, iou_threshold=NMS_IOU)
    return RegionSplit(boxes, labels, acc_valid, boxes, prop_valid)


def coordinate_bytes(split: RegionSplit) -> torch.Tensor:
    """Bytes for the returned coordinates (paper: 'only several bytes').

    4 x float16 coords + 1 byte header per proposal region."""
    return split.prop_valid.float().sum() * 9.0


def compaction_indices(prop_valid: np.ndarray,
                       buckets: Tuple[int, ...] = (4, 8, 16, 32, 64, 128)
                       ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Host-side gather plan for the compacted classify path.

    From the (F, N) validity mask (the flush's single host transfer) build
    the (frame, region) index lists of the valid proposals, padded up to the
    next bucket size so the compacted classifier sees few distinct shapes.
    Pad rows use the out-of-bounds frame index F: gathers clip (harmless
    garbage crop), scatters drop (the result grid keeps its zeros).  Past
    the largest bucket the batch runs at its exact size — padding down
    would silently drop proposals.

    Returns ``(fidx, ridx, n_valid, bucket_size)``."""
    pv = np.asarray(prop_valid, bool)
    f = pv.shape[0]
    idx = np.argwhere(pv)
    n = len(idx)
    size = next((b for b in buckets if n <= b), n)
    fidx = np.full(size, f, np.int32)       # OOB pad: scatter-dropped
    ridx = np.zeros(size, np.int32)
    if n:
        fidx[:n] = idx[:, 0]
        ridx[:n] = idx[:, 1]
    return fidx, ridx, n, size


# ---------------------------------------------------------------------------
# HQ crop extraction (fog side)
# ---------------------------------------------------------------------------
# Both entry points are gathers over every (frame, box) pair, so they run
# the crop-gather kernel with the full index plan -- the same bilinear
# program as the compacted path, so both give the same pixels.
def _full_plan(f: int, n: int, device) -> torch.Tensor:
    fidx = torch.arange(f, dtype=torch.int32, device=device).repeat_interleave(n)
    ridx = torch.arange(n, dtype=torch.int32, device=device).repeat(f)
    return torch.stack([fidx, ridx])


def crop_and_resize(
    frame: torch.Tensor,        # (H, W, 3)
    boxes: torch.Tensor,        # (N, 4) xyxy in [0, 1]
    out_hw: Tuple[int, int],
) -> torch.Tensor:
    """Bilinear crop of each box to out_hw; returns (N, h, w, 3)."""
    n = boxes.shape[0]
    return ops.crop_gather(frame[None], boxes[None],
                           _full_plan(1, n, frame.device), out_hw=out_hw)


def crop_batch(frames: torch.Tensor, boxes: torch.Tensor,
               out_hw: Tuple[int, int]) -> torch.Tensor:
    """frames (F, H, W, 3), boxes (F, N, 4) -> (F, N, h, w, 3)."""
    f, n = boxes.shape[0], boxes.shape[1]
    crops = ops.crop_gather(frames, boxes, _full_plan(f, n, frames.device),
                            out_hw=out_hw)
    return crops.reshape(f, n, *out_hw, frames.shape[-1])
