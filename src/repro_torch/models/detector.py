"""The cloud detector (FasterRCNN-101 stand-in), PyTorch port of
``repro.models.detector``.

A conv backbone + per-cell dense head that emits the *two separate signals*
the High-Low protocol exploits:

  * ``loc_scores``  — objectness / location confidence (Key Obs 2: survives
    aggressive quality degradation);
  * ``cls_logits``  — classification logits (destroyed by degradation).

Public tensors keep the JAX package's layouts: images (b, H, W, 3) NHWC,
boxes (b, N, 4) with the N = gh * gw cells in row-major order.  Parameters
are the port's (see :mod:`repro_torch.weights`): conv weights OIHW.
:func:`detector_loss` is the YOLO-style training loss.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.vpaas_video import DetectorConfig


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA "SAME" padding of an NCHW map: the total pad is split with the
    extra pixel at the bottom/right, so a stride-2 3x3 conv on an even size
    pads (0, 1) -- not torch's symmetric ``padding=1``."""
    pads = []
    for size in (x.shape[3], x.shape[2]):           # F.pad order: W then H
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def conv_same(p: Dict[str, torch.Tensor], x: torch.Tensor,
              stride: int) -> torch.Tensor:
    """SAME-padded conv + bias on NCHW ``x`` with OIHW ``p["w"]``."""
    k = p["w"].shape[-1]
    return F.conv2d(same_pad(x, k, stride), p["w"], p["b"], stride=stride)


def backbone(cfg: DetectorConfig, params, images: torch.Tensor
             ) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)                  # NHWC -> NCHW
    for i in range(len(cfg.widths)):
        x = torch.relu(conv_same(params[f"conv{i}"], x, 2))
    return x                                        # (b, w_last, G, G)


def detect(
    cfg: DetectorConfig,
    params,
    images: torch.Tensor,          # (b, H, W, 3) in [0, 1]
) -> Dict[str, torch.Tensor]:
    """Returns boxes (b,N,4) xyxy in [0,1], loc_scores (b,N), cls_logits
    (b,N,C), cls_probs (b,N,C)."""
    b = images.shape[0]
    feat = backbone(cfg, params, images)
    gh, gw = feat.shape[2], feat.shape[3]
    head = conv_same(params["head"], feat, 1)       # (b, 5+C, gh, gw)
    head = head.permute(0, 2, 3, 1).reshape(b, gh * gw, -1)

    obj = torch.sigmoid(head[..., 0])               # (b, N)
    toff = torch.sigmoid(head[..., 1:3])            # center offset in cell
    tsize = torch.sigmoid(head[..., 3:5])           # size as frame frac
    cls_logits = head[..., 5:]

    gy, gx = torch.meshgrid(torch.arange(gh, device=images.device),
                            torch.arange(gw, device=images.device),
                            indexing="ij")
    cell = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).float()
    cx = (cell[None, :, 0] + toff[..., 0]) / gw
    cy = (cell[None, :, 1] + toff[..., 1]) / gh
    w = tsize[..., 0]
    h = tsize[..., 1]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes = boxes.clamp(0.0, 1.0)
    return {
        "boxes": boxes,
        "loc_scores": obj,
        "cls_logits": cls_logits,
        "cls_probs": torch.softmax(cls_logits, dim=-1),
    }


# ---------------------------------------------------------------------------
# Training loss (per-cell assignment, YOLO-style)
# ---------------------------------------------------------------------------
def cell_targets(cfg: DetectorConfig, n: int, gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cell objectness, box and label targets (b, n), (b, n, 4), (b, n)
    from the gts whose centre falls in each cell; padding (label -1) is
    dropped.

    Where several gts share a cell the last one wins, as the reference's
    ``.at[...].set`` scatter resolves duplicates on XLA's CPU backend:
    the winner is picked explicitly (the highest valid gt index per cell),
    because ``index_put_`` with duplicate indices is undefined and on CUDA
    nondeterministic."""
    gh, gw = cfg.grid_hw
    b, m = gt_labels.shape
    valid = gt_labels >= 0
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    cell = ((cy * gh).to(torch.int64).clamp(0, gh - 1) * gw
            + (cx * gw).to(torch.int64).clamp(0, gw - 1))
    cell = torch.where(valid, cell, n)              # padding -> column n
    idx = torch.arange(m, device=cell.device).expand(b, m)
    winner = torch.full((b, n + 1), -1, dtype=torch.int64,
                        device=cell.device)
    winner = winner.scatter_reduce(1, cell, idx, "amax")[:, :n]
    hit = winner >= 0
    src = winner.clamp_min(0)
    box_t = torch.where(hit[..., None], torch.gather(
        gt_boxes, 1, src[..., None].expand(b, n, 4)), 0.0)
    lab_t = torch.where(hit, torch.gather(
        gt_labels.to(torch.int64), 1, src), 0)
    return hit.to(gt_boxes.dtype), box_t, lab_t


def detector_loss(
    cfg: DetectorConfig,
    params,
    images: torch.Tensor,          # (b, H, W, 3)
    gt_boxes: torch.Tensor,        # (b, M, 4) xyxy in [0,1]
    gt_labels: torch.Tensor,       # (b, M) int, -1 = padding
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = detect(cfg, params, images)
    obj_t, box_t, lab_t = cell_targets(cfg, out["loc_scores"].shape[1],
                                       gt_boxes, gt_labels)
    n_pos = torch.clamp(obj_t.sum(), min=1.0)
    obj = out["loc_scores"]
    # balanced BCE: positives are ~4% of cells; normalize each class
    # separately so objectness does not collapse toward zero
    pos_ce = -obj_t * torch.log(obj + 1e-8)
    neg_ce = -(1 - obj_t) * torch.log(1 - obj + 1e-8)
    l_obj = (pos_ce.sum() / n_pos
             + neg_ce.sum() / torch.clamp((1 - obj_t).sum(), min=1.0))
    l_box = (obj_t[..., None] * (out["boxes"] - box_t) ** 2).sum() / n_pos
    logp = torch.log_softmax(out["cls_logits"], dim=-1)
    l_cls = -(obj_t * torch.take_along_dim(
        logp, lab_t[..., None], dim=-1)[..., 0]).sum() / n_pos
    total = l_obj + 5.0 * l_box + l_cls
    return total, {"obj": l_obj, "box": l_box, "cls": l_cls}


def param_shapes(cfg: DetectorConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The JAX schema's shapes (HWIO convs), as ``repro.models.detector
    .detector_schema`` declares them."""
    s, cin = {}, cfg.in_channels
    for i, w in enumerate(cfg.widths):
        s[f"conv{i}"] = {"w": (3, 3, cin, w), "b": (w,)}
        cin = w
    out = 1 + 4 + cfg.num_classes
    s["head"] = {"w": (1, 1, cin, out), "b": (out,)}
    return s
