"""The cloud detector (FasterRCNN-101 stand-in), PyTorch port of
``repro.models.detector``.

A conv backbone + per-cell dense head that emits the *two separate signals*
the High-Low protocol exploits:

  * ``loc_scores``  — objectness / location confidence (Key Obs 2: survives
    aggressive quality degradation);
  * ``cls_logits``  — classification logits (destroyed by degradation).

Public tensors keep the JAX package's layouts: images (b, H, W, 3) NHWC,
boxes (b, N, 4) with the N = gh * gw cells in row-major order.  Parameters
are the port's (see :mod:`repro_torch.weights`): conv weights OIHW.  The
training loss waits for the training slice.
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
