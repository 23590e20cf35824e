"""Shared result structure + detection post-processing for baselines;
PyTorch port of ``repro.baselines.common``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.vpaas_video import DetectorConfig
from repro_torch.core.bandwidth import LatencyBreakdown
from repro_torch.core.protocol import to_host
from repro_torch.kernels import ops
from repro_torch.models import detector as det_mod


@dataclass
class BaselineResult:
    boxes: np.ndarray            # (F, N, 4)
    labels: np.ndarray           # (F, N)
    valid: np.ndarray            # (F, N) bool
    wan_bytes: float
    cloud_frames: int
    cloud_rounds: float          # billing rounds (DDS > 1, CloudSeg uses x2)
    latency: LatencyBreakdown

    def detections(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        keep = self.valid[frame]
        return self.boxes[frame][keep], self.labels[frame][keep]


def threshold_detections(det, theta_loc: float = 0.5,
                         theta_cls: float = 0.5, nms_iou: float = 0.45):
    """Plain cloud-only acceptance rule (+NMS) for baseline and fallback
    detectors: on the card the NMS is K4a's IoU matrix, then the NMS
    kernel.  Returns host numpy ``(boxes, labels, keep)``."""
    loc, probs, boxes = det["loc_scores"], det["cls_probs"], det["boxes"]
    conf = probs.amax(-1)
    labels = to_host(probs.argmax(-1)).astype(np.int64)
    valid = (loc >= theta_loc) & (conf >= theta_cls)
    keep = ops.nms_mask(boxes, loc * conf, valid, nms_iou)
    return to_host(boxes), labels, to_host(keep)


def run_detector(det_cfg: DetectorConfig, det_params,
                 frames: torch.Tensor) -> dict:
    return det_mod.detect(det_cfg, det_params, frames)
