"""MPEG baseline: stream near-original-quality video to the cloud; PyTorch
port of ``repro.baselines.mpeg``."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.baselines.common import (BaselineResult, run_detector,
                                          threshold_detections)
from repro_torch.configs.vpaas_video import DetectorConfig
from repro_torch.core.bandwidth import (CLIENT, CLOUD, DeviceProfile,
                                        LatencyBreakdown, NetworkModel)
from repro_torch.video import codec


@dataclass
class MPEGBaseline:
    det_cfg: DetectorConfig
    q: int = 10                  # near-lossless
    r: float = 1.0
    theta_loc: float = 0.5
    theta_cls: float = 0.5
    network: NetworkModel = field(default_factory=NetworkModel)
    client: DeviceProfile = CLIENT
    cloud: DeviceProfile = CLOUD
    device: str = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)

    def process_chunk(self, det_params, frames_hq: np.ndarray,
                      **_) -> BaselineResult:
        enc = codec.encode_inter(
            torch.as_tensor(frames_hq, device=self.device), self.r, self.q)
        det = run_detector(self.det_cfg, det_params, enc.frames)
        boxes, labels, valid = threshold_detections(
            det, self.theta_loc, self.theta_cls)
        f = frames_hq.shape[0]
        lat = LatencyBreakdown(
            quality_control=self.client.encode_time(f),   # client encodes
            transmission=self.network.wan_time(float(enc.nbytes)),
            cloud_inference=self.cloud.detect_time(f))
        return BaselineResult(boxes, labels, valid, float(enc.nbytes), f,
                              1.0, lat)
