"""DDS baseline: server-driven two-round streaming [Du et al., SIGCOMM'20];
PyTorch port of ``repro.baselines.dds``.

Round 1: low-quality chunk -> cloud detector -> confident labels + uncertain
regions.  Round 2: the uncertain regions are re-encoded in HIGH quality,
shipped again, and the cloud detector runs a second pass on the composited
frames.  Both rounds bill cloud inference (the paper's cost critique).

Round 1 splits the regions frame by frame, as the JAX baseline does
(``split_regions`` under its default ``impl="ref"``):
:func:`~repro_torch.core.regions.split_regions_framewise` launches the
single-frame filter kernel (K4b) once per frame.  The round-2 mask loop
and the composite stay host numpy, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.baselines.common import (BaselineResult, run_detector,
                                          threshold_detections)
from repro_torch.configs.vpaas_video import DetectorConfig
from repro_torch.core import regions as reg
from repro_torch.core.bandwidth import (CLIENT, CLOUD, DeviceProfile,
                                        LatencyBreakdown, NetworkModel)
from repro_torch.core.protocol import to_host
from repro_torch.video import codec


@dataclass
class DDSBaseline:
    det_cfg: DetectorConfig
    # paper §VI: round-1 QP 36 / RS 0.8, round-2 QP 26 / RS 0.8
    q1: int = 36
    r1: float = 0.8
    q2: int = 26
    r2: float = 0.8
    theta_cls: float = 0.85
    theta_loc: float = 0.5
    theta_iou: float = 0.3
    theta_back: float = 0.5
    network: NetworkModel = field(default_factory=NetworkModel)
    client: DeviceProfile = CLIENT
    cloud: DeviceProfile = CLOUD
    device: str = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)

    def process_chunk(self, det_params, frames_hq: np.ndarray,
                      **_) -> BaselineResult:
        f = frames_hq.shape[0]
        fhq = torch.as_tensor(frames_hq, device=self.device)

        # ---- round 1: low quality ----
        enc1 = codec.encode_inter(fhq, self.r1, self.q1)
        det1 = run_detector(self.det_cfg, det_params, enc1.frames)
        split = reg.split_regions_framewise(
            det1, theta_cls=self.theta_cls, theta_loc=self.theta_loc,
            theta_iou=self.theta_iou, theta_back=self.theta_back)

        # ---- round 2: uncertain regions in high quality ----
        enc2 = codec.encode_inter(fhq, self.r2, self.q2)
        mask = np.zeros(frames_hq.shape[:3] + (1,), np.float32)
        pv = to_host(split.prop_valid)
        pb = to_host(split.prop_boxes)
        h, w = frames_hq.shape[1:3]
        area = 0.0
        for t in range(f):
            for i in np.nonzero(pv[t])[0]:
                x1, y1, x2, y2 = pb[t, i]
                xa, xb = int(x1 * w), max(int(x2 * w), int(x1 * w) + 1)
                ya, yb = int(y1 * h), max(int(y2 * h), int(y1 * h) + 1)
                mask[t, ya:yb, xa:xb] = 1.0
                area += (xb - xa) * (yb - ya)
        # region bytes: hi-q rate scaled by covered area fraction
        frac = area / (f * h * w)
        round2_bytes = float(enc2.nbytes) * frac
        composite = (to_host(enc2.frames) * mask
                     + to_host(enc1.frames) * (1 - mask))
        det2 = run_detector(self.det_cfg, det_params,
                            torch.as_tensor(composite, device=self.device))
        boxes, labels, valid = threshold_detections(
            det2, self.theta_loc, self.theta_cls)

        # merge round-1 confident labels
        acc_v = to_host(split.acc_valid)
        labels = np.where(acc_v, to_host(split.acc_labels), labels)
        valid = valid | acc_v

        total_bytes = float(enc1.nbytes) + round2_bytes
        rounds = 1.0 + float(pv.any(axis=1).mean())   # frames with round 2
        lat = LatencyBreakdown(
            quality_control=2.0 * self.client.encode_time(f),
            transmission=(self.network.wan_time(float(enc1.nbytes))
                          + self.network.wan_time(round2_bytes)),
            cloud_inference=rounds * self.cloud.detect_time(f))
        return BaselineResult(boxes, labels, valid, total_bytes, f, rounds,
                              lat)
