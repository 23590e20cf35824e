"""Glimpse baseline (client-driven): pixel-difference frame filter +
client-side tracking between triggered frames [Chen et al., SenSys'15];
PyTorch port of ``repro.baselines.glimpse``.

Frames whose pixel delta vs the last *sent* frame exceeds a threshold are
shipped to the cloud; in between, the last detections are carried forward by
a global-motion estimate (our stand-in for Glimpse's feature tracker, per
the paper's note that their re-implementation uses an OpenCV tracker).  The
trigger and the tracker are client-side host numpy; each triggered frame
is encoded and detected on the baseline's device, and its NMS runs K4a on
the card (F = 1).
"""
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


def _global_shift(prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Coarse global motion (dx, dy) in [0,1] units via argmax correlation
    of downsampled grayscale images (cheap client-side tracking)."""
    def gray_small(x):
        g = x.mean(-1)
        return g[::4, ::4]
    a, b = gray_small(prev), gray_small(cur)
    fa, fb = np.fft.rfft2(a), np.fft.rfft2(b)
    corr = np.fft.irfft2(fa.conj() * fb, a.shape)
    dy, dx = np.unravel_index(np.argmax(corr), corr.shape)
    h, w = a.shape
    if dy > h // 2:
        dy -= h
    if dx > w // 2:
        dx -= w
    return np.array([dx * 4 / prev.shape[1], dy * 4 / prev.shape[0]])


@dataclass
class GlimpseBaseline:
    det_cfg: DetectorConfig
    diff_threshold: float = 0.02   # mean abs pixel delta trigger
    q: int = 26
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
        f = frames_hq.shape[0]
        gh, gw = self.det_cfg.grid_hw
        n = gh * gw
        boxes = np.zeros((f, n, 4), np.float32)
        labels = np.zeros((f, n), np.int64)
        valid = np.zeros((f, n), bool)

        total_bytes = 0.0
        sent = 0
        last_sent = None
        last_boxes = np.zeros((n, 4), np.float32)
        last_labels = np.zeros((n,), np.int64)
        last_valid = np.zeros((n,), bool)

        for t in range(f):
            frame = frames_hq[t]
            trigger = (last_sent is None or np.mean(
                np.abs(frame - last_sent)) > self.diff_threshold)
            if trigger:
                enc = codec.encode(
                    torch.as_tensor(frame[None], device=self.device),
                    self.r, self.q)
                total_bytes += float(enc.nbytes)
                det = run_detector(self.det_cfg, det_params, enc.frames)
                b, l, v = threshold_detections(det, self.theta_loc,
                                               self.theta_cls)
                last_boxes, last_labels, last_valid = b[0], l[0], v[0]
                last_sent = frame
                sent += 1
            else:
                shift = _global_shift(last_sent, frame)
                moved = last_boxes.copy()
                moved[:, [0, 2]] += shift[0]
                moved[:, [1, 3]] += shift[1]
                last_boxes = np.clip(moved, 0.0, 1.0)
            boxes[t], labels[t], valid[t] = (last_boxes, last_labels,
                                             last_valid)

        lat = LatencyBreakdown(
            quality_control=self.client.encode_time(sent),
            transmission=self.network.wan_time(total_bytes),
            cloud_inference=self.cloud.detect_time(sent))
        return BaselineResult(boxes, labels, valid, total_bytes, sent, 1.0,
                              lat)
