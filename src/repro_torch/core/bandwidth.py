"""Bandwidth, RTT and cloud-cost models (paper Eq. 2, §VI metrics).

Bytes are *derived* from the codec (F_v(r, q)); time and cost are modelled
from device/network profiles calibrated to the paper's Fig. 4 measurements.
The profiles are plain data: deployments override them with measured numbers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class DeviceProfile:
    """Throughput profile of one tier (paper Fig. 4)."""
    name: str
    encode_fps: float            # quality-control (re-encode) throughput
    detect_fps: float            # heavy detector inference
    classify_fps: float          # lightweight classifier (per crop batch)

    def encode_time(self, frames: int) -> float:
        return frames / self.encode_fps

    def detect_time(self, frames: int) -> float:
        return frames / self.detect_fps

    def classify_time(self, crops: int) -> float:
        return crops / self.classify_fps


# Calibrated to paper Fig. 4: the Pi cannot re-encode in real time; the
# Xavier-class fog runs quality control + classifiers fast but detectors
# slowly; the V100-class cloud runs everything fast.
CLIENT = DeviceProfile("client-rpi4", encode_fps=9.0, detect_fps=0.4,
                       classify_fps=25.0)
FOG = DeviceProfile("fog-xavier", encode_fps=120.0, detect_fps=8.0,
                    classify_fps=450.0)
CLOUD = DeviceProfile("cloud-v100", encode_fps=900.0, detect_fps=75.0,
                      classify_fps=3500.0)

PROFILES: Dict[str, DeviceProfile] = {p.name: p for p in (CLIENT, FOG, CLOUD)}


@dataclass
class NetworkModel:
    """Client/fog <-> cloud WAN and client <-> fog LAN links.

    Besides the binary ``up`` flag (Fig. 15's hard outage) the WAN link
    supports *brownouts*: time windows during which bandwidth and/or RTT
    degrade by a factor without the link going down.  Callers that pass
    the simulated time ``t`` to :meth:`wan_time` get the degraded figure
    inside an active window; callers that don't (or runs with no windows
    scheduled) take the exact original arithmetic path, so attaching an
    idle fault injector never perturbs a transfer time bitwise."""
    wan_mbps: float = 15.0       # paper micro-benchmark sweeps [10, 15, 20]
    wan_rtt_s: float = 0.04
    lan_mbps: float = 10000.0    # 10 Gbps co-located switch (paper testbed)
    lan_rtt_s: float = 0.001
    up: bool = True              # False simulates the Fig. 15 outage
    # (t0, t1, bw_factor, rtt_factor) degradation windows: inside
    # [t0, t1) effective bandwidth is wan_mbps * bw_factor and effective
    # RTT is wan_rtt_s * rtt_factor.  Overlapping windows compound.
    brownouts: List[Tuple[float, float, float, float]] = field(
        default_factory=list)

    def degradation(self, t: float) -> Tuple[float, float]:
        """(bw_factor, rtt_factor) in effect at simulated time ``t``."""
        bw, rtt = 1.0, 1.0
        for t0, t1, bf, rf in self.brownouts:
            if t0 <= t < t1:
                bw *= bf
                rtt *= rf
        return bw, rtt

    def wan_time(self, nbytes: float, t: Optional[float] = None) -> float:
        if t is not None and self.brownouts:
            bw, rtt = self.degradation(t)
            if bw != 1.0 or rtt != 1.0:
                return (self.wan_rtt_s * rtt
                        + nbytes * 8.0 / (self.wan_mbps * bw * 1e6))
        return self.wan_rtt_s + nbytes * 8.0 / (self.wan_mbps * 1e6)

    def lan_time(self, nbytes: float) -> float:
        return self.lan_rtt_s + nbytes * 8.0 / (self.lan_mbps * 1e6)


@dataclass
class CostModel:
    """Serverless per-request billing: c_F = p_F * n* (paper §VI)."""
    price_per_cloud_frame: float = 1.0    # normalized units
    extra_model_multiplier: float = 1.0   # CloudSeg runs 2 models -> 2.0

    def cost(self, cloud_frames: int, rounds: float = 1.0) -> float:
        return (self.price_per_cloud_frame * cloud_frames * rounds
                * self.extra_model_multiplier)


@dataclass
class LatencyBreakdown:
    quality_control: float = 0.0
    transmission: float = 0.0
    cloud_inference: float = 0.0
    fog_inference: float = 0.0
    # time spent waiting for cross-stream batch formation / a free cloud
    # device (zero on the sequential single-stream path)
    queue_wait: float = 0.0

    @property
    def total(self) -> float:
        return (self.quality_control + self.transmission
                + self.cloud_inference + self.fog_inference
                + self.queue_wait)

    def as_dict(self) -> Dict[str, float]:
        return {"quality_control": self.quality_control,
                "transmission": self.transmission,
                "cloud_inference": self.cloud_inference,
                "fog_inference": self.fog_inference,
                "queue_wait": self.queue_wait,
                "total": self.total}
