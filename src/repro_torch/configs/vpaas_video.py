"""The paper's own models: the cloud detector and the fog classifier.

The cloud detector plays the FasterRCNN-101 role: a conv backbone + a dense
per-cell head that emits *separately* a location-confidence (objectness)
signal, box geometry, and classification logits — the two-signal structure
the High-Low protocol exploits (Key Observations 1-3).

The fog classifier plays the lightweight one-vs-all pipeline of §IV.B: a
small conv backbone (feature extractor, "pre-trained on ImageNet" in the
paper) + a set of binary one-vs-all classifier heads whose weight matrix W is
the object of the §V incremental-learning updates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DetectorConfig:
    name: str = "vpaas-cloud-detector"
    image_hw: Tuple[int, int] = (128, 128)   # detector input resolution
    in_channels: int = 3
    widths: Tuple[int, ...] = (48, 96, 192)  # backbone stage widths (stride 2 each)
    num_classes: int = 8
    max_regions: int = 32          # fixed-size region budget (lax-friendly)
    nms_iou: float = 0.45
    source = "paper Fig 6 (FasterRCNN-101 stand-in, two-signal head)"

    @property
    def grid_hw(self) -> Tuple[int, int]:
        s = 2 ** len(self.widths)
        return (self.image_hw[0] // s, self.image_hw[1] // s)


@dataclass(frozen=True)
class ClassifierConfig:
    name: str = "vpaas-fog-classifier"
    crop_hw: Tuple[int, int] = (40, 40)      # region crop resolution
    in_channels: int = 3
    widths: Tuple[int, ...] = (16, 32, 64)
    feature_dim: int = 128         # backbone output feature (x_t in §V)
    num_classes: int = 8           # one-vs-all binary heads
    source = "paper §IV.B (one-vs-all reduction, Rifkin & Klautau)"


DETECTOR = DetectorConfig()
CLASSIFIER = ClassifierConfig()

# A smaller fog detector for the fault-tolerance fallback (YOLOv3 role).
FALLBACK_DETECTOR = DetectorConfig(
    name="vpaas-fog-fallback-detector",
    image_hw=(64, 64),
    widths=(16, 32, 64),
    num_classes=8,
    max_regions=32,
)
