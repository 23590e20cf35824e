"""Human-in-the-loop simulation: the annotator frontend of §V / Fig. 8.

The paper's human operator checks cropped regions and corrects wrong labels.
Here ground truth from the synthetic dataset plays the oracle; a labelling
budget and a per-label cost model the limited "human labor budget" tau.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.video.metrics import iou_np

BACKGROUND = -1
UNLABELED = -2     # box the operator never inspected (budget exhausted)


@dataclass
class OracleAnnotator:
    """Assigns ground-truth labels to cropped regions (IoU matching).

    ``budget`` models the paper's human labor budget tau: once
    ``labels_provided`` reaches it, remaining boxes come back ``UNLABELED``
    and are **not charged** — the operator never looked at them.  A
    ``BACKGROUND`` verdict *is* charged (inspecting a region and calling it
    background is labor all the same)."""
    iou_threshold: float = 0.4
    budget: Optional[int] = None    # max labels to issue (None = unlimited)
    labels_provided: int = 0

    @property
    def remaining(self) -> Optional[int]:
        if self.budget is None:
            return None
        return max(0, self.budget - self.labels_provided)

    def label_regions(
        self,
        boxes: np.ndarray,          # (N, 4) proposal boxes (one frame)
        gt_boxes: np.ndarray,       # (M, 4)
        gt_labels: np.ndarray,      # (M,)
    ) -> np.ndarray:
        """Returns (N,) labels; BACKGROUND where no gt matches, UNLABELED
        for boxes past the labor budget (charged only for issued labels)."""
        keep = gt_labels >= 0
        gt_b, gt_l = gt_boxes[keep], gt_labels[keep]
        n = len(boxes)
        charge = n if self.remaining is None else min(n, self.remaining)
        out = np.full(n, UNLABELED, np.int64)
        out[:charge] = BACKGROUND
        if len(gt_b) and charge:
            iou = iou_np(np.asarray(boxes)[:charge], gt_b)
            best = iou.argmax(axis=1)
            hit = iou[np.arange(charge), best] >= self.iou_threshold
            idx = np.arange(charge)[hit]
            out[idx] = gt_l[best[hit]]
        self.labels_provided += int(charge)
        return out


@dataclass
class FeedbackQueue:
    """Data collector (§III.D): buffers (crop, prediction) pairs for review."""
    max_size: int = 4096
    items: List[Tuple[np.ndarray, np.ndarray, int]] = None

    def __post_init__(self):
        self.items = []

    def push(self, features: np.ndarray, box: np.ndarray, pred: int) -> None:
        if len(self.items) < self.max_size:
            self.items.append((features, box, pred))

    def drain(self) -> List[Tuple[np.ndarray, np.ndarray, int]]:
        out, self.items = self.items, []
        return out
