"""Accuracy metrics: F1 with IoU matching (paper §VI evaluation metric)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


def iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (N,4), b (M,4) xyxy -> (N, M)."""
    ax1, ay1, ax2, ay2 = [a[:, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [b[None, :, i] for i in range(4)]
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0.0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0.0)
    inter = iw * ih
    area_a = np.maximum(ax2 - ax1, 0) * np.maximum(ay2 - ay1, 0)
    area_b = np.maximum(bx2 - bx1, 0) * np.maximum(by2 - by1, 0)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


@dataclass
class F1Accumulator:
    iou_threshold: float = 0.5
    tp: int = 0
    fp: int = 0
    fn: int = 0

    def update(self, pred_boxes: np.ndarray, pred_labels: np.ndarray,
               gt_boxes: np.ndarray, gt_labels: np.ndarray) -> None:
        """One frame. gt_labels == -1 are padding; preds are pre-filtered."""
        keep = gt_labels >= 0
        gt_boxes, gt_labels = gt_boxes[keep], gt_labels[keep]
        n, m = len(pred_boxes), len(gt_boxes)
        if m == 0:
            self.fp += n
            return
        if n == 0:
            self.fn += m
            return
        iou = iou_np(np.asarray(pred_boxes), np.asarray(gt_boxes))
        matched_gt = set()
        order = np.argsort(-iou.max(axis=1))
        for i in order:
            j = int(np.argmax(np.where(
                [jj not in matched_gt for jj in range(m)], iou[i], -1.0)))
            if iou[i, j] >= self.iou_threshold and j not in matched_gt:
                matched_gt.add(j)
                if pred_labels[i] == gt_labels[j]:
                    self.tp += 1
                else:
                    self.fp += 1
                    self.fn += 1
            else:
                self.fp += 1
        self.fn += m - len(matched_gt)

    @property
    def precision(self) -> float:
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def recall(self) -> float:
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / max(p + r, 1e-9)

    def summary(self) -> Dict[str, float]:
        return {"precision": self.precision, "recall": self.recall,
                "f1": self.f1, "tp": self.tp, "fp": self.fp, "fn": self.fn}


def localization_recall(pred_boxes: np.ndarray, gt_boxes: np.ndarray,
                        gt_labels: np.ndarray,
                        iou_threshold: float = 0.5) -> float:
    """Class-agnostic recall (measures Key Obs 2: localization power)."""
    keep = gt_labels >= 0
    gt = gt_boxes[keep]
    if len(gt) == 0:
        return 1.0
    if len(pred_boxes) == 0:
        return 0.0
    iou = iou_np(np.asarray(pred_boxes), np.asarray(gt))
    return float(np.mean(iou.max(axis=0) >= iou_threshold))
