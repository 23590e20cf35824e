"""Budgeted HITL labeling queue: most-uncertain-first under labor budget tau.

The paper's human operator has a fixed labor budget (§V).  The serving
plane's old behaviour ("label every proposal of every chunk") burns it on
regions the fog classifier already handles; this queue spends it where the
model is *least sure*.  On drift, uncertain regions are enqueued as
:class:`LabelCandidate`s ranked by margin uncertainty
(``1 - (top1 - top2)`` of the one-vs-all scores — a near-tie between two
heads is exactly where a human label buys the most), and ``issue`` pops the
top-K and asks the :class:`~repro_torch.core.hitl.OracleAnnotator` to label
only those — the annotator's own budget caps the charge to labels actually
issued.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hitl import UNLABELED, OracleAnnotator


def margin_uncertainty(scores: np.ndarray) -> float:
    """1 - (top1 - top2) of one-vs-all scores; 1.0 = maximally uncertain."""
    s = np.sort(np.asarray(scores, np.float64))
    if s.size < 2:
        return 1.0
    return float(np.clip(1.0 - (s[-1] - s[-2]), 0.0, 1.0))


@dataclass
class LabelCandidate:
    """One uncertain region awaiting a (possible) human label."""
    features: np.ndarray         # (d+1,) fog classifier features
    box: np.ndarray              # (4,) proposal box
    scores: np.ndarray           # (C,) one-vs-all scores
    gt_boxes: np.ndarray         # (M, 4) frame ground truth (oracle's view)
    gt_labels: np.ndarray        # (M,)
    stream: str = ""
    t: float = 0.0
    uncertainty: float = field(default=0.0)
    # readout version whose scores produced ``uncertainty``: candidates from
    # before a promotion rank by the *old* model's confusion and must be
    # re-scored (or expired) against the promoted readout before they can
    # compete fairly for the labor budget
    model_version: int = 0

    def __post_init__(self):
        if not self.uncertainty:
            self.uncertainty = margin_uncertainty(self.scores)


@dataclass
class IssuedLabel:
    candidate: LabelCandidate
    label: int                   # >= 0 class, BACKGROUND, or UNLABELED


class LabelingQueue:
    """Bounded max-heap of label candidates, most-uncertain-first."""

    def __init__(self, max_size: int = 4096):
        self.max_size = max_size
        self._heap: List[Tuple[float, int, LabelCandidate]] = []
        self._seq = itertools.count()
        self.stats: Dict[str, int] = {"enqueued": 0, "dropped": 0,
                                      "issued": 0, "background": 0,
                                      "unlabeled": 0, "rescored": 0,
                                      "expired": 0}

    def push(self, cand: LabelCandidate) -> bool:
        self.stats["enqueued"] += 1
        if len(self._heap) >= self.max_size:
            # full: the queue keeps the most uncertain candidates — evict
            # the least-uncertain entry only if the newcomer beats it
            worst = max(self._heap)           # max of (-u, seq): smallest u
            if cand.uncertainty <= -worst[0]:
                self.stats["dropped"] += 1
                return False
            self._heap.remove(worst)
            heapq.heapify(self._heap)
            self.stats["dropped"] += 1
        heapq.heappush(self._heap,
                       (-cand.uncertainty, next(self._seq), cand))
        return True

    def pop(self) -> Optional[LabelCandidate]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def pop_random(self, rng: np.random.Generator
                   ) -> Optional[LabelCandidate]:
        if not self._heap:
            return None
        entry = self._heap[int(rng.integers(len(self._heap)))]
        self._heap.remove(entry)
        heapq.heapify(self._heap)
        return entry[2]

    def issue(self, annotator: OracleAnnotator, k: int,
              explore: float = 0.0,
              rng: Optional[np.random.Generator] = None
              ) -> List[IssuedLabel]:
        """Label up to ``k`` queued candidates via the oracle.

        Candidates are drawn most-uncertain-first; an ``explore`` fraction
        is drawn uniformly from the queue instead (epsilon-greedy active
        learning: under a full distribution shift *every* region is
        miscalibrated, and labeling only the near-ties skews the training
        set toward intrinsically ambiguous crops).  The annotator's budget
        is the hard cap: candidates it declines (budget exhausted) come
        back ``UNLABELED`` and are *not* charged."""
        rng = rng or np.random.default_rng(0)
        out: List[IssuedLabel] = []
        for j in range(max(0, k)):
            if annotator.remaining == 0:      # None (unlimited) passes
                break
            take_random = explore > 0.0 and rng.random() < explore
            cand = self.pop_random(rng) if take_random else self.pop()
            if cand is None:
                break
            labels = annotator.label_regions(
                cand.box[None, :], cand.gt_boxes, cand.gt_labels)
            lab = int(labels[0])
            if lab == UNLABELED:
                self.stats["unlabeled"] += 1
            else:
                self.stats["issued"] += 1
                if lab < 0:
                    self.stats["background"] += 1
            out.append(IssuedLabel(cand, lab))
        return out

    def rescore(self, W, *, version: int,
                expire_below: float = 0.0) -> Dict[str, int]:
        """Age the queue after a model promotion / rollback hot-swap.

        Every candidate enqueued under an older ``model_version`` has its
        one-vs-all scores recomputed against the new readout ``W`` (the
        stored features make this a host-side matmul — no crop is re-run)
        and its priority re-ranked by the *new* model's margin uncertainty.
        Candidates the promoted model now answers confidently
        (``uncertainty < expire_below``) are expired: a human label there
        buys almost nothing, and holding the slot starves fresher, genuinely
        uncertain regions.  Returns ``{"rescored": ..., "expired": ...}``.
        """
        W = np.asarray(W, np.float64)
        kept: List[Tuple[float, int, LabelCandidate]] = []
        rescored = expired = 0
        for neg_u, seq, cand in self._heap:
            if cand.model_version >= version:
                kept.append((neg_u, seq, cand))
                continue
            scores = 1.0 / (1.0 + np.exp(-(np.asarray(cand.features,
                                                      np.float64) @ W)))
            cand.scores = scores
            cand.uncertainty = margin_uncertainty(scores)
            cand.model_version = version
            rescored += 1
            if cand.uncertainty < expire_below:
                expired += 1
                continue
            kept.append((-cand.uncertainty, seq, cand))
        self._heap = kept
        heapq.heapify(self._heap)
        self.stats["rescored"] += rescored
        self.stats["expired"] += expired
        return {"rescored": rescored, "expired": expired}

    def __len__(self) -> int:
        return len(self._heap)
