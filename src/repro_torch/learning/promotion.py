"""Shadow evaluation + promotion gate for candidate fog models.

A candidate W trained by the background trainer must not reach the serving
path on faith: it is scored against a **holdout replay buffer** — a slice
of issued human labels the trainer never saw — and promoted only when it
beats the live model by ``min_gain`` on at least ``min_holdout`` samples.

Promotion-gate invariants:

  1. never promote on fewer than ``min_holdout`` holdout samples;
  2. never promote a candidate that does not beat the live score by
     ``min_gain``;
  3. rollback fires only when the *previous* promoted version beats the
     live one by ``rollback_margin``, both scored on the **same** current
     holdout — a refreshing holdout cannot fake a regression;
  4. rollback restores the prior version's stored weights bit-identically
     (the zoo never mutates a registered record).

PyTorch port of ``repro.learning.promotion``: the zoo keeps host (numpy)
readouts and the holdout is host data, so the gate scores them on the
host, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.incremental import ensemble_accuracy, eval_accuracy


class ReplayBuffer:
    """Ring buffer of (feature, label) pairs — the holdout slice."""

    def __init__(self, max_size: int = 1024):
        self.max_size = max_size
        self._xs: List[np.ndarray] = []
        self._labels: List[int] = []
        self._ts: List[float] = []

    def add(self, x: np.ndarray, label: int, t: float = 0.0) -> None:
        self._xs.append(np.asarray(x, np.float32))
        self._labels.append(int(label))
        self._ts.append(float(t))
        if len(self._xs) > self.max_size:
            self._xs.pop(0)
            self._labels.pop(0)
            self._ts.pop(0)

    def drop_older_than(self, t: float,
                        into: Optional["ReplayBuffer"] = None) -> int:
        """Drop pre-drift holdout samples: the gate must judge candidates
        against the distribution the live model currently serves.

        ``into`` receives the dropped samples instead of discarding them —
        the learning plane archives the old regime's labels there so the
        Eq. 9 ensemble (whose whole point is spanning regimes) can still
        be fit and judged on data the single-readout gate rightly
        ignores.  Nothing is re-charged: these labels were already paid
        for."""
        keep = [i for i, ti in enumerate(self._ts) if ti >= t]
        dropped = len(self._ts) - len(keep)
        if into is not None:
            kept = set(keep)
            for i in range(len(self._ts)):
                if i not in kept:
                    into.add(self._xs[i], self._labels[i], t=self._ts[i])
        self._xs = [self._xs[i] for i in keep]
        self._labels = [self._labels[i] for i in keep]
        self._ts = [self._ts[i] for i in keep]
        return dropped

    def data(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._xs:
            return (np.zeros((0, 1), np.float32), np.zeros((0,), np.int64))
        return np.stack(self._xs), np.asarray(self._labels, np.int64)

    def times(self) -> List[float]:
        return list(self._ts)

    def __len__(self) -> int:
        return len(self._xs)


@dataclass
class ShadowEvaluator:
    """Scores readout candidates against the holdout replay buffer."""
    holdout: ReplayBuffer = field(default_factory=ReplayBuffer)

    def score(self, W) -> float:
        xs, labels = self.holdout.data()
        return eval_accuracy(W, xs, labels)

    def score_ensemble(self, snaps, omega) -> float:
        """Holdout accuracy of the Eq. (9) snapshot ensemble."""
        xs, labels = self.holdout.data()
        if not len(xs):
            return 0.0
        return ensemble_accuracy(np.asarray(snaps), np.asarray(omega),
                                 xs, labels)


@dataclass
class PromotionGate:
    evaluator: ShadowEvaluator
    min_holdout: int = 8
    min_gain: float = 0.0        # candidate must beat live by this much
    rollback_margin: float = 0.1

    promotions: int = 0
    rollbacks: int = 0
    decisions: List[Dict] = field(default_factory=list)
    # score the live model was admitted at (reporting only — the rollback
    # decision is the same-holdout comparison in should_rollback)
    promoted_score: Optional[float] = None

    def evaluate(self, live_W, cand_W, t: float = 0.0) -> Dict:
        """Shadow-evaluate a candidate; returns the decision record."""
        n = len(self.evaluator.holdout)
        live = self.evaluator.score(live_W)
        cand = self.evaluator.score(cand_W)
        promote = (n >= self.min_holdout
                   and cand >= live + self.min_gain
                   and cand > 0.0)
        rec = {"t": t, "holdout": n, "live_score": live,
               "cand_score": cand, "promote": promote}
        self.decisions.append(rec)
        return rec

    def evaluate_ensemble(self, live_W, snaps, omega, t: float = 0.0,
                          extra=None) -> Dict:
        """Gate the Eq. (9) ensemble against the latest promoted readout.

        Same invariants as :meth:`evaluate` — enough holdout, and the
        ensemble must not score *below* the live single readout (serving
        it on a tie is safe: its degenerate case is the live readout) —
        but scored on the holdout PLUS the ``extra`` (xs, labels) archive
        of pre-episode samples.  The single-readout gate judges candidates
        on the regime the model currently serves; the ensemble's whole
        point is robustness across the regimes the site has *ever*
        served, so it is judged on that union."""
        xs, labels = self.evaluator.holdout.data()
        if extra is not None and len(extra[0]):
            xs = np.concatenate([xs, np.asarray(extra[0], xs.dtype)]) \
                if len(xs) else np.asarray(extra[0])
            labels = np.concatenate([labels,
                                     np.asarray(extra[1], np.int64)])
        n = len(self.evaluator.holdout)
        live = eval_accuracy(live_W, xs, labels)
        ens = ensemble_accuracy(np.asarray(snaps), np.asarray(omega),
                                xs, labels)
        promote = n >= self.min_holdout and ens >= live and ens > 0.0
        rec = {"t": t, "holdout": n, "eval_samples": int(len(xs)),
               "live_score": live, "ens_score": ens, "promote": promote,
               "snapshots": int(np.asarray(snaps).shape[0])}
        self.decisions.append(rec)
        return rec

    def note_promotion(self, score: float) -> None:
        self.promotions += 1
        self.promoted_score = score

    def should_rollback(self, live_W, prev_W) -> Tuple[bool, float]:
        """True when the *previous* promoted model now beats the live one
        by the rollback margin.

        Both models are scored on the same current holdout, so the check is
        immune to the holdout refreshing under the gate (an absolute
        score-drop test would read distribution enrichment as regression
        and roll back a healthy promotion)."""
        if len(self.evaluator.holdout) < self.min_holdout:
            return False, 0.0
        live = self.evaluator.score(live_W)
        prev = self.evaluator.score(prev_W)
        return prev > live + self.rollback_margin, live

    def note_rollback(self, score: Optional[float] = None) -> None:
        self.rollbacks += 1
        self.promoted_score = score
