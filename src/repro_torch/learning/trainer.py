"""Background incremental trainer: labeled batches -> versioned candidates.

The auto-training backend of §III.D, run *off* the serving path: issued
labels accumulate in a replay buffer, and every ``min_batch`` fresh labels
the trainer applies the §V update rule (Eq. 8 closed form or the proximal
sigmoid-BCE variant) starting from the **current live** fog readout W,
replaying the full buffer.  Each resulting W_t is

  * kept as a snapshot for the Eq. (9) ensemble (``fit_ensemble``), and
  * registered as a **candidate version** in the extended
    :class:`~repro_torch.serving.registry.ModelZoo` with lineage metadata —
    parent (live) version, the training-data span it consumed, and the
    fresh labels the round cost — for the shadow evaluator / promotion
    gate to judge.

Training cost is charged to a background clock (``train_time_s``), never
to any chunk's serving latency.

PyTorch port of ``repro.learning.trainer``: the replay runs on the
trainer's ``device`` (the learning plane passes the scheduler's), where
each proximal step is one launch of the fused update K5; the candidate is
registered in the zoo as a host array, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.core.incremental import batch_update, ensemble_weights
from repro_torch.core.protocol import to_host
from repro_torch.learning.promotion import ReplayBuffer
from repro_torch.serving.registry import ModelRecord, ModelZoo


@dataclass
class BackgroundTrainer:
    zoo: ModelZoo
    num_classes: int = 0
    model_name: str = "fog-classifier"
    rule: str = "proximal"
    eta: float = 0.3
    passes: int = 2
    min_batch: int = 16          # fresh labels per training round
    max_buffer: int = 2048       # replay buffer cap (oldest dropped)
    keep_snapshots: int = 8
    # simulated per-instance training cost (background accounting only)
    per_label_train_s: float = 2e-4
    # where the replay runs: "cuda" launches K5 per step, "cpu" its plain
    # version
    device: Any = "cuda"

    rounds: int = 0
    train_time_s: float = 0.0
    labels_consumed: int = 0
    snapshots: List[np.ndarray] = field(default_factory=list)
    snapshot_versions: List[int] = field(default_factory=list)
    omega: Optional[np.ndarray] = None
    buffer: ReplayBuffer = None
    _fresh: int = 0
    _ens_snapshots: Optional[np.ndarray] = None
    seed_version: Optional[int] = None

    def __post_init__(self):
        self.device = require_device(self.device)
        if self.buffer is None:
            self.buffer = ReplayBuffer(max_size=self.max_buffer)

    def add_labeled(self, x: np.ndarray, label: int,
                    t: float = 0.0) -> None:
        self.buffer.add(x, label, t=t)
        self._fresh += 1

    def seed_snapshot(self, W, version: Optional[int] = None) -> None:
        """Anchor a drift episode's *starting* readout as snapshot W_0.

        Eq. (9)'s snapshot set {W_t} spans the adaptation trajectory from
        the pre-episode model onward; without the anchor the ensemble can
        only mix post-drift candidates and loses the old regime entirely —
        exactly the regime a site that oscillates between appearances
        needs back.  Called at episode entry; resets the lineage so each
        episode's ensemble is fit over its own trajectory."""
        self.snapshots = [to_host(W)]
        self.seed_version = version if version is not None else 0
        self.snapshot_versions = [self.seed_version]

    def drop_older_than(self, t: float) -> int:
        """Invalidate labels collected before ``t`` (a drift event makes
        pre-drift labels stale for the *new* regime; earlier regimes stay
        represented through the kept snapshots / Eq. 9 ensemble)."""
        dropped = self.buffer.drop_older_than(t)
        self._fresh = min(self._fresh, len(self.buffer))
        return dropped

    @property
    def buffered(self) -> int:
        return len(self.buffer)

    def ready(self) -> bool:
        return len(self.buffer) > 0 and self._fresh >= self.min_batch

    def _training_arrays(self):
        xs, labels = self.buffer.data()
        ys = np.zeros((len(labels), self.num_classes), np.float32)
        ys[np.arange(len(labels)), labels] = 1.0
        return (torch.as_tensor(xs, device=self.device),
                torch.as_tensor(ys, device=self.device))

    def maybe_train(self, base_W, t: float = 0.0,
                    parent_version: Optional[int] = None
                    ) -> Optional[ModelRecord]:
        """Run one training round when enough fresh labels accumulated.

        Returns the candidate's zoo record (a *version*, not a promotion)."""
        if not self.ready():
            return None
        xs, ys = self._training_arrays()
        W_new = to_host(batch_update(
            torch.as_tensor(base_W, device=self.device), xs, ys,
            rule=self.rule, eta=self.eta, passes=self.passes))
        fresh_cost = self._fresh
        self.rounds += 1
        self.labels_consumed += fresh_cost
        self.train_time_s += (self.per_label_train_s * len(self.buffer)
                              * max(self.passes, 1))
        self._fresh = 0
        ts = self.buffer.times()
        rec = self.zoo.register_version(
            self.model_name, {"W": W_new},
            lineage={"parent_version": parent_version,
                     "trained_at": t,
                     "data_span": (min(ts), max(ts)),
                     "labels": fresh_cost,
                     "replayed": len(self.buffer),
                     "rule": self.rule, "round": self.rounds})
        self.snapshots.append(W_new)
        self.snapshot_versions.append(rec.version)
        if len(self.snapshots) > self.keep_snapshots:
            if (self.seed_version is not None
                    and self.keep_snapshots >= 2
                    and self.snapshot_versions[0] == self.seed_version):
                # a seeded episode pins its anchor W_0: the rolling window
                # trims the middle, never the regime the ensemble must keep
                head = self.keep_snapshots - 1
                self.snapshots = [self.snapshots[0]] + self.snapshots[-head:]
                self.snapshot_versions = ([self.snapshot_versions[0]]
                                          + self.snapshot_versions[-head:])
            else:
                self.snapshots = self.snapshots[-self.keep_snapshots:]
                self.snapshot_versions = (
                    self.snapshot_versions[-self.keep_snapshots:])
        return rec

    def fit_ensemble(self, v: float = 1e-2, versions: Optional[set] = None,
                     extra=None) -> Optional[np.ndarray]:
        """Eq. (9) ridge weights over the kept snapshots (reusing the
        buffered labelled data, as §V prescribes).

        ``versions`` restricts the snapshot set by zoo version — the plane
        passes the episode's *promoted* lineage (plus the seed anchor W_0)
        so the ensemble mixes only models that earned serving through the
        gate; ridge-fitting over rejected candidates dilutes it with
        components that already lost on the holdout.  ``extra`` appends an
        archived (xs, labels) slice from *before* the episode, so omega
        balances the snapshots across both regimes instead of collapsing
        onto whatever the current buffer holds."""
        keep = [i for i, ver in enumerate(self.snapshot_versions)
                if versions is None or ver in versions]
        if len(keep) < 2 or not len(self.buffer):
            self.omega = None
            self._ens_snapshots = None
            return None
        xs, ys = self._training_arrays()
        if extra is not None and len(extra[0]):
            ex = np.asarray(extra[0], np.float32)
            ey = np.zeros((len(extra[1]), self.num_classes), np.float32)
            ey[np.arange(len(extra[1])), np.asarray(extra[1], int)] = 1.0
            xs = torch.cat([xs, torch.as_tensor(ex, device=self.device)])
            ys = torch.cat([ys, torch.as_tensor(ey, device=self.device)])
        picked = [self.snapshots[i] for i in keep]
        snaps = torch.as_tensor(np.stack(picked), device=self.device)
        self.omega = to_host(ensemble_weights(snaps, xs, ys, v=v))
        self._ens_snapshots = np.stack(picked)
        return self.omega

    def ensemble(self) -> Optional[tuple]:
        """(stacked snapshots (T, d+1, C), omega (T,)) once fit, else None
        — the servable Eq. (9) artifact for ``hot_swap_ensemble``."""
        snaps = getattr(self, "_ens_snapshots", None)
        if self.omega is None or snaps is None:
            return None
        return snaps, np.asarray(self.omega)

    def summary(self) -> Dict[str, Any]:
        return {"rounds": self.rounds, "labels_consumed": self.labels_consumed,
                "buffered": self.buffered, "train_time_s": self.train_time_s,
                "snapshots": len(self.snapshots),
                "snapshot_versions": list(self.snapshot_versions)}
