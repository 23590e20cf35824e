"""Continual-learning plane (§V online): drift detection, budgeted HITL
labeling, background incremental training, shadow evaluation, and
zero-downtime fog-model hot-swap.

The serving plane (``repro_torch.serving.graph``) executes chunks; this
package runs *beside* it, closing the paper's human-feedback loop online:

  drift -> label (budget tau, most-uncertain-first) -> train (Eq. 8/4)
        -> shadow-eval vs holdout replay -> promote / rollback -> hot-swap

PyTorch port of ``repro.learning``: the plane is host numpy over the
scheduler's chunk results, as in the reference; each site's background
trainer runs the §V update on the scheduler's device, where every proximal
step is the fused update kernel K5.
"""
from repro_torch.learning.drift import (DriftConfig, DriftDetector,
                                        DriftEvent, HealthPosterior)
from repro_torch.learning.labeling import LabelCandidate, LabelingQueue
from repro_torch.learning.plane import ContinualLearningPlane, LearningConfig
from repro_torch.learning.promotion import (PromotionGate, ReplayBuffer,
                                            ShadowEvaluator)
from repro_torch.learning.trainer import BackgroundTrainer

__all__ = [
    "BackgroundTrainer", "ContinualLearningPlane", "DriftConfig",
    "DriftDetector", "DriftEvent", "HealthPosterior", "LabelCandidate",
    "LabelingQueue", "LearningConfig", "PromotionGate", "ReplayBuffer",
    "ShadowEvaluator",
]
