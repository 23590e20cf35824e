"""The High-Low protocol generalized to LLM serving (beyond-paper, §2 of
DESIGN.md): confidence-routed big-little cascade with Eq. 8 online
adaptation of the fog model's head; PyTorch port of ``repro.core.cascade``.

Mapping from the paper's video pipeline:

  cloud detector on low-quality frames  ->  big model on the request
  confident boxes accepted directly     ->  high-margin tokens accepted
  uncertain regions -> fog classifier   ->  low-margin requests answered by
                                            the little (fog) model are
                                            escalated to the big model
  HITL + Eq. 8 last-layer updates       ->  online logit-bias adapter on the
                                            fog model's unembedding, updated
                                            from big-model (or human) labels

The adapter is a per-vocab logit bias b (the "last layer" W restricted to
its bias row — same Eq. 4 proximal structure), so fog adaptation costs O(V)
per update and ships to fog nodes for free (the paper's model-cache update).

Both forwards are :func:`repro_torch.models.transformer.forward` with
``last_token_only=True``: only the next-token logits are read, and the final
norm and unembedding act per position, so the last row equals the full
forward's.  On the card every forward runs the flash-attention (K6) and SSD
scan (K8) kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


@dataclass
class CascadeConfig:
    escalate_below: float = 0.55     # min top-token prob before escalation
    eta: float = 0.3                 # Eq. 4/8 proximal step size
    adapter_decay: float = 0.999     # proximal pull toward zero bias


@dataclass
class CascadeStats:
    fog_answered: int = 0
    escalated: int = 0
    adapter_updates: int = 0
    agreement: List[float] = field(default_factory=list)

    @property
    def escalation_rate(self) -> float:
        total = self.fog_answered + self.escalated
        return self.escalated / max(total, 1)


class BigLittleCascade:
    """Serve with the little model; escalate low-confidence requests."""

    def __init__(self, little_cfg: ModelConfig, little_params,
                 big_cfg: ModelConfig, big_params,
                 ccfg: CascadeConfig = CascadeConfig(), *, device="cuda"):
        self.device = require_device(device)
        self.little_cfg, self.little_params = little_cfg, little_params
        self.big_cfg, self.big_params = big_cfg, big_params
        self.ccfg = ccfg
        self.logit_bias = torch.zeros((little_cfg.vocab_size,),
                                      dtype=torch.float32, device=self.device)
        self.stats = CascadeStats()

    def _last_logits(self, cfg: ModelConfig, params, toks) -> torch.Tensor:
        return tfm.forward(cfg, params, toks, last_token_only=True)[0]

    # ------------------------------------------------------------------
    def answer(self, tokens: np.ndarray) -> Tuple[np.ndarray, Dict]:
        """Next-token prediction for a batch (b, s); routes per request."""
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                   device=self.device)
            little_logits = (self._last_logits(self.little_cfg,
                                               self.little_params, toks)
                             + self.logit_bias[None, None])[:, -1]
            probs = torch.softmax(little_logits, dim=-1)
            conf = probs.amax(dim=-1).cpu().numpy()
            pred = little_logits.argmax(dim=-1).cpu().numpy()

            escalate = conf < self.ccfg.escalate_below
            info = {"confidence": conf, "escalated": escalate}
            if escalate.any():
                big_logits = self._last_logits(self.big_cfg, self.big_params,
                                               toks)[:, -1]
                big_pred = big_logits.argmax(dim=-1).cpu().numpy()
                # big-model answers play the "human/golden" feedback role:
                # update the fog adapter on every escalated instance (Eq. 4)
                for i in np.nonzero(escalate)[0]:
                    self.update_adapter(little_logits[i], int(big_pred[i]))
                agree = (pred[escalate] == big_pred[escalate]).mean()
                self.stats.agreement.append(float(agree))
                pred = np.where(escalate, big_pred, pred)
        self.stats.fog_answered += int((~escalate).sum())
        self.stats.escalated += int(escalate.sum())
        return pred, info

    # ------------------------------------------------------------------
    def update_adapter(self, little_logits: torch.Tensor, label: int) -> None:
        """Eq. 4 proximal step on the logit-bias adapter:
        b <- decay*b - eta * (softmax(logits + b) - onehot(label))."""
        with torch.inference_mode():
            probs = torch.softmax(little_logits, dim=-1)  # bias already in
            grad = probs.clone()
            grad[label] -= 1.0
            self.logit_bias = (self.ccfg.adapter_decay * self.logit_bias
                               - self.ccfg.eta * grad)
        self.stats.adapter_updates += 1
