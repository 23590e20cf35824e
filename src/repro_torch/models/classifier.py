"""The fog classifier: feature backbone + one-vs-all binary heads (§IV.B),
PyTorch port of ``repro.models.classifier``.

Following the paper, the pipeline is a feature-extraction backbone (the
"pre-trained on ImageNet" network) producing x_t, fed into a set of binary
one-vs-all classifiers with weight matrix W — the object updated online by
the §V incremental-learning rule (bias absorbed by appending 1 to x_t).

Every readout runs through the one-vs-all kernel
(:func:`repro_torch.kernels.ops.onevsall_scores`): a single W, the per-crop
stacked readouts of the compacted path, and the snapshot lineages of the
Eq. 9 ensembles.  Crops are NHWC at this interface; parameters are the
port's (conv weights OIHW).  :func:`classifier_loss`, the backbone's
pre-training loss, is the one readout that does not go through the kernel:
the kernel is forward only, and the reference takes this product outside
Pallas too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.vpaas_video import ClassifierConfig
from repro_torch.kernels import ops
from repro_torch.models.detector import conv_same


def features(cfg: ClassifierConfig, params, crops: torch.Tensor
             ) -> torch.Tensor:
    """crops (b, h, w, 3) -> x_t (b, feature_dim + 1) with appended 1."""
    x = crops.permute(0, 3, 1, 2)                   # NHWC -> NCHW
    for i in range(len(cfg.widths)):
        x = torch.relu(conv_same(params[f"conv{i}"], x, 2))
    x = x.mean(dim=(2, 3))                          # global average pool
    x = torch.relu(x @ params["proj"])
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1)             # bias-absorbing 1


def classify(cfg: ClassifierConfig, params, crops: torch.Tensor,
             W: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """Returns per-class one-vs-all scores + argmax prediction.

    ``W`` overrides ``params["W"]`` — this is how incremental-learning
    snapshots {W_t} are evaluated without rebuilding the params."""
    x = features(cfg, params, crops)
    w = params["W"] if W is None else W
    scores = ops.onevsall_scores(x, w[None])        # (b, C) binary probs
    return {"features": x, "scores": scores, "pred": scores.argmax(dim=-1),
            "confidence": scores.amax(dim=-1)}


def classify_multi(cfg: ClassifierConfig, params, crops: torch.Tensor,
                   Ws: torch.Tensor, widx: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """One-vs-all scores with a *per-crop* readout selection.

    ``Ws`` stacks G readout matrices (G, feature_dim + 1, C) and ``widx``
    (b,) picks crop b's readout — the cross-stream compacted classify path
    scores each stream's crops against that stream's own W in one kernel
    launch."""
    x = features(cfg, params, crops)
    return {"features": x, "scores": ops.onevsall_scores(x, Ws, widx)}


def _lineage_scores(x: torch.Tensor, snaps: torch.Tensor,
                    sidx: torch.Tensor) -> torch.Tensor:
    """sigmoid(x_b @ snaps[sidx[b, t]]) for every row b and snapshot t:
    (b, T) snapshot indices into the flattened (S, d+1, C) stack -> (b, T, C),
    one kernel launch over the b * T (row, snapshot) pairs."""
    b, t = sidx.shape
    z = ops.onevsall_scores(x.repeat_interleave(t, dim=0), snaps,
                            sidx.reshape(-1).to(torch.int32))
    return z.reshape(b, t, -1)


def classify_ensemble(cfg: ClassifierConfig, params, crops: torch.Tensor,
                      snaps: torch.Tensor, omega: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Eq. (9) snapshot-ensemble scores over one stream's readout lineage.

    ``snaps`` stacks T readout snapshots (T, feature_dim + 1, C) and
    ``omega`` (T,) holds their ridge ensemble weights; the combined score
    is sum_t omega_t * sigmoid(x @ W_t), sharing one backbone pass across
    all snapshots."""
    x = features(cfg, params, crops)
    t = snaps.shape[0]
    sidx = torch.arange(t, device=x.device).expand(x.shape[0], t)
    z = _lineage_scores(x, snaps, sidx)
    scores = torch.einsum("t,btc->bc", omega, z)
    return {"features": x, "scores": scores}


def classify_ensemble_multi(cfg: ClassifierConfig, params,
                            crops: torch.Tensor, snaps: torch.Tensor,
                            omegas: torch.Tensor, widx: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
    """Per-crop ensemble selection: the cross-stream compacted variant.

    ``snaps`` stacks G per-stream snapshot lineages (G, T, feature_dim + 1,
    C) — lineages shorter than T are padded with zero snapshots whose
    ``omegas`` entry is 0.0 — and ``widx`` (b,) picks crop b's lineage."""
    x = features(cfg, params, crops)
    g, t = snaps.shape[0], snaps.shape[1]
    widx = widx.long()
    sidx = widx[:, None] * t + torch.arange(t, device=x.device)
    z = _lineage_scores(x, snaps.reshape(g * t, *snaps.shape[2:]), sidx)
    scores = torch.einsum("bt,btc->bc", omegas[widx], z)
    return {"features": x, "scores": scores}


def classifier_loss(cfg: ClassifierConfig, params, crops: torch.Tensor,
                    labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-vs-all BCE over all binary heads (backbone pre-training)."""
    x = features(cfg, params, crops)
    logits = x @ params["W"]
    onehot = F.one_hot(labels.to(torch.int64), cfg.num_classes).to(x.dtype)
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * onehot
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean((logits.argmax(dim=-1) == labels).to(torch.float32))
    return loss, {"acc": acc}


def param_shapes(cfg: ClassifierConfig) -> Dict[str, Tuple[int, ...]]:
    """The JAX schema's shapes (HWIO convs), as ``repro.models.classifier
    .classifier_schema`` declares them."""
    s, cin = {}, cfg.in_channels
    for i, w in enumerate(cfg.widths):
        s[f"conv{i}"] = {"w": (3, 3, cin, w), "b": (w,)}
        cin = w
    s["proj"] = (cin, cfg.feature_dim)
    s["W"] = (cfg.feature_dim + 1, cfg.num_classes)
    return s
