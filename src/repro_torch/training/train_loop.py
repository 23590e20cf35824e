"""Video-model training (detector / classifier pre-training), port of the
video half of ``repro.training.train_loop``.

Each loop keeps the reference's schedule and random streams: batches from
:mod:`repro_torch.training.data` (bit-equal to the reference's), the
detector's alternation of clean and codec-degraded batches with qualities
drawn from ``default_rng(seed + 7)``, AdamW at weight decay 1e-4, and a
history record every 25 steps and at the last.  The loops are built on
module-level step functions, ``(cfg, opt, params, opt_state, batch) ->
(params, opt_state, metrics)``, whose gradients come from
``torch.func.grad_and_value`` over the dict params.

No CUDA kernel of the port runs in the video loops: their losses are
convolutions and matmuls, as the reference's are outside Pallas.  On the
card the loops compute in full float32 (``set_reference_precision``) and
with cuDNN's deterministic algorithms, so a run is bit-identical to the
next from the same seed; the detector's targets resolve shared cells explicitly
(``detector.cell_targets``) for the same reason.

:func:`load_or_train` is the benchmarks' ``load_context``: the three
trained models under ``artifacts/``, trained there when missing.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import require_device, set_reference_precision, weights
from repro_torch.configs.vpaas_video import (CLASSIFIER, DETECTOR,
                                             FALLBACK_DETECTOR,
                                             ClassifierConfig,
                                             DetectorConfig)
from repro_torch.configs.base import ModelConfig
from repro_torch.models import classifier as clf_mod
from repro_torch.models import detector as det_mod
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint, data
from repro_torch.training.optimizer import AdamW, global_norm, tree_leaves
from repro_torch.video import codec

# the codec qualities (scale, QP) the detector's degraded batches draw from
QUALITIES = [(1.0, 10), (0.8, 30), (0.8, 36), (0.6, 36), (1.0, 26)]
HISTORY_EVERY = 25

ARTIFACTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", "..", "artifacts"))


# ---------------------------------------------------------------------------
# LLM training
# ---------------------------------------------------------------------------
def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def llm_grads(cfg: ModelConfig, params, batch, *, remat: bool = True,
              dtype=torch.float32):
    """``((total, {"ce", "aux"}), grads)`` of ``transformer.loss_fn`` at
    compute dtype ``dtype`` by ``torch.autograd.grad`` over the leaves of
    the dict ``params`` (a leaf the loss does not reach gets a zero
    gradient; each gradient in its leaf's dtype)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    total, parts = tfm.loss_fn(cfg, _rebuild(params, leaves), batch,
                               remat=remat, dtype=dtype)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return ((total.detach(), {k: v.detach() for k, v in parts.items()}),
            _rebuild(params, grads))


def make_train_step(cfg: ModelConfig, opt: AdamW, *, remat: bool = True
                    ) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, {"loss", "ce",
    "aux", "grad_norm"})``: one AdamW step on ``loss_fn``'s gradients."""
    def train_step(params, opt_state, batch):
        (total, parts), grads = llm_grads(cfg, params, batch, remat=remat)
        new_params, new_opt_state = opt.update(grads, opt_state, params)
        metrics = {"loss": total, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": global_norm(grads)}
        return new_params, new_opt_state, metrics

    return train_step


def train_llm(cfg: ModelConfig, *, steps: int, batch_size: int,
              seq_len: int, lr: float = 3e-4, seed: int = 0,
              log_every: int = 10, branching: int = 8, callback=None,
              device="cuda") -> Tuple[Any, List[dict]]:
    """Single-card training loop: ``init_params(cfg, seed)``, AdamW at
    ``lr``, batches from ``TokenStream(vocab, seq_len, batch_size, seed,
    branching)``, no remat; a history record every ``log_every`` steps and
    at the last.  Returns (params, history)."""
    device = require_device(device)
    set_reference_precision()
    params = tfm.init_params(cfg, seed, device)
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)
    history: List[dict] = []
    stream = iter(data.TokenStream(cfg.vocab_size, seq_len, batch_size, seed,
                                   branching=branching))
    for step in range(steps):
        batch = to_device(next(stream), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _record(history, step, steps, metrics, callback, log_every)
    return params, history


# ---------------------------------------------------------------------------
# Video-model training
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (its default backward-weight
    algorithms may sum in a run-dependent order), restored afterwards."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def grad_and_value(loss_fn, params):
    """``(grads, (loss, parts))`` of ``loss_fn(params) -> (loss, parts)``
    over the dict params, with cuDNN's deterministic algorithms."""
    with deterministic_cudnn():
        return torch.func.grad_and_value(loss_fn, has_aux=True)(params)


def detector_grads(cfg: DetectorConfig, params, batch):
    """``(grads, (loss, parts))`` of ``detector_loss`` at ``params``."""
    return grad_and_value(lambda p: det_mod.detector_loss(
        cfg, p, batch["images"], batch["gt_boxes"], batch["gt_labels"]),
        params)


def classifier_grads(cfg: ClassifierConfig, params, batch):
    """``(grads, (loss, parts))`` of ``classifier_loss`` at ``params``."""
    return grad_and_value(lambda p: clf_mod.classifier_loss(
        cfg, p, batch["crops"], batch["labels"]), params)


def detector_step(cfg: DetectorConfig, opt, params, opt_state, batch):
    grads, (total, parts) = detector_grads(cfg, params, batch)
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, {"loss": total, **parts}


def classifier_step(cfg: ClassifierConfig, opt, params, opt_state, batch):
    grads, (total, parts) = classifier_grads(cfg, params, batch)
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, {"loss": total, **parts}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _record(history: List[dict], step: int, steps: int, metrics,
            callback: Optional[Callable], every: int = HISTORY_EVERY) -> None:
    if step % every == 0 or step == steps - 1:
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        history.append(rec)
        if callback:
            callback(rec)


def train_detector(det_cfg: DetectorConfig, *, steps: int = 300,
                   batch_size: int = 16, lr: float = 1e-3, seed: int = 0,
                   content: str = "all", degrade: bool = True,
                   callback=None, device="cuda"
                   ) -> Tuple[Any, List[dict]]:
    """``degrade=True`` trains on a mix of clean and codec-degraded frames —
    the cloud detector must keep its localization power on low-quality
    video (protocol Key Observation 2)."""
    device = require_device(device)
    set_reference_precision()
    rng = np.random.default_rng(seed + 7)
    params = weights.init_detector(
        det_cfg, torch.Generator().manual_seed(seed), device)
    opt = AdamW(lr=lr, weight_decay=1e-4)
    opt_state = opt.init(params)
    history: List[dict] = []
    gen = data.detector_batches(det_cfg, batch_size, seed, content)
    for step in range(steps):
        batch = to_device(next(gen), device)
        if degrade and step % 2 == 1:   # alternate clean / degraded batches
            r, q = QUALITIES[int(rng.integers(len(QUALITIES)))]
            batch["images"] = codec.encode(batch["images"], r, q).frames
        params, opt_state, m = detector_step(det_cfg, opt, params, opt_state,
                                             batch)
        _record(history, step, steps, m, callback)
    return params, history


def train_classifier(clf_cfg: ClassifierConfig, *, steps: int = 300,
                     batch_size: int = 64, lr: float = 1e-3, seed: int = 0,
                     drift: float = 0.0, callback=None, device="cuda"
                     ) -> Tuple[Any, List[dict]]:
    device = require_device(device)
    set_reference_precision()
    params = weights.init_classifier(
        clf_cfg, torch.Generator().manual_seed(seed), device)
    opt = AdamW(lr=lr, weight_decay=1e-4)
    opt_state = opt.init(params)
    history: List[dict] = []
    gen = data.classifier_batches(clf_cfg, batch_size, seed, drift=drift)
    for step in range(steps):
        batch = to_device(next(gen), device)
        params, opt_state, m = classifier_step(clf_cfg, opt, params,
                                               opt_state, batch)
        _record(history, step, steps, m, callback)
    return params, history


class Pretrained(NamedTuple):
    det_params: Any
    clf_params: Any
    fallback_params: Any


def load_or_train(root: str = ARTIFACTS, device="cuda") -> Pretrained:
    """The three trained models under ``root`` (``det_params.npz``,
    ``clf_params.npz``, ``fallback_params.npz``, the files the JAX
    package's benchmarks write in the same format); each one missing or of
    another shape is trained with the benchmarks' step counts and saved
    there."""
    device = require_device(device)

    def one(tag, init, cfg, train, **kw):
        path = os.path.join(root, tag)
        try:
            return checkpoint.restore(
                path, init(cfg, torch.Generator().manual_seed(0), device))
        except (FileNotFoundError, KeyError, ValueError):
            params, _ = train(cfg, device=device, **kw)
            checkpoint.save(path, params, {"trained_by": "repro_torch"})
            return params

    return Pretrained(
        one("det_params", weights.init_detector, DETECTOR, train_detector,
            steps=500, batch_size=16),
        one("clf_params", weights.init_classifier, CLASSIFIER,
            train_classifier, steps=400, batch_size=64),
        one("fallback_params", weights.init_detector, FALLBACK_DETECTOR,
            train_detector, steps=200, batch_size=16, degrade=False))
