"""§V human-in-the-loop incremental learning — Eqs. (3)-(9), faithfully.

Only the last layer W of the fog classifier moves (one-vs-all heads, bias
absorbed by the appended 1-feature).  Two update rules are provided:

  * ``update_eq8``      — the paper's closed-form proximal step, Eq. (8):
        W_t = W_{t-1} - eta * y_t * (1 / sigma(W_{t-1}^T x_t)) * x_t
                                                 if W_{t-1}^T x_t > 0
        W_t = W_{t-1}                            otherwise
    with sigma = ReLU, applied column-wise per one-vs-all head.  A small
    epsilon guards the 1/sigma pole (the paper leaves this implicit).

  * ``update_proximal`` — the Eq. (4) objective solved with the exact
    gradient of sigmoid-BCE instead of the paper's ReLU approximation
    (beyond-paper 'robust' mode; same proximal structure, no pole).

Snapshots {W_t} are ensembled with ridge weights omega per Eq. (9).

PyTorch port of ``repro.core.incremental``.  Every proximal step is K5's
one-row step (``kernels.ops.onevsall_update``).  ``batch_update`` with the
proximal rule stays the reference's sequential scan, one step per instance
per pass, and hands the whole scan to ``kernels.ops.onevsall_replay``: on
the card one launch that runs the steps in order and equals a loop of
one-row launches bit for bit; on the CPU that loop of plain one-row steps.
(One K5 call over the whole buffer would be a batch gradient step, another
function.)  The Eq. (8) rule has no Pallas kernel in the JAX package and
stays plain PyTorch on both devices.  Tensors stay on the device of the W
they are given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.protocol import to_host
from repro_torch.kernels import ops


def _on(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a float tensor on ``like``'s device and dtype."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Single-instance updates
# ---------------------------------------------------------------------------
def update_eq8(W: torch.Tensor, x: torch.Tensor, y_onehot: torch.Tensor,
               eta: float = 0.05, eps: float = 1e-2) -> torch.Tensor:
    """Paper Eq. (8). W (d+1, C); x (d+1,) with trailing 1; y one-hot (C,)."""
    pre = x @ W                                       # (C,) = W^T x
    sig = torch.clamp(pre, min=0.0)                   # sigma = ReLU
    grad_scale = y_onehot / torch.clamp(sig, min=eps)  # y_t / sigma(W^T x)
    delta = -eta * torch.outer(x, grad_scale)         # (d+1, C)
    return torch.where(pre[None, :] > 0.0, W + delta, W)


def update_proximal(W: torch.Tensor, x: torch.Tensor, y_onehot: torch.Tensor,
                    eta: float = 0.5) -> torch.Tensor:
    """Eq. (4) with exact sigmoid-BCE gradient (robust variant).

    argmin_W 0.5 ||W - W_{t-1}||_F^2 + eta * l(f(x_t), y_t)
    one gradient step at W_{t-1}:  W_t = W_{t-1} - eta * x (f - y)^T,
    which is K5 on the single row x."""
    return ops.onevsall_update(x[None], y_onehot[None], W, eta=eta)


def batch_update(W, xs, ys, rule: str = "eq8", eta: float = 0.05,
                 passes: int = 1) -> torch.Tensor:
    """Sequentially apply the per-instance rule over a labelled batch.

    ``passes > 1`` replays the buffer (still per-instance updates; the
    paper's Eq. 8 is the single-pass case).  ``xs`` and ``ys`` move to W's
    device once per call; the proximal rule's scan is one K5 replay."""
    fn = {"eq8": update_eq8, "proximal": update_proximal}[rule]
    W = torch.as_tensor(W)
    xs, ys = _on(xs, W), _on(ys, W)
    if rule == "proximal":
        return ops.onevsall_replay(xs, ys, W, eta=eta,
                                   passes=max(passes, 1))
    for _ in range(max(passes, 1)):
        for i in range(xs.shape[0]):
            W = fn(W, xs[i], ys[i], eta)
    return W


# ---------------------------------------------------------------------------
# Ensemble weighting — Eq. (9)
# ---------------------------------------------------------------------------
def _readouts(snapshots: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """sigmoid(x @ W_t) for every snapshot: (tau, N, C)."""
    return torch.sigmoid(torch.einsum("nd,tdc->tnc", xs, snapshots))


def ensemble_weights(
    snapshots,                   # (tau, d+1, C) classifier snapshots {W_t}
    xs,                          # (N, d+1) labelled features (reused, §V)
    ys,                          # (N, C) one-hot labels
    v: float = 1e-2,
) -> torch.Tensor:
    """Ridge solution of Eq. (9): omega = (A + vI)^{-1} b with
    A[t,t'] = sum_i <f_t(x_i), f_t'(x_i)>, b[t] = sum_i <f_t(x_i), y_i>.
    Runs on the device of ``snapshots``."""
    snapshots = torch.as_tensor(snapshots)
    xs, ys = _on(xs, snapshots), _on(ys, snapshots)
    z = _readouts(snapshots, xs)                                  # (tau,N,C)
    A = torch.einsum("tnc,snc->ts", z, z)
    b = torch.einsum("tnc,nc->t", z, ys)
    tau = snapshots.shape[0]
    eye = torch.eye(tau, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A + v * eye, b)


def ensemble_predict(snapshots, omega, xs) -> torch.Tensor:
    """Weighted-combined prediction over snapshot classifiers."""
    snapshots = torch.as_tensor(snapshots)
    z = _readouts(snapshots, _on(xs, snapshots))
    return torch.einsum("t,tnc->nc", _on(omega, snapshots), z)


def prune_ensemble(snapshots, omega, *, eps: float = 1e-3):
    """Drop near-zero-omega snapshots before serving.

    The ridge solution of Eq. (9) routinely assigns some snapshots weights
    orders of magnitude below the dominant one — they contribute nothing to
    the combined score but inflate the serving-side stacked (G, T, d+1, C)
    upload and the T-fold ensemble einsum linearly.  A snapshot is kept
    when ``|omega_t| > eps * max_t |omega_t|`` (relative threshold: omega's
    scale depends on the label count); the argmax snapshot is always kept,
    so the pruned ensemble is never empty.  Returns host-side
    ``(snapshots, omega, kept_idx)``."""
    snapshots = to_host(snapshots)
    omega = to_host(omega)
    mag = np.abs(omega)
    keep = mag > eps * mag.max()
    keep[int(mag.argmax())] = True
    idx = np.flatnonzero(keep)
    return snapshots[idx], omega[idx], idx


# ---------------------------------------------------------------------------
# Evaluation helpers (shadow evaluator / promotion gate)
# ---------------------------------------------------------------------------
def _top1(pred: torch.Tensor, labels) -> float:
    """Share of rows whose argmax is the label, rounded as the reference's
    float32 mean rounds it: the exact count times the float32 reciprocal of
    the row count (XLA's mean; a division differs in the last bit)."""
    labels = torch.as_tensor(to_host(labels), device=pred.device)
    hits = int((pred.argmax(-1) == labels).sum())
    return float(np.float32(hits) * (np.float32(1) / np.float32(len(pred))))


def eval_accuracy(W, xs, labels) -> float:
    """Top-1 accuracy of the one-vs-all readout W on labelled features.

    sigmoid is monotone, so argmax over logits equals argmax over the
    per-head probabilities the serving path uses.  Runs on W's device (the
    host for the zoo's numpy readouts)."""
    W = torch.as_tensor(W)
    xs = _on(xs, W)
    if xs.shape[0] == 0:
        return 0.0
    return _top1(xs @ W, labels)


def ensemble_accuracy(snapshots, omega, xs, labels) -> float:
    """Top-1 accuracy of the Eq. (9) snapshot ensemble."""
    if len(xs) == 0:
        return 0.0
    return _top1(ensemble_predict(snapshots, omega, xs), labels)


# ---------------------------------------------------------------------------
# The stateful learner used by the platform's auto-training backend
# ---------------------------------------------------------------------------
@dataclass
class IncrementalLearner:
    """Data collector + model trainer of the auto-training backend (§III.D).

    Buffers human-labelled features; every ``trigger`` labels performs one
    incremental update (Eq. 8 / proximal) and records a snapshot for the
    Eq. (9) ensemble.  ``budget`` is the paper's human-labor budget tau.
    Updates run on the device of the W passed to :meth:`maybe_update` (the
    scheduler passes the stream's device-resident readout); snapshots and
    the collected data are kept on the host, where the Eq. (9) fit runs."""
    num_classes: int
    rule: str = "proximal"
    eta: float = 0.3
    passes: int = 2
    trigger: int = 16
    budget: int = 512
    keep_snapshots: int = 8

    labels_used: int = 0
    updates_done: int = 0
    _xs: List[np.ndarray] = field(default_factory=list)
    _ys: List[np.ndarray] = field(default_factory=list)
    _all_xs: List[np.ndarray] = field(default_factory=list)
    _all_ys: List[np.ndarray] = field(default_factory=list)
    snapshots: List[np.ndarray] = field(default_factory=list)
    omega: Optional[np.ndarray] = None

    @property
    def budget_exhausted(self) -> bool:
        return self.labels_used >= self.budget

    @property
    def buffered(self) -> int:
        """Labelled instances collected but not yet consumed by an update."""
        return len(self._xs)

    def collect(self, x: np.ndarray, label: int) -> bool:
        """Add one human-labelled instance; True if it was accepted."""
        if self.budget_exhausted:
            return False
        self._xs.append(np.asarray(x))
        y = np.zeros(self.num_classes, np.float32)
        y[label] = 1.0
        self._ys.append(y)
        self._all_xs.append(np.asarray(x))
        self._all_ys.append(y)
        self.labels_used += 1
        return True

    def maybe_update(self, W) -> Tuple[torch.Tensor, bool]:
        """Run Eq. (8)/(4) over the buffered batch when the trigger fires."""
        if len(self._xs) < self.trigger and not (
                self.budget_exhausted and self._xs):
            return W, False
        W_new = batch_update(W, np.stack(self._xs), np.stack(self._ys),
                             rule=self.rule, eta=self.eta,
                             passes=self.passes)
        self._xs.clear()
        self._ys.clear()
        self.updates_done += 1
        self.snapshots.append(to_host(W_new))
        self.snapshots = self.snapshots[-self.keep_snapshots:]
        return W_new, True

    def fit_ensemble(self, v: float = 1e-2) -> Optional[np.ndarray]:
        """Eq. (9) over collected data once the budget is exhausted."""
        if len(self.snapshots) < 2 or not self._all_xs:
            return None
        self.omega = to_host(ensemble_weights(
            np.stack(self.snapshots), np.stack(self._all_xs),
            np.stack(self._all_ys), v=v))
        return self.omega

    def predict(self, xs) -> torch.Tensor:
        """Ensemble prediction if omega is fit, else latest snapshot (on
        the device of ``xs``)."""
        xs = torch.as_tensor(xs)
        snaps = _on(np.stack(self.snapshots), xs)
        if self.omega is not None:
            return ensemble_predict(snaps, self.omega, xs)
        return torch.sigmoid(xs @ snaps[-1])
