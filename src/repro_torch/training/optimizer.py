"""Optimizers (AdamW, SGD+momentum) and LR schedules, PyTorch port of
``repro.training.optimizer``.

Parameters are the port's nested dicts of tensors (``conv0/w``, ``head/b``,
``proj``, ``W``); the state mirrors them.  The arithmetic is the
reference's, step for step: the step counter is bumped before ``lr(step)``
is read, gradients are clipped by their global norm with the scale
``min(1, clip / (norm + 1e-9))``, and the bias corrections are
``1 / (1 - b ** t)`` with ``t`` in float32.  ``torch.optim.AdamW`` is not
used: it has no global-norm clip, adds ``eps`` after its own bias
correction (another rounding) and takes no ``lr(step)`` callable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    mu: Any
    nu: Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` shaped alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in sorted key order, as ``jax.tree.leaves`` orders a dict."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _lr(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _first_leaf(tree) -> torch.Tensor:
    return tree_leaves(tree)[0]


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


@dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        step = torch.zeros((), dtype=torch.int32,
                           device=_first_leaf(params).device)
        return AdamWState(step, tree_map(_zeros, params),
                          tree_map(_zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        scale = None
        if self.grad_clip is not None:
            scale = torch.clamp(self.grad_clip / (global_norm(grads) + 1e-9),
                                max=1.0)

        def clipped(g):
            # float32, as the reference's bf16 gradient times its float32
            # scale is; taken leaf by leaf, so no clipped copy of the whole
            # tree is live at once
            g = g.float()
            return g if scale is None else g * scale

        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * clipped(g),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(clipped(g)),
            state.nu, grads)
        t = step.float()
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, t))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, t))
        lr = _lr(self.lr, step)

        def upd(p, m, v):
            u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + self.eps)
            u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamWState(step, mu, nu)


@dataclass(frozen=True)
class SGDM:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-2
    momentum: float = 0.9

    def init(self, params) -> AdamWState:
        step = torch.zeros((), dtype=torch.int32,
                           device=_first_leaf(params).device)
        return AdamWState(step, tree_map(_zeros, params), None)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        lr = _lr(self.lr, step)
        mu = tree_map(lambda m, g: self.momentum * m + g.float(),
                      state.mu, grads)
        new_params = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                              params, mu)
        return new_params, AdamWState(step, mu, None)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------
def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant_schedule(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.tensor(lr, dtype=torch.float32)
