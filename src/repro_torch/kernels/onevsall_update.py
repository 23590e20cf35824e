"""K5: the §V proximal update of the one-vs-all readout as a hand-written
CUDA kernel.

Port of the Pallas kernel ``repro.kernels.onevsall.onevsall_update``
(source: ``csrc/onevsall_update.cu``): the fused batch step
``W - eta * X^T (sigmoid(X W) - Y)`` for X (B, d+1) with the
bias-absorbing 1, one-hot Y (B, C) and the readout W (d+1, C).  The
incremental learner (``repro_torch.core.incremental.update_proximal``)
calls it once per labelled instance, B = 1.

The kernel has its own module, and so its own launch count, apart from K3's
(``kernels/onevsall.py``).  The plain PyTorch version is
:func:`onevsall_update_ref`; the kernel agrees with it within
``testing.UPDATE_RTOL`` of the output scale (the dot products and the
gradient's sum over rows run in another order) and gives the same bits from
run to run (no atomics).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset (ops.py)

MAX_CLASSES = 4096    # one tile's residuals must fit the block's shared memory


def onevsall_update_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                        *, eta: float) -> torch.Tensor:
    """w - eta * x^T (sigmoid(x @ w) - y), in float32."""
    x, y, w = x.float(), y.float(), w.float()
    probs = torch.sigmoid(x @ w)
    grad = x.t() @ (probs - y)
    return w - eta * grad


def onevsall_update(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                    eta: float) -> torch.Tensor:
    """x (B, D1), y (B, C), w (D1, C) float32 on the card -> (D1, C)."""
    global launches
    b, d1 = x.shape
    c = w.shape[1]
    if c > MAX_CLASSES:
        raise ValueError(f"onevsall_update: {c} classes exceed the kernel's "
                         f"{MAX_CLASSES}")
    x, y, w = x.contiguous(), y.contiguous(), w.contiguous()
    _build.check_operands(("x", x, torch.float32, None),
                          ("y", y, torch.float32, (b, c)),
                          ("w", w, torch.float32, (d1, c)))
    out = torch.empty_like(w)
    _build.launch("vpaas_onevsall_update", x.data_ptr(), y.data_ptr(),
                  w.data_ptr(), out.data_ptr(), b, d1, c, float(eta))
    launches += 1
    return out
