"""K3: the fog classifier's one-vs-all readout as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.onevsall.onevsall_scores``
(source: ``csrc/onevsall.cu``): ``scores = sigmoid(X W)`` for a batch of crop
features X (B, d+1) with the bias-absorbing 1.  The kernel takes a stack of
G readouts ``Ws`` (G, d+1, C) and an optional per-row readout index ``widx``
(B,), so the full-budget classify (G = 1, no ``widx``) and the compacted
cross-stream classify (one readout per stream, any number of streams)
share it.  One warp computes one row.  The plain PyTorch version is
:func:`onevsall_scores_ref`; the kernel agrees with it within
``testing.ONEVSALL_ATOL`` (the dot products sum in another order).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset (ops.py)


def onevsall_scores_ref(x: torch.Tensor, ws: torch.Tensor,
                        widx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sigmoid(x @ W) with a per-row readout: x (B, D1), ws (G, D1, C),
    widx (B,) picks row b's readout (None = readout 0 for every row)."""
    x = x.float()
    if widx is None:
        return torch.sigmoid(x @ ws[0].float())
    return torch.sigmoid(torch.einsum("bd,bdc->bc", x,
                                      ws.float()[widx.long()]))


def onevsall_scores(x: torch.Tensor, ws: torch.Tensor,
                    widx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, D1), ws (G, D1, C), widx (B,) int32 or None -> (B, C)."""
    global launches
    b, d1 = x.shape
    g, _, c = ws.shape
    x = x.contiguous()
    ws = ws.contiguous()
    if widx is None:
        _build.check_operands(("x", x, torch.float32, None),
                              ("ws", ws, torch.float32, (g, d1, c)))
    else:
        widx = widx.to(torch.int32).contiguous()
        _build.check_operands(("x", x, torch.float32, None),
                              ("ws", ws, torch.float32, (g, d1, c)),
                              ("widx", widx, torch.int32, (b,)))
    out = x.new_empty((b, c))
    if b:
        _build.launch("vpaas_onevsall_scores", x.data_ptr(), ws.data_ptr(),
                      None if widx is None else widx.data_ptr(),
                      out.data_ptr(), b, d1, c, g)
        launches += 1
    return out
