"""K5: the §V proximal update of the one-vs-all readout as a hand-written
CUDA kernel.

Port of the Pallas kernel ``repro.kernels.onevsall.onevsall_update``
(source: ``csrc/onevsall_update.cu``): the fused batch step
``W - eta * X^T (sigmoid(X W) - Y)`` for X (B, d+1) with the
bias-absorbing 1, one-hot Y (B, C) and the readout W (d+1, C).

Two entry points share the kernel source:

* :func:`onevsall_update` -- one step of B rows (one block for a tile of up
  to 32 rows; beyond that a block per tile and a combine kernel that adds
  the tiles' parts in tile order).
* :func:`onevsall_replay` -- the incremental learner's replay
  (``repro_torch.core.incremental.batch_update``, rule ``"proximal"``):
  ``passes`` passes of one-row steps over a buffer, in the reference's
  order, in one launch of one persistent block that keeps W in shared
  memory.  It equals a loop of one-row :func:`onevsall_update` calls bit
  for bit -- the same function as the reference's sequential scan, not a
  batch gradient step.
  Where W does not fit the block (:func:`replay_in_one_block`), the
  launcher runs that loop of one-row launches itself.

The module keeps its own counts, apart from K3's (``kernels/onevsall.py``):
``launches`` counts wrapper calls that launched, ``replays`` those of
:func:`onevsall_replay`, ``steps`` the proximal steps they ran (one per
:func:`onevsall_update`, ``passes`` x rows per :func:`onevsall_replay`).
The plain PyTorch versions are :func:`onevsall_update_ref` and
:func:`onevsall_replay_ref`; the kernel agrees with them within
``testing.UPDATE_RTOL`` of the output scale per step (the dot products and
the gradient's sum over rows run in another order) and gives the same bits
from run to run (no atomics).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0          # wrapper calls that launched, since the last reset
replays = 0           # of those, replays (ops.py resets all three)
steps = 0             # proximal steps those launches ran

# csrc/onevsall_update.cu: kMaxSmem, kTileBytes, kMaxTileRows
MAX_SMEM = 48 * 1024
TILE_BYTES = 24 * 1024
MAX_TILE_ROWS = 32


def tile_rows(d1: int, c: int) -> int:
    """Rows per block of a batch step: x rows and residuals in 24 KB."""
    return max(1, min(MAX_TILE_ROWS, TILE_BYTES // (4 * (d1 + c))))


def replay_in_one_block(d1: int, c: int) -> bool:
    """Whether one block runs the replay: W (rows padded to an odd stride)
    and two chunks of 8 x and y rows fit its shared memory."""
    return 4 * (d1 * (c | 1) + 16 * (d1 + c)) <= MAX_SMEM


def onevsall_update_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                        *, eta: float) -> torch.Tensor:
    """w - eta * x^T (sigmoid(x @ w) - y), in float32."""
    x, y, w = x.float(), y.float(), w.float()
    probs = torch.sigmoid(x @ w)
    grad = x.t() @ (probs - y)
    return w - eta * grad


def onevsall_replay_ref(xs: torch.Tensor, ys: torch.Tensor, w: torch.Tensor,
                        *, eta: float, passes: int = 1) -> torch.Tensor:
    """``passes`` passes of one-row :func:`onevsall_update_ref` steps over
    the rows of xs / ys in order."""
    for _ in range(passes):
        for i in range(xs.shape[0]):
            w = onevsall_update_ref(xs[i:i + 1], ys[i:i + 1], w, eta=eta)
    return w


def _check_width(d1: int, c: int) -> None:
    if 4 * (d1 + c) > MAX_SMEM:
        raise ValueError(f"onevsall_update: a row of {d1} features and {c} "
                         f"classes exceeds the kernel's {MAX_SMEM} B of "
                         "shared memory")


def onevsall_update(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                    eta: float) -> torch.Tensor:
    """x (B, D1), y (B, C), w (D1, C) float32 on the card -> (D1, C)."""
    global launches, steps
    b, d1 = x.shape
    c = w.shape[1]
    _check_width(d1, c)
    x, y, w = x.contiguous(), y.contiguous(), w.contiguous()
    _build.check_operands(("x", x, torch.float32, None),
                          ("y", y, torch.float32, (b, c)),
                          ("w", w, torch.float32, (d1, c)))
    out = torch.empty_like(w)
    tiles = -(-b // tile_rows(d1, c))
    part = w.new_empty((tiles, d1, c)) if tiles > 1 else None
    _build.launch("vpaas_onevsall_update", x.data_ptr(), y.data_ptr(),
                  w.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(), tiles, b, d1,
                  c, float(eta))
    launches += 1
    steps += 1
    return out


def onevsall_replay(xs: torch.Tensor, ys: torch.Tensor, w: torch.Tensor, *,
                    eta: float, passes: int = 1) -> torch.Tensor:
    """xs (N, D1), ys (N, C), w (D1, C) float32 on the card -> (D1, C):
    ``passes`` passes of one-row proximal steps, one launch.  With no step
    to run it returns ``w`` itself, as the plain loop does."""
    global launches, replays, steps
    n, d1 = xs.shape
    c = w.shape[1]
    if n == 0 or passes <= 0:
        return w
    _check_width(d1, c)
    xs, ys, w = xs.contiguous(), ys.contiguous(), w.contiguous()
    _build.check_operands(("xs", xs, torch.float32, None),
                          ("ys", ys, torch.float32, (n, c)),
                          ("w", w, torch.float32, (d1, c)))
    out = torch.empty_like(w)
    tmp = None if replay_in_one_block(d1, c) else torch.empty_like(w)
    _build.launch("vpaas_onevsall_replay", xs.data_ptr(), ys.data_ptr(),
                  w.data_ptr(), out.data_ptr(),
                  None if tmp is None else tmp.data_ptr(), n, d1, c,
                  int(passes), float(eta))
    launches += 1
    replays += 1
    steps += n * passes
    return out
