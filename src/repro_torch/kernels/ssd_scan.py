"""K8: the Mamba2 SSD chunked scan as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan`` (source:
``csrc/ssd_scan.cu``): one block per (head, batch row) walks the chunks in
order with the (p, n) state in shared memory and returns ``y`` and the final
state.  The sequence's tail past ``s`` acts as the plain version's zero
padding without any padded copy.  The plain PyTorch version is
:func:`ssd_scan_ref` (``ref.ssd_scan``); the kernel agrees with it within
``testing.SSD_ATOL``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)

ssd_scan_ref = ref.ssd_scan

MAX_HEAD_DIM = 64     # p: four 16-wide column groups per thread
MAX_STATE = 128       # n: eight 16-wide column groups per thread


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,s,h,p), dt (b,s,h), A (h,), B and C (b,s,n), initial_state
    (b,h,p,n) or None -> (y (b,s,h,p), final_state (b,h,p,n))."""
    global launches
    b, s, h, p = x.shape
    n = B.shape[-1]
    x, dt, A = x.contiguous(), dt.contiguous(), A.contiguous()
    B, C = B.contiguous(), C.contiguous()
    operands = [("x", x, torch.float32, None),
                ("dt", dt, torch.float32, (b, s, h)),
                ("A", A, torch.float32, (h,)),
                ("B", B, torch.float32, (b, s, n)),
                ("C", C, torch.float32, (b, s, n))]
    if initial_state is not None:
        initial_state = initial_state.contiguous()
        operands.append(("initial_state", initial_state, torch.float32,
                         (b, h, p, n)))
    _build.check_operands(*operands)
    if not (0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE and chunk > 0):
        raise ValueError(f"ssd_scan: unsupported head dim {p}, state {n} "
                         f"or chunk {chunk}")
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b and h:
        _build.launch("vpaas_ssd_scan", x.data_ptr(), dt.data_ptr(),
                      A.data_ptr(), B.data_ptr(), C.data_ptr(),
                      None if initial_state is None
                      else initial_state.data_ptr(),
                      y.data_ptr(), fin.data_ptr(), b, s, h, p, n, chunk)
        launches += 1
    return y, fin
