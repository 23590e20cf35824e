"""K8: the Mamba2 SSD chunked scan as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan`` (source:
``csrc/ssd_scan.cu``), returning ``y`` and the final state.  Where p and n
are multiples of 8 a call runs three device kernels on the tensor cores:
each 64-step tile's part of its chunk's state, the state recurrence
across chunks, then 64-row output tiles in parallel; the parts and the
states go through a workspace.  Other shapes take one CUDA-core kernel
that walks the chunks in order.  The sequence's tail past ``s`` acts as the plain
version's zero padding without any padded copy.  The plain PyTorch version
is :func:`ssd_scan_ref` (``ref.ssd_scan``); the kernel agrees with it
within ``testing.SSD_RTOL`` of the output's scale.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0          # wrapper calls that launched the kernels (ops.py)

ssd_scan_ref = ref.ssd_scan

MAX_HEAD_DIM = 64     # p
MAX_STATE = 128       # n


def path(p: int, n: int) -> str:
    """Which kernel the launcher runs for head dim ``p`` and state ``n``."""
    return "tensor cores" if p % 8 == 0 and n % 8 == 0 else "CUDA cores"


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
        ws = None
        if path(p, n) == "tensor cores":
            # each 64-step tile's part of its chunk's state (the first then
            # holds the state entering the chunk) and each chunk's decay
            nc, tiles = -(-s // chunk), -(-chunk // 64)
            ws = torch.empty(b * nc * h * (tiles * p * n + 1),
                             dtype=torch.float32, device=x.device)
        _build.launch("vpaas_ssd_scan", x.data_ptr(), dt.data_ptr(),
                      A.data_ptr(), B.data_ptr(), C.data_ptr(),
                      None if initial_state is None
                      else initial_state.data_ptr(),
                      y.data_ptr(), fin.data_ptr(),
                      None if ws is None else ws.data_ptr(),
                      b, s, h, p, n, chunk)
        launches += 1
    return y, fin
