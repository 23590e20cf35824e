"""PyTorch / CUDA port of the VPaaS High-Low video serving platform.

The package mirrors ``repro``'s module layout (``repro_torch.core.protocol``
is the port of ``repro.core.protocol``, and so on) and keeps its public
tensor layouts (NHWC frames, ``(F, N, 4)`` boxes).  The three Pallas
kernels on the serving path are hand-written CUDA C++ kernels under
``csrc/``, built at first use by :mod:`repro_torch.kernels._build`.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; on a CPU tensor every kernel wrapper computes its plain PyTorch
version instead.
"""
from __future__ import annotations

import torch


def set_reference_precision() -> None:
    """Make float32 mean float32 on the card, and bf16 products sum in
    float32.

    cuDNN convolutions default to TF32 on Hopper (about three decimal
    digits); the reference computes in full float32, so serving and the
    on-card checks turn TF32 off for both convolutions and matmuls.  A bf16
    GEMM of cuBLAS may reduce split-K partial sums in bf16 by PyTorch's
    default; XLA's bf16 dots accumulate in float32, so that is turned off
    too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def require_device(device) -> torch.device:
    """Resolve ``device``; raise when a CUDA device is asked for but absent.

    The port never carries on quietly on the CPU when the card is missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
