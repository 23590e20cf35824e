"""Target-hardware constants for the roofline model (port of
``repro.roofline.hw``, retargeted from the TPU v5e to one NVIDIA H100).

The figures are NVIDIA's data sheet for the H100 SXM (80 GB HBM3, 700 W):
dense rates without sparsity.  The port's steps compute in bfloat16, as
the reference's (``launch.specs.COMPUTE_DTYPE``), so the roofline divides
their FLOPs and K6's and K7's products by ``peak_flops_bf16``, K8's 3xTF32
products by ``peak_flops_tf32``; a step run in float32 (TF32 off,
``repro_torch.set_reference_precision``) by ``peak_flops_fp32``, its K6
and K7 products by the TF32 rate, three times.  ``ici_link_bandwidth`` is
one NVLink 4 link.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float       # FLOP/s per chip, dense bf16 tensor cores
    hbm_bandwidth: float         # bytes/s per chip
    hbm_bytes: float             # HBM capacity per chip
    ici_link_bandwidth: float    # bytes/s per link
    peak_flops_tf32: float = 0.0     # FLOP/s, dense TF32 tensor cores
    peak_flops_fp32: float = 0.0     # FLOP/s, fp32 outside the tensor cores
    sms: int = 0                     # streaming multiprocessors per chip

    def peak_flops(self, dtype: str) -> float:
        """The peak for a step's compute dtype: ``bf16``, ``tf32`` or
        ``fp32``."""
        return {"bf16": self.peak_flops_bf16, "tf32": self.peak_flops_tf32,
                "fp32": self.peak_flops_fp32}[dtype]


H100 = ChipSpec(
    name="nvidia-h100-sxm-80gb",
    peak_flops_bf16=989.4e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    ici_link_bandwidth=50e9,
    peak_flops_tf32=495e12,
    peak_flops_fp32=67e12,
    sms=132,
)
