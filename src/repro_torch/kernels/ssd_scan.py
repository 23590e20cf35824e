"""K8: the Mamba2 SSD chunked scan as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan`` (source:
``csrc/ssd_scan.cu``), returning ``y`` and the final state.  Where p and n
are multiples of 8 a call runs three device kernels on the tensor cores:
each chunk's state (its 64-step tiles summed on chip), the state
recurrence across chunks, then 64-row output tiles in parallel; one state
per chunk goes through a workspace.  Other shapes take one CUDA-core
kernel that walks the chunks in order.  The sequence's tail past ``s``
acts as the plain version's zero padding without any padded copy.  x, B
and C are float32 or bfloat16 (one dtype; y comes out in it); dt, A and
the initial and final states are float32 either way, as the reference's
Mamba2 layer passes them.  float32 runs every product in 3xTF32.  bf16
operands stay bf16 in shared memory: C B^T, a product of bf16 values, is
one bf16 product; each of the others has a float32 operand (W with dt,
x dt with its decay, the states) beside a bf16 one (x, B, C): a bf16
value is exact in tf32, so it takes two TF32 products where 3xTF32 takes
three (:func:`work` counts C B^T as the bf16 product, the others as
products with one bf16 operand).  The plain PyTorch version is
:func:`ssd_scan_ref` (``ref.ssd_scan``); the kernel agrees with it within
``testing.SSD_RTOL`` (float32) or ``testing.SSD_BF16_RTOL`` (bfloat16) of
the output's scale.  float16 raises.

There is no backward kernel, as the Pallas kernel has no differentiation
rule.  :class:`SSDScan` makes the scan differentiable: its forward
launches the kernel, its backward is :func:`ssd_scan_vjp`, the VJP of the
plain version recomputed from the saved inputs (the gradient ``jax.grad``
takes of the reference's ``impl="ref"`` training path), against the
cotangents of both ``y`` and the final state.  ``vjps`` counts those
plain backward calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0          # wrapper calls that launched the kernels (ops.py)
launches_bf16 = 0     # the launches among them on bf16 operands
vjps = 0              # plain-version VJPs since the last reset (ops.py)

ssd_scan_ref = ref.ssd_scan

MAX_HEAD_DIM = 64     # p
MAX_STATE = 128       # n


def path(p: int, n: int) -> str:
    """Which kernel the launcher runs for head dim ``p`` and state ``n``."""
    return "tensor cores" if p % 8 == 0 and n % 8 == 0 else "CUDA cores"


def workspace_bytes(x: torch.Tensor, B: torch.Tensor, chunk: int) -> int:
    """Bytes of the per-call workspace of the tensor-core path: each
    chunk's state (then the state entering the chunk) and decay, float32;
    none on the CUDA cores."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if path(p, n) != "tensor cores":
        return 0
    return 4 * b * -(-s // chunk) * h * (p * n + 1)


def chunked_ops(b: int, s: int, h: int, p: int, n: int, chunk: int
                ) -> Tuple[int, int, int]:
    """(matrix-product flops, other flops, the C B^T part of the products)
    of the chunked form K8 runs: per (row, head), C B^T and W U on each
    chunk's causal triangle (2n and 2p per pair), the chunk states U^T (B o
    decay) and the incoming C S^T (2pn per step each); besides them the
    decay weights (a difference, an exp and a product per pair), per step
    u = x dt and its decay (2p), exp(cum_i) C S added to y (2p), the cumsum
    and decays (5), and the recurrence across chunks (2pn per chunk)."""
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = sum(n_ * (n_ + 1) // 2 for n_ in lens)
    mma = b * h * (2 * (n + p) * pairs + 4 * s * p * n)
    other = b * h * (3 * pairs + s * (4 * p + 5) + 2 * p * n * len(lens))
    return mma, other, b * h * 2 * n * pairs


def work(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
         initial_state: Optional[torch.Tensor] = None
         ) -> Tuple[int, int, int, int]:
    """(products, other, bf16 products, products with one bf16 operand)
    operations K8 does on these operands (:func:`chunked_ops`; the
    roofline's floor, ``roofline.analysis``).  On bf16 x, B and C its bf16
    product is C B^T, whose operands are bf16 values; each of the others
    has one float32 operand (W with dt, x dt with its decay, the states)
    and one bf16 one (x, B, C).  On float32 every product is a 3xTF32
    one."""
    b, s, h, p = x.shape
    return chunked_work(b, s, h, p, B.shape[-1], chunk,
                        x.dtype == torch.bfloat16)


def chunked_work(b: int, s: int, h: int, p: int, n: int, chunk: int,
                 bf16: bool) -> Tuple[int, int, int, int]:
    """:func:`work` from the shapes: :func:`chunked_ops` with C B^T as the
    bf16 products and the others as products with one bf16 operand where
    ``bf16``, every product a 3xTF32 one where not."""
    mma, other, cbt = chunked_ops(b, s, h, p, n, chunk)
    return (mma, other, cbt, mma - cbt) if bf16 else (mma, other, 0, 0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,s,h,p), B and C (b,s,n) (float32 or bfloat16, one dtype), dt
    (b,s,h), A (h,), initial_state (b,h,p,n) or None (float32) -> (y
    (b,s,h,p) in x's dtype, final_state (b,h,p,n) float32)."""
    global launches, launches_bf16
    b, s, h, p = x.shape
    n = B.shape[-1]
    x, dt, A = x.contiguous(), dt.contiguous(), A.contiguous()
    B, C = B.contiguous(), C.contiguous()
    operands = [("x", x, _build.DTYPES, None),
                ("dt", dt, torch.float32, (b, s, h)),
                ("A", A, torch.float32, (h,)),
                ("B", B, _build.DTYPES, (b, s, n)),
                ("C", C, _build.DTYPES, (b, s, n))]
    if initial_state is not None:
        initial_state = initial_state.contiguous()
        operands.append(("initial_state", initial_state, torch.float32,
                         (b, h, p, n)))
    _build.check_operands(*operands, same=[("x", "B", "C")])
    if not (0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE and chunk > 0):
        raise ValueError(f"ssd_scan: unsupported head dim {p}, state {n} "
                         f"or chunk {chunk}")
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b and h:
        nws = workspace_bytes(x, B, chunk) // 4
        ws = (torch.empty(nws, dtype=torch.float32, device=x.device)
              if nws else None)
        _build.launch(_build.launcher("vpaas_ssd_scan", x.dtype),
                      x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                      B.data_ptr(), C.data_ptr(),
                      None if initial_state is None
                      else initial_state.data_ptr(),
                      y.data_ptr(), fin.data_ptr(),
                      None if ws is None else ws.data_ptr(),
                      b, s, h, p, n, chunk)
        launches += 1
        launches_bf16 += x.dtype == torch.bfloat16
    return y, fin


def ssd_scan_vjp(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, d_y: torch.Tensor,
                 d_final: torch.Tensor, *, chunk: int = 64,
                 initial_state: Optional[torch.Tensor] = None):
    """(dx, ddt, dA, dB, dC, d_initial_state or None): the VJP of the plain
    version at these inputs against the cotangents of ``y`` and of the
    final state, recomputed under autograd on the inputs' device."""
    global vjps
    vjps += not x.is_meta          # the dry run's count on meta runs none
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        if initial_state is not None:
            leaves.append(initial_state.detach().requires_grad_(True))
        y, fin = ssd_scan_ref(*leaves[:5], chunk=chunk,
                              initial_state=leaves[5] if len(leaves) > 5
                              else None)
        grads = torch.autograd.grad((y, fin), leaves, (d_y, d_final))
    return tuple(grads) + (None,) * (6 - len(grads))


class SSDScan(torch.autograd.Function):
    """The kernel forward, the plain version's VJP backward."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk, initial_state):
        return ssd_scan(x, dt, A, B, C, chunk=chunk,
                        initial_state=initial_state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, B, C, chunk, initial_state = inputs
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        ctx.chunk = chunk

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_y, d_final):
        x, dt, A, B, C, st = ctx.saved_tensors
        dx, ddt, dA, dB, dC, dst = ssd_scan_vjp(
            x, dt, A, B, C, d_y, d_final, chunk=ctx.chunk, initial_state=st)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, ddt if need[1] else None,
                dA if need[2] else None, dB if need[3] else None,
                dC if need[4] else None, None, dst if need[6] else None)
