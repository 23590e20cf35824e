"""K6: flash attention (prefill) as a hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.flash_attention.flash_attention``
(source: ``csrc/flash_attention.cu``): GQA attention with an online softmax,
causal mask, optional sliding window and logit softcap, on float32 or
bfloat16 operands (q, k and v of one dtype; the output in it too), with
every sum in float32, as the Pallas kernel computes on the bf16 operands
of the reference's launch path.  float32 runs its two products on the
tensor cores in 3xTF32 up to d = 192 and d_v = 128 (MLA's prefill: 192 for
q and k, 128 for v), and where q, k and v share a head dim up to 256
(gemma2's float32 serving prefill: past 128 a kernel whose warps each take
a quarter of the head dim, since O's 16 x 256 floats would not fit one
warp's registers beside S); bfloat16 on the same head dims as wgmma on TMA
tiles (q.k exact in float32, p.v with p split into two bf16 halves; MLA's
192 / 128 with v at its own width; :func:`block_rows` says how many query
rows a block takes); at d <= 64 a persistent warp-specialised kernel, and
one query row (s_q = 1) a kernel of its own (:func:`instance` names the
kernel a call runs).  A value head dim of its own past 192 / 128 runs on
the CUDA cores (bf16 widened to float32 as it loads).  The bf16
tensor-core kernel loads by TMA, whose row strides are multiples of 16
bytes: a head dim that is not a multiple of 8, or an operand that is not
16-byte aligned, is copied into zero-padded tensors first (q and k to d,
v to d_v, each rounded up to 8: :func:`tma_ready`).  The query
offset is a device array read
at run time (a scalar is broadcast to one entry per batch row), so the
cache prefill's per-row cache index takes the kernel too.  The plain
PyTorch version is :func:`flash_attention_ref` (``ref.flash_attention``);
the kernel agrees with it within ``testing.ATTN_ATOL`` (float32) or
``testing.ATTN_BF16_RTOL`` (bfloat16).  float16 raises.  Every route is
one device kernel a call, which records the CUDA events
``_build.time_next_launch`` hands it before and after that kernel, so
the gap between them is the call's device time.

The kernel has no backward kernel, as the Pallas one has no
differentiation rule.  :class:`FlashAttention` makes it differentiable:
its forward launches the kernel, its backward is
:func:`flash_attention_vjp`, the VJP of the plain version recomputed from
the saved inputs -- the gradient ``jax.grad`` takes of the reference's
``impl="ref"`` training path.  ``vjps`` counts those plain backward calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (ops.py)
launches_bf16 = 0     # the launches among them on bf16 operands
launches_d64 = 0      # those among them on the d <= 64 kernels
vjps = 0              # plain-version VJPs since the last reset (ops.py)

flash_attention_ref = ref.flash_attention

MAX_HEAD_DIM = 256


def on_tensor_cores(d: int, d_v: int,
                    dtype: torch.dtype = torch.float32) -> bool:
    """Whether the launcher runs these head dims on operands of ``dtype``
    on a tensor-core kernel (else on its CUDA-core one), as the built
    library answers it."""
    return bool(_build.query("vpaas_flash_attention_on_tensor_cores", d, d_v,
                             int(dtype == torch.bfloat16)))


# vpaas_flash_attention_bf16_kernel's answers past the wgmma kernel's NWG
_WS_KERNEL, _ROW_KERNEL = 3, 4


def _nkt(d: int) -> int:
    """The wgmma kernels' 16-column steps of a (padded) head dim."""
    return next(n for n in (2, 4, 6, 7, 8, 16) if 16 * n >= d)


def instance(b: int, s_q: int, n_q: int, d: int, d_v: int,
             dtype: torch.dtype = torch.bfloat16) -> str:
    """The name (as ptxas reports it) of the kernel instance the launcher
    runs on (b, s_q, n_q, d) queries and values of head dim ``d_v`` in
    ``dtype``: in bf16 the route the built library answers
    (``vpaas_flash_attention_bf16_kernel``: at d <= 64 the persistent
    kernel, or the one-row kernel at s_q = 1; else the wgmma kernel by its
    block's warpgroups, or the CUDA-core kernel), in float32 its dispatch's
    head-dim steps."""
    if dtype == torch.bfloat16:
        dp, d_vp = -(-d // 8) * 8, -(-d_v // 8) * 8
        route = _build.query("vpaas_flash_attention_bf16_kernel", b, s_q,
                             n_q, dp, d_vp)
        if route == _WS_KERNEL:
            return f"flash_attention_ws_kernel<{_nkt(dp)}>"
        if route == _ROW_KERNEL:
            return f"flash_attention_row_kernel<{_nkt(dp)}>"
        if route:
            if d > 128 and d_v < d:            # MLA's value head dim
                return f"flash_attention_wgmma_kernel<{route}, 12, 8>"
            return (f"flash_attention_wgmma_kernel<{route}, {_nkt(dp)}, "
                    f"{_nkt(dp)}>")
    elif on_tensor_cores(d, d_v):
        if d == d_v and d > 128:           # 32-row blocks of column warps
            return "flash_attention_cols_kernel"
        if d == d_v:
            ndt = nvt = next(n for n in (4, 8, 12, 14, 16) if 8 * n >= d)
        else:
            ndt = next(n for n in (8, 12, 16, 24) if 8 * n >= d)
            nvt = 8 if d_v <= 64 else 16
        rw = 4 if d <= 128 else 2          # row warps: 32-row blocks past 128
        return f"flash_attention_mma_kernel<{ndt}, {nvt}, {rw}>"
    nc = 2 if d_v <= 64 else 4 if d_v <= 128 else 8
    elem = "bf16" if dtype == torch.bfloat16 else "float"
    return f"flash_attention_simt_kernel<{elem}, {nc}>"


def block_rows(b: int, s_q: int, n_q: int) -> int:
    """The query rows a block of the bf16 tensor-core kernel takes at this
    grid: 128 (two consumer warpgroups), or 64 where 128-row blocks would
    not put one on every SM of the card."""
    return _build.query("vpaas_flash_attention_bf16_block_rows", b, s_q, n_q)


def tma_ready(*tensors: torch.Tensor) -> bool:
    """Whether the bf16 tensor-core kernel's TMA can read these (b, s, n,
    d) operands as they are: d a multiple of 8 (row strides of 16 bytes)
    and every pointer 16-byte aligned."""
    return all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
               for t in tensors)


# (value, b, device) -> the (b,) int32 tensor of an int offset: made once,
# since copying a host int to the card waits for the stream
_ROWS: dict = {}
MAX_ROWS = 64


def row_array(value, b: int, device, name: str) -> torch.Tensor:
    """An int, 0-d or (b,) integer tensor as a contiguous (b,) int32 tensor
    on ``device`` (one entry per batch row).  An int's tensor is kept for
    the next call with the same int, batch and device (the kernels only
    read it)."""
    if (isinstance(value, torch.Tensor) and value.dtype == torch.int32
            and value.device == device and value.numel() == 1 and b == 1):
        return value.reshape(1)      # the prefill's own case: no copy
    if isinstance(value, int) and not isinstance(value, bool):
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # a graph's fill runs only on replay: not kept for other calls
            return torch.full((b,), value, dtype=torch.int32, device=device)
        key = (value, b, device)
        rows = _ROWS.get(key)
        if rows is None:
            if len(_ROWS) >= MAX_ROWS:
                _ROWS.clear()
            rows = _ROWS[key] = torch.full((b,), value, dtype=torch.int32,
                                           device=device)
        return rows
    t = torch.as_tensor(value, device=device)
    if t.is_floating_point():
        raise ValueError(f"{name}: expected integers, got {t.dtype}")
    t = t.to(torch.int32).reshape(-1)
    if t.numel() == 1:
        t = t.expand(b)
    if t.shape != (b,):
        raise ValueError(f"{name}: expected a scalar or ({b},), got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def check_options(window: Optional[int], softcap: Optional[float]) -> None:
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def pair_work(pairs: int, d: int, d_v: int, softcap: Optional[float],
              dtype: torch.dtype = torch.float32
              ) -> Tuple[int, int, int, int]:
    """(products, other, bf16 products, products with one bf16 operand)
    floating-point operations of ``pairs`` (query head, key) pairs on
    operands of ``dtype``: q.k and p.v (2 d + 2 d_v), and beside them the
    scale, running max, exp and sum (5) and a softcap's division, tanh and
    multiply (3).  The products of bf16 operands are all bf16 products: the
    least time charges them at the bf16 tensor-core rate, whichever unit a
    kernel runs them on; none has one bf16 operand only."""
    products = pairs * 2 * (d + d_v)
    return (products, pairs * (5 + (3 if softcap else 0)),
            products if dtype == torch.bfloat16 else 0, 0)


def causal_pairs(s_q: int, s_kv: int, *, causal: bool,
                 window: Optional[int], q_offset) -> int:
    """The (query, key) pairs of one row and head that the mask lets
    through.  A tensor ``q_offset`` (which has no value on meta) counts the
    queries as the last ``s_q`` positions of the keys."""
    off = (s_kv - s_q if isinstance(q_offset, torch.Tensor)
           else int(q_offset))
    pos = torch.arange(s_q, dtype=torch.long) + off
    hi = pos.clamp(max=s_kv - 1) if causal else torch.full_like(pos,
                                                                 s_kv - 1)
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    return int((hi - lo + 1).clamp(min=0).sum())


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         softcap: Optional[float] = None,
         q_offset=0) -> Tuple[int, int, int, int]:
    """(products, other, bf16 products, products with one bf16 operand:
    :func:`pair_work`) operations K6 does on these
    operands: every pair the mask lets through, for each row and query head
    (the roofline's floor; ``roofline.analysis``)."""
    b, s_q, n_q, d = q.shape
    pairs = causal_pairs(s_q, k.shape[1], causal=causal, window=window,
                         q_offset=q_offset)
    return pair_work(b * n_q * pairs, d, v.shape[-1], softcap, q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset=0) -> torch.Tensor:
    """q (b, s_q, n_q, d), k (b, s_kv, n_kv, d) and v (b, s_kv, n_kv, d_v),
    all float32 or all bfloat16, -> (b, s_q, n_q, d_v) in their dtype, with
    d_v <= d; the logits are scaled by d ** -0.5."""
    global launches, launches_bf16, launches_d64
    b, s_q, n_q, d = q.shape
    s_kv, n_kv, d_v = k.shape[1], k.shape[2], v.shape[-1]
    v_dim = d_v
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.check_operands(("q", q, _build.DTYPES, None),
                          ("k", k, _build.DTYPES, (b, s_kv, n_kv, d)),
                          ("v", v, _build.DTYPES, (b, s_kv, n_kv, d_v)),
                          same=[("q", "k", "v")])
    if (n_kv == 0 or n_q % n_kv or not 0 < d_v <= d <= MAX_HEAD_DIM
            or s_kv == 0):
        raise ValueError(f"flash_attention: unsupported heads {n_q}/{n_kv}, "
                         f"head dims {d}/{d_v} or {s_kv} keys")
    check_options(window, softcap)
    off = row_array(q_offset, b, q.device, "q_offset")
    scale = d ** -0.5
    padded = (q.dtype == torch.bfloat16 and not tma_ready(q, k, v)
              and on_tensor_cores(d, d_v, q.dtype))
    if padded:                  # zero columns add nothing to q.k or p.v
        pad = torch.nn.functional.pad
        dp, d_vp = -(-d // 8) * 8, -(-d_v // 8) * 8
        q, k = pad(q, (0, dp - d)), pad(k, (0, dp - d))
        v = pad(v, (0, d_vp - d_v))
        d, d_v = dp, d_vp
    out = q.new_empty((b, s_q, n_q, d_v))
    if b and s_q:
        _build.launch(_build.launcher("vpaas_flash_attention", q.dtype),
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      off.data_ptr(), out.data_ptr(), b, s_q, s_kv, n_q,
                      n_kv, d, d_v, int(causal), window or 0,
                      float(softcap or 0.0), scale)
        launches += 1
        launches_bf16 += q.dtype == torch.bfloat16
        launches_d64 += q.dtype == torch.bfloat16 and d <= 64
    return out[..., :v_dim].contiguous() if padded else out


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        d_out: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset=0):
    """(dq, dk, dv): the VJP of the plain version at (q, k, v) against the
    cotangent ``d_out``, recomputed under autograd on the inputs' device."""
    global vjps
    vjps += not q.is_meta          # the dry run's count on meta runs none
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window,
                                  softcap=softcap, q_offset=q_offset)
        return torch.autograd.grad(out, leaves, d_out)


class FlashAttention(torch.autograd.Function):
    """The kernel forward, the plain version's VJP backward."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap, q_offset):
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap, q_offset = inputs
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        grads = flash_attention_vjp(*ctx.saved_tensors, d_out, **ctx.kw)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,) * 4
