"""K7: decode attention (one new token against the KV cache) as a
hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.decode_attention.decode_attention``
(source: ``csrc/decode_attention.cu``): each batch row's query attends to
the first ``cache_len[b]`` slots of its cache (a scalar is broadcast to
every row), with an optional window and logit softcap, GQA, on float32 or
bfloat16 operands (q and the caches of one dtype, the output in it too;
the sums and the workspace float32).  A call runs two device kernels: one
block per (kv-head group, row, split of the row's valid slots) writes a
partial softmax state to a workspace, and a combine kernel merges the
splits in a fixed order.  The plain PyTorch version is
:func:`decode_attention_ref` (``ref.decode_attention``); the kernel agrees
with it within ``testing.ATTN_ATOL`` (float32) or ``testing.ATTN_BF16_RTOL``
(bfloat16).  float16 raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, check_options,
                                                 pair_work, row_array)

launches = 0          # wrapper calls that launched the kernels (ops.py)
launches_bf16 = 0     # the launches among them on bf16 operands

decode_attention_ref = ref.decode_attention

SPLIT_SLOTS = 64      # fewest slots a split takes: two 32-slot tiles
TARGET_BLOCKS = 1024  # blocks a call aims at: ~8 per SM of an H100's 132


def splits(b: int, S: int, n_kv: int, window: Optional[int]
           ) -> Tuple[int, int]:
    """(slots per split, number of splits) for a call.  The longest valid
    length the host knows without reading ``cache_len`` from the device is
    ``S``, or the window where it is shorter; it is cut into splits of at
    least ``SPLIT_SLOTS`` slots, as many as bring the grid to about
    ``TARGET_BLOCKS`` blocks."""
    longest = min(S, window) if window else S
    want = -(-TARGET_BLOCKS // max(1, b * n_kv))
    per = max(SPLIT_SLOTS, -(-longest // want))
    per = -(-per // 32) * 32                   # whole 32-slot tiles
    return per, -(-longest // per)


def workspace_bytes(q: torch.Tensor, k_cache: torch.Tensor,
                    window: Optional[int]) -> int:
    """Bytes of the per-call workspace: each split's partial softmax state
    (d + 2 floats, whatever the operands' dtype) for every (row, query
    head)."""
    b, n_q, d = q.shape
    _, nsplit = splits(b, k_cache.shape[1], k_cache.shape[2], window)
    return 4 * b * n_q * nsplit * (d + 2)


def work(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         cache_len, *, window: Optional[int] = None,
         softcap: Optional[float] = None) -> Tuple[int, int, int]:
    """(products, other, bf16 products) operations K7 does on these
    operands: each valid slot (the last ``window`` of them where there is
    one) for every row and query head.  A tensor ``cache_len`` (which has
    no value on meta) counts the whole cache (the roofline's floor;
    ``roofline.analysis``)."""
    b, n_q, d = q.shape
    S = k_cache.shape[1]
    rows = S if isinstance(cache_len, torch.Tensor) else min(int(cache_len),
                                                             S)
    if window:
        rows = min(rows, window)
    return pair_work(b * n_q * rows, d, v_cache.shape[-1], softcap,
                     q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (b, n_q, d), caches (b, S, n_kv, d), all float32 or all bfloat16,
    cache_len scalar or (b,) -> (b, n_q, d) in their dtype."""
    global launches, launches_bf16
    b, n_q, d = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    _build.check_operands(
        ("q", q, _build.DTYPES, None),
        ("k_cache", k_cache, _build.DTYPES, (b, S, n_kv, d)),
        ("v_cache", v_cache, _build.DTYPES, (b, S, n_kv, d)),
        same=[("q", "k_cache", "v_cache")])
    if n_kv == 0 or n_q % n_kv or not 0 < d <= MAX_HEAD_DIM or S == 0:
        raise ValueError(f"decode_attention: unsupported heads {n_q}/{n_kv},"
                         f" head dim {d} or {S} cache slots")
    check_options(window, softcap)
    clen = row_array(cache_len, b, q.device, "cache_len")
    out = torch.empty_like(q)
    if b and n_q:
        per, nsplit = splits(b, S, n_kv, window)
        ws = torch.empty(workspace_bytes(q, k_cache, window) // 4,
                         dtype=torch.float32, device=q.device)
        _build.launch(_build.launcher("vpaas_decode_attention", q.dtype),
                      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      clen.data_ptr(), ws.data_ptr(), out.data_ptr(), b, S,
                      n_q, n_kv, d, per, nsplit, window or 0,
                      float(softcap or 0.0), d ** -0.5)
        launches += 1
        launches_bf16 += q.dtype == torch.bfloat16
    return out
