"""K7: decode attention (one new token against the KV cache) as a
hand-written CUDA kernel.

Port of the Pallas kernel ``repro.kernels.decode_attention.decode_attention``
(source: ``csrc/decode_attention.cu``): each batch row's query attends to
the first ``cache_len[b]`` slots of its cache (a scalar is broadcast to
every row), with an optional window and logit softcap, GQA, float32.  The
plain PyTorch version is :func:`decode_attention_ref`
(``ref.decode_attention``); the kernel agrees with it within
``testing.ATTN_ATOL``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, check_options,
                                                 row_array)

launches = 0          # kernel launches since the last reset (ops.py)

decode_attention_ref = ref.decode_attention


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (b, n_q, d), caches (b, S, n_kv, d), cache_len scalar or (b,)
    -> (b, n_q, d)."""
    global launches
    b, n_q, d = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    _build.check_operands(
        ("q", q, torch.float32, None),
        ("k_cache", k_cache, torch.float32, (b, S, n_kv, d)),
        ("v_cache", v_cache, torch.float32, (b, S, n_kv, d)))
    if n_kv == 0 or n_q % n_kv or not 0 < d <= MAX_HEAD_DIM or S == 0:
        raise ValueError(f"decode_attention: unsupported heads {n_q}/{n_kv},"
                         f" head dim {d} or {S} cache slots")
    check_options(window, softcap)
    clen = row_array(cache_len, b, q.device, "cache_len")
    out = torch.empty_like(q)
    if b and n_q:
        _build.launch("vpaas_decode_attention", q.data_ptr(),
                      k_cache.data_ptr(), v_cache.data_ptr(), clen.data_ptr(),
                      out.data_ptr(), b, S, n_q, n_kv, d, window or 0,
                      float(softcap or 0.0), d ** -0.5)
        launches += 1
    return out
