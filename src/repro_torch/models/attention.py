"""GQA self-attention, full or sliding-window (port of the self-attention
part of ``repro.models.attention``; MLA and cross-attention come with a
later slice, ROADMAP M11).

Decode passes a KV cache dict and ``cache_index``: the write position, a
0-d tensor (every row alike) or ``(b,)`` (per-slot continuous batching).
The cache is updated **in place** -- a decode step writes one position of
each row instead of copying the whole cache -- and the same tensors are
returned as the new cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.schema import Leaf


def attn_schema(cfg: ModelConfig):
    d = cfg.d_model
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    s = {
        "wq": Leaf((d, q_dim), ("embed", "q_dim"), "fan_in"),
        "wk": Leaf((d, kv_dim), ("embed", "kv_dim"), "fan_in"),
        "wv": Leaf((d, kv_dim), ("embed", "kv_dim"), "fan_in"),
        "wo": Leaf((q_dim, d), ("q_dim", "embed"), "fan_in"),
    }
    if cfg.qkv_bias:
        s["bq"] = Leaf((q_dim,), ("q_dim",), "zeros")
        s["bk"] = Leaf((kv_dim,), ("kv_dim",), "zeros")
        s["bv"] = Leaf((kv_dim,), ("kv_dim",), "zeros")
    return s


def attn_cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    kv = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def _cache_update(cache: torch.Tensor, new: torch.Tensor,
                  index: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (b, s, ...) into ``cache`` (b, S, ...) in place at seq
    position ``index`` (0-d, or (b,) per slot) and return ``cache``.  As
    ``lax.dynamic_update_slice`` does, the start is clamped so the s
    positions fit."""
    b, s = new.shape[:2]
    span = torch.arange(s, device=cache.device)
    start = index.long().clamp(0, cache.shape[1] - s)
    new = new.to(cache.dtype)
    if start.dim() == 0:
        cache.index_copy_(1, start + span, new)
    else:
        rows = torch.arange(b, device=cache.device)[:, None]
        cache[rows, start[:, None] + span[None, :]] = new
    return cache


def _project_qkv(cfg: ModelConfig, params, x: torch.Tensor):
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    b, s, _ = x.shape
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def self_attention(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                    # (b, s, d)
    positions: torch.Tensor,            # (b, s)
    *,
    window: Optional[int] = None,
    cache=None,
    cache_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_logit_softcap)
        new_cache = None
    else:
        k_cache = _cache_update(cache["k"], k, cache_index)
        v_cache = _cache_update(cache["v"], v, cache_index)
        new_cache = {"k": k_cache, "v": v_cache}
        if s == 1:
            out = ops.decode_attention(
                q[:, 0], k_cache, v_cache, cache_index + 1, window=window,
                softcap=cfg.attn_logit_softcap)[:, None]
        else:
            # prefill into the cache: attends over all max_seq slots; the
            # slots past the prompt are removed by the causal mask
            out = ops.flash_attention(
                q, k_cache, v_cache, causal=True, window=window,
                softcap=cfg.attn_logit_softcap, q_offset=cache_index)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], new_cache
