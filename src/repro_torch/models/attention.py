"""Attention mixers: GQA self-attention (full / sliding-window), MLA
(DeepSeek latent attention) and cross-attention over frontend embeddings
(port of ``repro.models.attention``).

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


def mla_schema(cfg: ModelConfig):
    d = cfg.d_model
    nh, hd, rd = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    r = cfg.kv_lora_rank
    return {
        # queries (no q-lora in V2-Lite): per-head nope + rope parts
        "wq": Leaf((d, nh * (hd + rd)), ("embed", "q_dim"), "fan_in"),
        # kv down-projection to latent + decoupled rope key
        "w_dkv": Leaf((d, r), ("embed", "lora"), "fan_in"),
        "w_krope": Leaf((d, rd), ("embed", "rope"), "fan_in"),
        # up-projections from latent
        "w_uk": Leaf((r, nh * hd), ("lora", "q_dim"), "fan_in"),
        "w_uv": Leaf((r, nh * hd), ("lora", "q_dim"), "fan_in"),
        "wo": Leaf((nh * hd, d), ("q_dim", "embed"), "fan_in"),
    }


def cross_attn_schema(cfg: ModelConfig):
    d = cfg.d_model
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    return {
        "wq": Leaf((d, q_dim), ("embed", "q_dim"), "fan_in"),
        "wk": Leaf((d, kv_dim), ("embed", "kv_dim"), "fan_in"),
        "wv": Leaf((d, kv_dim), ("embed", "kv_dim"), "fan_in"),
        "wo": Leaf((q_dim, d), ("q_dim", "embed"), "fan_in"),
    }


def attn_cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    kv = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def mla_cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
    return {
        "c_kv": (batch, max_seq, cfg.kv_lora_rank),
        "k_rope": (batch, max_seq, cfg.rope_head_dim),
    }


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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_attention(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                    # (b, s, d)
    positions: torch.Tensor,            # (b, s)
    *,
    cache=None,
    cache_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    nh, hd, rd = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim

    q = (x @ params["wq"]).reshape(b, s, nh, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = x @ params["w_dkv"]                        # (b, s, r)
    k_rope = (x @ params["w_krope"]).reshape(b, s, 1, rd)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]

    new_cache = None
    if cache is not None:
        c_kv = _cache_update(cache["c_kv"], c_kv, cache_index)
        k_rope = _cache_update(cache["k_rope"], k_rope, cache_index)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}

    if cache is not None and s == 1:
        # weight-absorbed decode: attention against the latent cache, per
        # head K/V never materialised (plain PyTorch, as the reference's
        # einsums: no kernel)
        S, r = c_kv.shape[1], cfg.kv_lora_rank
        w_uk = params["w_uk"].reshape(r, nh, hd).float()
        w_uv = params["w_uv"].reshape(r, nh, hd).float()
        q_abs = torch.einsum("bnd,rnd->bnr", q_nope[:, 0].float(), w_uk)
        logits = (torch.einsum("bnr,bSr->bnS", q_abs, c_kv.float())
                  + torch.einsum("bnd,bSd->bnS", q_rope[:, 0].float(),
                                 k_rope.float())) * (hd + rd) ** -0.5
        clen = (cache_index + 1).reshape(-1, 1, 1)    # (b|1, 1, 1)
        valid = torch.arange(S, device=x.device)[None, None, :] < clen
        logits = torch.where(valid, logits, logits.new_full((), -1e30))
        probs = torch.softmax(logits, dim=-1)
        ctxv = torch.einsum("bnS,bSr->bnr", probs, c_kv.float())
        out = torch.einsum("bnr,rnd->bnd", ctxv, w_uv).to(x.dtype)
        return out.reshape(b, 1, nh * hd) @ params["wo"], new_cache

    # prefill: per-head keys [k_nope, k_rope] and values over the whole
    # cache (or the prompt), K6 with q/k head dim hd + rd and v's hd
    S = c_kv.shape[1]
    k_nope = (c_kv @ params["w_uk"]).reshape(b, S, nh, hd)
    v = (c_kv @ params["w_uv"]).reshape(b, S, nh, hd)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, S, nh, rd)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = ops.flash_attention(
        q_full, k, v, causal=True,
        q_offset=0 if cache is None else cache_index)
    return out.reshape(b, s, nh * hd) @ params["wo"], new_cache


# ---------------------------------------------------------------------------
# Cross-attention over frontend (image-patch / audio-frame) embeddings
# ---------------------------------------------------------------------------
def cross_attention(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                    # (b, s, d)
    ctx: torch.Tensor,                  # (b, n_ctx, d), already projected
) -> torch.Tensor:
    """Non-causal attention of every position over the context tokens.  K
    and V are recomputed from ``ctx`` at every call, decode included: the
    reference keeps no cross-attention cache either."""
    b, s, _ = x.shape
    n_ctx = ctx.shape[1]
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (ctx @ params["wk"]).reshape(b, n_ctx, cfg.num_kv_heads, cfg.head_dim)
    v = (ctx @ params["wv"]).reshape(b, n_ctx, cfg.num_kv_heads, cfg.head_dim)
    out = ops.flash_attention(q, k, v, causal=False)
    return out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ params["wo"]
