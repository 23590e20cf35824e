"""Shared primitive layers: RMSNorm, RoPE, gated MLP, embeddings, softcap
(port of ``repro.models.layers``).  Matmul weights keep the JAX
``(in, out)`` layout: a projection is ``x @ w``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import Leaf


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rmsnorm_schema(dim: int):
    return {"scale": Leaf((dim,), ("null",), "ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """As the reference: the learned scale multiplies as ``1 + scale``
    (and is initialised to ones)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings (split-halves layout)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs          # (..., s, half)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., s, 1, h)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# --------------------------------------------------------------------------
def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": Leaf((d, f), ("embed", "ffn"), "fan_in"),
        "wi_up": Leaf((d, f), ("embed", "ffn"), "fan_in"),
        "wo": Leaf((f, d), ("ffn", "embed"), "fan_in"),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, as ``jax.nn.silu`` computes it: in bf16 the
    sigmoid is rounded before the product, which ``F.silu``'s one fused
    rounding is not (about a third of a bf16 conv's outputs differ)."""
    return x * torch.sigmoid(x)


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = silu(x @ params["wi_gate"])
    return (gate * (x @ params["wi_up"])) @ params["wo"]


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def embed_schema(cfg: ModelConfig):
    v = cfg.padded_vocab
    s = {"embedding": Leaf((v, cfg.d_model), ("vocab", "embed"), "normal")}
    if not cfg.tie_embeddings:
        s["lm_head"] = Leaf((cfg.d_model, v), ("embed", "vocab"), "fan_in")
    return s


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embedding"].to(dtype)[tokens.long()]


def unembed(params, x: torch.Tensor,
            cap: Optional[float] = None) -> torch.Tensor:
    if "lm_head" in params:
        logits = x @ params["lm_head"].to(x.dtype)
    else:
        logits = x @ params["embedding"].to(x.dtype).T
    return softcap(logits.float(), cap)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``cap * tanh(x / cap)``, or ``x`` when ``cap`` is None."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)

