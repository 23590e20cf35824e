"""Mamba2 SSD mixer (state-space duality), shared by mamba2-2.7b and the
zamba2-7b hybrid (port of ``repro.models.ssm``).

One input projection packs (z, x, B, C, dt) with B/C shared across heads
(n_groups=1), a short causal depthwise conv over (x, B, C), softplus dt,
scalar-per-head decay A, skip D, gated RMSNorm, output projection.  The
sequence mixer is the chunked SSD scan (K8 on the card); decode takes one
recurrent step (plain PyTorch) with the rolled conv window.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm, rmsnorm_schema, silu
from repro_torch.models.schema import Leaf


def ssm_schema(cfg: ModelConfig):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = di + 2 * n
    return {
        "w_in": Leaf((d, 2 * di + 2 * n + h), ("embed", "ssm_inner"),
                     "fan_in"),
        "conv_w": Leaf((cfg.conv_kernel, conv_dim), ("conv", "ssm_inner"),
                       "fan_in"),
        "conv_b": Leaf((conv_dim,), ("ssm_inner",), "zeros"),
        "A_log": Leaf((h,), ("ssm_heads",), "small_a"),
        "D": Leaf((h,), ("ssm_heads",), "ones"),
        "dt_bias": Leaf((h,), ("ssm_heads",), "zeros"),
        "norm": rmsnorm_schema(di),
        "w_out": Leaf((di, d), ("ssm_inner", "embed"), "fan_in"),
    }


def ssm_cache_spec(cfg: ModelConfig, batch: int):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {
        "state": (batch, h, cfg.ssm_head_dim, n),
        "conv": (batch, cfg.conv_kernel - 1, di + 2 * n),
    }


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt


def _causal_conv(cfg: ModelConfig, params, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (b, s, conv_dim)."""
    k = cfg.conv_kernel
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * params["conv_w"][0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * params["conv_w"][i]
    return silu(out + params["conv_b"])


def ssm_apply(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,                 # (b, s, d)
    *,
    cache: Optional[dict] = None,
    cache_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (out, new cache or None).  The new cache holds fresh
    tensors; the caller writes them into its cache storage."""
    del cache_index          # the SSM cache is positionless
    b, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    A = -torch.exp(params["A_log"].float())

    zxbcdt = x @ params["w_in"]
    z, xbc_raw, dt_raw = _split(cfg, zxbcdt)

    decode = cache is not None and s == 1
    if decode:
        # roll the conv window, then one recurrent step
        window = torch.cat([cache["conv"], xbc_raw], dim=1)   # (b, K, cd)
        conv_out = silu(torch.einsum("bkc,kc->bc", window, params["conv_w"])
                        + params["conv_b"])[:, None]
        new_conv = window[:, 1:]
        xbc = conv_out
    else:
        xbc = _causal_conv(cfg, params, xbc_raw)

    x_part = xbc[..., :di].reshape(b, s, h, p)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())

    if decode:
        y, new_state = ops.ssd_step(x_part[:, 0], dt[:, 0], A, B[:, 0],
                                    C[:, 0], cache["state"])
        y = y[:, None]
        new_cache = {"state": new_state, "conv": new_conv}
    else:
        init = cache["state"] if cache is not None else None
        y, final_state = ops.ssd_scan(x_part, dt, A, B, C,
                                      chunk=cfg.ssm_chunk,
                                      initial_state=init)
        if cache is not None:   # chunked prefill into a fresh cache
            k = cfg.conv_kernel
            pad = F.pad(xbc_raw, (0, 0, k - 1, 0))
            new_cache = {"state": final_state, "conv": pad[:, -(k - 1):]}
        else:
            new_cache = None

    y = y + x_part * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = rmsnorm(params["norm"], y * silu(z), eps=cfg.norm_eps)
    return y @ params["w_out"], new_cache
