"""Generic decoder stack (port of ``repro.models.transformer`` for the layer
kinds ATTN, LOCAL, SSM, SSM_FFN and SHARED_ATTN).

The layer stack is ``prefix_layers + num_blocks * block_pattern +
suffix_layers``.  The repeated pattern keeps the JAX package's stacked
parameters (a leading ``num_blocks`` dim under ``blocks/<i>``); where the
JAX package runs a ``lax.scan`` over it, the port loops over the leading
dim in Python.  Shared-weight attention blocks (zamba2) use the single
``shared`` parameter set at every occurrence but keep per-occurrence KV
caches inside ``blocks/<i>``.  Parameter and cache trees keep the JAX
package's keys, so :func:`repro_torch.weights.llm_from_numpy_tree` maps one
onto the other.

MoE, cross-attention (and its frontend embeddings) and MLA come with a
later slice (ROADMAP M11): a config that needs them raises
``NotImplementedError``.

Public API:
  init_params(cfg, seed, device) / init_cache(cfg, batch, max_seq, device)
  forward(cfg, params, tokens, ...)   -> (logits, cache, aux)
  prefill / decode_step                (the serving engine's two calls)

A cache passed to ``forward`` is updated in place and returned.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN, CROSS, LOCAL, MOE, SHARED_ATTN,
                                      SSM, SSM_FFN, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import schema as sch
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed, embed_schema, mlp, mlp_schema,
                                       rmsnorm, rmsnorm_schema, unembed)


def check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.prefix_layers + cfg.block_pattern + cfg.suffix_layers)
    for what, needed in (("MoE layers", MOE in kinds),
                         ("cross-attention layers", CROSS in kinds),
                         ("frontend context embeddings",
                          bool(cfg.num_ctx_tokens)),
                         ("MLA attention layers", cfg.mla)):
        if needed:
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet (ROADMAP M11: MoE, "
                "cross-attention, MLA)")


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------
def layer_schema(cfg: ModelConfig, kind: str):
    d = cfg.d_model
    if kind in (ATTN, LOCAL, SHARED_ATTN):
        return {"ln": rmsnorm_schema(d), "attn": attn_mod.attn_schema(cfg),
                "ln2": rmsnorm_schema(d), "mlp": mlp_schema(cfg)}
    if kind == SSM:
        return {"ln": rmsnorm_schema(d), "ssm": ssm_mod.ssm_schema(cfg)}
    if kind == SSM_FFN:
        return {"ln": rmsnorm_schema(d), "ssm": ssm_mod.ssm_schema(cfg),
                "ln2": rmsnorm_schema(d), "mlp": mlp_schema(cfg)}
    raise ValueError(kind)


def layer_cache_shapes(cfg: ModelConfig, kind: str, batch: int,
                       max_seq: int):
    """Shape dict for one layer's decode cache."""
    if kind in (ATTN, LOCAL, SHARED_ATTN):
        return attn_mod.attn_cache_spec(cfg, batch, max_seq)
    if kind in (SSM, SSM_FFN):
        return ssm_mod.ssm_cache_spec(cfg, batch)
    raise ValueError(kind)


def model_schema(cfg: ModelConfig):
    check_supported(cfg)
    s: Dict[str, Any] = {"embed": embed_schema(cfg)}
    if cfg.prefix_layers:
        s["prefix"] = {str(i): layer_schema(cfg, k)
                       for i, k in enumerate(cfg.prefix_layers)}
    unit = {str(i): (layer_schema(cfg, k) if k != SHARED_ATTN else {})
            for i, k in enumerate(cfg.block_pattern)}
    s["blocks"] = sch.stack(unit, cfg.num_blocks)
    if SHARED_ATTN in cfg.block_pattern:
        s["shared"] = layer_schema(cfg, SHARED_ATTN)
    if cfg.suffix_layers:
        s["suffix"] = {str(i): layer_schema(cfg, k)
                       for i, k in enumerate(cfg.suffix_layers)}
    s["final_norm"] = rmsnorm_schema(cfg.d_model)
    return s


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random float32 parameters from a ``torch.Generator`` on ``device``
    seeded with ``seed`` (the JAX package's initialisers; the numbers differ
    from ``jax.random``'s)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return sch.init(model_schema(cfg), gen, device)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def _cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    out: Dict[str, Any] = {}
    if cfg.prefix_layers:
        out["prefix"] = {str(i): layer_cache_shapes(cfg, k, batch, max_seq)
                         for i, k in enumerate(cfg.prefix_layers)}
    out["blocks"] = {
        str(i): {name: (cfg.num_blocks,) + shp for name, shp in
                 layer_cache_shapes(cfg, k, batch, max_seq).items()}
        for i, k in enumerate(cfg.block_pattern)}
    if cfg.suffix_layers:
        out["suffix"] = {str(i): layer_cache_shapes(cfg, k, batch, max_seq)
                         for i, k in enumerate(cfg.suffix_layers)}
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zeroed float32 decode cache (the SSM ``state`` is float32 in every
    configuration, as in the reference)."""
    check_supported(cfg)
    return {part: {key: {name: torch.zeros(shp, dtype=torch.float32,
                                           device=device)
                         for name, shp in layer.items()}
                   for key, layer in layers.items()}
            for part, layers in _cache_shapes(cfg, batch, max_seq).items()}


def _write_back(dst: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
    """Store a layer's new cache in the cache storage ``dst`` (attention
    caches were already updated in place)."""
    for name, t in new.items():
        if t is not dst[name]:
            dst[name].copy_(t)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def _apply_layer(cfg: ModelConfig, kind: str, params, x, *, positions, cache,
                 cache_index):
    window = cfg.sliding_window if kind == LOCAL else None
    c = cache if cache else None

    if kind in (SSM, SSM_FFN):
        h, new_c = ssm_mod.ssm_apply(cfg, params["ssm"],
                                     rmsnorm(params["ln"], x, cfg.norm_eps),
                                     cache=c, cache_index=cache_index)
        x = x + h
        if kind == SSM_FFN:
            x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
        return x, new_c

    h, new_c = attn_mod.self_attention(
        cfg, params["attn"], rmsnorm(params["ln"], x, cfg.norm_eps),
        positions, window=window, cache=c, cache_index=cache_index)
    x = x + h
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, new_c


def _apply_stack(cfg: ModelConfig, kinds, layer_params, x, cache, **kw):
    """Layers ``kinds`` (prefix or suffix), writing their caches back."""
    for i, kind in enumerate(kinds):
        c = cache[str(i)] if cache is not None else None
        x, nc = _apply_layer(cfg, kind, layer_params[str(i)], x, cache=c,
                             **kw)
        if nc is not None:
            _write_back(c, nc)
    return x


def _apply_unit(cfg: ModelConfig, unit_params, shared_params, x, unit_cache,
                **kw):
    for i, kind in enumerate(cfg.block_pattern):
        p = shared_params if kind == SHARED_ATTN else unit_params[str(i)]
        c = unit_cache[str(i)] if unit_cache is not None else None
        x, nc = _apply_layer(cfg, kind, p, x, cache=c, **kw)
        if nc is not None:
            _write_back(c, nc)
    return x


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,                # (b, s) integer
    *,
    cache: Optional[dict] = None,
    cache_index=None,                    # int, 0-d or (b,)
    positions: Optional[torch.Tensor] = None,
    last_token_only: bool = False,       # unembed only the final position
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (logits (b,s,V) float32, cache updated in place or None,
    aux loss (zero: no MoE layer in this slice))."""
    check_supported(cfg)
    dev = tokens.device
    b, s = tokens.shape
    x = embed(params["embed"], tokens, torch.float32)
    if cfg.scale_embed:
        x = x * (cfg.d_model ** 0.5)

    if cache_index is None:
        cache_index = 0
    cache_index = torch.as_tensor(cache_index, device=dev).long()
    if positions is None:
        base = cache_index[:, None] if cache_index.dim() == 1 else cache_index
        positions = (base + torch.arange(s, device=dev)[None, :]).expand(b, s)

    kw = dict(positions=positions, cache_index=cache_index)
    if cfg.prefix_layers:
        x = _apply_stack(cfg, cfg.prefix_layers, params["prefix"], x,
                         cache["prefix"] if cache is not None else None, **kw)

    shared = params.get("shared")
    for i in range(cfg.num_blocks):
        bp = sch.tree_map(lambda t: t[i], params["blocks"])
        bc = (sch.tree_map(lambda t: t[i], cache["blocks"])
              if cache is not None else None)
        x = _apply_unit(cfg, bp, shared, x, bc, **kw)

    if cfg.suffix_layers:
        x = _apply_stack(cfg, cfg.suffix_layers, params["suffix"], x,
                         cache["suffix"] if cache is not None else None, **kw)

    if last_token_only:
        x = x[:, -1:]                    # prefill: only the next-token logits
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x, softcap=cfg.logit_softcap)
    return logits, cache, torch.zeros((), device=dev)


def decode_step(cfg: ModelConfig, params, tokens, cache, cache_index):
    """One serving decode step: (b,1) token + cache -> logits, cache."""
    logits, cache, _ = forward(cfg, params, tokens, cache=cache,
                               cache_index=cache_index)
    return logits, cache


def prefill(cfg: ModelConfig, params, tokens, cache):
    """Prefill a fresh cache with a full prompt; returns last-token logits
    and the cache."""
    logits, cache, _ = forward(cfg, params, tokens, cache=cache,
                               cache_index=0, last_token_only=True)
    return logits[:, -1], cache
