"""Generic decoder stack covering every assigned architecture family (port
of ``repro.models.transformer``: the layer kinds ATTN, LOCAL, MOE, CROSS,
SSM, SSM_FFN and SHARED_ATTN, MLA or GQA attention, and the frontend
context of the VLM and audio families).

The layer stack is ``prefix_layers + num_blocks * block_pattern +
suffix_layers``.  The repeated pattern keeps the JAX package's stacked
parameters (a leading ``num_blocks`` dim under ``blocks/<i>``); where the
JAX package runs a ``lax.scan`` over it, the port loops over the leading
dim in Python.  Shared-weight attention blocks (zamba2) use the single
``shared`` parameter set at every occurrence but keep per-occurrence KV
caches inside ``blocks/<i>``.  Parameter and cache trees keep the JAX
package's keys, so :func:`repro_torch.weights.llm_from_numpy_tree` maps one
onto the other.  A config with ``num_ctx_tokens`` (cross-attention over
frontend embeddings: llama-vision, musicgen) needs ``ctx_embed`` in every
call, as in the reference; ``LLMServer`` takes none, so such a config runs
through ``prefill`` / ``decode_step`` directly.

Public API:
  init_params(cfg, seed, device, dtype) / abstract_params /
      param_partition_specs
  init_cache(cfg, batch, max_seq, device, dtype) / abstract_cache /
      cache_partition_specs
  forward(cfg, params, tokens, ...)   -> (logits, cache, aux)
  loss_fn(cfg, params, batch, ...)    -> (total, {"ce", "aux"})
  prefill / decode_step                (the serving engine's two calls)

A cache passed to ``forward`` is updated in place and returned.  With
``remat`` each block unit is rematerialised in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of its
scan body; the prefix and suffix layers are not.  The sharding hooks
``act_constraint(x, kind)`` (after each block unit, and MoE's
``constrain``) and ``block_param_constraint(block_params)`` (before each
block unit) are called where the reference calls them; on one card they
place nothing, and the dry run passes none.  The reference's
``unroll_blocks`` (a Python loop in place of its scan, for XLA's cost
probes) is what the port always does.  ``dtype`` is the reference's: the
compute dtype of ``forward``, ``loss_fn``, ``prefill`` and ``decode_step``
(the embedding and the frontend context are cast to it; every other cast
follows the parameters' and the activations' dtypes, as the reference's
do), float32 by default as there, bfloat16 on the launch path
(``launch.specs.COMPUTE_DTYPE``) with bf16 parameters and caches.  The
SSM ``state`` stays float32 in every cache, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, CROSS, LOCAL, MOE, SHARED_ATTN,
                                      SSM, SSM_FFN, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import schema as sch
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed, embed_schema, mlp, mlp_schema,
                                       rmsnorm, rmsnorm_schema, unembed)
from repro_torch.models.schema import Leaf
from repro_torch.models.sharding import PartitionSpec


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------
def _mixer_schema(cfg: ModelConfig):
    return attn_mod.mla_schema(cfg) if cfg.mla else attn_mod.attn_schema(cfg)


def layer_schema(cfg: ModelConfig, kind: str):
    d = cfg.d_model
    if kind in (ATTN, LOCAL, SHARED_ATTN):
        return {"ln": rmsnorm_schema(d), "attn": _mixer_schema(cfg),
                "ln2": rmsnorm_schema(d), "mlp": mlp_schema(cfg)}
    if kind == MOE:
        return {"ln": rmsnorm_schema(d), "attn": _mixer_schema(cfg),
                "ln2": rmsnorm_schema(d), "moe": moe_mod.moe_schema(cfg)}
    if kind == SSM:
        return {"ln": rmsnorm_schema(d), "ssm": ssm_mod.ssm_schema(cfg)}
    if kind == SSM_FFN:
        return {"ln": rmsnorm_schema(d), "ssm": ssm_mod.ssm_schema(cfg),
                "ln2": rmsnorm_schema(d), "mlp": mlp_schema(cfg)}
    if kind == CROSS:
        return {"ln": rmsnorm_schema(d), "attn": _mixer_schema(cfg),
                "ln2": rmsnorm_schema(d),
                "xattn": attn_mod.cross_attn_schema(cfg),
                "ln3": rmsnorm_schema(d), "mlp": mlp_schema(cfg)}
    raise ValueError(kind)


def layer_cache_shapes(cfg: ModelConfig, kind: str, batch: int,
                       max_seq: int):
    """Shape dict for one layer's decode cache."""
    if kind in (ATTN, LOCAL, MOE, CROSS, SHARED_ATTN):
        if cfg.mla:
            return attn_mod.mla_cache_spec(cfg, batch, max_seq)
        return attn_mod.attn_cache_spec(cfg, batch, max_seq)
    if kind in (SSM, SSM_FFN):
        return ssm_mod.ssm_cache_spec(cfg, batch)
    raise ValueError(kind)


def _unit_schema(cfg: ModelConfig):
    """One block unit's schema (unstacked); the shared-attention slot is
    empty."""
    return {str(i): (layer_schema(cfg, k) if k != SHARED_ATTN else {})
            for i, k in enumerate(cfg.block_pattern)}


def model_schema(cfg: ModelConfig):
    s: Dict[str, Any] = {"embed": embed_schema(cfg)}
    if cfg.num_ctx_tokens:
        ctx_dim = cfg.ctx_dim or cfg.d_model
        s["ctx_proj"] = Leaf((ctx_dim, cfg.d_model), ("ctx", "embed"),
                             "fan_in")
    if cfg.prefix_layers:
        s["prefix"] = {str(i): layer_schema(cfg, k)
                       for i, k in enumerate(cfg.prefix_layers)}
    s["blocks"] = sch.stack(_unit_schema(cfg), cfg.num_blocks)
    if SHARED_ATTN in cfg.block_pattern:
        s["shared"] = layer_schema(cfg, SHARED_ATTN)
    if cfg.suffix_layers:
        s["suffix"] = {str(i): layer_schema(cfg, k)
                       for i, k in enumerate(cfg.suffix_layers)}
    s["final_norm"] = rmsnorm_schema(cfg.d_model)
    return s


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """Meta-tensor parameter tree (shapes only), bf16 by default as the
    reference's."""
    return sch.abstract(model_schema(cfg), dtype)


def param_partition_specs(cfg: ModelConfig, rules: Dict[str, Any]):
    return sch.partition_specs(model_schema(cfg), rules)


def block_unit_specs(cfg: ModelConfig, rules: Dict[str, Any]):
    """Partition specs for ONE block unit (unstacked): the reference's
    use-site weight resharding (two-level FSDP gather)."""
    return sch.partition_specs(_unit_schema(cfg), rules)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.float32):
    """Random parameters from a ``torch.Generator`` on ``device`` seeded
    with ``seed``, drawn in float32 and cast to ``dtype`` (the JAX
    package's initialisers; the numbers differ from ``jax.random``'s)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return sch.init(model_schema(cfg), gen, device, dtype)


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


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               dtype=torch.float32):
    """Zeroed decode cache in ``dtype``; the SSM ``state`` is float32
    whatever ``dtype`` is, as in the reference."""
    return _map_cache(
        lambda name, shp: torch.zeros(shp, dtype=_cache_dtype(name, dtype),
                                      device=device),
        _cache_shapes(cfg, batch, max_seq))


def _cache_dtype(name: str, dtype):
    # SSM recurrent states stay float32 for numerical fidelity
    return torch.float32 if name == "state" else dtype


def _map_cache(fn, shapes):
    """``fn(name, shape)`` over a tree of cache shapes."""
    return {part: {key: {name: fn(name, shp) for name, shp in layer.items()}
                   for key, layer in layers.items()}
            for part, layers in shapes.items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16):
    """Meta-tensor decode cache, bf16 by default as the reference's; the
    SSM ``state`` is float32 whatever ``dtype`` is."""
    return _map_cache(
        lambda name, shp: torch.empty(shp, dtype=_cache_dtype(name, dtype),
                                      device="meta"),
        _cache_shapes(cfg, batch, max_seq))


_CACHE_AXES = {
    "k": ("cache_batch", "cache_seq", "kv_heads_cache", None),
    "v": ("cache_batch", "cache_seq", "kv_heads_cache", None),
    "c_kv": ("cache_batch", "cache_seq", None),
    "k_rope": ("cache_batch", "cache_seq", None),
    "state": ("cache_batch", "ssm_heads_cache", None, None),
    "conv": ("cache_batch", None, "ssm_inner_cache"),
}


def cache_partition_specs(cfg: ModelConfig, batch: int, max_seq: int,
                          rules: Dict[str, Any]):
    def spec(name, shp):
        axes = _CACHE_AXES[name]
        entries = [rules.get(a) if a else None for a in axes]
        if len(shp) == len(axes) + 1:      # stacked over the blocks
            entries = [None] + entries
        return PartitionSpec(*entries)

    return _map_cache(spec, _cache_shapes(cfg, batch, max_seq))


def _write_back(dst: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
    """Store a layer's new cache in the cache storage ``dst`` (attention
    caches were already updated in place)."""
    for name, t in new.items():
        if t is not dst[name]:
            dst[name].copy_(t)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------
def _apply_layer(cfg: ModelConfig, kind: str, params, x, *, positions, ctx,
                 cache, cache_index, moe_groups, act_constraint=None):
    """One layer: (x, its new cache or None, its aux loss or None)."""
    window = cfg.sliding_window if kind == LOCAL else None
    c = cache if cache else None

    if kind in (SSM, SSM_FFN):
        h, new_c = ssm_mod.ssm_apply(cfg, params["ssm"],
                                     rmsnorm(params["ln"], x, cfg.norm_eps),
                                     cache=c, cache_index=cache_index)
        x = x + h
        if kind == SSM_FFN:
            x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
        return x, new_c, None

    # attention-bearing kinds
    h_in = rmsnorm(params["ln"], x, cfg.norm_eps)
    if cfg.mla:
        h, new_c = attn_mod.mla_attention(cfg, params["attn"], h_in,
                                          positions, cache=c,
                                          cache_index=cache_index)
    else:
        h, new_c = attn_mod.self_attention(cfg, params["attn"], h_in,
                                           positions, window=window, cache=c,
                                           cache_index=cache_index)
    x = x + h

    aux = None
    if kind == CROSS:
        x = x + attn_mod.cross_attention(
            cfg, params["xattn"], rmsnorm(params["ln2"], x, cfg.norm_eps),
            ctx)
        x = x + mlp(params["mlp"], rmsnorm(params["ln3"], x, cfg.norm_eps))
    elif kind == MOE:
        h, aux = moe_mod.moe_apply(cfg, params["moe"],
                                   rmsnorm(params["ln2"], x, cfg.norm_eps),
                                   constrain=act_constraint,
                                   groups=moe_groups)
        x = x + h
    else:
        x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, new_c, aux


def _apply_layers(cfg: ModelConfig, kinds, layer_params, x, cache, aux,
                  shared_params=None, **kw):
    """Layers ``kinds`` (prefix, suffix or one block unit) in order, writing
    their caches back; returns x and ``aux`` plus their aux losses."""
    for i, kind in enumerate(kinds):
        p = shared_params if kind == SHARED_ATTN else layer_params[str(i)]
        c = cache[str(i)] if cache is not None else None
        x, nc, a = _apply_layer(cfg, kind, p, x, cache=c, **kw)
        if nc is not None:
            _write_back(c, nc)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,                # (b, s) integer
    *,
    ctx_embed: Optional[torch.Tensor] = None,   # (b, n_ctx, ctx_dim)
    cache: Optional[dict] = None,
    cache_index=None,                    # int, 0-d or (b,)
    positions: Optional[torch.Tensor] = None,
    moe_groups: Tuple[int, int] = (1, 1),
    last_token_only: bool = False,       # unembed only the final position
    remat: bool = False,                 # recompute each block unit backward
    act_constraint=None,                 # fn(x, kind) -> x: sharding hook
    block_param_constraint=None,         # fn(block_params) -> block_params
    dtype=torch.float32,                 # the compute dtype
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (logits (b,s,V) float32, cache updated in place or None,
    the MoE layers' summed aux load-balance loss, float32 0-d)."""
    dev = tokens.device
    b, s = tokens.shape
    x = embed(params["embed"], tokens, dtype)
    if cfg.scale_embed:
        # the reference's scale is a constant of the compute dtype
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=dev)

    if cache_index is None:
        cache_index = 0
    cache_index = torch.as_tensor(cache_index, device=dev).long()
    if positions is None:
        base = cache_index[:, None] if cache_index.dim() == 1 else cache_index
        positions = (base + torch.arange(s, device=dev)[None, :]).expand(b, s)

    ctx = None
    if cfg.num_ctx_tokens:
        if ctx_embed is None:
            raise ValueError(f"{cfg.name} requires ctx_embed (frontend stub)")
        ctx = ctx_embed.to(dtype) @ params["ctx_proj"].to(dtype)

    aux = torch.zeros((), device=dev)
    kw = dict(positions=positions, ctx=ctx, cache_index=cache_index,
              moe_groups=moe_groups, act_constraint=act_constraint)
    if cfg.prefix_layers:
        x, aux = _apply_layers(cfg, cfg.prefix_layers, params["prefix"], x,
                               cache["prefix"] if cache is not None else None,
                               aux, **kw)

    shared = params.get("shared")

    def unit(x, aux, bp, bc):
        x, aux = _apply_layers(cfg, cfg.block_pattern, bp, x, bc, aux,
                               shared_params=shared, **kw)
        if act_constraint is not None:
            x = act_constraint(x, "residual")
        return x, aux

    for i in range(cfg.num_blocks):
        bp = sch.tree_map(lambda t: t[i], params["blocks"])
        if block_param_constraint is not None:
            bp = block_param_constraint(bp)
        bc = (sch.tree_map(lambda t: t[i], cache["blocks"])
              if cache is not None else None)
        if remat:
            x, aux = checkpoint(unit, x, aux, bp, bc, use_reentrant=False)
        else:
            x, aux = unit(x, aux, bp, bc)

    if cfg.suffix_layers:
        x, aux = _apply_layers(cfg, cfg.suffix_layers, params["suffix"], x,
                               cache["suffix"] if cache is not None else None,
                               aux, **kw)

    if last_token_only:
        x = x[:, -1:]                    # prefill: only the next-token logits
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x, cap=cfg.logit_softcap)
    return logits, cache, aux


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True, moe_groups: Tuple[int, int] = (1, 1),
            act_constraint=None, block_param_constraint=None,
            dtype=torch.float32
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy of ``batch`` (``tokens``, ``labels`` (b, s),
    optional ``ctx_embed``): the mean NLL over the positions with
    ``labels >= 0`` (log-softmax in float32), plus ``router_aux_loss``
    times the MoE aux loss.  Returns (total, {"ce", "aux"})."""
    logits, _, aux = forward(cfg, params, batch["tokens"],
                             ctx_embed=batch.get("ctx_embed"), remat=remat,
                             moe_groups=moe_groups,
                             act_constraint=act_constraint,
                             block_param_constraint=block_param_constraint,
                             dtype=dtype)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = ce + cfg.router_aux_loss * aux
    return total, {"ce": ce, "aux": aux}


def decode_step(cfg: ModelConfig, params, tokens, cache, cache_index, *,
                ctx_embed=None, moe_groups=(1, 1), act_constraint=None,
                dtype=torch.float32):
    """One serving decode step: (b,1) token + cache -> logits, cache."""
    logits, cache, _ = forward(cfg, params, tokens, ctx_embed=ctx_embed,
                               cache=cache, cache_index=cache_index,
                               moe_groups=moe_groups,
                               act_constraint=act_constraint, dtype=dtype)
    return logits, cache


def prefill(cfg: ModelConfig, params, tokens, cache, *, ctx_embed=None,
            moe_groups=(1, 1), act_constraint=None, dtype=torch.float32):
    """Prefill a fresh cache with a full prompt; returns last-token logits
    and the cache."""
    logits, cache, _ = forward(cfg, params, tokens, ctx_embed=ctx_embed,
                               cache=cache, cache_index=0,
                               moe_groups=moe_groups, last_token_only=True,
                               act_constraint=act_constraint, dtype=dtype)
    return logits[:, -1], cache
