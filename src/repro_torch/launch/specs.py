"""input_specs(): meta-tensor stand-ins for every model input, plus the step
functions and their partition specs for each (arch x shape) (port of
``repro.launch.specs``).

Everything ``input_specs`` and ``make_step``'s abstract arguments hold is
allocation-free: meta tensors of the real shapes.  The dry run
(``launch.dryrun``) counts a step on them; the launchers and the dry run's
card pass call the same step functions with real tensors.

The steps compute in ``COMPUTE_DTYPE``, bfloat16 as the reference's
(``COMPUTE_DTYPE = jnp.bfloat16``): bf16 parameters and caches (the SSM
state float32), the kernels K6, K7 and K8 on bf16 operands, float32 sums
and logits.  The reference runs on a TPU mesh, the port on one card: the
specs describe the reference's layouts and place nothing.  Everything
here reads ``COMPUTE_DTYPE`` when it is called, so a caller (a test) that
sets it to float32 gets float32 steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import sharding as shd
from repro_torch.models import stubs
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import PartitionSpec
from repro_torch.training import train_loop
from repro_torch.training.optimizer import AdamW, AdamWState, tree_map

COMPUTE_DTYPE = torch.bfloat16
# the port's index dtype for tokens and cache positions (the reference's
# are int32)
INDEX_DTYPE = torch.long


def arch_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Adapt an arch to a shape: long_500k needs a sub-quadratic variant.

    Dense/MoE/VLM/audio archs switch full-attention layers to sliding-window
    (window 8192); SSM/hybrid archs run unchanged, and gemma2's local layers
    already slide."""
    if shape.name != "long_500k" or cfg.sub_quadratic:
        return cfg

    def slide(kinds):
        return tuple("local" if k == "attn" else k for k in kinds)
    return dataclasses.replace(
        cfg, name=cfg.name + "+sliding",
        block_pattern=slide(cfg.block_pattern),
        prefix_layers=slide(cfg.prefix_layers),
        suffix_layers=slide(cfg.suffix_layers),
        sliding_window=8192, num_blocks=cfg.num_blocks)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                *, dtype=None) -> Dict[str, Any]:
    """Abstract model inputs for one (arch, shape), as meta tensors, the
    cache and the frontend context in ``dtype`` (default
    ``COMPUTE_DTYPE``)."""
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        specs = {"tokens": _meta((b, s), INDEX_DTYPE),
                 "labels": _meta((b, s), INDEX_DTYPE)}
    elif shape.mode == "prefill":
        specs = {"tokens": _meta((b, s), INDEX_DTYPE)}
    else:
        # decode: ONE new token + a cache of seq_len
        specs = {"tokens": _meta((b, 1), INDEX_DTYPE),
                 "cache": tfm.abstract_cache(cfg, b, s, dtype),
                 "cache_index": _meta((), INDEX_DTYPE)}
    if cfg.num_ctx_tokens:
        specs["ctx_embed"] = stubs.frontend_spec(cfg, b, dtype)
    return specs


def make_step(cfg: ModelConfig, shape: ShapeConfig,
              rules: Optional[Dict[str, Any]] = None,
              mesh: Optional[Mesh] = None, *, lr: float = 1e-4,
              remat: bool = True, microbatch: int = 1):
    """Returns ``(fn, abstract_args, in_specs, out_specs)``: the step for
    ``shape.mode``, its arguments as meta tensors, and the partition specs
    of its arguments and results under ``rules`` (default
    ``default_rules(shape)``) on ``mesh``, the one-card mesh (so the MoE
    groups, which the reference takes from the mesh's axis sizes, are
    (1, 1), and the reference's sharding constraints place nothing and are
    not passed).

    * train: ``(params, opt_state, batch) -> (params, opt_state,
      metrics)``, AdamW at ``lr``.  With ``microbatch`` K > 1 dividing the
      global batch, the gradients of K microbatches are accumulated in
      float32 as ``grad / K`` (and the loss as ``loss / K``) before one
      update; the metrics are then the reference's ``{"loss": total, "ce":
      total, "aux": 0}``.  Otherwise ``{"loss": total, "ce", "aux"}``.
    * prefill: ``(params, tokens[, ctx_embed]) -> (last-token logits (b,
      V), cache)``, into a zeroed cache (``init_cache``) on the tokens'
      device.
    * decode: ``(params, tokens (b, 1), cache, cache_index[, ctx_embed])
      -> (logits (b, 1, V), cache)``, the cache updated in place.

    Every step computes in ``COMPUTE_DTYPE`` (as read at this call), with
    parameters, caches and context in it: the reference's ``loss_fn`` /
    ``prefill`` / ``decode_step`` with ``dtype=COMPUTE_DTYPE``.
    """
    rules = shd.default_rules(shape) if rules is None else rules
    mesh = make_host_mesh() if mesh is None else mesh
    if mesh.size != 1:
        raise NotImplementedError(f"make_step: a mesh of {mesh.size} "
                                  "devices; the port runs on one card")
    b, s = shape.global_batch, shape.seq_len

    dtype = COMPUTE_DTYPE
    p_specs = tfm.param_partition_specs(cfg, rules)
    params_abs = tfm.abstract_params(cfg, dtype)
    tok_spec, ctx_spec = shd.token_spec(rules), shd.ctx_spec(rules)
    repl = PartitionSpec()
    specs = input_specs(cfg, shape, dtype=dtype)

    if shape.mode == "train":
        opt = AdamW(lr=lr)

        def grads_of(params, batch):
            return train_loop.llm_grads(cfg, params, batch, remat=remat,
                                        dtype=dtype)

        if microbatch > 1 and b % microbatch == 0:
            mb = b // microbatch

            def train_step(params, opt_state, batch):
                acc = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                total = torch.zeros((), dtype=torch.float32,
                                    device=batch["tokens"].device)
                for j in range(microbatch):
                    mbatch = {k: v[j * mb:(j + 1) * mb]
                              for k, v in batch.items()}
                    (loss, _), grads = grads_of(params, mbatch)
                    acc = tree_map(lambda a, g: a + g.float() / microbatch,
                                   acc, grads)
                    total = total + loss / microbatch
                new_params, new_opt = opt.update(acc, opt_state, params)
                return new_params, new_opt, {"loss": total, "ce": total,
                                             "aux": torch.zeros_like(total)}
        else:
            def train_step(params, opt_state, batch):
                (total, parts), grads = grads_of(params, batch)
                new_params, new_opt = opt.update(grads, opt_state, params)
                return new_params, new_opt, {"loss": total, **parts}

        opt_abs = AdamWState(
            _meta((), torch.int32),
            tree_map(lambda p: _meta(p.shape, torch.float32), params_abs),
            tree_map(lambda p: _meta(p.shape, torch.float32), params_abs))
        opt_specs = AdamWState(repl, p_specs, p_specs)
        batch_specs = {k: (ctx_spec if k == "ctx_embed" else tok_spec)
                       for k in specs}
        return (train_step, (params_abs, opt_abs, specs),
                (p_specs, opt_specs, batch_specs),
                (p_specs, opt_specs, repl))

    cache_specs = tfm.cache_partition_specs(cfg, b, s, rules)
    has_ctx = "ctx_embed" in specs

    if shape.mode == "prefill":
        def prefill_step(params, tokens, ctx_embed=None):
            with torch.no_grad():
                cache = tfm.init_cache(cfg, tokens.shape[0], s,
                                       tokens.device, dtype)
                return tfm.prefill(cfg, params, tokens, cache,
                                   ctx_embed=ctx_embed, dtype=dtype)

        args = (params_abs, specs["tokens"]) + (
            (specs["ctx_embed"],) if has_ctx else ())
        in_specs = (p_specs, tok_spec) + ((ctx_spec,) if has_ctx else ())
        out_specs = (PartitionSpec(rules.get("act_batch"), "model"),
                     cache_specs)
        return prefill_step, args, in_specs, out_specs

    def decode_step(params, tokens, cache, cache_index, ctx_embed=None):
        with torch.no_grad():
            return tfm.decode_step(cfg, params, tokens, cache, cache_index,
                                   ctx_embed=ctx_embed, dtype=dtype)

    args = (params_abs, specs["tokens"], specs["cache"],
            specs["cache_index"]) + ((specs["ctx_embed"],) if has_ctx else ())
    in_specs = (p_specs, tok_spec, cache_specs, repl) + (
        (ctx_spec,) if has_ctx else ())
    out_specs = (PartitionSpec(rules.get("act_batch"), None, "model"),
                 cache_specs)
    return decode_step, args, in_specs, out_specs
