"""Step functions for one (arch, shape), port of the train branch of
``repro.launch.specs``.

The reference builds each step with its shardings for a TPU mesh and
computes in bfloat16 (``specs.COMPUTE_DTYPE``).  Here a step runs on one
card, in float32, with no shardings; the prefill and decode steps, the
abstract inputs (``input_specs``) and the sharding specs belong to the
TPU-pod tooling (M12) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.training import train_loop
from repro_torch.training.optimizer import AdamW, tree_map


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


def make_step(cfg: ModelConfig, shape: ShapeConfig, *, lr: float = 1e-4,
              remat: bool = True, microbatch: int = 1) -> Callable:
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on one card, AdamW at ``lr``.

    With ``microbatch`` K > 1 dividing the global batch, the gradients of
    K microbatches are accumulated in float32 as ``grad / K`` (and the loss
    as ``loss / K``) before one update; the metrics are then the
    reference's ``{"loss": total, "ce": total, "aux": 0}``.  Otherwise
    ``{"loss": total, "ce", "aux"}``."""
    if shape.mode != "train":
        raise NotImplementedError(
            f"make_step: the {shape.mode} step is part of the TPU-pod "
            "tooling (M12), not yet ported")
    opt = AdamW(lr=lr)
    b = shape.global_batch

    def grads_of(params, batch):
        return train_loop.llm_grads(cfg, params, batch, remat=remat)

    if microbatch > 1 and b % microbatch == 0:
        mb = b // microbatch

        def train_step(params, opt_state, batch):
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            total = torch.zeros((), dtype=torch.float32,
                                device=batch["tokens"].device)
            for j in range(microbatch):
                mbatch = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
                (loss, _), grads = grads_of(params, mbatch)
                acc = tree_map(lambda a, g: a + g.float() / microbatch, acc,
                               grads)
                total = total + loss / microbatch
            new_params, new_opt = opt.update(acc, opt_state, params)
            return new_params, new_opt, {"loss": total, "ce": total,
                                         "aux": torch.zeros_like(total)}
    else:
        def train_step(params, opt_state, batch):
            (total, parts), grads = grads_of(params, batch)
            new_params, new_opt = opt.update(grads, opt_state, params)
            return new_params, new_opt, {"loss": total, **parts}

    return train_step
