"""Modality-frontend stubs (port of ``repro.models.stubs``).

The vision encoder (VLM) and the audio feature extractor are not
implemented, in the port as in the reference: a stub gives precomputed
patch / frame embeddings of the right shape, which the decoder's own
projector (``ctx_proj``) and cross-attention layers consume.

The reference's default key is ``PRNGKey(hash(cfg.name) % 2**31)``, which
changes with each process's string-hash seed; the port's default
generator is seeded from a CRC-32 of the name, the same in every process.
Neither matches the other's numbers: tests hand both packages the same
numpy-made embeddings.
"""
from __future__ import annotations

import zlib
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


def frontend_embeddings(cfg: ModelConfig, batch: int, *,
                        generator: Optional[torch.Generator] = None,
                        device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Pseudo patch / frame embeddings (batch, num_ctx_tokens, ctx_dim or
    d_model), unit normals from ``generator`` (on ``device``) cast to
    ``dtype`` and times 0.02, as the reference's."""
    if not cfg.num_ctx_tokens:
        raise ValueError(f"{cfg.name} has no modality frontend")
    d = cfg.ctx_dim or cfg.d_model
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            zlib.crc32(cfg.name.encode()))
    return torch.randn((batch, cfg.num_ctx_tokens, d), generator=generator,
                       device=device).to(dtype) * 0.02


def frontend_spec(cfg: ModelConfig, batch: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """The stub embeddings' shape as a meta tensor (the dry run's input),
    bf16 by default as the reference's."""
    d = cfg.ctx_dim or cfg.d_model
    return torch.empty((batch, cfg.num_ctx_tokens, d), dtype=dtype,
                       device="meta")
