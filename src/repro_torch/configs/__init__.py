"""Architecture registry: ``--arch <id>`` resolution for every entry point."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig  # noqa: F401
from repro_torch.configs import vpaas_video  # noqa: F401

from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen15_110b
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7b
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.qwen3_moe_235b import CONFIG as _qwen3moe
from repro_torch.configs.deepseek_v2_lite import CONFIG as _dsv2lite
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.llama3_2_vision_90b import CONFIG as _llama_vision

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        _qwen15_110b, _qwen2_7b, _musicgen, _starcoder2, _mamba2,
        _gemma2, _qwen3moe, _dsv2lite, _zamba2, _llama_vision,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def get_shape(name: str) -> ShapeConfig:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]
