"""MusicGen-medium — audio decoder-only over EnCodec tokens. [arXiv:2306.05284]

Each layer: self-attention + cross-attention (conditioning embeddings) + FFN.
The mel/conv/T5 conditioning frontend is a stub per assignment: ``input_specs``
provides precomputed conditioning-frame embeddings of shape
(batch, num_ctx_tokens, ctx_dim).
"""
from repro_torch.configs.base import CROSS, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=(CROSS,),
    num_ctx_tokens=256,
    ctx_dim=768,               # T5-style conditioning dim, projected in-model
    rope_theta=10000.0,
    source="arXiv:2306.05284",
)
