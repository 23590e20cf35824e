"""Llama-3.2-Vision-90B — dense GQA decoder with cross-attention image
layers. [hf:meta-llama/Llama-3.2-11B-Vision]

100 layers = 20 x (4 self-attention + 1 cross-attention).  The ViT vision
encoder + its pre-projector output is a stub per assignment: ``input_specs``
provides patch embeddings (batch, num_ctx_tokens, ctx_dim=1280); the in-model
projector maps them to d_model.
"""
from repro_torch.configs.base import ATTN, CROSS, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
    num_ctx_tokens=1600,       # image patch tokens
    ctx_dim=1280,              # ViT-H patch embedding dim (pre-projector)
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
