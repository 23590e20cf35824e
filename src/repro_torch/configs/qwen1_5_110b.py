"""Qwen1.5-110B — dense GQA decoder. [hf:Qwen/Qwen1.5-0.5B family card]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B (Qwen1.5 family; 110B scale-up)",
)
