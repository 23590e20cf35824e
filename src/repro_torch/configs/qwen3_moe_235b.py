"""Qwen3-MoE-235B-A22B — 128 experts, top-8 routing, GQA.
[hf:Qwen/Qwen3-30B-A3B family card]"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert hidden (spec)
    vocab_size=151936,
    block_pattern=(MOE,),
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    router_aux_loss=0.001,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B (Qwen3-MoE family)",
)
