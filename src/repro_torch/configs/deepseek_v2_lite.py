"""DeepSeek-V2-Lite (16B) — MLA (kv_lora=512) + MoE (64 routed top-6,
2 shared). [arXiv:2405.04434]

Assignment header says "MoE 64e top-6"; the bracket note "160 routed" is the
V2-full figure — V2-Lite has 64 routed experts (model card), which we use.
First layer is a dense-FFN layer (first_k_dense_replace=1).
"""
from repro_torch.configs.base import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,              # nope head dim; +rope_head_dim decoupled dims
    d_ff=1408,                 # spec value (expert hidden; used for the dense prefix too)
    vocab_size=102400,
    prefix_layers=(ATTN,),
    block_pattern=(MOE,),
    num_experts=64,
    num_experts_per_tok=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    router_aux_loss=0.001,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    source="arXiv:2405.04434",
)
