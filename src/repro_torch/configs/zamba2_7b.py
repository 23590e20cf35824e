"""Zamba2-7B — hybrid: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

81 layers = 1 Mamba2 prefix + 10 x (7 Mamba2 + 1 shared-weight attention
block).  The attention block's weights are shared across all its occurrences
(Zamba2's parameter-sharing trick).
"""
from repro_torch.configs.base import SHARED_ATTN, SSM, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,              # 3584 / 32
    d_ff=14336,
    vocab_size=32000,
    prefix_layers=(SSM,),
    block_pattern=(SSM,) * 7 + (SHARED_ATTN,),
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_kernel=4,
    source="arXiv:2411.15242",
)
