"""StarCoder2-7B — dense GQA decoder, RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    block_pattern=(ATTN,),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    sliding_window=4096,       # StarCoder2 ships a 4k sliding window option
    source="arXiv:2402.19173",
)
