"""Gemma2-9B — local/global alternating attention, logit softcaps.
[arXiv:2408.00118]"""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=(LOCAL, ATTN),   # alternate sliding-window / global
    attn_variant="local_global",
    sliding_window=4096,
    logit_softcap=30.0,
    attn_logit_softcap=50.0,
    scale_embed=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
