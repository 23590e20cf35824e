"""Model/architecture configuration (a copy of ``repro.configs.base``).

One ``ModelConfig`` describes a decoder backbone (dense / MoE / SSM / hybrid /
VLM / audio).  The generic stack in ``repro_torch.models.transformer``
consumes it.  Layer heterogeneity (gemma2 local/global alternation, zamba2
shared-attention interleave, llama-vision cross-attention layers, deepseek
first-dense-then-MoE) is expressed with a *block pattern*: the full layer stack
is ``prefix_layers + num_blocks * block_pattern + suffix_layers`` and the
pattern repeats with stacked parameters (a leading ``num_blocks`` dim).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds usable in block patterns.
ATTN = "attn"          # self attention (full, causal) + FFN
LOCAL = "local"        # sliding-window self attention + FFN
SLIDING = "local"      # alias
SSM = "ssm"            # Mamba2 SSD mixer (no FFN; d_ff==0 families)
SSM_FFN = "ssm_ffn"    # Mamba2 mixer + FFN (hybrid families)
MOE = "moe"            # self attention + MoE FFN
CROSS = "cross"        # cross-attention (images/audio ctx) + FFN
SHARED_ATTN = "shared_attn"  # zamba2-style shared-weight attention block

LAYER_KINDS = (ATTN, LOCAL, SSM, SSM_FFN, MOE, CROSS, SHARED_ATTN)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # ---- layer stacking -------------------------------------------------
    block_pattern: Tuple[str, ...] = (ATTN,)
    num_blocks: int = 0            # 0 -> derived: num_layers // len(block_pattern)
    prefix_layers: Tuple[str, ...] = ()
    suffix_layers: Tuple[str, ...] = ()

    # ---- attention ------------------------------------------------------
    attn_variant: str = "full"     # full | sliding | local_global
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None        # final-logit softcap (gemma2)
    attn_logit_softcap: Optional[float] = None   # attention softcap (gemma2)

    # ---- MoE --------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0              # per-expert hidden size
    num_shared_experts: int = 0    # deepseek shared experts
    router_aux_loss: float = 0.0   # load-balance aux loss coefficient
    moe_capacity_factor: float = 1.25

    # ---- MLA (deepseek) ---------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64        # decoupled RoPE dims in MLA

    # ---- SSM (mamba2 / zamba2) ---------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0             # 0 -> derived from d_inner / ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256           # SSD chunk length
    conv_kernel: int = 4

    # ---- multimodal context (vlm / audio) -----------------------------------
    num_ctx_tokens: int = 0        # image-patch / audio-frame embeddings
    ctx_dim: int = 0               # frontend embedding dim (0 -> d_model)

    # ---- misc ----------------------------------------------------------------
    scale_embed: bool = False      # multiply embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""               # citation

    # ------------------------------------------------------------------
    def __post_init__(self):
        for k in self.block_pattern + self.prefix_layers + self.suffix_layers:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")
        nb = self.num_blocks or (
            (self.num_layers - len(self.prefix_layers) - len(self.suffix_layers))
            // len(self.block_pattern))
        object.__setattr__(self, "num_blocks", nb)
        total = (len(self.prefix_layers) + nb * len(self.block_pattern)
                 + len(self.suffix_layers))
        if total != self.num_layers:
            raise ValueError(
                f"{self.name}: pattern covers {total} layers, expected "
                f"{self.num_layers}")

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the embedding/logits
        shard evenly over a 16-way model axis (mamba2's 50280 -> 50304).
        Logits carry the padded size; labels always index < vocab_size."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def uses_ssm(self) -> bool:
        kinds = self.block_pattern + self.prefix_layers + self.suffix_layers
        return SSM in kinds or SSM_FFN in kinds

    @property
    def uses_attention(self) -> bool:
        kinds = set(self.block_pattern + self.prefix_layers + self.suffix_layers)
        return bool(kinds & {ATTN, LOCAL, MOE, CROSS, SHARED_ATTN})

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer does full-seq quadratic attention."""
        kinds = set(self.block_pattern + self.prefix_layers + self.suffix_layers)
        quad = kinds & {ATTN, MOE, CROSS, SHARED_ATTN}
        return not quad

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        counts = {}
        emb = self.vocab_size * self.d_model
        total = emb if self.tie_embeddings else 2 * emb
        kinds = (list(self.prefix_layers)
                 + list(self.block_pattern) * self.num_blocks
                 + list(self.suffix_layers))
        d, hd = self.d_model, self.head_dim
        q_dim = self.num_heads * hd
        kv_dim = self.num_kv_heads * hd
        if self.mla:
            attn_p = (d * self.q_lora_rank + self.q_lora_rank * self.num_heads
                      * (hd + self.rope_head_dim)
                      + d * (self.kv_lora_rank + self.rope_head_dim)
                      + self.kv_lora_rank * self.num_heads * 2 * hd
                      + q_dim * d)
        else:
            attn_p = d * (q_dim + 2 * kv_dim) + q_dim * d
        ffn_p = 3 * d * self.d_ff
        moe_p = (d * self.num_experts
                 + self.num_experts * 3 * d * self.moe_d_ff
                 + self.num_shared_experts * 3 * d * self.moe_d_ff)
        di = self.d_inner
        # Mamba2 in_proj: z, x (2*di), B, C (shared across heads, n_groups=1),
        # dt (n_heads); conv over (x, B, C); out_proj.
        ssm_p = (d * (2 * di + 2 * self.ssm_state + self.n_ssm_heads)
                 + di * d + self.conv_kernel * (di + 2 * self.ssm_state))
        shared_counted = False
        for k in kinds:
            if k == ATTN or k == LOCAL:
                total += attn_p + ffn_p
            elif k == MOE:
                total += attn_p + moe_p
            elif k == CROSS:
                total += 2 * attn_p + ffn_p
            elif k == SSM:
                total += ssm_p
            elif k == SSM_FFN:
                total += ssm_p + ffn_p
            elif k == SHARED_ATTN:
                if not shared_counted:       # weights shared across uses
                    total += attn_p + ffn_p
                    shared_counted = True
        return int(total)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE top-k routing)."""
        if not self.num_experts:
            return self.param_count()
        dense_like = dataclasses.replace(
            self, num_experts=0, num_experts_per_tok=0)
        # careful: replace() recomputes num_blocks; keep same structure
        total = self.param_count()
        kinds = (list(self.prefix_layers)
                 + list(self.block_pattern) * self.num_blocks
                 + list(self.suffix_layers))
        n_moe = sum(1 for k in kinds if k == MOE)
        d = self.d_model
        all_exp = self.num_experts * 3 * d * self.moe_d_ff
        act_exp = self.num_experts_per_tok * 3 * d * self.moe_d_ff
        return int(total - n_moe * (all_exp - act_exp))

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        changes = dict(
            name=self.name + "-smoke",
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            rope_head_dim=32 if self.mla else self.rope_head_dim,
            kv_lora_rank=64 if self.mla else 0,
            q_lora_rank=64 if self.q_lora_rank else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2)
            if self.num_experts_per_tok else 0,
            num_shared_experts=min(self.num_shared_experts, 1)
            if self.num_shared_experts else 0,
            # drop-free capacity (cf >= E/k) so smoke tests are exact
            moe_capacity_factor=4.0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.uses_ssm else self.ssm_head_dim,
            ssm_chunk=32 if self.uses_ssm else self.ssm_chunk,
            sliding_window=64,
            num_ctx_tokens=8 if self.num_ctx_tokens else 0,
            ctx_dim=min(self.ctx_dim, 128) if self.ctx_dim else 0,
        )
        # >=2 layers total, but keep the smoke variant tiny for long patterns
        nb = 1 if len(self.block_pattern) > 2 else 2
        changes["num_layers"] = (len(self.prefix_layers)
                                 + nb * len(self.block_pattern)
                                 + len(self.suffix_layers))
        changes["num_blocks"] = nb
        changes.update(overrides)
        if changes.get("ssm_heads") is None:
            changes["ssm_heads"] = 0
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
