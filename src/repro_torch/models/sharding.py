"""Logical-axis -> mesh-axis sharding rules (port of
``repro.models.sharding``, MaxText-style).

Parameters carry *logical* axis names (see ``repro_torch.models.schema``);
a rules dict maps each logical axis to a mesh axis (or tuple of axes, or
None).  The defaults are the reference's FSDP(+pod) x tensor parallelism
for its TPU pod:

  * weight ``embed`` dims shard over the fsdp axes ("data", and "pod" when
    multi-pod) -- ZeRO-3 style;
  * weight ``ffn`` / ``q_dim`` / ``kv_dim`` / ``vocab`` / ``experts`` /
    ``ssm_inner`` dims shard over "model" -- tensor/expert parallelism;
  * activations: batch over (pod, data); sequence over "model" between
    layer boundaries for train/prefill; decode shards the KV-cache sequence
    dim over "model" instead (flash-decode style).

The port runs on one card (``launch.mesh.make_host_mesh``: a 1 x 1 mesh),
where a spec describes a layout and places nothing: the rules and specs
are kept, equal to the reference's, for the dry run and for a multi-card
port to start from.  :class:`PartitionSpec` is the port's own, a tuple with
no JAX in it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.configs.base import ShapeConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis, a tuple of axes, or None.
    Entries are normalised as ``jax.sharding.PartitionSpec`` normalises
    them: a one-axis tuple becomes its axis, an empty tuple None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def default_rules(
    shape: ShapeConfig,
    *,
    multi_pod: bool = False,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    fsdp = ("pod", "data") if multi_pod else ("data",)
    batch = ("pod", "data") if multi_pod else ("data",)

    rules: Dict[str, Any] = {
        # ---- weights ----
        "embed": fsdp,
        "ffn": "model",
        "q_dim": "model",
        "kv_dim": "model",
        "vocab": "model",
        "experts": "model",
        "experts_router": None,
        "expert_ff": None,
        "lora": None,
        "rope": None,
        "ssm_inner": "model",
        "ssm_heads": None,
        "ssm_state": None,
        "conv": None,
        "ctx": None,
        "null": None,
        "layers": None,
        # ---- activations ----
        "act_batch": batch,
        "act_seq": "model" if shape.mode in ("train", "prefill") else None,
        "act_embed": None,
        # ---- caches ----
        "cache_batch": batch,
        "cache_seq": "model" if shape.mode == "decode" else None,
        "kv_heads_cache": None,
        "ssm_heads_cache": "model",
        "ssm_inner_cache": "model",
    }
    # the reference's per-mode defaults, measured on its TPU pod
    if shape.mode == "train" and not multi_pod:
        # pure FSDP / ZeRO-3: batch over all chips, full sequence per chip
        # (a multi-pod batch of 256 does not divide 512 chips)
        if shape.global_batch % 256 == 0:
            rules["act_batch"] = ("data", "model")
            rules["act_seq"] = None
    if shape.mode == "decode":
        # decode keeps weights resident: the residual d_model over "data"
        rules["act_batch"] = None
        rules["act_embed"] = "data"
    if shape.mode == "decode" and shape.global_batch == 1:
        # long-context decode: the cache sequence over both axes
        rules["cache_batch"] = None
        rules["cache_seq"] = (fsdp[-1], "model") if not multi_pod else \
            ("data", "model")
        rules["ssm_heads_cache"] = "model"
    if overrides:
        rules.update(overrides)
    return rules


def activation_spec(rules: Dict[str, Any]) -> PartitionSpec:
    """Residual-stream layout (batch, seq, embed)."""
    return PartitionSpec(rules.get("act_batch"), rules.get("act_seq"),
                         rules.get("act_embed"))


def token_spec(rules: Dict[str, Any]) -> PartitionSpec:
    return PartitionSpec(rules.get("act_batch"), rules.get("act_seq"))


def ctx_spec(rules: Dict[str, Any]) -> PartitionSpec:
    return PartitionSpec(rules.get("act_batch"), None, None)


def logits_spec(rules: Dict[str, Any]) -> PartitionSpec:
    return PartitionSpec(rules.get("act_batch"), rules.get("act_seq"),
                         "model")
