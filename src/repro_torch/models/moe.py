"""Mixture-of-Experts FFN with top-k routing and grouped, capacity-bounded
dispatch (port of ``repro.models.moe``: GShard-style groups,
Megablocks-style sort-based slotting).

Tokens are partitioned into ``groups``; routing, position assignment and
the dispatch scatter are local to a group, and each group has its own
capacity, so the grouping decides which tokens drop.  The JAX package
aligns the groups with its mesh's activation sharding; on one card they
are a layout only, and the sharding hook ``constrain(x, kind)`` is called
where the reference calls it, on tensors of the reference's shapes.

Ties keep the reference's order: the top k come from a stable descending
sort (``jax.lax.top_k`` puts the lower expert first among equal
probabilities), and slots from a stable argsort.  A token past its
expert's capacity is dropped: its slot is the extra row ``e * cap`` of
the dispatch buffer, which is cut off before the experts run.  The three
expert products are plain batched matmuls, as they are plain einsums
outside any Pallas kernel in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp, mlp_schema, silu
from repro_torch.models.schema import Leaf


def moe_schema(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s = {
        "router": Leaf((d, e), ("embed", "experts_router"), "fan_in"),
        "wi_gate": Leaf((e, d, f), ("experts", "embed", "expert_ff"), "fan_in"),
        "wi_up": Leaf((e, d, f), ("experts", "embed", "expert_ff"), "fan_in"),
        "wo": Leaf((e, f, d), ("experts", "expert_ff", "embed"), "fan_in"),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_schema(cfg, d_ff=cfg.num_shared_experts * f)
    return s


def capacity(cfg: ModelConfig, num_tokens: int,
             capacity_factor: float = 1.25) -> int:
    c = math.ceil(num_tokens * cfg.num_experts_per_tok * capacity_factor
                  / cfg.num_experts)
    return max(c, 1)


def _positions_in_expert(flat_ids: torch.Tensor, e: int) -> torch.Tensor:
    """Stable-sort position of each assignment within its expert, per group:
    flat_ids (..., m) expert ids -> (..., m) positions."""
    m = flat_ids.shape[-1]
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    counts = torch.zeros(flat_ids.shape[:-1] + (e,), dtype=torch.long,
                         device=flat_ids.device).scatter_add_(
        -1, flat_ids, torch.ones_like(flat_ids))
    starts = counts.cumsum(-1) - counts
    sorted_ids = flat_ids.gather(-1, order)
    pos_sorted = (torch.arange(m, device=flat_ids.device)
                  - starts.gather(-1, sorted_ids))
    # order is a permutation: every position is written exactly once
    return torch.empty_like(flat_ids).scatter_(-1, order, pos_sorted)


def group_split(b: int, s: int, groups: Tuple[int, int]) -> Tuple[int, int]:
    """The (batch, sequence) split of b x s tokens into ``groups``: a split
    that does not divide its axis is dropped."""
    return (groups[0] if b % groups[0] == 0 else 1,
            groups[1] if s % groups[1] == 0 else 1)


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor,
          cap: int):
    """Top-k routing of grouped tokens xg (g, n, d) at ``cap`` tokens an
    expert and group: (probs (g, n, e), gate (g, n, k) renormalised over
    the k, expert_ids (g, n, k) in rank order, slot (g, n k): expert * cap
    + its position there, or e * cap where the assignment is dropped)."""
    g, n, _ = xg.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    router_logits = (xg @ router).float()                        # (g, n, e)
    probs = torch.softmax(router_logits, dim=-1)
    gate, expert_ids = probs.sort(dim=-1, descending=True, stable=True)
    gate, expert_ids = gate[..., :k], expert_ids[..., :k]        # (g, n, k)
    gate = gate / gate.sum(-1, keepdim=True)                     # qwen3 norm

    flat_ids = expert_ids.reshape(g, n * k)
    pos = _positions_in_expert(flat_ids, e)
    slot = torch.where(pos < cap, flat_ids * cap + pos,
                       torch.full_like(pos, e * cap))            # drop tail
    return probs, gate, expert_ids, slot


def moe_apply(cfg: ModelConfig, params, x: torch.Tensor, *,
              capacity_factor: Optional[float] = None,
              constrain=None,      # fn(x, kind) -> x: sharding hook
              groups: Tuple[int, int] = (1, 1)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y (b, s, d), aux load-balance loss)."""
    def cn(t, kind):
        return constrain(t, kind) if constrain is not None else t

    b, s, d = x.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    gd, gm = group_split(b, s, groups)
    g = gd * gm
    n_loc = (b // gd) * (s // gm)
    cf = capacity_factor or cfg.moe_capacity_factor
    cap = capacity(cfg, n_loc, cf)       # per-group capacity

    # ---- group tokens as the reference's (batch, seq) sharding does ----
    xg = x.reshape(gd, b // gd, gm, s // gm, d)
    xg = xg.permute(0, 2, 1, 3, 4).reshape(g, n_loc, d)
    xg = cn(xg, "moe_tokens")

    probs, gate, expert_ids, slot = route(cfg, params["router"], xg, cap)

    # ---- dispatch: slots are distinct except the drop row, cut off ----
    x_rep = xg.repeat_interleave(k, dim=1)                       # (g, n*k, d)
    buf = x.new_zeros((g, e * cap + 1, d))
    rows = torch.arange(g, device=x.device)[:, None]
    buf[rows, slot] = x_rep
    buf = cn(buf[:, :e * cap], "moe_buffer")
    xe = buf.reshape(g, e, cap, d).transpose(0, 1)
    xe = cn(xe.reshape(e, g * cap, d), "expert")

    h = (silu(torch.bmm(xe, params["wi_gate"]))
         * torch.bmm(xe, params["wi_up"]))
    h = cn(h, "expert_ff")
    ye = cn(torch.bmm(h, params["wo"]), "expert")

    # ---- combine: gather each assignment's expert row, sum over k ----
    yb = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    yb = cn(yb, "moe_buffer")
    safe = slot.clamp(max=e * cap - 1)
    gathered = yb.gather(1, safe[..., None].expand(g, n_loc * k, d))
    gathered = torch.where((slot < e * cap)[..., None], gathered,
                           gathered.new_zeros(()))
    yg = (gathered.reshape(g, n_loc, k, d)
          * gate.to(x.dtype)[..., None]).sum(dim=2)              # (g, n, d)

    y = yg.reshape(gd, gm, b // gd, s // gm, d).permute(0, 2, 1, 3, 4)
    y = y.reshape(b, s, d)

    if "shared" in params:
        y = y + mlp(params["shared"], x)

    # GShard load-balance auxiliary loss: E * sum_e f_e * P_e
    assign_frac = F.one_hot(expert_ids, e).float().mean(dim=(0, 1, 2))
    prob_mean = probs.mean(dim=(0, 1))
    aux = e * (assign_frac * prob_mean).sum()
    return y, aux
