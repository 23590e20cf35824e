"""The port's MoE layer (``repro_torch.models.moe``) on the CPU against the
JAX package's ``repro.models.moe``: the same numpy-made weights and inputs
through ``moe_apply`` give the same output and aux loss, with and without
capacity drops, one and four groups, shared experts on and off; the slot
assignment and the top-k tie order equal the reference's exactly; and the
invariants of tests/test_moe.py hold in the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models import schema as sch
from repro_torch.testing import MOE_RTOL, rel_err

torch.set_num_threads(1)

QWEN, DEEPSEEK = "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"


def _weights(cfg, seed):
    """numpy weights for ``cfg``'s MoE schema: each leaf unit normal over
    the square root of its fan-in, as the schema's ``fan_in`` init."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        return (rng.normal(size=leaf.shape)
                / np.sqrt(leaf.shape[-2])).astype(np.float32)

    def walk(s):
        return draw(s) if isinstance(s, sch.Leaf) else {
            k: walk(v) for k, v in s.items()}
    return walk(tmoe.moe_schema(cfg))


def _both(name, seed=0):
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    w = _weights(tcfg, seed)
    return (jcfg, jax.tree.map(jnp.asarray, w), tcfg,
            sch.tree_map(torch.as_tensor, w))


def _x(cfg, b, s, seed):
    return (np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("name", [QWEN, DEEPSEEK], ids=["qwen3", "deepseek"])
@pytest.mark.parametrize("cf", [4.0, 1.25], ids=["drop-free", "drops"])
@pytest.mark.parametrize("groups", [(1, 1), (2, 2)], ids=["g1", "g4"])
def test_moe_apply_matches_jax(name, cf, groups):
    # qwen3-smoke has no shared expert, deepseek-smoke one; 1.25 is the
    # full-width factor, so tokens drop
    jcfg, jp, tcfg, tp = _both(name)
    x = _x(tcfg, 4, 16, 1)
    yj, auxj = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), capacity_factor=cf,
                              groups=groups)
    yt, auxt = tmoe.moe_apply(tcfg, tp, torch.as_tensor(x),
                              capacity_factor=cf, groups=groups)
    assert yt.shape == x.shape and auxt.shape == ()
    assert rel_err(yt.numpy(), np.asarray(yj)) <= MOE_RTOL
    assert abs(float(auxt) - float(auxj)) <= MOE_RTOL * float(auxj)
    assert ("shared" in tp) == (name == DEEPSEEK)


def test_full_width_factor_drops_tokens_at_the_smoke_widths():
    # what test_moe_apply_matches_jax[...-drops-...] exercises: some
    # assignment lies past its expert's capacity
    _, _, tcfg, tp = _both(QWEN)
    x = torch.as_tensor(_x(tcfg, 4, 16, 1))
    probs = torch.softmax(x.reshape(1, 64, -1) @ tp["router"], -1)
    ids = probs.sort(dim=-1, descending=True, stable=True)[1][..., :2]
    pos = tmoe._positions_in_expert(ids.reshape(1, -1), 4)
    assert int((pos >= tmoe.capacity(tcfg, 64, 1.25)).sum()) > 0
    assert int((pos >= tmoe.capacity(tcfg, 64, 4.0)).sum()) == 0


def test_positions_in_expert_equal_jax():
    ids = np.random.default_rng(3).integers(0, 5, 97).astype(np.int32)
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(ids), 5))
    got = tmoe._positions_in_expert(torch.as_tensor(ids, dtype=torch.long),
                                    5)
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch of groups is the groups one by one
    two = tmoe._positions_in_expert(
        torch.as_tensor(np.stack([ids, ids[::-1]]), dtype=torch.long), 5)
    np.testing.assert_array_equal(two[0].numpy(), want)
    np.testing.assert_array_equal(
        two[1].numpy(), np.asarray(jmoe._positions_in_expert(
            jnp.asarray(ids[::-1].copy()), 5)))


def test_tied_router_probabilities_pick_the_lower_expert_as_jax():
    # experts 1 and 2 get the same router column, so every token's two
    # probabilities tie exactly; jax.lax.top_k takes the lower index first,
    # and so must the port (torch.topk promises no order among ties)
    jcfg, jp, tcfg, tp = _both(QWEN, seed=4)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.as_tensor(router))
    x = _x(tcfg, 2, 8, 5)
    yj, auxj = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), capacity_factor=1.25)
    yt, auxt = tmoe.moe_apply(tcfg, tp, torch.as_tensor(x),
                              capacity_factor=1.25)
    assert rel_err(yt.numpy(), np.asarray(yj)) <= MOE_RTOL
    assert abs(float(auxt) - float(auxj)) <= MOE_RTOL * float(auxj)


def test_full_width_capacities():
    # deepseek-v2-lite at 1.25: a 384-token prefill keeps 45 assignments
    # an expert; a 4-slot decode step keeps 1, so slots share experts' room
    cfg = get_config(DEEPSEEK)
    assert tmoe.capacity(cfg, 384, 1.25) == 45
    assert tmoe.capacity(cfg, 4, 1.25) == 1
    assert tmoe.capacity(cfg, 1, 0.01) == 1


# ---------------------------------------------------------------------------
# tests/test_moe.py's invariants, in the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    _, _, cfg, params = _both(QWEN, seed=7)
    x = torch.as_tensor(_x(cfg, 4, 16, 8))
    return cfg, params, x


def test_grouped_dispatch_matches_ungrouped(setup):
    """With drop-free capacity the grouping is a pure layout change."""
    cfg, params, x = setup
    y1, aux1 = tmoe.moe_apply(cfg, params, x, groups=(1, 1))
    y2, aux2 = tmoe.moe_apply(cfg, params, x, groups=(2, 2))
    y4, _ = tmoe.moe_apply(cfg, params, x, groups=(4, 4))
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), atol=2e-5)
    np.testing.assert_allclose(y4.numpy(), y1.numpy(), atol=2e-5)
    assert abs(float(aux1 - aux2)) < 1e-5


def test_moe_matches_dense_loop(setup):
    """Drop-free MoE == explicit per-token top-k expert sum."""
    cfg, params, x = setup
    y, _ = tmoe.moe_apply(cfg, params, x)
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ params["router"], -1)
    gate, ids = probs.topk(cfg.num_experts_per_tok, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.num_experts_per_tok):
            e = int(ids[t, j])
            h = (F.silu(xf[t] @ params["wi_gate"][e])
                 * (xf[t] @ params["wi_up"][e]))
            want[t] += gate[t, j] * (h @ params["wo"][e])
    np.testing.assert_allclose(y.reshape(-1, d).numpy(), want.numpy(),
                               atol=3e-4)


def test_capacity_drops_tokens(setup):
    cfg, params, x = setup
    tight = dataclasses.replace(cfg, moe_capacity_factor=0.25)
    y_tight, _ = tmoe.moe_apply(tight, params, x)
    y_free, _ = tmoe.moe_apply(cfg, params, x)
    assert not np.allclose(y_tight.numpy(), y_free.numpy())
    assert bool(torch.isfinite(y_tight).all())


def test_aux_loss_favors_balance(setup):
    cfg, params, x = setup
    _, aux = tmoe.moe_apply(cfg, params, x)
    # a perfectly balanced router gives aux == 1; random weights are close
    assert 0.5 < float(aux) < 4.0


def test_shared_experts_add():
    _, _, cfg, params = _both(DEEPSEEK, seed=9)
    x = torch.as_tensor(_x(cfg, 2, 8, 10))
    y_with, _ = tmoe.moe_apply(cfg, params, x)
    params_no = {k: v for k, v in params.items() if k != "shared"}
    y_without, _ = tmoe.moe_apply(cfg, params_no, x)
    assert not np.allclose(y_with.numpy(), y_without.numpy())


def test_router_tap_finds_a_routing_tie():
    # the card-vs-CPU LLM checks exempt a row only where a router of its
    # call holds a near-tie: with experts 1 and 2 sharing a router column,
    # some token has them 2nd and 3rd, a margin of 0; the untied router's
    # smallest margin lies far above the tie
    from repro_torch.testing import ROUTER_TIE, RouterTap, router_margin
    _, _, cfg, tp = _both(QWEN, seed=4)
    x = torch.as_tensor(_x(cfg, 2, 8, 5))
    tied = dict(tp, router=tp["router"][:, [0, 1, 1, 3]])
    with RouterTap() as tap:
        tmoe.moe_apply(cfg, tp, x)
        tmoe.moe_apply(cfg, tied, x)
    assert tmoe.moe_apply is tap._orig               # restored
    assert len(tap.calls) == 2 and torch.equal(tap.calls[0][2], x)
    assert router_margin(tap.calls[:1]) > ROUTER_TIE
    assert router_margin(tap.calls[1:]) < ROUTER_TIE
    assert router_margin([]) == float("inf")


def _tie_calls(card_rows=None, card_cf=None):
    """Two RouterTap-style calls of one MoE layer: 4 experts, top 2, an
    identity router (a token's logits are its x), 8 tokens at capacity 4
    an expert.  The reference's token 1 has experts 1 and 2 at a near-tie
    (1.0 against 0.99); ``card_rows`` replaces rows of the other call's
    x, ``card_cf`` its capacity factor."""
    import types
    cfg = types.SimpleNamespace(num_experts=4, num_experts_per_tok=2,
                                moe_capacity_factor=1.0)
    x = torch.tensor([[3, 2, 0, -1], [3, 1.0, 0.99, -1], [2, 3, -1, -2],
                      [-1, 3, 2, -2], [-1, 3, -2, 2], [-1, -2, 3, 2],
                      [-1, -2, 2, 3], [0, -1, -2, 3]])[None]
    x_card = x.clone()
    for i, row in (card_rows or {}).items():
        x_card[0, i] = torch.tensor(row)
    kw_card = {} if card_cf is None else {"capacity_factor": card_cf}
    return cfg, (cfg, torch.eye(4), x, {}), (cfg, torch.eye(4), x_card,
                                             kw_card)


def test_moe_routing_is_the_layers_routing():
    # testing.moe_routing routes as moe.route does inside moe_apply: the
    # top k of the softmax in rank order, each expert's first `cap`
    # assignments of its group kept, the groups laid out as moe_apply's
    from repro_torch.testing import moe_routing
    _, _, cfg, tp = _both(DEEPSEEK)
    x = torch.as_tensor(_x(cfg, 4, 16, 1))
    logits, ids, kept = moe_routing(cfg, tp["router"], x, groups=(2, 2),
                                    capacity_factor=1.25)
    assert logits.shape == (4, 16, cfg.num_experts)
    xg = x.reshape(2, 2, 2, 8, -1).permute(0, 2, 1, 3, 4).reshape(4, 16, -1)
    assert torch.equal(logits, xg @ tp["router"])
    assert torch.equal(ids, torch.softmax(logits, -1).sort(
        dim=-1, descending=True, stable=True)[1][
            ..., :cfg.num_experts_per_tok])
    cap = tmoe.capacity(cfg, 16, 1.25)
    for g in range(4):
        for e in range(cfg.num_experts):
            hits = (ids[g] == e).reshape(-1)
            assert int(kept[g].reshape(-1)[hits].sum()) == min(
                int(hits.sum()), cap)
            assert bool(kept[g].reshape(-1)[hits].cummin(0)[0].eq(
                kept[g].reshape(-1)[hits]).all())     # the first cap kept
    assert not kept.all()                              # some drop


def test_route_exempt_counts_a_tie_and_the_drop_it_moves():
    # the card swaps token 1's near-tied experts: token 1 is a tie, and
    # expert 1, one assignment lighter, keeps token 4 (the reference drops
    # it at capacity 4): moved.  Only they are exempt
    from repro_torch.testing import route_exempt
    cfg, want, got = _tie_calls({1: [3, 0.99, 1.0, -1]})
    mask, counts = route_exempt(cfg, want, got)
    assert counts == {"ties": 1, "moved": 1, "near": 1}
    assert mask.shape == (1, 8)
    assert mask[0].nonzero().reshape(-1).tolist() == [1, 4]
    mask, counts = route_exempt(cfg, want, want)
    assert counts == {"ties": 0, "moved": 0, "near": 1} and not mask.any()


def test_route_exempt_refuses_routing_apart_away_from_a_tie():
    from repro_torch.testing import route_exempt
    cfg, want, got = _tie_calls({2: [2, -3, 3, -2]})      # a margin of 3
    with pytest.raises(AssertionError, match="away from a bf16 tie"):
        route_exempt(cfg, want, got)
    cfg, want, got = _tie_calls(card_cf=2.0)               # no tie: cap 8
    with pytest.raises(AssertionError, match="no routing tie"):
        route_exempt(cfg, want, got)


def test_route_exempt_maps_groups_back_to_tokens():
    # four groups (2 x 2) of 4 tokens at capacity 2: the last group is
    # batch row 1's positions 4-7, whose first token is the near-tie; the
    # card's swap there moves token 7's drop (expert 2 full a token early)
    from repro_torch.testing import route_exempt
    cfg, (_, r, x, _), _ = _tie_calls()
    x = torch.stack([x[0, [0, 2, 3, 5, 0, 2, 3, 5]],
                     x[0, [0, 2, 3, 5, 1, 6, 7, 5]]])
    x_card = x.clone()
    x_card[1, 4] = torch.tensor([3, 0.99, 1.0, -1])
    kw = {"groups": (2, 2)}
    mask, counts = route_exempt(cfg, (cfg, r, x, kw), (cfg, r, x_card, kw))
    assert counts == {"ties": 1, "moved": 1, "near": 1}
    assert mask.nonzero().tolist() == [[1, 4], [1, 7]]
