"""gemma2-9b's path at its own head dim (256) on the CPU, the port against
the JAX package on the same weights (``weights.llm_from_numpy_tree``): the
-smoke config with head_dim 256 and a window shorter than the prompts
(two LOCAL and two global layers, GQA 2, the attention softcap 50, the
final-logit softcap, the embedding scale and tied embeddings), served
through ``LLMServer`` for a few tokens and run through one bf16
``launch.specs.make_step`` prefill and decode.  In bf16 the port's step is
held to the JAX package layer by layer (each layer the step applied, run
again by the JAX package on that layer's own inputs): end to end a random
-smoke model's bf16 noise grows past any fixed bound
(``testing.BF16_LLM_RTOL``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving.server import LLMServer as JaxServer
from repro.serving.server import Request as JaxRequest
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs
from repro_torch.serving.server import LLMServer, Request
from repro_torch.testing import BF16_LLM_RTOL, LLM_RTOL, LayerTap, rel_err

torch.set_num_threads(1)
BF = torch.bfloat16
# gemma2-9b-smoke at gemma2-9b's head dim, its window below the prompts
GEMMA2_D256 = dict(head_dim=256, sliding_window=16)


def _cfgs():
    return (dataclasses.replace(jax_config("gemma2-9b-smoke"), **GEMMA2_D256),
            dataclasses.replace(get_config("gemma2-9b-smoke"), **GEMMA2_D256))


def _jax(t):
    """A port tensor or tree as the JAX package's: bf16 stays bf16 (exact
    through float32), integers become int32."""
    if isinstance(t, dict):
        return {k: _jax(v) for k, v in t.items()}
    if not isinstance(t, torch.Tensor):
        return t
    if t.dtype == BF:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.is_floating_point():
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.numpy().astype(np.int32))


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_reduced_config_keeps_gemma2s_attention():
    jcfg, tcfg = _cfgs()
    full = get_config("gemma2-9b")
    assert tcfg.head_dim == jcfg.head_dim == full.head_dim == 256
    assert tcfg.block_pattern == jcfg.block_pattern == full.block_pattern
    assert tcfg.num_blocks == 2 and tcfg.sliding_window == 16
    assert (tcfg.num_heads // tcfg.num_kv_heads
            == full.num_heads // full.num_kv_heads == 2)
    for key in ("attn_logit_softcap", "logit_softcap", "scale_embed",
                "tie_embeddings"):
        assert getattr(tcfg, key) == getattr(jcfg, key) == getattr(full, key)


def test_llm_server_matches_jax_at_head_dim_256():
    # more requests than slots; 20-token prompts and 6 new tokens each, so
    # the LOCAL layers' 16-token window closes on the prefill and decode
    jcfg, tcfg = _cfgs()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    servers = (JaxServer(jcfg, jp, num_slots=2, max_seq=48, eos_token=-1),
               LLMServer(tcfg, tp, num_slots=2, max_seq=48, eos_token=-1))
    for srv, req_cls in zip(servers, (JaxRequest, Request)):
        rng = np.random.default_rng(0)
        for i in range(3):
            srv.submit(req_cls(i, rng.integers(0, jcfg.vocab_size, 20),
                               max_new_tokens=6))
    done_j, done_t = (srv.run_until_drained(max_steps=200)
                      for srv in servers)
    assert len(done_t) == 3
    for rj, rt in zip(done_j, done_t):
        assert rt.request_id == rj.request_id
        assert len(rt.output) == 6 and rt.output == rj.output
        assert abs(rt.confidence - rj.confidence) <= LLM_RTOL


# the JAX package's implementation per mode: its prefill passes the cache
# index as an array, which its Pallas K6 takes only as a static int, so the
# jnp oracle; the decode step its Pallas K7 in interpret mode
IMPL = {"prefill": "ref", "decode": "interpret"}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_bf16_make_step_matches_jax_layer_by_layer_at_head_dim_256(mode):
    jcfg, tcfg = _cfgs()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu",
                                     BF)
    b, s = 2, 24
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (b, s))).long()
    assert specs.COMPUTE_DTYPE == BF
    prefill = specs.make_step(tcfg, ShapeConfig("p", s, b, "prefill"))[0]
    with torch.no_grad(), LayerTap() as tap:
        logits, cache = prefill(tp, toks)
        if mode == "decode":               # over the prefill's cache,
            tap.calls.clear()              # rewriting its last slot
            decode = specs.make_step(tcfg, ShapeConfig("d", s, b,
                                                       "decode"))[0]
            logits, _ = decode(tp, toks[:, -1:], cache, torch.tensor(s - 1))
    assert len(tap.calls) == tcfg.num_blocks * len(tcfg.block_pattern)
    assert [c["kind"] for c in tap.calls] == ["local", "attn"] * 2
    for i, c in enumerate(tap.calls):
        assert c["x"].dtype == BF
        kw = c["kw"]
        out, new_cache, _ = JT._apply_layer(
            jcfg, c["kind"], _jax(c["params"]), _jax(c["x"]),
            positions=_jax(kw["positions"]), ctx=None,
            cache=_jax(c["cache"]), cache_index=_jax(kw["cache_index"]),
            impl=IMPL[mode])
        err = rel_err(_f(c["out"]), _f(out))
        assert err <= BF16_LLM_RTOL, f"layer {i} ({c['kind']}): {err:.2e}"
        for name, want in (new_cache or {}).items():
            err = rel_err(_f(c["new_cache"][name]), _f(want))
            assert err <= BF16_LLM_RTOL, f"layer {i} cache {name}: {err:.2e}"
    assert logits.dtype == torch.float32
    assert logits.shape[0] == b and bool(torch.isfinite(logits).all())
