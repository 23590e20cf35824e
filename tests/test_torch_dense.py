"""The dense GQA decoders (qwen2-7b, starcoder2-7b) at their own head
layouts on the CPU, the port against the JAX package: 28 and 36 q-heads
over 4 kv-heads (GQA groups of 7 and 9) at head dim 128, which the
``-smoke`` configs cut to 4 over 2 at 64.

K6's and K7's plain versions (the kernels' CPU path) against the Pallas
kernels in interpret mode and the jnp oracles, in float32 and on bf16
operands (``testing.FLASH_DENSE_CASES``, ``DECODE_DENSE_CASES``); then a
two-layer cut of each arch at those heads (``reduced(num_heads=...,
num_kv_heads=4, head_dim=128)``) on the JAX package's own weights
(``weights.llm_from_numpy_tree``): served through ``LLMServer`` in
float32, one bf16 ``launch.specs.make_step`` prefill and decode held to
the JAX package layer by layer (each layer the step applied, run again by
the JAX package on that layer's own inputs: a random model's bf16 noise
grows end to end past any fixed bound), and the long_500k ``+sliding``
variant's decode with its window cut below the cache.

Tolerances (``repro_torch.testing``): ``ATTN_ATOL`` (float32 kernels),
``ATTN_BF16_RTOL`` (bf16 against the Pallas kernel: one bf16 ulp of a
row's largest value), ``BF16_REF_RTOL`` (bf16 against the jnp oracle,
which rounds p to bf16), ``LLM_RTOL`` (float32 logits) and
``BF16_LLM_RTOL`` (a bf16 layer's output and cache)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro.serving.server import LLMServer as JaxServer
from repro.serving.server import Request as JaxRequest
from repro_torch import weights
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.models import transformer as TT
from repro_torch.serving.server import LLMServer, Request
from repro_torch.testing import (ATTN_ATOL, ATTN_BF16_RTOL, BF16_LLM_RTOL,
                                 BF16_REF_RTOL, DECODE_DENSE_CASES,
                                 DECODE_DENSE_IDS, FLASH_DENSE_CASES,
                                 FLASH_DENSE_IDS, LLM_RTOL, LayerTap,
                                 attention_case, bf16_err, decode_case,
                                 rel_err)

torch.set_num_threads(1)
BF = torch.bfloat16
DENSE = {"qwen2-7b": 28, "starcoder2-7b": 36}   # q-heads over 4 kv-heads
WINDOW = 16                # the +sliding variant's window, below the cache


def _f(x) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arrays, dtype):
    """The same numpy arrays as JAX and port operands of ``dtype``
    ("float32" or "bfloat16": the same round-to-nearest bits)."""
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


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


# ---------------------------------------------------------------------------
# K6 and K7 at 28 / 4 and 36 / 4 heads, d 128
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_DENSE_CASES, ids=FLASH_DENSE_IDS)
def test_flash_attention_plain_matches_jax_at_dense_heads(case, dtype):
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    assert (n_q, n_kv, d) in ((28, 4, 128), (36, 4, 128))
    (jq, jk, jv), (tq, tk, tv) = _pair(
        attention_case(b, s_q, s_kv, n_q, n_kv, d, seed=11), dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    want_kernel = jflash(jq, jk, jv, bq=16, bk=16, interpret=True, **kw)
    want_ref = jref.flash_attention(jq, jk, jv, **kw)
    ops.reset_launch_counts()
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert ops.launch_counts()["flash_attention"] == 0     # plain on CPU
    assert got.shape == (b, s_q, n_q, d) and got.dtype == tq.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f(got), _f(want_kernel), atol=ATTN_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_f(got), _f(want_ref), atol=ATTN_ATOL,
                                   rtol=0)
    else:
        assert bf16_err(_f(got), _f(want_kernel)) <= ATTN_BF16_RTOL
        assert rel_err(_f(got), _f(want_ref)) <= BF16_REF_RTOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_DENSE_CASES, ids=DECODE_DENSE_IDS)
def test_decode_attention_plain_matches_jax_at_dense_heads(case, dtype):
    b, S, n_q, n_kv, d, clen, window, cap = case
    assert (n_q, n_kv, d) in ((28, 4, 128), (36, 4, 128))
    (jq, jk, jv), (tq, tk, tv) = _pair(decode_case(b, S, n_q, n_kv, d,
                                                   seed=11), dtype)
    cl = np.asarray(clen, np.int32)
    kw = dict(window=window, softcap=cap)
    want_kernel = jdecode(jq, jk, jv, jnp.asarray(cl), bk=32, interpret=True,
                          **kw)
    want_ref = jref.decode_attention(jq, jk, jv, jnp.asarray(cl), **kw)
    got = ops.decode_attention(tq, tk, tv, torch.as_tensor(cl), **kw)
    assert got.shape == (b, n_q, d) and got.dtype == tq.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f(got), _f(want_kernel), atol=ATTN_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_f(got), _f(want_ref), atol=ATTN_ATOL,
                                   rtol=0)
    else:
        assert bf16_err(_f(got), _f(want_kernel)) <= ATTN_BF16_RTOL
        assert rel_err(_f(got), _f(want_ref)) <= BF16_REF_RTOL


# ---------------------------------------------------------------------------
# two-layer cuts at the archs' own heads
# ---------------------------------------------------------------------------
def _cfgs(arch, sliding=False):
    """(JAX, port) configs of ``arch`` reduced at its own heads, kv-heads
    and head dim; with ``sliding`` its long_500k variant (every layer
    LOCAL) with the window cut to WINDOW."""
    kw = dict(num_heads=DENSE[arch], num_kv_heads=4, head_dim=128)
    jcfg, tcfg = jax_config(arch).reduced(**kw), get_config(arch).reduced(
        **kw)
    if sliding:
        jcfg = dataclasses.replace(jspecs.arch_for_shape(
            jcfg, JAX_SHAPES["long_500k"]), sliding_window=WINDOW)
        tcfg = dataclasses.replace(specs.arch_for_shape(
            tcfg, INPUT_SHAPES["long_500k"]), sliding_window=WINDOW)
    return jcfg, tcfg


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_cuts_keep_the_archs_attention(arch):
    full = get_config(arch)
    for sliding in (False, True):
        jcfg, tcfg = _cfgs(arch, sliding)
        for cfg in (jcfg, tcfg):
            assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
                full.num_heads, full.num_kv_heads, full.head_dim)
            assert cfg.num_layers == 2 and cfg.qkv_bias
            assert cfg.rope_theta == full.rope_theta == 1_000_000.0
            assert cfg.block_pattern == (("local",) if sliding else ("attn",))
    assert full.num_heads // full.num_kv_heads == {"qwen2-7b": 7,
                                                   "starcoder2-7b": 9}[arch]
    # starcoder2's sliding_window acts only on LOCAL layers: its served
    # and 32k steps are full causal, its long_500k variant slides (8192)
    assert full.block_pattern == ("attn",)
    slid = specs.arch_for_shape(full, INPUT_SHAPES["long_500k"])
    assert slid.block_pattern == ("local",) and slid.sliding_window == 8192


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_llm_server_matches_jax_at_the_archs_heads(arch):
    # more requests than slots, the same prompts and weights on both sides
    jcfg, tcfg = _cfgs(arch)
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


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_sliding_decode_matches_jax_in_float32(arch):
    # the +sliding variant: a 24-token prefill, then two decode steps at
    # cache indices 24 and 25 of a 32-slot cache, the window of 16 below
    # both
    jcfg, tcfg = _cfgs(arch, sliding=True)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t, c: JT.prefill(jcfg, p, t, c))(
        jp, jnp.asarray(toks), JT.init_cache(jcfg, 2, 32))
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, tp, torch.as_tensor(toks),
                            TT.init_cache(tcfg, 2, 32, "cpu"))
    assert rel_err(_f(tl), _f(jl)) <= LLM_RTOL
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jdec = jax.jit(lambda p, t, c, i: JT.decode_step(jcfg, p, t, c, i))
    for step in range(2):
        jl, jc = jdec(jp, jnp.asarray(nxt), jc, jnp.int32(24 + step))
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, tp, torch.as_tensor(nxt), tc,
                                    torch.tensor(24 + step))
        assert rel_err(_f(tl[:, 0]), _f(jl[:, 0])) <= LLM_RTOL, step
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]


# the JAX package's implementation per mode: its prefill passes the cache
# index as an array, which its Pallas K6 takes only as a static int, so the
# jnp oracle; the decode step its Pallas K7 in interpret mode
IMPL = {"prefill": "ref", "decode": "interpret", "sliding-decode":
        "interpret"}


@pytest.mark.parametrize("mode", sorted(IMPL))
@pytest.mark.parametrize("arch", sorted(DENSE))
def test_bf16_make_step_matches_jax_layer_by_layer(arch, mode):
    # a 2 x 24 prefill; the decode over its cache, rewriting the last slot
    # (index 23); the +sliding variant's decode with its window of 16
    # below the 24 valid slots
    jcfg, tcfg = _cfgs(arch, sliding=mode == "sliding-decode")
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
        if mode != "prefill":
            tap.calls.clear()
            decode = specs.make_step(tcfg, ShapeConfig("d", s, b,
                                                       "decode"))[0]
            logits, _ = decode(tp, toks[:, -1:], cache, torch.tensor(s - 1))
    kind = "local" if mode == "sliding-decode" else "attn"
    assert [c["kind"] for c in tap.calls] == [kind] * tcfg.num_layers
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
