"""musicgen-medium at its own head layout on the CPU, the port against the
JAX package: 24 q-heads over 24 kv-heads (MHA) at head dim 64, each layer
a causal self-attention, a cross-attention over the 256 context tokens and
an FFN, which the ``-smoke`` config cuts to 4 over 2 heads and 8 context
tokens.

K6's plain version (the kernel's CPU path) against the Pallas kernel in
interpret mode and the jnp oracle at the three calls the bf16 steps make
(a causal cache prefill with a per-row query offset, the cross-attention
over 256 context keys, and its one-token decode step), in float32 and on
bf16 operands; K7's plain version at the decode step's heads; the plain
VJP that trains K6 at the cross-attention's shape against ``jax.vjp``;
then a two-layer cut at full width (``d_model`` 1536, 24 heads, FFN 6144,
context 768) on the JAX package's own bf16 weights
(``weights.llm_from_numpy_tree``): one ``launch.specs.make_step`` train
step (remat, AdamW) with context embeddings against ``jax.value_and_grad``
of the JAX package's ``loss_fn`` and its AdamW, and the bf16 prefill and
decode held layer by layer (``test_torch_bf16.assert_layers_match_jax``).

Tolerances (``repro_torch.testing``): ``ATTN_ATOL`` (float32 kernels),
``ATTN_BF16_RTOL`` (bf16 against the Pallas kernel: one bf16 ulp of a
row's largest value), ``BF16_REF_RTOL`` (bf16 against the jnp oracle,
which rounds p to bf16), ``ATTN_VJP_RTOL`` (the plain VJP against
``jax.vjp``) and ``BF16_LLM_RTOL`` (a bf16 layer's output and cache, the
train step's loss and parameters)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import transformer as JT
from repro.training.optimizer import AdamW as JAdamW
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.testing import (ATTN_ATOL, ATTN_BF16_RTOL, ATTN_VJP_RTOL,
                                 BF16_LLM_RTOL, BF16_REF_RTOL,
                                 assert_train_params_close, attention_case,
                                 bf16_err, decode_case, leaf_rel_err,
                                 llm_batch, rel_err)
from repro_torch.training.optimizer import AdamW
from test_torch_bf16 import assert_layers_match_jax

torch.set_num_threads(1)
BF = torch.bfloat16
ARCH = "musicgen-medium"
HEADS, D, N_CTX = 24, 64, 256           # q-heads = kv-heads, head dim
# (b, s_q, s_kv, causal, q_offset): the self-attention's cache prefill at
# a per-row offset, the cross-attention over the context at prefill and at
# a decode step
FLASH_MUSICGEN_CASES = [(2, 40, 96, True, [56, 30]),
                        (2, 33, N_CTX, False, 0),
                        (3, 1, N_CTX, False, 0)]
FLASH_MUSICGEN_IDS = ["self-cache-prefill", "cross-prefill", "cross-decode"]


def _f(x) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arrays, dtype):
    """The same numpy arrays as JAX and port operands of ``dtype``."""
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_the_heads_are_musicgens():
    for cfg in (get_config(ARCH), jax_config(ARCH)):
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (HEADS,
                                                                   HEADS, D)
        assert cfg.num_ctx_tokens == N_CTX and cfg.block_pattern == (
            "cross",)


# ---------------------------------------------------------------------------
# K6, K7 and K6's plain VJP at 24 / 24 heads, d 64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_MUSICGEN_CASES, ids=FLASH_MUSICGEN_IDS)
def test_flash_attention_plain_matches_jax_at_musicgen_heads(case, dtype):
    b, s_q, s_kv, causal, off = case
    (jq, jk, jv), (tq, tk, tv) = _pair(
        attention_case(b, s_q, s_kv, HEADS, HEADS, D, seed=13), dtype)
    ops.reset_launch_counts()
    got = ops.flash_attention(tq, tk, tv, causal=causal,
                              q_offset=torch.as_tensor(off))
    assert ops.launch_counts()["flash_attention"] == 0     # plain on CPU
    assert got.shape == (b, s_q, HEADS, D) and got.dtype == tq.dtype
    # the JAX package takes a scalar offset: a per-row one row by row
    rows = ([(slice(None), off)] if np.ndim(off) == 0 else
            [(slice(r, r + 1), o) for r, o in enumerate(off)])
    for sl, o in rows:
        kw = dict(causal=causal, q_offset=o)
        want_kernel = jflash(jq[sl], jk[sl], jv[sl], bq=16, bk=16,
                             interpret=True, **kw)
        want_ref = jref.flash_attention(jq[sl], jk[sl], jv[sl], **kw)
        mine = _f(got[sl])
        if dtype == "float32":
            np.testing.assert_allclose(mine, _f(want_kernel), atol=ATTN_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(mine, _f(want_ref), atol=ATTN_ATOL,
                                       rtol=0)
        else:
            assert bf16_err(mine, _f(want_kernel)) <= ATTN_BF16_RTOL
            assert rel_err(mine, _f(want_ref)) <= BF16_REF_RTOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_jax_at_musicgen_heads(dtype):
    # a full row, a partly filled one and a row of one slot
    b, S, lens = 3, 160, [160, 77, 1]
    (jq, jk, jv), (tq, tk, tv) = _pair(decode_case(b, S, HEADS, HEADS, D,
                                                   seed=13), dtype)
    cl = np.asarray(lens, np.int32)
    want_kernel = jdecode(jq, jk, jv, jnp.asarray(cl), bk=32, interpret=True)
    want_ref = jref.decode_attention(jq, jk, jv, jnp.asarray(cl))
    got = ops.decode_attention(tq, tk, tv, torch.as_tensor(cl))
    assert got.shape == (b, HEADS, D) and got.dtype == tq.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f(got), _f(want_kernel), atol=ATTN_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_f(got), _f(want_ref), atol=ATTN_ATOL,
                                   rtol=0)
    else:
        assert bf16_err(_f(got), _f(want_kernel)) <= ATTN_BF16_RTOL
        assert rel_err(_f(got), _f(want_ref)) <= BF16_REF_RTOL


def test_flash_attention_vjp_matches_jax_at_the_cross_shape():
    # the backward that trains the cross-attention: 16 queries over the 256
    # context keys, non-causal
    q, k, v = attention_case(2, 16, N_CTX, HEADS, HEADS, D, seed=5)
    g = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    fa.vjps = 0
    got = fa.flash_attention_vjp(*map(torch.as_tensor, (q, k, v, g)),
                                 causal=False)
    assert fa.vjps == 1
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention(q, k, v,
                                                          causal=False),
                     *map(jnp.asarray, (q, k, v)))
    for name, x, w in zip("qkv", got, vjp(jnp.asarray(g))):
        assert rel_err(x.numpy(), np.asarray(w)) <= ATTN_VJP_RTOL, name


# ---------------------------------------------------------------------------
# a two-layer cut at full width, bf16, on the JAX package's weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cut():
    """(JAX config, port config, JAX bf16 parameters, the port's): two
    layers of musicgen-medium at full width."""
    kw = dict(num_layers=2, num_blocks=2)
    jcfg = dataclasses.replace(jax_config(ARCH), name=ARCH + "-2", **kw)
    tcfg = dataclasses.replace(get_config(ARCH), name=ARCH + "-2", **kw)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu",
                                     BF)
    return jcfg, tcfg, jp, tp


def test_the_cut_keeps_the_full_widths(cut):
    jcfg, tcfg, _, _ = cut
    full = get_config(ARCH)
    for cfg in (jcfg, tcfg):
        assert cfg.num_layers == 2 and cfg.num_blocks == 2
        assert (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.ctx_dim) == (
            full.d_model, full.d_ff, full.vocab_size, full.ctx_dim)


def test_bf16_train_step_with_context_matches_jax(cut):
    # one AdamW step of the launcher's make_step (bf16 parameters, remat)
    # and the JAX package's train step by hand: value_and_grad of loss_fn
    # at dtype=bfloat16 over the same bf16 context, then its AdamW
    jcfg, tcfg, jp, tp = cut
    lr, b, s = 1e-3, 2, 32
    batch = llm_batch(jcfg, b, s, seed=3)
    ctx = jnp.asarray(batch["ctx_embed"]).astype(jnp.bfloat16)
    jbatch = {"tokens": jnp.asarray(batch["tokens"]),
              "labels": jnp.asarray(batch["labels"]), "ctx_embed": ctx}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jbatch, remat=True,
                             dtype=jnp.bfloat16), has_aux=True))(jp)
    jopt = JAdamW(lr=lr)
    jnew, _ = jopt.update(jgrads, jopt.init(jp), jp)
    fn = specs.make_step(tcfg, ShapeConfig("t", s, b, "train"), lr=lr)[0]
    tbatch = {"tokens": torch.as_tensor(batch["tokens"]).long(),
              "labels": torch.as_tensor(batch["labels"]).long(),
              "ctx_embed": torch.as_tensor(_f(ctx)).to(BF)}
    new, state, m = fn(tp, AdamW(lr=lr).init(tp), tbatch)
    assert leaf_rel_err(float(m["loss"]), float(jloss)) <= BF16_LLM_RTOL
    got = _flat(new)
    assert all(t.dtype == BF for t in got.values())
    assert all(t.dtype == torch.float32 for t in _flat(state.mu).values())
    # the step moved the leaves the context reaches: its projection and
    # the cross-attention's K and V
    old, grads = _flat(tp), _flat(jgrads)
    for k in ("/ctx_proj", "/blocks/0/xattn/wk", "/blocks/0/xattn/wv"):
        assert float(np.abs(_f(grads[k])).max()) > 0, k
        assert not torch.equal(got[k], old[k]), k
    assert_train_params_close(
        {k: _f(v) for k, v in got.items()},
        {k: _f(v) for k, v in _flat(jnew).items()},
        {k: _f(v) for k, v in grads.items()}, lr, 1,
        "musicgen bf16 train step vs JAX", rtol=BF16_LLM_RTOL)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_bf16_steps_match_jax_layer_by_layer(cut, mode):
    # a 2 x 24 prefill into a 32-slot cache (the JAX package's oracle: its
    # prefill passes the cache index as an array); one decode step at index
    # 20 over a random cache (its Pallas K7 in interpret mode); both over
    # the same bf16 context
    jcfg, tcfg, jp, tp = cut
    rng = np.random.default_rng(4)
    b, s, S = 2, 24, 32
    toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (b, s)), jnp.int32)
    ctx = jnp.asarray(0.02 * rng.normal(size=(b, N_CTX, jcfg.ctx_dim)),
                      jnp.float32).astype(jnp.bfloat16)
    kw = dict(ctx_embed=ctx, dtype=jnp.bfloat16, unroll_blocks=True)
    if mode == "prefill":
        def run():
            return JT.prefill(jcfg, jp, toks, JT.init_cache(
                jcfg, b, S, jnp.bfloat16), impl="ref", **kw)[0]
    else:
        cache = jax.tree.map(
            lambda c: jnp.asarray(0.5 * rng.normal(size=c.shape)
                                  ).astype(c.dtype),
            JT.init_cache(jcfg, b, S, jnp.bfloat16))

        def run():
            return JT.decode_step(jcfg, jp, toks[:, :1], cache, jnp.int32(20),
                                  impl="interpret", **kw)[0]
    assert_layers_match_jax(tcfg, tp, run)
