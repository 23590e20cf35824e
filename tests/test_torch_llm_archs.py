"""The port's MoE, MLA and cross-attention families on the CPU against the
JAX package (``impl="ref"``), on the four reduced configs that need them:
deepseek-v2-lite (MLA + MoE with a shared expert and a dense prefix),
qwen3-moe (GQA + MoE), musicgen (self- and cross-attention over audio-frame
embeddings) and llama-3.2-vision (GQA with a cross-attention layer over
image-patch embeddings).  The same JAX ``init_params`` weights (converted
with ``llm_from_numpy_tree``), numpy tokens and numpy context embeddings go
through ``forward``, ``prefill`` + ``decode_step`` (a scalar and a per-slot
cache index) and, for deepseek, the ``LLMServer`` loop.  Logits agree
within ``LLM_RTOL`` of their scale, aux losses within ``MOE_RTOL``."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import schema as jsch
from repro.models import transformer as JT
from repro.serving.kv_cache import CachePool as JaxPool
from repro.serving.server import LLMServer as JaxServer
from repro.serving.server import Request as JaxRequest
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import schema as sch
from repro_torch.models import stubs
from repro_torch.models import transformer as TT
from repro_torch.serving.kv_cache import CachePool
from repro_torch.serving.server import LLMServer, Request
from repro_torch.testing import LLM_RTOL, MOE_RTOL, rel_err

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "musicgen-medium",
            "llama-3.2-vision-90b"]


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    jcfg = jax_config(request.param).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, get_config(request.param).reduced(), jp, tp


def _close(got, want, what):
    err = rel_err(got, want)
    assert err <= LLM_RTOL, f"{what}: {err:.2e} of the logit scale"


def _leaves(tree):
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _ctx(cfg, b, seed):
    """numpy context embeddings for a ctx config (None for the others), at
    the stub's scale."""
    if not cfg.num_ctx_tokens:
        return None
    shape = (b, cfg.num_ctx_tokens, cfg.ctx_dim or cfg.d_model)
    return (np.random.default_rng(seed).normal(size=shape)
            * 0.02).astype(np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, ctx = _tokens(jcfg, (2, 40), 1), _ctx(jcfg, 2, 2)
    wl, _, wa = jax.jit(lambda p, t, c: JT.forward(jcfg, p, t, ctx_embed=c))(
        jp, jnp.asarray(toks), _j(ctx))
    got, cache, aux = TT.forward(tcfg, tp, torch.as_tensor(toks),
                                 ctx_embed=_t(ctx))
    assert cache is None and got.shape == (2, 40, tcfg.padded_vocab)
    _close(got.numpy(), np.asarray(wl), "forward logits")
    assert aux.shape == () and aux.dtype == torch.float32
    assert abs(float(aux) - float(wa)) <= MOE_RTOL * max(1.0, float(wa))
    assert (float(aux) > 0) == (tcfg.num_experts > 0)


def test_prefill_decode_scalar_index_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    b, s, max_seq = 2, 20, 32
    toks, ctx = _tokens(jcfg, (b, s), 3), _ctx(jcfg, b, 4)
    jprefill = jax.jit(lambda p, t, c, x: JT.prefill(jcfg, p, t, c,
                                                      ctx_embed=x))
    jdecode = jax.jit(lambda p, t, c, i, x: JT.decode_step(
        jcfg, p, t, c, i, ctx_embed=x))
    jl, jc = jprefill(jp, jnp.asarray(toks), JT.init_cache(jcfg, b, max_seq),
                      _j(ctx))
    tl, tc = TT.prefill(tcfg, tp, torch.as_tensor(toks),
                        TT.init_cache(tcfg, b, max_seq, "cpu"),
                        ctx_embed=_t(ctx))
    _close(tl.numpy(), np.asarray(jl), "prefill logits")
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for step in range(2):
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.int32(s + step),
                         _j(ctx))
        tl, tc = TT.decode_step(tcfg, tp, torch.as_tensor(nxt), tc,
                                torch.tensor(s + step), ctx_embed=_t(ctx))
        _close(tl[:, 0].numpy(), np.asarray(jl[:, 0]), f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
    flat_j, flat_t = dict(_leaves(jc)), dict(_leaves(tc))
    assert flat_j.keys() == flat_t.keys()
    for key, a in flat_j.items():
        assert a.shape == tuple(flat_t[key].shape), key
        assert rel_err(flat_t[key].numpy(), np.asarray(a)) <= LLM_RTOL, key


def test_per_slot_decode_matches_jax(model):
    # the server's flow: prompts of different lengths prefilled one by one
    # into a slot pool (each with its own context row), then lockstep
    # decode with a (b,) cache index; MoE routes the slots' tokens together
    jcfg, tcfg, jp, tp = model
    max_seq, lens = 40, (9, 23, 14)
    ctx = _ctx(jcfg, len(lens), 5)
    jpool = JaxPool(jcfg, len(lens), max_seq)
    tpool = CachePool(tcfg, len(lens), max_seq, "cpu")
    jprefill = jax.jit(lambda p, t, c, x: JT.prefill(jcfg, p, t, c,
                                                      ctx_embed=x))
    jdecode = jax.jit(lambda p, t, c, i, x: JT.decode_step(
        jcfg, p, t, c, i, ctx_embed=x))
    nxt = np.zeros((len(lens), 1), np.int32)
    for slot, n in enumerate(lens):
        toks = _tokens(jcfg, (1, n), 10 + slot)
        row = None if ctx is None else ctx[slot:slot + 1]
        jl, one = jprefill(jp, jnp.asarray(toks),
                           JT.init_cache(jcfg, 1, max_seq), _j(row))
        jpool.write_prefill(slot, one, n)
        tl, tone = TT.prefill(tcfg, tp, torch.as_tensor(toks),
                              TT.init_cache(tcfg, 1, max_seq, "cpu"),
                              ctx_embed=_t(row))
        tpool.write_prefill(slot, tone, n)
        _close(tl.numpy(), np.asarray(jl), f"prefill slot {slot}")
        nxt[slot, 0] = int(jnp.argmax(jl[0]))
    idx = np.asarray(lens, np.int32)
    jc, tc = jpool.cache, tpool.cache
    for step in range(3):
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(idx + step),
                         _j(ctx))
        tl, tc = TT.decode_step(tcfg, tp, torch.as_tensor(nxt), tc,
                                torch.as_tensor(idx + step),
                                ctx_embed=_t(ctx))
        _close(tl[:, 0].numpy(), np.asarray(jl[:, 0]), f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]


@pytest.mark.parametrize("cf", [4.0, 1.25], ids=["drop-free", "drops"])
def test_deepseek_server_matches_jax(cf):
    # continuous batching with more requests than slots; at 1.25 (the
    # full-width factor) a decode step's 2 x 2 assignments share each
    # expert's room of ceil(2 * 2 * 1.25 / 4) = 2, so slots can drop each
    # other's tokens, as in the reference
    jcfg = dataclasses.replace(jax_config("deepseek-v2-lite-16b").reduced(),
                               moe_capacity_factor=cf)
    tcfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                               moe_capacity_factor=cf)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    servers = (JaxServer(jcfg, jp, num_slots=2, max_seq=64, eos_token=-1),
               LLMServer(tcfg, tp, num_slots=2, max_seq=64, eos_token=-1))
    for srv, req_cls in zip(servers, (JaxRequest, Request)):
        rng = np.random.default_rng(0)
        for i in range(4):
            srv.submit(req_cls(i, rng.integers(0, jcfg.vocab_size, 12),
                               max_new_tokens=5))
    done_j, done_t = (srv.run_until_drained(max_steps=200)
                      for srv in servers)
    assert len(done_t) == 4
    for rj, rt in zip(done_j, done_t):
        assert rt.request_id == rj.request_id
        assert rt.output == rj.output
        assert abs(rt.confidence - rj.confidence) <= LLM_RTOL


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_groups_match_jax(name):
    # moe_groups (2, 2) at the full-width factor 1.25: each of the four
    # (batch, seq) groups has its own capacity, so which tokens drop differs
    # from (1, 1); forward, then prefill (groups over the prompt) and two
    # decode steps (a one-token step keeps one sequence group)
    jcfg = dataclasses.replace(jax_config(name).reduced(),
                               moe_capacity_factor=1.25)
    tcfg = dataclasses.replace(get_config(name).reduced(),
                               moe_capacity_factor=1.25)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(2))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    toks, g = _tokens(jcfg, (2, 24), 11), (2, 2)
    wl, _, wa = jax.jit(lambda p, t: JT.forward(jcfg, p, t, moe_groups=g))(
        jp, jnp.asarray(toks))
    got, _, aux = TT.forward(tcfg, tp, torch.as_tensor(toks), moe_groups=g)
    _close(got.numpy(), np.asarray(wl), "forward logits, groups (2, 2)")
    assert abs(float(aux) - float(wa)) <= MOE_RTOL * max(1.0, float(wa))
    one, _, _ = TT.forward(tcfg, tp, torch.as_tensor(toks))
    assert rel_err(one.numpy(), got.numpy()) > LLM_RTOL   # groups matter
    jl, jc = jax.jit(lambda p, t, c: JT.prefill(jcfg, p, t, c, moe_groups=g))(
        jp, jnp.asarray(toks), JT.init_cache(jcfg, 2, 32))
    tl, tc = TT.prefill(tcfg, tp, torch.as_tensor(toks),
                        TT.init_cache(tcfg, 2, 32, "cpu"), moe_groups=g)
    _close(tl.numpy(), np.asarray(jl), "prefill logits, groups (2, 2)")
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(jcfg, p, t, c, i,
                                                        moe_groups=g))
    for step in range(2):
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.int32(24 + step))
        tl, tc = TT.decode_step(tcfg, tp, torch.as_tensor(nxt), tc,
                                torch.tensor(24 + step), moe_groups=g)
        _close(tl[:, 0].numpy(), np.asarray(jl[:, 0]), f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]


# ---------------------------------------------------------------------------
# the mixers alone
# ---------------------------------------------------------------------------
def _mixer_params(schema_fn, jcfg, seed):
    jp = jsch.init(schema_fn(jcfg), jax.random.PRNGKey(seed))
    return jp, weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp),
                                           "cpu")


def test_mla_attention_matches_jax():
    # prefill without a cache, prefill into a cache (K6 over all its slots
    # with the query offset), then the weight-absorbed decode at a scalar
    # and at a per-slot index
    jcfg = jax_config("deepseek-v2-lite-16b").reduced()
    tcfg = get_config("deepseek-v2-lite-16b").reduced()
    jp, tp = _mixer_params(JA.mla_schema, jcfg, 1)
    rng = np.random.default_rng(6)
    b, s, S = 2, 12, 24
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want, _ = JA.mla_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got, none = TA.mla_attention(tcfg, tp, torch.as_tensor(x),
                                 torch.as_tensor(pos))
    assert none is None
    assert rel_err(got.numpy(), np.asarray(want)) <= LLM_RTOL

    spec = JA.mla_cache_spec(jcfg, b, S)
    assert TA.mla_cache_spec(tcfg, b, S) == spec
    jcache = {k: jnp.zeros(v) for k, v in spec.items()}
    tcache = {k: torch.zeros(v) for k, v in spec.items()}
    want, jcache = JA.mla_attention(jcfg, jp, jnp.asarray(x),
                                    jnp.asarray(pos), cache=jcache,
                                    cache_index=jnp.int32(0))
    got, tcache = TA.mla_attention(tcfg, tp, torch.as_tensor(x),
                                   torch.as_tensor(pos), cache=tcache,
                                   cache_index=torch.tensor(0))
    assert rel_err(got.numpy(), np.asarray(want)) <= LLM_RTOL
    for idx in (np.int32(s), np.asarray([s, 5], np.int32)):
        x1 = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
        p1 = np.broadcast_to(idx, (b,)).reshape(b, 1).copy()
        want, jc = JA.mla_attention(jcfg, jp, jnp.asarray(x1),
                                    jnp.asarray(p1), cache=jcache,
                                    cache_index=jnp.asarray(idx))
        got, tc = TA.mla_attention(tcfg, tp, torch.as_tensor(x1),
                                   torch.as_tensor(p1),
                                   cache={k: v.clone()
                                          for k, v in tcache.items()},
                                   cache_index=torch.as_tensor(idx).long())
        assert rel_err(got.numpy(), np.asarray(want)) <= LLM_RTOL, idx
        for k in spec:
            assert rel_err(tc[k].numpy(), np.asarray(jc[k])) <= LLM_RTOL, k


def test_cross_attention_matches_jax():
    jcfg = jax_config("musicgen-medium").reduced()
    tcfg = get_config("musicgen-medium").reduced()
    jp, tp = _mixer_params(JA.cross_attn_schema, jcfg, 2)
    rng = np.random.default_rng(7)
    ctx = rng.normal(size=(2, 8, jcfg.d_model)).astype(np.float32)
    for s in (11, 1):                    # a prefill and a decode step
        x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
        want = JA.cross_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(ctx))
        got = TA.cross_attention(tcfg, tp, torch.as_tensor(x),
                                 torch.as_tensor(ctx))
        assert got.shape == (2, s, tcfg.d_model)
        assert rel_err(got.numpy(), np.asarray(want)) <= LLM_RTOL, s


# ---------------------------------------------------------------------------
# trees, the stub, the entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_params_and_cache_follow_the_jax_trees(name):
    # same keys and shapes as the JAX package's init_params / init_cache
    # (ctx_proj, moe, xattn, ln3, the MLA projections and latent cache),
    # and llm_from_numpy_tree carries every JAX leaf over unchanged
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TT.init_params(tcfg, 0, "cpu")
    assert ({k: tuple(t.shape) for k, t in _leaves(tp)}
            == {k: a.shape for k, a in _leaves(jp)})
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 16))
    tcache = TT.init_cache(tcfg, 2, 16, "cpu")
    assert ({k: tuple(t.shape) for k, t in _leaves(tcache)}
            == {k: a.shape for k, a in _leaves(jcache)})
    assert sch.param_bytes(TT.model_schema(tcfg)) == 4 * sum(
        t.numel() for t in jax.tree.leaves(tp))
    conv = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    flat = dict(_leaves(conv))
    for key, a in _leaves(jp):
        np.testing.assert_array_equal(flat[key].numpy(), np.asarray(a))


def test_softcap_matches_jax():
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    x = np.random.default_rng(8).normal(size=(3, 17)).astype(np.float32) * 60
    for cap in (None, 30.0, 50.0):
        want = np.asarray(JL.softcap(jnp.asarray(x), cap))
        np.testing.assert_allclose(TL.softcap(torch.as_tensor(x), cap).numpy(),
                                   want, rtol=1e-6, atol=1e-5)


def test_frontend_embeddings_stub():
    cfg = get_config("musicgen-medium")
    a = stubs.frontend_embeddings(cfg, 2, device="cpu")
    assert a.shape == (2, 256, 768) and a.dtype == torch.float32
    assert torch.equal(a, stubs.frontend_embeddings(cfg, 2, device="cpu"))
    assert abs(float(a.std()) - 0.02) < 1e-3
    gen = torch.Generator().manual_seed(3)
    b = stubs.frontend_embeddings(cfg, 2, generator=gen, device="cpu")
    assert torch.equal(b, torch.randn(
        (2, 256, 768), generator=torch.Generator().manual_seed(3)) * 0.02)
    vis = get_config("llama-3.2-vision-90b").reduced()
    assert stubs.frontend_embeddings(vis, 1, device="cpu").shape == \
        (1, vis.num_ctx_tokens, vis.ctx_dim)
    with pytest.raises(ValueError, match="no modality frontend"):
        stubs.frontend_embeddings(get_config("qwen2-7b"), 1, device="cpu")


def test_ctx_config_requires_ctx_embed(model):
    _, tcfg, _, tp = model
    toks = torch.zeros((1, 4), dtype=torch.long)
    if not tcfg.num_ctx_tokens:
        TT.forward(tcfg, tp, toks)
        return
    with pytest.raises(ValueError, match="requires ctx_embed"):
        TT.forward(tcfg, tp, toks)


def _serve(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--requests", "3", "--slots", "2", "--max-new", "4", "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b-smoke",
                                  "qwen3-moe-235b-a22b-smoke"])
def test_serve_entry_point_serves_moe_and_mla(arch):
    proc = _serve(arch)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests, 12 tokens" in proc.stdout


def test_serve_entry_point_refuses_a_ctx_config():
    # as the reference: the server takes no frontend embeddings
    proc = _serve("musicgen-medium-smoke")
    assert proc.returncode != 0
    assert "frontend embeddings" in proc.stderr
