"""The port's LLM serving path on the CPU against the JAX package, on the
reduced configs of five dense and SSM families (hybrid zamba2, pure-SSM
mamba2, local/global-attention gemma2 with softcaps, GQA qwen2 and
starcoder2 with QKV bias; the MoE, MLA and cross-attention families are in
tests/test_torch_llm_archs.py): the same JAX ``init_params`` weights
(converted with ``llm_from_numpy_tree``) and the same numpy tokens through
``forward``, ``prefill`` + ``decode_step`` (a scalar and a per-slot cache
index) and the ``LLMServer`` loop.  Logits agree within ``LLM_RTOL`` of
their scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving.kv_cache import CachePool as JaxPool
from repro.serving.server import LLMServer as JaxServer
from repro.serving.server import Request as JaxRequest
from repro_torch import weights
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import schema as sch
from repro_torch.models import transformer as TT
from repro_torch.serving.kv_cache import CachePool
from repro_torch.serving.server import LLMServer, Request
from repro_torch.testing import LLM_RTOL, rel_err

torch.set_num_threads(1)

FAMILIES = ["zamba2-7b", "mamba2-2.7b", "gemma2-9b", "qwen2-7b",
            "starcoder2-7b"]


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
    """(path string, leaf) pairs of a JAX or a port tree."""
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    # 72 tokens: past gemma2-smoke's 64-token window and two SSM chunks
    toks = _tokens(jcfg, (2, 72), 1)
    want = np.asarray(jax.jit(lambda p, t: JT.forward(jcfg, p, t)[0])(
        jp, jnp.asarray(toks)))
    got, cache, _ = TT.forward(tcfg, tp, torch.as_tensor(toks))
    assert cache is None
    assert got.shape == (2, 72, tcfg.padded_vocab)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, "forward logits")


def test_prefill_decode_scalar_index_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    b, s, max_seq = 2, 70, 80
    toks = _tokens(jcfg, (b, s), 2)
    jprefill = jax.jit(lambda p, t, c: JT.prefill(jcfg, p, t, c))
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(jcfg, p, t, c, i))
    jl, jc = jprefill(jp, jnp.asarray(toks), JT.init_cache(jcfg, b, max_seq))
    tl, tc = TT.prefill(tcfg, tp, torch.as_tensor(toks),
                        TT.init_cache(tcfg, b, max_seq, "cpu"))
    _close(tl.numpy(), np.asarray(jl), "prefill logits")
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for step in range(2):                 # positions 70, 71: window bites
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.int32(s + step))
        tl, tc = TT.decode_step(tcfg, tp, torch.as_tensor(nxt), tc,
                                torch.tensor(s + step))
        _close(tl[:, 0].numpy(), np.asarray(jl[:, 0]), f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
    flat_j = dict(_leaves(jc))
    flat_t = dict(_leaves(tc))
    assert flat_j.keys() == flat_t.keys()
    for key, a in flat_j.items():
        assert a.shape == tuple(flat_t[key].shape), key
        assert rel_err(flat_t[key].numpy(), np.asarray(a)) <= LLM_RTOL, key


def test_per_slot_decode_matches_jax(model):
    # the server's flow: prompts of different lengths prefilled one by one
    # into a slot pool, then lockstep decode with a (b,) cache index
    jcfg, tcfg, jp, tp = model
    max_seq, lens = 48, (9, 23, 14)
    jpool = JaxPool(jcfg, len(lens), max_seq)
    tpool = CachePool(tcfg, len(lens), max_seq, "cpu")
    jprefill = jax.jit(lambda p, t, c: JT.prefill(jcfg, p, t, c))
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(jcfg, p, t, c, i))
    nxt = np.zeros((len(lens), 1), np.int32)
    for slot, n in enumerate(lens):
        toks = _tokens(jcfg, (1, n), 10 + slot)
        jl, one = jprefill(jp, jnp.asarray(toks),
                           JT.init_cache(jcfg, 1, max_seq))
        jpool.write_prefill(slot, one, n)
        tl, tone = TT.prefill(tcfg, tp, torch.as_tensor(toks),
                              TT.init_cache(tcfg, 1, max_seq, "cpu"))
        tpool.write_prefill(slot, tone, n)
        _close(tl.numpy(), np.asarray(jl), f"prefill slot {slot}")
        nxt[slot, 0] = int(jnp.argmax(jl[0]))
    idx = np.asarray(lens, np.int32)
    jc, tc = jpool.cache, tpool.cache
    for step in range(3):
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(idx + step))
        tl, tc = TT.decode_step(tcfg, tp, torch.as_tensor(nxt), tc,
                                torch.as_tensor(idx + step))
        _close(tl[:, 0].numpy(), np.asarray(jl[:, 0]), f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]


def test_llm_server_matches_jax():
    # tests/test_serving.py's continuous-batching case: more requests than
    # slots, the same prompts and weights on both sides
    jcfg = jax_config("qwen2-7b").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    servers = (JaxServer(jcfg, jp, num_slots=2, max_seq=64, eos_token=-1),
               LLMServer(get_config("qwen2-7b-smoke"), tp, num_slots=2,
                         max_seq=64, eos_token=-1))
    for srv, req_cls in zip(servers, (JaxRequest, Request)):
        rng = np.random.default_rng(0)
        for i in range(4):
            srv.submit(req_cls(i, rng.integers(0, jcfg.vocab_size, 5),
                               max_new_tokens=4))
    done_j, done_t = (srv.run_until_drained(max_steps=200)
                      for srv in servers)
    assert len(done_t) == 4
    assert servers[1].monitor.counters["requests_finished"] == 4
    for rj, rt in zip(done_j, done_t):
        assert rt.request_id == rj.request_id
        assert rt.output == rj.output
        assert abs(rt.confidence - rj.confidence) <= LLM_RTOL


@pytest.mark.parametrize("name", FAMILIES)
def test_params_and_cache_follow_the_jax_trees(name):
    # same keys and shapes as the JAX package's init_params / init_cache,
    # and the schema's initialisers
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tp = TT.init_params(tcfg, 0, "cpu")
    assert ({k: tuple(t.shape) for k, t in _leaves(tp)}
            == {k: a.shape for k, a in _leaves(shapes)})
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 16))
    tcache = TT.init_cache(tcfg, 2, 16, "cpu")
    assert ({k: tuple(t.shape) for k, t in _leaves(tcache)}
            == {k: a.shape for k, a in _leaves(jcache)})
    scales = [t for k, t in _leaves(tp) if k.endswith("['scale']")]
    assert scales and all(bool((t == 1).all()) for t in scales)
    if tcfg.uses_ssm:
        a_log = (tp["blocks"]["0"]["ssm"]["A_log"])
        assert bool(((a_log >= 0) & (a_log <= np.log(16.0))).all())
    assert sch.param_bytes(TT.model_schema(tcfg)) == 4 * sum(
        t.numel() for t in jax.tree.leaves(tp))


def test_llm_from_numpy_tree_keeps_every_layout():
    # stacked block leaves are 4-d without being convs: nothing transposed
    jcfg = jax_config("zamba2-7b").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["blocks"]["7"] == {}            # the shared-attention slot
    for a, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


# starcoder2-7b, compared above since it joined FAMILIES, keeps its
# fresh-weight forward here too
@pytest.mark.parametrize("name", sorted(set(ARCHS) - set(FAMILIES)
                                        | {"starcoder2-7b"}))
def test_other_families_run_or_name_their_milestone(name):
    # every family of the registry runs now, MoE, MLA and cross-attention
    # included (tests/test_torch_llm_archs.py holds those against JAX): a
    # forward from fresh weights, with numpy context where the config
    # takes frontend embeddings
    cfg = get_config(name).reduced()
    params = TT.init_params(cfg, 0, "cpu")
    ctx = None
    if cfg.num_ctx_tokens:
        ctx = torch.as_tensor(np.random.default_rng(0).normal(
            size=(2, cfg.num_ctx_tokens, cfg.ctx_dim or cfg.d_model))
            .astype(np.float32) * 0.02)
    logits, cache, aux = TT.forward(cfg, params,
                                    torch.as_tensor(_tokens(cfg, (2, 9), 4)),
                                    ctx_embed=ctx)
    assert cache is None and logits.shape == (2, 9, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert (float(aux) > 0) == (cfg.num_experts > 0)
    TT.init_cache(cfg, 1, 8, "cpu")
