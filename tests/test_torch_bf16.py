"""The bfloat16 launch path on the CPU against the JAX package: the plain
versions of K6, K7 and K8 on bf16 operands against the Pallas kernels in
interpret mode and the jnp oracles; ``forward``, ``prefill``,
``decode_step`` and ``loss_fn`` at ``dtype=bfloat16`` on the JAX
package's own bf16 parameters for five families at ``-smoke`` size;
``launch.specs.make_step``'s bf16 steps, abstract arguments and train
step; and bf16 checkpoints between the packages.  The CUDA kernels are
held against the same plain versions on the card by
tests/test_torch_cuda.py.

Tolerances (``repro_torch.testing``): ``ATTN_BF16_RTOL`` and
``SSD_BF16_RTOL`` (one bf16 ulp of each output row's largest value,
``bf16_err``) against the Pallas kernels, measured at most 2.36e-3 (K6),
0 (K7, bit for bit) and 6.17e-3 (K8); ``BF16_REF_RTOL`` against the jnp oracles, which round p to bf16
(measured 5.75e-3 for K6, 5.46e-3 for K7); ``BF16_LLM_RTOL`` for the
models: layer by layer on the JAX layer's own inputs, the loss end to
end, and the logits end to end for the two families whose bf16 noise
does not grow past it (testing.py says why and by how much)."""
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
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.launch import specs as jspecs
from repro.launch.mesh import make_host_mesh
from repro.models import sharding as jshd
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamW as JAdamW
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.testing import (ATTN_BF16_RTOL, BF16_LLM_RTOL, BF16_REF_RTOL,
                                 DECODE_CASES, FLASH_CASES, FLASH_DV_CASES,
                                 FLASH_RAGGED_CASES, SSD_BF16_RTOL,
                                 SSD_CASES, SSD_RTOL,
                                 assert_train_params_close, attention_case,
                                 bf16_err, decode_case, leaf_rel_err,
                                 llm_batch, rel_err, ssd_case)
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamW

torch.set_num_threads(1)

BF = torch.bfloat16
ARCHS = ["zamba2-7b", "qwen2-7b", "mamba2-2.7b", "deepseek-v2-lite-16b",
         "musicgen-medium"]
# the families whose logits are compared end to end (BF16_LLM_RTOL)
END_TO_END = ["qwen2-7b", "musicgen-medium"]


def _jb(arrays):
    """numpy float32 -> JAX bf16 (round to nearest even)."""
    return [None if a is None else jnp.asarray(a).astype(jnp.bfloat16)
            for a in arrays]


def _tb(arrays):
    """numpy float32 -> torch bf16 (round to nearest even: the same bits
    as ``_jb``)."""
    return [None if a is None else torch.as_tensor(a).to(BF)
            for a in arrays]


def _f(x) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_bf16_inputs_have_the_same_bits_in_both_packages():
    x = np.random.default_rng(0).normal(size=(4096,)).astype(np.float32)
    assert np.array_equal(_f(_jb([x])[0]), _f(_tb([x])[0]))


# ---------------------------------------------------------------------------
# K6, K7, K8: the plain versions on bf16 operands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_RAGGED_CASES,
                         ids=[f"flash{i}" for i in range(
                             len(FLASH_CASES) + len(FLASH_RAGGED_CASES))])
def test_flash_attention_bf16_plain_matches_pallas(case):
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    arrays = attention_case(b, s_q, s_kv, n_q, n_kv, d)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    want_kernel = jflash(*_jb(arrays), bq=16, bk=16, interpret=True, **kw)
    want_ref = jref.flash_attention(*_jb(arrays), **kw)
    assert want_kernel.dtype == jnp.bfloat16
    ops.reset_launch_counts()
    got = ops.flash_attention(*_tb(arrays), **kw)
    assert ops.launch_counts()["flash_attention"] == 0     # plain on CPU
    assert got.dtype == BF and got.shape == (b, s_q, n_q, d)
    assert bf16_err(_f(got), _f(want_kernel)) <= ATTN_BF16_RTOL
    assert rel_err(_f(got), _f(want_ref)) <= BF16_REF_RTOL


@pytest.mark.parametrize("case", FLASH_DV_CASES,
                         ids=[f"dv{c[5]}-{c[6]}" for c in FLASH_DV_CASES])
def test_flash_attention_bf16_plain_takes_a_value_head_dim(case):
    # MLA's prefill against the jnp oracle (the Pallas kernel gives v q's
    # head dim), a (b,) offset row by row
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = ops.flash_attention(*_tb((q, k, v)), q_offset=torch.as_tensor(off),
                              **kw)
    assert got.dtype == BF and got.shape == (b, s_q, n_q, d_v)
    offs = np.broadcast_to(np.asarray(off), (b,))
    for i in range(b):
        want = jref.flash_attention(
            *_jb((q[i:i + 1], k[i:i + 1], v[i:i + 1])),
            q_offset=int(offs[i]), **kw)
        assert rel_err(_f(got[i:i + 1]), _f(want)) <= BF16_REF_RTOL


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"decode{i}" for i in range(len(DECODE_CASES))])
def test_decode_attention_bf16_plain_matches_pallas(case):
    b, S, n_q, n_kv, d, clen, window, cap = case
    arrays = decode_case(b, S, n_q, n_kv, d)
    cl = np.asarray(clen, np.int32)
    kw = dict(window=window, softcap=cap)
    want_kernel = jdecode(*_jb(arrays), jnp.asarray(cl), bk=32,
                          interpret=True, **kw)
    want_ref = jref.decode_attention(*_jb(arrays), jnp.asarray(cl), **kw)
    got = ops.decode_attention(*_tb(arrays), torch.as_tensor(cl), **kw)
    assert got.dtype == BF and got.shape == (b, n_q, d)
    assert bf16_err(_f(got), _f(want_kernel)) <= ATTN_BF16_RTOL
    assert rel_err(_f(got), _f(want_ref)) <= BF16_REF_RTOL


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=[f"ssd{i}" for i in range(len(SSD_CASES))])
def test_ssd_scan_bf16_plain_matches_pallas(case):
    # x, B and C bf16, dt, A and the states float32, as the reference's
    # Mamba2 layer passes them; y bf16, the final state float32
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, init, weak=weak)
    jx, jB, jC = _jb((x, B, C))
    tx, tB, tC = _tb((x, B, C))
    jst = None if st is None else jnp.asarray(st)
    y_k, fin_k = jssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                      chunk=chunk, initial_state=jst, interpret=True)
    y_r, fin_r = jref.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                               chunk=chunk, initial_state=jst)
    y, fin = ops.ssd_scan(tx, torch.as_tensor(dt), torch.as_tensor(A), tB,
                          tC, chunk=chunk,
                          initial_state=None if st is None
                          else torch.as_tensor(st))
    assert y.dtype == BF and fin.dtype == torch.float32
    assert y_k.dtype == jnp.bfloat16
    for want_y, want_fin in ((y_k, fin_k), (y_r, fin_r)):
        assert bf16_err(_f(y), _f(want_y)) <= SSD_BF16_RTOL
        assert rel_err(_f(fin), _f(want_fin)) <= SSD_RTOL


# ---------------------------------------------------------------------------
# the models at dtype=bfloat16 on the JAX package's bf16 parameters
# ---------------------------------------------------------------------------
def _to_torch(tree):
    """A JAX tree (arrays, None, dicts) as the port's: bf16 stays bf16,
    integers become int64."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64))
    return torch.from_numpy(np.array(a, np.float32)).to(
        BF if a.dtype == jnp.bfloat16 else torch.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_config(request.param).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu",
                                     BF)
    return jcfg, get_config(request.param).reduced(), jp, tp


def _inputs(jcfg, b=2, s=24, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    ctx = None
    if jcfg.num_ctx_tokens:
        ctx = (0.02 * rng.normal(size=(b, jcfg.num_ctx_tokens,
                                       jcfg.ctx_dim or jcfg.d_model))
               ).astype(np.float32)
    return rng, toks, ctx


def test_bf16_parameters_carry_across_bit_for_bit(model):
    _, _, jp, tp = model
    got, want = _flat(tp), _flat(jax.tree.map(np.asarray, jp))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == BF, k
        assert np.array_equal(_f(got[k]), want[k].astype(np.float32)), k


# the JAX package's implementation per mode: its Pallas kernels in
# interpret mode (p kept float32, as the port's) where they run; its
# prefill passes the cache index as a traced offset, which the Pallas
# kernel takes only as a static int, and its Pallas K6 gives v q's head
# dim (MLA's d_v differs), so those run the jnp oracles
IMPL = {"forward": "interpret", "prefill": "ref", "decode": "interpret"}


def _impl(jcfg, mode: str) -> str:
    return "ref" if jcfg.mla and mode != "decode" else IMPL[mode]


def assert_layers_match_jax(tcfg, tp, run_jax) -> None:
    """Run the JAX package's bf16 step ``run_jax()`` (built with
    ``unroll_blocks=True``; it returns the logits) and hold the port to it
    layer by layer: every layer the step applies (prefix, each block's
    layers, suffix) is applied by the port (``tp``, bf16) to that layer's
    own inputs -- residual stream, positions, context, cache, index --
    and its output and new cache agree within ``BF16_LLM_RTOL``; then the
    final norm and unembedding of the step's last hidden state give its
    logits.  (End to end, bf16 noise grows through a random-weight model
    past any fixed bound: testing.BF16_LLM_RTOL.)"""
    calls, hidden = [], []
    orig, orig_norm = JT._apply_layer, JT.rmsnorm

    def record(cfg, kind, params, x, **kw):
        out = orig(cfg, kind, params, x, **kw)
        calls.append((kind, params, x, kw, out))
        return out

    def norm(params, x, eps=1e-6):
        hidden.append(x)        # the step's last call is the final norm's
        return orig_norm(params, x, eps)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "_apply_layer", record)
        mp.setattr(JT, "rmsnorm", norm)
        jl = run_jax()
    assert len(calls) == len(tcfg.prefix_layers) + len(tcfg.suffix_layers) \
        + tcfg.num_blocks * len(tcfg.block_pattern)
    for i, (kind, params, x, kw, (x_out, new_cache, _)) in enumerate(calls):
        cache = _to_torch(kw["cache"]) if kw["cache"] else None
        with torch.no_grad():
            got, got_cache, _ = TT._apply_layer(
                tcfg, kind, _to_torch(params), _to_torch(x),
                positions=_to_torch(kw["positions"]), ctx=_to_torch(kw["ctx"]),
                cache=cache, cache_index=_to_torch(kw["cache_index"]),
                moe_groups=(1, 1))
        assert got.dtype == BF
        err = rel_err(_f(got), _f(x_out))
        assert err <= BF16_LLM_RTOL, f"layer {i} ({kind}): {err:.2e}"
        for name, want in (new_cache or {}).items():
            assert got_cache[name].dtype == (torch.float32 if name == "state"
                                             else BF), name
            err = rel_err(_f(got_cache[name]), _f(want))
            assert err <= BF16_LLM_RTOL, f"layer {i} cache {name}: {err:.2e}"
    with torch.no_grad():
        x_t = TT.rmsnorm(tp["final_norm"], _to_torch(hidden[-1]),
                         tcfg.norm_eps)
        logits = TT.unembed(tp["embed"], x_t, cap=tcfg.logit_softcap)
    assert logits.dtype == torch.float32
    assert rel_err(_f(logits).reshape(jl.shape), _f(jl)) <= BF16_LLM_RTOL


@pytest.mark.parametrize("mode", ["forward", "prefill", "decode"])
def test_bf16_layers_match_jax_layer_by_layer(model, mode):
    jcfg, tcfg, jp, tp = model
    rng, toks, ctx = _inputs(jcfg)
    b = toks.shape[0]
    kw = dict(ctx_embed=None if ctx is None else jnp.asarray(ctx),
              dtype=jnp.bfloat16, unroll_blocks=True, impl=_impl(jcfg, mode))
    if mode == "forward":
        def run():
            return JT.forward(jcfg, jp, jnp.asarray(toks), **kw)[0]
    elif mode == "prefill":
        def run():
            return JT.prefill(jcfg, jp, jnp.asarray(toks), JT.init_cache(
                jcfg, b, 32, jnp.bfloat16), **kw)[0]
    else:
        cache = jax.tree.map(
            lambda c: jnp.asarray(0.5 * rng.normal(size=c.shape)
                                  ).astype(c.dtype),
            JT.init_cache(jcfg, b, 32, jnp.bfloat16))

        def run():
            return JT.decode_step(jcfg, jp, jnp.asarray(toks[:, :1]), cache,
                                  jnp.int32(20), **kw)[0]
    assert_layers_match_jax(tcfg, tp, run)


def test_bf16_loss_matches_jax_end_to_end(model):
    jcfg, tcfg, jp, tp = model
    batch = llm_batch(jcfg, 2, 24)
    jtot, jparts = JT.loss_fn(jcfg, jp, {k: jnp.asarray(v)
                                         for k, v in batch.items()},
                              dtype=jnp.bfloat16,
                              impl=_impl(jcfg, "forward"))
    with torch.no_grad():
        ttot, tparts = TT.loss_fn(tcfg, tp, {k: torch.as_tensor(v)
                                             for k, v in batch.items()},
                                  dtype=BF)
    assert ttot.dtype == torch.float32 and np.isfinite(float(ttot))
    assert leaf_rel_err(float(ttot), float(jtot)) <= BF16_LLM_RTOL
    assert abs(float(tparts["aux"]) - float(jparts["aux"])) \
        <= BF16_LLM_RTOL * max(1.0, abs(float(jparts["aux"])))


@pytest.mark.parametrize("name", END_TO_END)
def test_bf16_steps_match_jax_end_to_end(name):
    # make_step's bf16 prefill and decode (COMPUTE_DTYPE) against the JAX
    # package's at dtype=bfloat16, and forward's logits
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu",
                                     BF)
    rng, toks, ctx = _inputs(jcfg, seed=2)
    b, s = toks.shape
    jx = {} if ctx is None else {"ctx_embed": jnp.asarray(ctx)}
    tx = () if ctx is None else (torch.as_tensor(ctx).to(BF),)
    jl = JT.forward(jcfg, jp, jnp.asarray(toks), dtype=jnp.bfloat16,
                    impl="interpret", **jx)[0]
    with torch.no_grad():
        tl = TT.forward(tcfg, tp, torch.as_tensor(toks).long(), dtype=BF,
                        ctx_embed=tx[0] if tx else None)[0]
    assert rel_err(_f(tl), _f(jl)) <= BF16_LLM_RTOL

    assert specs.COMPUTE_DTYPE == BF
    prefill = specs.make_step(tcfg, ShapeConfig("p", s, b, "prefill"))[0]
    tl, tc = prefill(tp, torch.as_tensor(toks).long(), *tx)
    jl, jc = JT.prefill(jcfg, jp, jnp.asarray(toks),
                        JT.init_cache(jcfg, b, s, jnp.bfloat16),
                        dtype=jnp.bfloat16, **jx)
    assert rel_err(_f(tl), _f(jl)) <= BF16_LLM_RTOL
    got, want = _flat(tc), _flat(jc)
    for k in want:
        assert got[k].dtype == (torch.float32 if k.endswith("state")
                                else BF), k
        assert rel_err(_f(got[k]), _f(want[k])) <= BF16_LLM_RTOL, k

    S, idx = 40, 31
    decode, dargs, _, _ = specs.make_step(tcfg, ShapeConfig("d", S, b,
                                                            "decode"))
    cache_np = {k: (0.5 * rng.normal(size=tuple(t.shape))).astype(np.float32)
                for k, t in _flat(dargs[2]).items()}
    jcache = JT.init_cache(jcfg, b, S, jnp.bfloat16)
    flat_j = jax.tree_util.tree_flatten_with_path(jcache)
    jcache = jax.tree_util.tree_unflatten(flat_j[1], [
        jnp.asarray(cache_np["".join(f"/{p.key}" for p in path)]
                    ).astype(leaf.dtype) for path, leaf in flat_j[0]])
    tcache = TT.init_cache(tcfg, b, S, "cpu", BF)
    for k, t in _flat(tcache).items():
        t.copy_(torch.as_tensor(cache_np[k]))
    nxt = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    tl, tc = decode(tp, torch.as_tensor(nxt).long(), tcache,
                    torch.tensor(idx), *tx)
    jl, jc = JT.decode_step(jcfg, jp, jnp.asarray(nxt), jcache,
                            jnp.int32(idx), dtype=jnp.bfloat16,
                            impl="interpret", **jx)
    assert tc is tcache
    assert rel_err(_f(tl), _f(jl)) <= BF16_LLM_RTOL
    got, want = _flat(tc), _flat(jc)
    for k in want:
        assert rel_err(_f(got[k]), _f(want[k])) <= BF16_LLM_RTOL, k


# ---------------------------------------------------------------------------
# make_step in bf16: abstract arguments, the train step
# ---------------------------------------------------------------------------
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): BF, jnp.dtype(jnp.int32): torch.long}


def _same_abstract(got, want):
    g = _flat(got if not hasattr(got, "_fields") else got._asdict())
    w = _flat(want if not hasattr(want, "_fields") else want._asdict())
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].is_meta and tuple(g[k].shape) == tuple(w[k].shape), k
        assert g[k].dtype == DTYPES[jnp.dtype(w[k].dtype)], k


@pytest.mark.parametrize("arch,shape", [
    ("zamba2-7b", "prefill_32k"), ("zamba2-7b", "decode_32k"),
    ("deepseek-v2-lite-16b", "train_4k"), ("musicgen-medium", "decode_32k"),
    ("musicgen-medium", "prefill_32k"), ("musicgen-medium", "train_4k")])
def test_make_step_abstract_args_are_the_references_in_bf16(arch, shape):
    tcfg, jcfg = get_config(arch), jax_config(arch)
    from repro.configs import INPUT_SHAPES as J_SHAPES
    from repro_torch.configs import INPUT_SHAPES
    sh, jsh = INPUT_SHAPES[shape], J_SHAPES[shape]
    _, args, _, _ = specs.make_step(tcfg, sh)
    _, jargs, _, _ = jspecs.make_step(jcfg, jsh, jshd.default_rules(jsh),
                                      make_host_mesh())
    assert len(args) == len(jargs)
    _same_abstract(args[0], jargs[0])          # bf16 parameters
    if sh.mode == "train":
        _same_abstract(args[1].mu, jargs[1].mu)    # float32 moments
        _same_abstract(args[2], jargs[2])
    else:
        for got, want in zip(args[1:], jargs[1:]):
            _same_abstract({"x": got} if isinstance(got, torch.Tensor)
                           else got,
                           {"x": want} if hasattr(want, "shape") else want)
    _same_abstract(specs.input_specs(tcfg, sh), jspecs.input_specs(jcfg, jsh))


def test_bf16_train_step_matches_jax():
    # one AdamW step of the launcher's make_step (bf16 parameters, remat)
    # and the reference's train step by hand (its make_step's sharding
    # constraints refuse this JAX's host mesh): value_and_grad of loss_fn
    # at dtype=bfloat16, then its AdamW, from the same bf16 parameters
    name, lr = "qwen2-7b", 1e-3
    jcfg, tcfg = jax_config(name).reduced(), get_config(name).reduced()
    shape = ShapeConfig("t", 32, 4, "train")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu",
                                     BF)
    batch = llm_batch(jcfg, 4, 32, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jbatch, remat=True,
                             dtype=jnp.bfloat16), has_aux=True))(jp)
    jopt = JAdamW(lr=lr)
    jnew, _ = jopt.update(jgrads, jopt.init(jp), jp)
    fn = specs.make_step(tcfg, shape, lr=lr)[0]
    new, state, m = fn(tp, AdamW(lr=lr).init(tp),
                       {k: torch.as_tensor(v) for k, v in batch.items()})
    assert leaf_rel_err(float(m["loss"]), float(jloss)) <= BF16_LLM_RTOL
    assert all(t.dtype == BF for t in _flat(new).values())
    assert all(t.dtype == torch.float32 for t in _flat(state.mu).values())
    assert_train_params_close(
        {k: _f(v) for k, v in _flat(new).items()},
        {k: _f(v) for k, v in _flat(jnew).items()},
        {k: _f(v) for k, v in _flat(jgrads).items()}, lr, 1,
        "bf16 train step vs JAX", rtol=BF16_LLM_RTOL)


# ---------------------------------------------------------------------------
# bf16 checkpoints
# ---------------------------------------------------------------------------
def test_bf16_checkpoint_restores_exactly_in_both_packages(tmp_path):
    cfg, jcfg = get_config("zamba2-7b-smoke"), jax_config("zamba2-7b-smoke")
    params = TT.init_params(cfg, 3, "cpu", BF)
    path = str(tmp_path / "bf16")
    checkpoint.save(path, params, hwio=False)
    with np.load(path + ".npz") as data:      # bf16 values as float32
        assert all(data[k].dtype == np.float32 for k in data.files)
    back = checkpoint.restore(path, TT.init_params(cfg, 4, "cpu", BF),
                              hwio=False)
    jlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         JT.init_params(jcfg, jax.random.PRNGKey(0),
                                        jnp.bfloat16))
    jback = _flat(jckpt.restore(path, jlike))
    want = _flat(params)
    for k, v in _flat(back).items():
        assert v.dtype == BF and torch.equal(v, want[k]), k
        assert jback[k].dtype == jnp.bfloat16, k
        assert np.array_equal(_f(jback[k]), _f(want[k])), k
    # and the JAX package's own bf16 file (its bf16 leaves as 2-byte
    # voids) comes back bit for bit
    jpath = str(tmp_path / "jax_bf16")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(5), jnp.bfloat16)
    jckpt.save(jpath, jparams)
    back = _flat(checkpoint.restore(jpath, params, hwio=False))
    for k, v in _flat(jax.tree.map(np.asarray, jparams)).items():
        assert back[k].dtype == BF and np.array_equal(_f(back[k]),
                                                      v.astype(np.float32)), k


def test_launcher_trains_bf16_parameters(tmp_path, capsys):
    path = str(tmp_path / "ckpt")
    launch_train.main(["--arch", "mamba2-2.7b-smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--log-every", "1", "--save", path])
    assert "step     1 loss" in capsys.readouterr().out
    with np.load(path + ".npz") as data:
        for k in data.files:
            # float32 values whose low 16 bits are zero: bf16 parameters
            bits = data[k].view(np.uint32)
            assert not (bits & 0xFFFF).any(), k


def test_roofline_charges_bf16_products_at_the_bf16_rate():
    from repro_torch.roofline.analysis import analyze_step
    from repro_torch.roofline.hw import H100
    b, s, h, d = 1, 1024, 8, 64
    cfg = get_config("qwen2-7b-smoke")
    shape = ShapeConfig("t", s, b, "prefill")
    meta = lambda *sh: torch.empty(sh, device="meta", dtype=BF)  # noqa: E731
    rep = analyze_step(lambda q, k, v: ops.flash_attention(q, k, v),
                       tuple(meta(b, s, h, d) for _ in range(3)), arch="t",
                       shape=shape,
                       cfg=cfg)
    pairs = b * h * s * (s + 1) // 2
    assert rep.compute_dtype == "bf16"
    assert rep.kernel_products == rep.kernel_products_bf16 == pairs * 4 * d
    assert rep.hlo_bytes == 4 * 2 * b * s * h * d         # bf16: 2 B each
    assert rep.t_compute == pytest.approx(
        pairs * 5 / H100.peak_flops_bf16
        + pairs * 4 * d / H100.peak_flops_bf16, rel=1e-12)
    # K8 on bf16 operands: C B^T (bf16 values, 2n a causal pair) at the
    # bf16 rate, its other products (one bf16 operand) as two TF32 ones
    x, B = meta(1, 256, 4, 64), meta(1, 256, 64)
    dt = torch.empty(1, 256, 4, device="meta")
    A = torch.empty(4, device="meta")
    rep = analyze_step(lambda *a: ops.ssd_scan(*a, chunk=64),
                       (x, dt, A, B, B), arch="t", shape=shape, cfg=cfg)
    cbt = 4 * 2 * 64 * 4 * (64 * 65 // 2)
    assert rep.kernel_products > rep.kernel_products_bf16 == cbt
    assert rep.kernel_products_tf32x2 == rep.kernel_products - cbt


def test_compute_dtype_is_read_when_a_step_is_made(monkeypatch):
    cfg = get_config("qwen2-7b-smoke")
    sh = ShapeConfig("t", 8, 1, "decode")
    _, args, _, _ = specs.make_step(cfg, sh)
    assert args[0]["final_norm"]["scale"].dtype == BF
    assert _flat(args[2])["/blocks/0/k"].dtype == BF
    monkeypatch.setattr(specs, "COMPUTE_DTYPE", torch.float32)
    _, args, _, _ = specs.make_step(cfg, sh)
    assert args[0]["final_norm"]["scale"].dtype == torch.float32
    assert specs.input_specs(cfg, dataclasses.replace(
        sh, mode="prefill"))["tokens"].dtype == torch.long
