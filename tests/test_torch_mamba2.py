"""mamba2-2.7b's own widths on the CPU, the port against the JAX package:
K8's plain version (the kernel's CPU path) at p 64, n 128 and chunk 256
against the Pallas kernel in interpret mode and against ``ref.ssd_scan``,
in float32 and on bf16 x, B and C; then a two-layer cut of the full-width
config (d_model 2560, 80 SSM heads, vocabulary 50280) on the JAX package's
own weights (``weights.llm_from_numpy_tree``): the prefill logits and one
decode step at 1 x 300 tokens, and the caches they leave.  The ``-smoke``
config cuts n to 16, p to 32 and the chunk to 32, so the other files never
reach these widths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models import transformer as JT
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from repro_torch.testing import (LLM_RTOL, SSD_BF16_RTOL, SSD_RTOL,
                                 bf16_err, rel_err, ssd_case)

torch.set_num_threads(1)

# (b, s, h, p, n, chunk): mamba2-2.7b's p, n and chunk over 4 heads; 300
# steps are one full chunk and a partial one of 44
MAMBA2_SSD = (1, 300, 4, 64, 128, 256)
CUT_LAYERS = 2
PROMPT = 300


def _f(x) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True], ids=["zero_state",
                                                     "initial_state"])
def test_ssd_scan_plain_matches_jax_at_mamba2_widths(dtype, init):
    # x, B and C in ``dtype`` (bf16: the same round-to-nearest bits on both
    # sides), dt, A and the states float32, as the Mamba2 layer passes them;
    # y is held to SSD_BF16_RTOL of its row's largest value in bf16 (one
    # rounding of the output past SSD_RTOL) and the float32 final state to
    # SSD_RTOL of its scale
    b, s, h, p, n, chunk = MAMBA2_SSD
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, init, weak=True)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx, jB, jC = (jnp.asarray(a).astype(jdt) for a in (x, B, C))
    tx, tB, tC = (torch.as_tensor(a).to(tdt) for a in (x, B, C))
    jst = None if st is None else jnp.asarray(st)
    want = {"pallas": jssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                           chunk=chunk, initial_state=jst, interpret=True),
            "ref": jref.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB,
                                 jC, chunk=chunk, initial_state=jst)}
    y, fin = ops.ssd_scan(tx, torch.as_tensor(dt), torch.as_tensor(A), tB,
                          tC, chunk=chunk,
                          initial_state=None if st is None
                          else torch.as_tensor(st))
    assert y.dtype == tdt and fin.dtype == torch.float32
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    for what, (want_y, want_fin) in want.items():
        if dtype == "bfloat16":
            err = bf16_err(_f(y), _f(want_y))
            assert err <= SSD_BF16_RTOL, (what, err)
        else:
            err = rel_err(_f(y), _f(want_y))
            assert err <= SSD_RTOL, (what, err)
        err = rel_err(_f(fin), _f(want_fin))
        assert err <= SSD_RTOL, (what, "final state", err)


@pytest.fixture(scope="module")
def mamba2_cut():
    """mamba2-2.7b at full width cut to CUT_LAYERS Mamba2 layers, the JAX
    package's float32 weights on both sides, and the JAX and port prefill
    of one PROMPT-token prompt into a fresh cache."""
    jcfg = jax_config("mamba2-2.7b")
    jcfg = dataclasses.replace(jcfg, name=f"{jcfg.name}-{CUT_LAYERS}-layers",
                               num_layers=CUT_LAYERS, num_blocks=CUT_LAYERS)
    tcfg = get_config("mamba2-2.7b")
    tcfg = dataclasses.replace(tcfg, name=jcfg.name, num_layers=CUT_LAYERS,
                               num_blocks=CUT_LAYERS)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (1, PROMPT)).astype(np.int32)
    max_seq = PROMPT + 4
    jl, jc = jax.jit(lambda p, t, c: JT.prefill(jcfg, p, t, c))(
        jp, jnp.asarray(toks), JT.init_cache(jcfg, 1, max_seq))
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, tp, torch.as_tensor(toks),
                            TT.init_cache(tcfg, 1, max_seq, "cpu"))
    return jcfg, tcfg, jp, tp, (jl, jc), (tl, tc)


def test_mamba2_cut_keeps_the_full_widths(mamba2_cut):
    jcfg, tcfg, *_ = mamba2_cut
    assert (tcfg.d_model, tcfg.n_ssm_heads, tcfg.ssm_head_dim,
            tcfg.ssm_state, tcfg.ssm_chunk, tcfg.vocab_size) == \
        (2560, 80, 64, 128, 256, 50280)
    assert (jcfg.d_model, jcfg.ssm_state, jcfg.ssm_chunk, jcfg.vocab_size) \
        == (2560, 128, 256, 50280)
    assert tcfg.num_layers == jcfg.num_layers == CUT_LAYERS


def test_mamba2_cut_prefill_matches_jax_at_full_width(mamba2_cut):
    # 300 tokens: one full 256-step chunk and a partial one in each layer's
    # scan; the logits of the last position and the SSM states and conv
    # windows the layers leave in the cache (stacked, a row a layer),
    # within LLM_RTOL of their scale
    _, tcfg, _, _, (jl, jc), (tl, tc) = mamba2_cut
    assert tl.shape == (1, tcfg.padded_vocab)
    assert rel_err(_f(tl), _f(jl)) <= LLM_RTOL
    flat_j = jax.tree_util.tree_flatten_with_path(jc)[0]
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(tc)[0]}
    assert len(flat_j) == len(flat_t) == 2   # state, conv: a row a layer
    for path, a in flat_j:
        got = flat_t[jax.tree_util.keystr(path)]
        assert tuple(got.shape) == a.shape and a.shape[0] == CUT_LAYERS, path
        assert rel_err(_f(got), _f(a)) <= LLM_RTOL, path


def test_mamba2_cut_decode_step_matches_jax_at_full_width(mamba2_cut):
    # one decode step after the prefill (the recurrent ssd_step and the
    # rolled conv window), the JAX package's greedy token as its input
    jcfg, tcfg, jp, tp, (jl, jc), (tl, tc) = mamba2_cut
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jd, _ = jax.jit(lambda p, t, c, i: JT.decode_step(jcfg, p, t, c, i))(
        jp, jnp.asarray(nxt), jc, jnp.int32(PROMPT))
    with torch.no_grad():
        td, _ = TT.decode_step(tcfg, tp, torch.as_tensor(nxt), tc,
                               torch.tensor(PROMPT))
    assert td.shape == (1, 1, tcfg.padded_vocab)
    assert rel_err(_f(td[:, 0]), _f(jd[:, 0])) <= LLM_RTOL
