"""The port's big/little LLM cascade (``repro_torch.core.cascade``) against
the JAX package's on a reduced ``zamba2-7b``: the same JAX ``init_params``
weights (a little and a big model from two seeds, converted with
``llm_from_numpy_tree``) and the same numpy tokens through ``answer`` at
three escalation thresholds (all escalate, none, about half), then a second
``answer`` with the learned logit bias applied.  The port's forward takes
only the last position (``last_token_only``); the reference runs the full
forward and reads ``[:, -1]``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.cascade import BigLittleCascade as JCascade
from repro.core.cascade import CascadeConfig as JCascadeConfig
from repro.models import transformer as JT
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.core.cascade import (BigLittleCascade, CascadeConfig,
                                      CascadeStats)
from repro_torch.testing import LLM_RTOL, THRESHOLD_TIE, rel_err

torch.set_num_threads(1)

ARCH = "zamba2-7b"
BATCH, SEQ = 6, 40                    # past one 32-token SSM chunk


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config(ARCH).reduced()
    little = JT.init_params(jcfg, jax.random.PRNGKey(0))
    big = JT.init_params(jcfg, jax.random.PRNGKey(1))
    port = [weights.llm_from_numpy_tree(jax.tree.map(np.asarray, p), "cpu")
            for p in (little, big)]
    fwd = jax.jit(lambda p, t: JT.forward(jcfg, p, t)[0][:, -1])
    return jcfg, get_config(ARCH).reduced(), (little, big), port, fwd


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)


def _top2_tie(logits):
    """Rows whose top-2 logit gap lies within LLM_RTOL of the scale."""
    scale = max(1.0, float(np.abs(logits).max()))
    top2 = np.sort(logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < LLM_RTOL * scale


def _threshold(models, which):
    jcfg, _, (little, _), _, fwd = models
    if which == "all":
        return 1.1
    if which == "none":
        return 0.0
    logits = np.asarray(fwd(little, jnp.asarray(_tokens(jcfg, 1))))
    conf = np.asarray(jax.nn.softmax(logits, -1)).max(-1)
    return float(np.median(conf))


def _answer_both(models, jc, tc, toks):
    """One ``answer`` on both cascades; asserts predictions, confidences and
    the escalation mask agree, exempting top-2 ties and confidences within
    THRESHOLD_TIE of the threshold.  Returns the two masks."""
    jcfg, _, (little, big), _, fwd = models
    lil = np.asarray(fwd(little, jnp.asarray(toks))) + np.asarray(
        jc.logit_bias)
    big_tie = _top2_tie(np.asarray(fwd(big, jnp.asarray(toks))))
    jpred, jinfo = jc.answer(toks)
    tpred, tinfo = tc.answer(toks)
    np.testing.assert_allclose(tinfo["confidence"], jinfo["confidence"],
                               rtol=LLM_RTOL)
    near = np.abs(jinfo["confidence"] - jc.ccfg.escalate_below) \
        <= THRESHOLD_TIE
    esc_j, esc_t = jinfo["escalated"], tinfo["escalated"]
    assert not ((esc_j != esc_t) & ~near).any()
    tie = near | np.where(esc_j, big_tie, _top2_tie(lil))
    assert not ((jpred != tpred) & ~tie).any()
    return esc_j, esc_t, tie


@pytest.mark.parametrize("which", ["all", "none", "middle"])
def test_cascade_matches_jax(models, which):
    jcfg, tcfg, (little, big), (tlittle, tbig), _ = models
    thr = _threshold(models, which)
    jc = JCascade(jcfg, little, jcfg, big,
                  JCascadeConfig(escalate_below=thr))
    tc = BigLittleCascade(tcfg, tlittle, tcfg, tbig,
                          CascadeConfig(escalate_below=thr), device="cpu")
    toks = _tokens(jcfg, 1)
    esc_j, esc_t, tie = _answer_both(models, jc, tc, toks)
    if which == "all":
        assert esc_t.all()
    elif which == "none":
        assert not esc_t.any()
    else:
        assert 0 < esc_t.sum() < BATCH
    # the learned bias, then a second answer that applies it
    assert tc.logit_bias.shape == (tcfg.vocab_size,)
    assert tc.logit_bias.dtype == torch.float32
    assert rel_err(tc.logit_bias.numpy(), np.asarray(jc.logit_bias)) \
        <= LLM_RTOL
    esc2_j, esc2_t, tie2 = _answer_both(models, jc, tc, _tokens(jcfg, 2))
    assert rel_err(tc.logit_bias.numpy(), np.asarray(jc.logit_bias)) \
        <= LLM_RTOL
    if not (tie.any() or tie2.any()):
        assert (tc.stats.fog_answered, tc.stats.escalated,
                tc.stats.adapter_updates) == (
            jc.stats.fog_answered, jc.stats.escalated,
            jc.stats.adapter_updates)
        assert tc.stats.agreement == jc.stats.agreement
    assert tc.stats.escalation_rate == pytest.approx(
        tc.stats.escalated / (2 * BATCH))


def test_update_adapter_is_the_proximal_step():
    # b <- decay * b - eta * (softmax(logits) - onehot(label)), in float32
    cfg = get_config(ARCH).reduced()
    tc = BigLittleCascade(cfg, None, cfg, None,
                          CascadeConfig(eta=0.5, adapter_decay=0.9),
                          device="cpu")
    rng = np.random.default_rng(0)
    bias = rng.normal(size=cfg.vocab_size).astype(np.float32)
    logits = rng.normal(size=cfg.vocab_size).astype(np.float32)
    tc.logit_bias = torch.as_tensor(bias)
    tc.update_adapter(torch.as_tensor(logits), 7)
    want = np.asarray(0.9 * jnp.asarray(bias) - 0.5 * (
        jax.nn.softmax(jnp.asarray(logits)) - jax.nn.one_hot(7, bias.size)))
    np.testing.assert_allclose(tc.logit_bias.numpy(), want, rtol=1e-6,
                               atol=1e-7)
    assert tc.stats.adapter_updates == 1


def test_cascade_stats_rate_and_device():
    assert CascadeStats().escalation_rate == 0.0
    assert CascadeStats(fog_answered=3, escalated=1).escalation_rate == 0.25
    if not torch.cuda.is_available():
        cfg = get_config(ARCH).reduced()
        with pytest.raises(RuntimeError, match="cuda"):
            BigLittleCascade(cfg, None, cfg, None)
