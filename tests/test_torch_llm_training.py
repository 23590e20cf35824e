"""The port's LLM loss (``transformer.loss_fn``) against the JAX package on
the CPU: for every registry config at its ``-smoke`` size, the same JAX
``init_params`` weights (through ``llm_from_numpy_tree``), the same numpy
tokens, labels (some masked with -1) and, for a config with frontend
context, the same numpy embeddings go through ``jax.value_and_grad`` of the
reference's ``loss_fn`` (``impl="ref"``, no remat) and through the port's
``train_loop.llm_grads``.  Loss and every gradient leaf agree within
``LLM_GRAD_RTOL`` (``repro_torch.testing``) of their scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch import weights
from repro_torch.configs import ARCHS, get_config
from repro_torch.testing import LLM_GRAD_RTOL, leaf_rel_err, llm_batch
from repro_torch.training import train_loop

torch.set_num_threads(1)

ARCH_NAMES = sorted(ARCHS)


def flat(tree):
    """{path: numpy array} of a JAX or a port parameter tree."""
    return weights._flatten(tree, hwio=False)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_grads_match_jax(name):
    jcfg = jax_config(name).reduced()
    tcfg = get_config(name).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    batch = llm_batch(tcfg, 2, 24, seed=3)

    def jloss(p, b):
        return JT.loss_fn(jcfg, p, b, remat=False)

    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    (total, parts), grads = train_loop.llm_grads(
        tcfg, tp, train_loop.to_device(batch, "cpu"), remat=False)
    assert ("ctx_embed" in batch) == bool(tcfg.num_ctx_tokens)
    assert leaf_rel_err(float(total), float(jtotal)) <= LLM_GRAD_RTOL
    assert leaf_rel_err(float(parts["aux"]), float(jparts["aux"])) \
        <= LLM_GRAD_RTOL
    want, got = flat(jgrads), flat(grads)
    assert got.keys() == want.keys()
    errs = {k: leaf_rel_err(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LLM_GRAD_RTOL, (worst, errs[worst])
    assert all(np.abs(want[k]).max() > 0 for k in want if "bias" not in k)
