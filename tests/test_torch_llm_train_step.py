"""The port's LLM training step on the CPU against the JAX package:
``make_train_step`` over a few steps from JAX's init against the
reference's jitted step; ``train_llm``; remat; the microbatched
``launch.specs.make_step``; and the ``launch.train`` launcher (the VJPs
behind K6 and K8 are in tests/test_torch_llm_vjp.py).

Tolerances (``repro_torch.testing``): ``LLM_GRAD_RTOL`` for losses and
gradients through a model, ``assert_train_params_close`` at
``LLM_GRAD_RTOL`` for parameters after a few steps."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.testing import (BF16_LLM_RTOL, LLM_GRAD_RTOL,
                                 assert_train_params_close, leaf_rel_err,
                                 llm_batch)
from repro_torch.training import checkpoint, data, train_loop
from repro_torch.training.optimizer import AdamW, tree_leaves

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def flat(tree):
    return weights._flatten(tree, hwio=False)


# ---------------------------------------------------------------------------
# steps, loops, remat, microbatching
# ---------------------------------------------------------------------------
def _models(name):
    jcfg = jax_config(name).reduced()
    tcfg = get_config(name).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, weights.llm_from_numpy_tree(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name, steps", [("qwen2-7b", 3), ("mamba2-2.7b", 3),
                                         ("zamba2-7b", 1)])
def test_train_steps_match_jax(name, steps):
    # AdamW with eps = 1: Adam's first steps move an entry by about
    # lr * sign(g), which turns the float noise of a gradient that is zero
    # but for rounding (qwen2's key bias: softmax ignores a per-row
    # constant) into lr-sized parameter differences, and zamba2-smoke's
    # loss is steep enough (gradient norm ~3.6e3) that such differences
    # move the next gradients by tens of percent.  With eps = 1 the
    # clipped update stays linear in the gradient, so the comparison
    # measures the steps' arithmetic.  Even so zamba2-smoke's steep loss
    # carries float32 differences to the edge of LLM_GRAD_RTOL within
    # three steps: it is held over one, K6 and K8 over three in qwen2 and
    # mamba2
    jcfg, tcfg, jp, tp = _models(name)
    lr = 1e-3
    jopt_, topt = jopt.AdamW(lr=lr, eps=1.0), AdamW(lr=lr, eps=1.0)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt_, remat=False))
    tstep = train_loop.make_train_step(tcfg, topt, remat=False)
    jstate, tstate = jopt_.init(jp), topt.init(tp)
    stream = iter(data.TokenStream(tcfg.vocab_size, 24, 2, 0))
    first = None
    for _ in range(steps):
        batch = next(stream)
        if first is None:
            first = flat(train_loop.llm_grads(
                tcfg, tp, train_loop.to_device(batch, "cpu"),
                remat=False)[1])
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        tp, tstate, tm = tstep(tp, tstate, train_loop.to_device(batch, "cpu"))
        assert tm.keys() == jm.keys() == {"loss", "ce", "aux", "grad_norm"}
        for key in tm:
            assert leaf_rel_err(float(tm[key]), float(jm[key])) \
                <= LLM_GRAD_RTOL, key
    assert int(tstate.step) == steps
    assert_train_params_close(flat(tp), flat(jp), first, lr, steps, name,
                              rtol=LLM_GRAD_RTOL)


def test_train_llm_loss_decreases():
    # the twin of tests/test_training.py::test_train_llm_loss_decreases
    cfg = get_config("qwen2-7b").reduced()
    _, hist = train_loop.train_llm(cfg, steps=30, batch_size=4, seq_len=32,
                                   lr=3e-3, log_every=29, device="cpu")
    assert [h["step"] for h in hist] == [0, 29]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2, hist


def test_train_llm_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop.train_llm(get_config("qwen2-7b").reduced(), steps=1,
                             batch_size=1, seq_len=8)


@pytest.mark.parametrize("name", ["zamba2-7b", "deepseek-v2-lite-16b",
                                  "musicgen-medium"])
def test_remat_equals_no_remat(name):
    cfg = get_config(name).reduced()
    params = TT.init_params(cfg, 0, "cpu")
    batch = train_loop.to_device(llm_batch(cfg, 2, 24, seed=5), "cpu")
    (l0, p0), g0 = train_loop.llm_grads(cfg, params, batch, remat=False)
    (l1, p1), g1 = train_loop.llm_grads(cfg, params, batch, remat=True)
    assert torch.equal(l0, l1) and torch.equal(p0["aux"], p1["aux"])
    f0, f1 = flat(g0), flat(g1)
    assert f0.keys() == f1.keys()
    for k in f0:
        np.testing.assert_array_equal(f1[k], f0[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_microbatched_step_matches_one_batch_and_jax_mean_of_grads(
        monkeypatch, dtype):
    # make_step at its compute dtype: float32 (set here) on float32
    # parameters within LLM_GRAD_RTOL, or bfloat16 (the reference's) on
    # the JAX package's bf16 parameters within BF16_LLM_RTOL, against the
    # reference's accumulation at the same dtype
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    rtol = LLM_GRAD_RTOL if dtype == "float32" else BF16_LLM_RTOL
    monkeypatch.setattr(specs, "COMPUTE_DTYPE", tdtype)
    jcfg = jax_config("qwen2-7b").reduced()
    tcfg = get_config("qwen2-7b").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jdtype)
    tp = weights.llm_from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu",
                                     tdtype)
    shape = ShapeConfig("t", 32, 8, "train")
    lr = 1e-3
    batch = next(iter(data.TokenStream(tcfg.vocab_size, 32, 8, 0)))
    tbatch = train_loop.to_device(batch, "cpu")
    state = AdamW(lr=lr).init(tp)
    out = {k: specs.make_step(tcfg, shape, lr=lr, microbatch=k)[0](
        tp, state, tbatch) for k in (1, 4)}
    (p1, _, m1), (p4, s4, m4) = out[1], out[4]
    assert m4["ce"] is m4["loss"] and float(m4["aux"]) == 0.0
    assert set(m1) == {"loss", "ce", "aux"}
    assert leaf_rel_err(float(m4["loss"]), float(m1["loss"])) <= rtol
    assert all(t.dtype == tdtype for t in tree_leaves(p4))
    grads = flat(train_loop.llm_grads(tcfg, tp, tbatch, dtype=tdtype)[1])
    assert_train_params_close(flat(p4), flat(p1), grads, lr, 1,
                              "microbatch 4 vs 1", rtol=rtol)
    # the reference's accumulation by hand: the mean of the microbatches'
    # float32 gradients, then one AdamW update
    acc, total = None, 0.0
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, mb: JT.loss_fn(jcfg, p, mb, remat=True, dtype=jdtype),
        has_aux=True))
    for j in range(4):
        mb = {k: jnp.asarray(v[2 * j:2 * j + 2]) for k, v in batch.items()}
        (loss, _), g = grad_fn(jp, mb)
        g = jax.tree.map(lambda x: x.astype(jnp.float32) / 4, g)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        total += float(loss) / 4
    jopt_ = jopt.AdamW(lr=lr)
    jp4, _ = jopt_.update(acc, jopt_.init(jp), jp)
    assert leaf_rel_err(float(m4["loss"]), total) <= rtol
    assert_train_params_close(flat(p4), flat(jp4), flat(acc), lr, 1,
                              "microbatch 4 vs JAX", rtol=rtol)
    assert int(s4.step) == 1


def test_make_step_leaves_prefill_and_decode_to_the_pod_tooling():
    # the pod tooling (launch/specs.py, M12) now builds every mode's step
    # as the reference's (fn, abstract_args, in_specs, out_specs); only a
    # mesh past one card raises
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("qwen2-7b").reduced()
    for mode, n_args in (("train", 3), ("prefill", 2), ("decode", 4)):
        fn, args, in_specs, out_specs = specs.make_step(
            cfg, ShapeConfig("x", 8, 1, mode))
        assert callable(fn) and len(args) == len(in_specs) == n_args
        assert all(t.is_meta for t in args[0].values()
                   if isinstance(t, torch.Tensor))
    pod = Mesh(("data", "model"), (16, 16), ("tpu",) * 256)
    with pytest.raises(NotImplementedError, match="one card"):
        specs.make_step(cfg, ShapeConfig("x", 8, 1, "train"), mesh=pod)


def test_arch_for_shape_slides_long_context_only():
    cfg = get_config("qwen2-7b")
    long = ShapeConfig("long_500k", 524288, 1, "decode")
    slid = specs.arch_for_shape(cfg, long)
    assert slid.name == "qwen2-7b+sliding" and slid.sliding_window == 8192
    assert set(slid.block_pattern) == {"local"}
    assert specs.arch_for_shape(cfg, ShapeConfig("t", 8, 1, "train")) is cfg
    ssm = get_config("mamba2-2.7b")
    assert specs.arch_for_shape(ssm, long) is ssm


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_on_the_cpu_and_saves_a_jax_readable_checkpoint(
        tmp_path, capsys):
    path = str(tmp_path / "ckpt")
    launch_train.main(["--arch", "deepseek-v2-lite-16b-smoke", "--device",
                       "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--log-every", "1", "--microbatch", "2", "--save",
                       path])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    like = TT.init_params(cfg, 1, "cpu")
    back = checkpoint.restore(path, like, hwio=False)
    # the MoE experts' 4-d leaves keep their layout in both packages
    jcfg = jax_config("deepseek-v2-lite-16b-smoke")
    jlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         JT.init_params(jcfg, jax.random.PRNGKey(0)))
    jback = flat(jckpt.restore(path, jlike))
    got = flat(back)
    assert got.keys() == jback.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], jback[k], err_msg=k)
    assert checkpoint.load_metadata(path) == {
        "arch": "deepseek-v2-lite-16b-smoke", "steps": 2}


def test_launcher_module_runs_with_ctx_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "musicgen-medium-smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "training musicgen-medium-smoke" in run.stdout
    assert "step     1 loss" in run.stdout


def test_launcher_refuses_what_it_cannot_run(monkeypatch):
    # the production meshes raise through launch.mesh (one card)
    for mesh, chips in (("pod", 256), ("multipod", 512)):
        with pytest.raises(NotImplementedError, match=f"{chips} chips"):
            launch_train.main(["--arch", "qwen2-7b-smoke", "--mesh", mesh,
                               "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "qwen2-7b-smoke", "--steps", "1"])
