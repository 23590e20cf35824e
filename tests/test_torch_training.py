"""The port's video-model training (``repro_torch.training``, the losses in
``repro_torch.models``) against the JAX package on the CPU: the same
numpy-seeded inputs and the same initial weights through both.

Tolerances: the optimizers' elementwise float32 arithmetic is the
reference's op for op, so only a transcendental's last bit may differ
(``OPT_RTOL``); the data generators are numpy on both sides and bit-equal;
losses, gradients and trained parameters follow ``TRAIN_RTOL``
(``repro_torch.testing``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.vpaas_video import CLASSIFIER as J_CLF
from repro.configs.vpaas_video import DETECTOR as J_DET
from repro.configs.vpaas_video import FALLBACK_DETECTOR as J_FB
from repro.configs.vpaas_video import ClassifierConfig as JClfConfig
from repro.configs.vpaas_video import DetectorConfig as JDetConfig
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.video import codec as jcodec
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import classifier as tclf
from repro_torch.models import detector as tdet
from repro_torch.testing import (TRAIN_RTOL, CodecTap,
                                 assert_train_params_close, leaf_rel_err)
from repro_torch.training import checkpoint, data, optimizer, train_loop

torch.set_num_threads(1)

# the optimizers, op for op: float32 elementwise arithmetic in the same
# order; pow, sqrt and cos may round their last bit differently
OPT_RTOL = 1e-6

# reduced configs for the training loops (the loss tests run full width)
J_SMALL_DET = JDetConfig(name="torch-test-det", image_hw=(32, 32),
                         widths=(8, 16))
T_SMALL_DET = tcfg.DetectorConfig(name="torch-test-det", image_hw=(32, 32),
                                  widths=(8, 16))
J_SMALL_CLF = JClfConfig(name="torch-test-clf", crop_hw=(16, 16),
                         widths=(8, 16), feature_dim=16)
T_SMALL_CLF = tcfg.ClassifierConfig(name="torch-test-clf", crop_hw=(16, 16),
                                    widths=(8, 16), feature_dim=16)


def _np(t):
    return t.detach().cpu().numpy()


def _flat_j(tree):
    return jckpt._flatten(tree)


def _assert_flat_close(got, want, rtol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].shape == want[k].shape, f"{what} {k}"
        err = leaf_rel_err(got[k], want[k])
        assert err <= rtol, f"{what} {k}: {err:.2e} of its scale"


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_tree(rng):
    return {"conv0": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)},
            "W": rng.normal(size=(5, 3)).astype(np.float32)}


OPT_CASES = {
    "adamw-clip-active": lambda m: m.AdamW(lr=0.05, grad_clip=0.5),
    "adamw-no-clip": lambda m: m.AdamW(lr=0.05, grad_clip=None,
                                       weight_decay=0.0),
    "adamw-clip-inactive-wd": lambda m: m.AdamW(lr=0.05, grad_clip=1e6,
                                                weight_decay=0.1),
    "adamw-cosine-lr": lambda m: m.AdamW(
        lr=m.cosine_schedule(0.1, warmup=2, total=5), weight_decay=0.01),
    "adamw-constant-lr": lambda m: m.AdamW(lr=m.constant_schedule(0.02)),
    "sgdm": lambda m: m.SGDM(lr=0.05),
    "sgdm-cosine-lr": lambda m: m.SGDM(
        lr=m.cosine_schedule(0.1, warmup=1, total=5), momentum=0.8),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_jax_over_five_steps(case):
    rng = np.random.default_rng(11)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(5)]
    j_opt, t_opt = OPT_CASES[case](jopt), OPT_CASES[case](optimizer)
    jp = jax.tree.map(jnp.asarray, params)
    tp = weights.from_numpy_tree(params, "cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for g in grads:
        jp, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = t_opt.update(weights.from_numpy_tree(g, "cpu"), ts, tp)
    _assert_flat_close(weights._flatten(tp), _flat_j(jp), OPT_RTOL, case)
    # the state too: step, first and (AdamW) second moments, through the
    # checkpoint format's keys
    _assert_flat_close(weights._flatten(ts), _flat_j(js), OPT_RTOL,
                       f"{case} state")
    assert int(ts.step) == 5 and ts.step.dtype == torch.int32


def test_global_norm_matches_jax():
    tree = _opt_tree(np.random.default_rng(2))
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = optimizer.global_norm(weights.from_numpy_tree(tree, "cpu"))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=OPT_RTOL)


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1), (0, 7, 0.0),
                                                (3, 3, 0.5)])
def test_schedules_match_jax_at_every_step(warmup, total, floor):
    j_fn = jopt.cosine_schedule(0.3, warmup, total, floor)
    t_fn = optimizer.cosine_schedule(0.3, warmup, total, floor)
    for step in range(total + 1):
        want = float(j_fn(jnp.asarray(step, jnp.int32)))
        got = float(t_fn(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=OPT_RTOL, abs=1e-9), step
        assert float(optimizer.constant_schedule(0.3)(torch.tensor(step))) \
            == float(jopt.constant_schedule(0.3)(jnp.asarray(step)))


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = optimizer.AdamW(lr=0.1, weight_decay=0.0)
    state = opt.init(params)
    for _ in range(200):
        grads = torch.func.grad(lambda p: torch.sum(p["w"] ** 2))(params)
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = optimizer.AdamW(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    huge = {"w": torch.full((4,), 1e6)}
    norm = float(optimizer.global_norm(huge))
    assert norm * min(1.0, 1e-3 / norm) <= 1e-3 + 1e-9
    p2, state = opt.update(huge, opt.init(params), params)
    assert torch.isfinite(p2["w"]).all()
    # the clipped gradient is what the first moment keeps
    assert float(optimizer.global_norm(state.mu)) == pytest.approx(
        0.1 * 1e-3, rel=1e-5)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _assert_batches_equal(got, want, n, what):
    for i in range(n):
        g, w = next(got), next(want)
        assert g.keys() == w.keys(), what
        for k in w:
            assert g[k].dtype == w[k].dtype, f"{what} {k}"
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


def test_token_stream_and_batch_for_match_jax():
    for seed in (0, 3):
        _assert_batches_equal(
            iter(data.TokenStream(64, 16, 4, seed, branching=4)),
            iter(jdata.TokenStream(64, 16, 4, seed, branching=4)), 3,
            f"tokens {seed}")
    _assert_batches_equal(
        iter([data.batch_for(t_get_config("qwen2-7b").reduced(), 2, 8, 1)]),
        iter([jdata.batch_for(j_get_config("qwen2-7b").reduced(), 2, 8, 1)]),
        1, "batch_for")


@pytest.mark.parametrize("cfg,content", [(tcfg.DETECTOR, "traffic"),
                                         (tcfg.FALLBACK_DETECTOR, "all")])
def test_detector_batches_match_jax(cfg, content):
    jcfg = J_DET if cfg is tcfg.DETECTOR else J_FB
    _assert_batches_equal(data.detector_batches(cfg, 5, 4, content),
                          jdata.detector_batches(jcfg, 5, 4, content), 2,
                          f"{cfg.name} {content}")


@pytest.mark.parametrize("drift,jitter", [(0.0, 0.1), (0.7, 0.1),
                                          (0.0, 0.0)])
def test_classifier_batches_match_jax(drift, jitter):
    _assert_batches_equal(
        data.classifier_batches(tcfg.CLASSIFIER, 12, 9, drift=drift,
                                box_jitter=jitter),
        jdata.classifier_batches(J_CLF, 12, 9, drift=drift,
                                 box_jitter=jitter), 2,
        f"crops drift {drift} jitter {jitter}")


def test_bilinear_resize_matches_jax():
    rng = np.random.default_rng(4)
    for shape, out in (((7, 5, 3), (16, 16)), ((2, 2, 3), (40, 40)),
                       ((33, 20, 3), (8, 12))):
        img = rng.random(shape, dtype=np.float32)
        got = data.bilinear_resize(img, out)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jdata.bilinear_resize(img, out))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _shared_cells(cfg, batch) -> int:
    gh, gw = cfg.grid_hw
    b = batch["gt_boxes"]
    cx, cy = (b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2
    cell = (np.clip((cy * gh).astype(np.int32), 0, gh - 1) * gw
            + np.clip((cx * gw).astype(np.int32), 0, gw - 1))
    return sum(int((batch["gt_labels"][r] >= 0).sum())
               - len(set(cell[r][batch["gt_labels"][r] >= 0].tolist()))
               for r in range(cell.shape[0]))


def _batch_with_shared_cells(cfg, batch_size, seed):
    """The first batch of a seeded stream in which gts share a cell."""
    gen = data.detector_batches(cfg, batch_size, seed, "all")
    for _ in range(20):
        batch = next(gen)
        if _shared_cells(cfg, batch):
            return batch
    raise AssertionError("no batch with shared cells in 20")


DETECTORS = {"detector": (tcfg.DETECTOR, J_DET),
             "fallback": (tcfg.FALLBACK_DETECTOR, J_FB)}


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_cell_targets_keep_the_last_gt_of_a_shared_cell_as_jax(name):
    """The reference's targets are a `.at[...].set(mode="drop")` scatter:
    on XLA's CPU backend the last of several gts in one cell wins."""
    cfg, jcfg = DETECTORS[name]
    batch = _batch_with_shared_cells(cfg, 8, 1)
    n = cfg.grid_hw[0] * cfg.grid_hw[1]
    gt_boxes, gt_labels = (jnp.asarray(batch[k])
                           for k in ("gt_boxes", "gt_labels"))
    gh, gw = jcfg.grid_hw
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    cell = (jnp.clip((cy * gh).astype(jnp.int32), 0, gh - 1) * gw
            + jnp.clip((cx * gw).astype(jnp.int32), 0, gw - 1))
    cell = jnp.where(gt_labels >= 0, cell, n)
    rows = jnp.arange(8)[:, None]
    want_obj = jnp.zeros((8, n + 1)).at[rows, cell].set(1.0, mode="drop")
    want_box = jnp.zeros((8, n + 1, 4)).at[rows, cell].set(gt_boxes,
                                                           mode="drop")
    want_lab = jnp.zeros((8, n + 1), jnp.int32).at[rows, cell].set(
        jnp.maximum(gt_labels, 0), mode="drop")
    obj, box, lab = tdet.cell_targets(
        cfg, n, torch.as_tensor(batch["gt_boxes"]),
        torch.as_tensor(batch["gt_labels"]))
    np.testing.assert_array_equal(_np(obj), np.asarray(want_obj[:, :n]))
    np.testing.assert_array_equal(_np(box), np.asarray(want_box[:, :n]))
    np.testing.assert_array_equal(_np(lab), np.asarray(want_lab[:, :n]))
    # the first writer would have given other targets: the case is real
    assert _shared_cells(cfg, batch) > 0


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_loss_and_grads_match_jax(name):
    cfg, jcfg = DETECTORS[name]
    batch = _batch_with_shared_cells(cfg, 8, 5)
    jp = jdet.init_detector(jcfg, jax.random.PRNGKey(2))

    def jloss(p):
        return jdet.detector_loss(jcfg, p, *(jnp.asarray(batch[k]) for k in
                                             ("images", "gt_boxes",
                                              "gt_labels")))

    (jl, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tg, (tl, tparts) = train_loop.detector_grads(
        cfg, weights.from_numpy_tree(jp, "cpu"),
        train_loop.to_device(batch, "cpu"))
    assert float(tl) == pytest.approx(float(jl), rel=TRAIN_RTOL)
    assert tparts.keys() == jparts.keys()
    for k in jparts:
        assert float(tparts[k]) == pytest.approx(float(jparts[k]),
                                                 rel=TRAIN_RTOL), k
    # conv gradients compared in the reference's HWIO layout
    _assert_flat_close(weights._flatten(tg), _flat_j(jg), TRAIN_RTOL,
                       f"{name} grads")


def test_classifier_loss_and_grads_match_jax():
    batch = next(data.classifier_batches(tcfg.CLASSIFIER, 16, 3))
    jp = jclf.init_classifier(J_CLF, jax.random.PRNGKey(4))

    def jloss(p):
        return jclf.classifier_loss(J_CLF, p, jnp.asarray(batch["crops"]),
                                    jnp.asarray(batch["labels"]))

    (jl, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tg, (tl, tparts) = train_loop.classifier_grads(
        tcfg.CLASSIFIER, weights.from_numpy_tree(jp, "cpu"),
        train_loop.to_device(batch, "cpu"))
    assert float(tl) == pytest.approx(float(jl), rel=TRAIN_RTOL)
    assert float(tparts["acc"]) == float(jparts["acc"])
    _assert_flat_close(weights._flatten(tg), _flat_j(jg), TRAIN_RTOL,
                       "classifier grads")


def test_classifier_loss_does_not_run_the_readout_kernel(monkeypatch):
    """The loss takes x @ W itself: K3 (``ops.onevsall_scores``) is a
    forward-only kernel."""
    from repro_torch.kernels import ops

    def forbidden(*a, **k):
        raise AssertionError("classifier_loss called onevsall_scores")

    monkeypatch.setattr(ops, "onevsall_scores", forbidden)
    params = weights.init_classifier(T_SMALL_CLF,
                                     torch.Generator().manual_seed(0), "cpu")
    batch = next(data.classifier_batches(T_SMALL_CLF, 4, 0))
    loss, _ = tclf.classifier_loss(T_SMALL_CLF, params,
                                   torch.as_tensor(batch["crops"]),
                                   torch.as_tensor(batch["labels"]))
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# training loops: 3 steps from the JAX package's initial parameters
# ---------------------------------------------------------------------------
def _jax_codec_frames(kind, frames, r, q, i):
    return np.asarray(getattr(jcodec, kind)(
        jnp.asarray(frames.cpu().numpy()), r, q).frames)


def _check_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=TRAIN_RTOL), (g, w)


def _start_from(monkeypatch, name, tree):
    """The loop's seeded init replaced by the JAX package's parameters."""
    monkeypatch.setattr(weights, name, lambda cfg, gen, device:
                        weights.from_numpy_tree(tree, device))
    return weights.from_numpy_tree(tree, "cpu")


@pytest.mark.parametrize("degrade", [False, True])
def test_train_detector_matches_jax(degrade, monkeypatch):
    kw = dict(steps=3, batch_size=4, seed=3, degrade=degrade)
    jp, jhist = jtl.train_detector(J_SMALL_DET, **kw)
    init = _start_from(monkeypatch, "init_detector", jdet.init_detector(
        J_SMALL_DET, jax.random.PRNGKey(3)))
    # the degraded step (step 1) decodes through the reference's codec
    with CodecTap(_jax_codec_frames if degrade else None) as tap:
        tp, thist = train_loop.train_detector(T_SMALL_DET, device="cpu",
                                              **kw)
    assert len(tap.frames) == (1 if degrade else 0)
    assert tap.tie_flips() == 0
    _check_history(thist, jhist)
    first = train_loop.to_device(
        next(data.detector_batches(T_SMALL_DET, 4, 3, "all")), "cpu")
    grads, _ = train_loop.detector_grads(T_SMALL_DET, init, first)
    assert_train_params_close(weights._flatten(tp), _flat_j(jp),
                              weights._flatten(grads), 1e-3, 3,
                              f"detector degrade={degrade}")


@pytest.mark.parametrize("drift", [0.0, 0.5])
def test_train_classifier_matches_jax(drift, monkeypatch):
    kw = dict(steps=3, batch_size=8, seed=3, drift=drift)
    jp, jhist = jtl.train_classifier(J_SMALL_CLF, **kw)
    init = _start_from(monkeypatch, "init_classifier", jclf.init_classifier(
        J_SMALL_CLF, jax.random.PRNGKey(3)))
    tp, thist = train_loop.train_classifier(T_SMALL_CLF, device="cpu", **kw)
    _check_history(thist, jhist)
    first = train_loop.to_device(
        next(data.classifier_batches(T_SMALL_CLF, 8, 3, drift=drift)),
        "cpu")
    grads, _ = train_loop.classifier_grads(T_SMALL_CLF, init, first)
    assert_train_params_close(weights._flatten(tp), _flat_j(jp),
                              weights._flatten(grads), 1e-3, 3,
                              f"classifier drift={drift}")


def test_history_every_25_steps_and_the_last():
    seen = []
    _, hist = train_loop.train_classifier(T_SMALL_CLF, steps=27,
                                          batch_size=2, device="cpu",
                                          callback=seen.append)
    assert [h["step"] for h in hist] == [0, 25, 26]
    assert seen == hist


def test_loss_falls_on_the_fallback_detector_and_the_classifier():
    _, hist = train_loop.train_detector(tcfg.FALLBACK_DETECTOR, steps=30,
                                        batch_size=8, seed=5, degrade=False,
                                        device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"], hist
    _, hist = train_loop.train_classifier(tcfg.CLASSIFIER, steps=30,
                                          batch_size=16, seed=5,
                                          device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"], hist


def test_training_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop.train_classifier(T_SMALL_CLF, steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop.train_detector(T_SMALL_DET, steps=1)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _trained_state(steps=2):
    """Port params and AdamW state after a few steps on seeded grads."""
    params = weights.init_detector(T_SMALL_DET,
                                   torch.Generator().manual_seed(1), "cpu")
    opt = optimizer.AdamW(lr=0.01)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(2)
    for _ in range(steps):
        grads = optimizer.tree_map(
            lambda p: torch.randn(p.shape, generator=gen), params)
        params, state = opt.update(grads, state, params)
    return params, state


def _assert_trees_equal(a, b):
    fa, fb = weights._flatten(a), weights._flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_checkpoint_round_trips_params_and_optimizer_state(tmp_path):
    params, state = _trained_state()
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, {"params": params, "opt": state}, {"note": "t"})
    like = {"params": weights.init_detector(
        T_SMALL_DET, torch.Generator().manual_seed(9), "cpu"),
        "opt": optimizer.AdamW().init(params)}
    back = checkpoint.restore(path, like)
    assert isinstance(back["opt"], optimizer.AdamWState)
    assert back["opt"].step.dtype == torch.int32
    assert back["params"]["conv0"]["w"].shape == params["conv0"]["w"].shape
    _assert_trees_equal(back, {"params": params, "opt": state})
    assert checkpoint.load_metadata(path)["note"] == "t"
    # SGDM's state has no second moment (None): saved and restored as such
    sgd = optimizer.SGDM().init(params)
    checkpoint.save(str(tmp_path / "sgd"), sgd)
    back = checkpoint.restore(str(tmp_path / "sgd"), sgd)
    assert back.nu is None
    _assert_trees_equal(back, sgd)


def test_checkpoints_move_between_packages_with_optimizer_state(tmp_path):
    params, state = _trained_state()
    # port -> JAX: the reference restores params and AdamW state as saved
    checkpoint.save(str(tmp_path / "port"), (params, state))
    j_like = jdet.init_detector(J_SMALL_DET, jax.random.PRNGKey(0))
    j_like = (j_like, jopt.AdamW().init(j_like))
    j_back = jckpt.restore(str(tmp_path / "port"), j_like)
    want = weights._flatten((params, state))
    got = _flat_j(j_back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # JAX -> port
    jckpt.save(str(tmp_path / "jax"), j_back)
    back = checkpoint.restore(str(tmp_path / "jax"), (
        weights.init_detector(T_SMALL_DET, torch.Generator().manual_seed(5),
                              "cpu"), optimizer.AdamW().init(params)))
    _assert_trees_equal(back, (params, state))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt2")
    checkpoint.save(path, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(path, {"w": torch.zeros((3, 3))})
    # a conv kept HWIO on disk is checked in the port's OIHW layout
    checkpoint.save(path, {"w": torch.zeros((4, 2, 3, 3))})
    assert checkpoint.restore(path, {"w": torch.ones((4, 2, 3, 3))})[
        "w"].shape == (4, 2, 3, 3)
    with pytest.raises(ValueError):
        checkpoint.restore(path, {"w": torch.ones((2, 4, 3, 3))})


def test_load_or_train_restores_and_trains_only_what_is_missing(
        tmp_path, monkeypatch):
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    det = weights.init_detector(tcfg.DETECTOR, gen(1), "cpu")
    fb = weights.init_detector(tcfg.FALLBACK_DETECTOR, gen(2), "cpu")
    checkpoint.save(str(tmp_path / "det_params"), det)
    checkpoint.save(str(tmp_path / "fallback_params"), fb)
    clf = weights.init_classifier(tcfg.CLASSIFIER, gen(3), "cpu")
    calls = []

    def fake_train(cfg, **kw):
        calls.append((cfg.name, kw))
        return clf, []

    monkeypatch.setattr(train_loop, "train_classifier", fake_train)
    out = train_loop.load_or_train(str(tmp_path), "cpu")
    assert calls == [(tcfg.CLASSIFIER.name,
                      dict(device=torch.device("cpu"), steps=400,
                           batch_size=64))]
    _assert_trees_equal(out.det_params, det)
    _assert_trees_equal(out.fallback_params, fb)
    _assert_trees_equal(out.clf_params, clf)
    # the trained one was saved: a second call trains nothing
    calls.clear()
    _assert_trees_equal(train_loop.load_or_train(str(tmp_path),
                                                 "cpu").clf_params, clf)
    assert calls == []
