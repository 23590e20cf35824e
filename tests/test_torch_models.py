"""The port's codec, detector, classifier and weight conversion against the
JAX package, on the same numpy-seeded inputs and the same (untrained)
weights carried across with ``repro_torch.weights``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.training import checkpoint as jckpt
from repro.video import codec as jcodec
from repro.video import synthetic
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.models import classifier as tclf
from repro_torch.models import detector as tdet
from repro_torch.testing import CODEC_ATOL, MODEL_ATOL, NBYTES_RTOL
from repro_torch.video import codec as tcodec

torch.set_num_threads(1)

DET = DetectorConfig(name="torch-test-det", image_hw=(32, 32), widths=(8, 16))
CLF = ClassifierConfig(name="torch-test-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="torch-test-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="torch-test-clf", crop_hw=(16, 16),
                              widths=(8, 16), feature_dim=16)


@pytest.fixture(scope="module")
def params():
    jd = jdet.init_detector(DET, jax.random.PRNGKey(0))
    jc = jclf.init_classifier(CLF, jax.random.PRNGKey(1))
    return (jd, jc, weights.from_numpy_tree(jd, "cpu"),
            weights.from_numpy_tree(jc, "cpu"))


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["encode", "encode_inter"])
@pytest.mark.parametrize("hw", [(32, 32), (128, 128)])
def test_codec_matches_jax(fn, hw):
    rng = np.random.default_rng(3 + hw[0])
    frames = synthetic.make_chunk(rng, "traffic", num_frames=2,
                                  hw=hw).frames
    want = getattr(jcodec, fn)(jnp.asarray(frames), 0.8, 36)
    got = getattr(tcodec, fn)(torch.as_tensor(frames), 0.8, 36)
    assert got.frames.shape == frames.shape and got.nbytes.dim() == 0
    np.testing.assert_allclose(_np(got.frames), np.asarray(want.frames),
                               atol=CODEC_ATOL, rtol=0)
    np.testing.assert_allclose(float(got.nbytes), float(want.nbytes),
                               rtol=NBYTES_RTOL)


def test_codec_identity_resolution_and_qp_step():
    rng = np.random.default_rng(9)
    frames = synthetic.make_chunk(rng, "traffic", num_frames=2,
                                  hw=(36, 44)).frames      # block padding
    want = jcodec.encode(jnp.asarray(frames), 1.0, 20)
    got = tcodec.encode(torch.as_tensor(frames), 1.0, 20)
    np.testing.assert_allclose(_np(got.frames), np.asarray(want.frames),
                               atol=CODEC_ATOL, rtol=0)
    np.testing.assert_allclose(float(got.nbytes), float(want.nbytes),
                               rtol=NBYTES_RTOL)
    assert tcodec.qp_to_step(36) == float(jcodec.qp_to_step(36))


# ---------------------------------------------------------------------------
# detector + classifier
# ---------------------------------------------------------------------------
def test_detector_matches_jax(params):
    jd, _, td, _ = params
    rng = np.random.default_rng(4)
    images = rng.random((3, 32, 32, 3), dtype=np.float32)
    want = jdet.detect(DET, jd, jnp.asarray(images))
    got = tdet.detect(T_DET, td, torch.as_tensor(images))
    assert got["boxes"].shape == (3, 64, 4)
    for k in ("boxes", "loc_scores", "cls_logits", "cls_probs"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=MODEL_ATOL, rtol=0, err_msg=k)


def test_classifier_readouts_match_jax(params):
    _, jc, _, tc = params
    rng = np.random.default_rng(5)
    crops = rng.random((6, 16, 16, 3), dtype=np.float32)
    W = np.asarray(jc["W"])
    Ws = np.stack([W, 0.5 * W, -W])
    widx = np.asarray([0, 1, 2, 2, 1, 0], np.int32)
    omega = np.asarray([0.7, 0.3], np.float32)
    omegas = np.asarray([[1.0, 0.0], [0.6, 0.4], [0.5, 0.5]], np.float32)
    snaps = np.stack([np.stack([W, 0.9 * W]), np.stack([0.5 * W, W]),
                      np.stack([-W, 0 * W])])
    jx, tx = jnp.asarray(crops), torch.as_tensor(crops)
    cases = {
        "classify": (jclf.classify(CLF, jc, jx),
                     tclf.classify(T_CLF, tc, tx)),
        "classify_multi": (
            jclf.classify_multi(CLF, jc, jx, jnp.asarray(Ws),
                                jnp.asarray(widx)),
            tclf.classify_multi(T_CLF, tc, tx, torch.as_tensor(Ws),
                                torch.as_tensor(widx))),
        "classify_ensemble": (
            jclf.classify_ensemble(CLF, jc, jx, jnp.asarray(snaps[0]),
                                   jnp.asarray(omega)),
            tclf.classify_ensemble(T_CLF, tc, tx, torch.as_tensor(snaps[0]),
                                   torch.as_tensor(omega))),
        "classify_ensemble_multi": (
            jclf.classify_ensemble_multi(CLF, jc, jx, jnp.asarray(snaps),
                                         jnp.asarray(omegas),
                                         jnp.asarray(widx)),
            tclf.classify_ensemble_multi(T_CLF, tc, tx,
                                         torch.as_tensor(snaps),
                                         torch.as_tensor(omegas),
                                         torch.as_tensor(widx))),
    }
    for name, (want, got) in cases.items():
        for k in ("features", "scores"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       atol=MODEL_ATOL, rtol=0,
                                       err_msg=f"{name}.{k}")
    want, got = cases["classify"]
    np.testing.assert_array_equal(_np(got["pred"]), np.asarray(want["pred"]))


# ---------------------------------------------------------------------------
# weights: init schema, conversion, checkpoints in both directions
# ---------------------------------------------------------------------------
def test_init_follows_jax_schema():
    gen = torch.Generator().manual_seed(0)
    det = weights.init_detector(T_DET, gen, "cpu")
    clf = weights.init_classifier(T_CLF, gen, "cpu")
    jd = jdet.init_detector(DET, jax.random.PRNGKey(0))
    jc = jclf.init_classifier(CLF, jax.random.PRNGKey(1))
    for port, ref in ((det, jd), (clf, jc)):
        flat_p = weights._flatten(port)          # back to HWIO
        flat_r = jckpt._flatten(ref)
        assert flat_p.keys() == flat_r.keys()
        for k in flat_p:
            assert flat_p[k].shape == flat_r[k].shape, k
            if k.endswith("/b"):
                assert not flat_p[k].any()
    # fan_in is cin (HWIO axis -2), not 9 * cin: conv1 of (3, 3, 8, 16)
    assert det["conv1"]["w"].shape == (16, 8, 3, 3)
    std = float(torch.cat([weights.init_detector(
        tcfg.DETECTOR, torch.Generator().manual_seed(s), "cpu")["conv2"]["w"]
        .flatten() for s in range(2)]).std())
    assert abs(std - 1 / np.sqrt(96)) < 0.01


def test_npz_checkpoints_round_trip_both_ways(params, tmp_path):
    jd, _, td, _ = params
    jckpt.save(str(tmp_path / "jax_det"), jd)
    loaded = weights.load_npz(str(tmp_path / "jax_det"), "cpu")
    for k in ("conv0", "conv1", "head"):
        for leaf in ("w", "b"):
            assert torch.equal(loaded[k][leaf], td[k][leaf])
    weights.save_npz(str(tmp_path / "port_det"), td, {"version": 1})
    back = jckpt.restore(str(tmp_path / "port_det"), jd)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jd)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
