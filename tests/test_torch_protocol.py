"""The port's protocol stages against the JAX package's, on the same chunk
and the same (untrained) weights: the §IV.B split fed the same detector
output, the classify stages fed the same split, and ``process_chunk`` end
to end."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro.core import protocol as jpm
from repro.core import regions as jreg
from repro.models import classifier as jclf
from repro.models import detector as jdet
from repro.video import synthetic
from repro_torch import weights
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core import protocol as tpm
from repro_torch.core import regions as treg
from repro_torch.testing import LATENCY_RTOL, MODEL_ATOL, THRESHOLD_TIE

torch.set_num_threads(1)

DET = DetectorConfig(name="torch-proto-det", image_hw=(32, 32),
                     widths=(8, 16))
CLF = ClassifierConfig(name="torch-proto-clf", crop_hw=(16, 16),
                       widths=(8, 16), feature_dim=16)
T_DET = tcfg.DetectorConfig(name="torch-proto-det", image_hw=(32, 32),
                            widths=(8, 16))
T_CLF = tcfg.ClassifierConfig(name="torch-proto-clf", crop_hw=(16, 16),
                              widths=(8, 16), feature_dim=16)
J_PCFG = jpm.ProtocolConfig()
T_PCFG = tpm.ProtocolConfig()


@pytest.fixture(scope="module")
def models():
    jd = jdet.init_detector(DET, jax.random.PRNGKey(0))
    jc = jclf.init_classifier(CLF, jax.random.PRNGKey(1))
    return (jd, jc, weights.from_numpy_tree(jd, "cpu"),
            weights.from_numpy_tree(jc, "cpu"))


@pytest.fixture(scope="module")
def chunk():
    return synthetic.make_chunk(np.random.default_rng(7), "traffic",
                                num_frames=2, hw=(32, 32))


def _torch_split(split):
    return treg.RegionSplit(*(torch.as_tensor(np.array(v)) for v in split))


def _near(x, thr):
    return np.abs(np.asarray(x) - thr) <= THRESHOLD_TIE


def _score_ties(scores):
    """Positions whose fog decision rests within the tie band: confidence
    at fog_min_conf, or top-two class scores within the band."""
    scores = np.asarray(scores)
    top2 = np.sort(scores, -1)[..., -2:]
    return (_near(top2[..., 1], J_PCFG.fog_min_conf)
            | ((top2[..., 1] - top2[..., 0]) <= THRESHOLD_TIE))


def _assert_discrete_equal(want, got, exempt):
    for k in ("labels", "valid", "source"):
        w, g = np.asarray(want[k]), np.asarray(got[k])
        bad = (w != g) & ~exempt
        assert not bad.any(), f"{k} differs at {np.argwhere(bad)[:5]}"


def test_split_same_detector_output_is_exact(models, chunk):
    jd, _, _, _ = models
    enc = jpm.encode_low(J_PCFG, jnp.asarray(chunk.frames))
    det = jpm.detect_regions(DET, jd, enc.frames)
    want, want_bytes = jpm.split_uncertain(J_PCFG, det)
    tdet = {k: torch.as_tensor(np.array(v)) for k, v in det.items()}
    got, got_bytes = tpm.split_uncertain(T_PCFG, tdet)
    for k in ("acc_valid", "prop_valid", "acc_labels"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    assert float(got_bytes) == float(want_bytes)
    # per-frame thresholds at the global defaults: the same masks
    f = chunk.frames.shape[0]
    dyn = treg.split_regions_dynamic(
        tdet, theta_cls=torch.full((f,), T_PCFG.theta_cls),
        theta_loc=torch.full((f,), T_PCFG.theta_loc),
        theta_iou=T_PCFG.theta_iou, theta_back=T_PCFG.theta_back)
    for k in ("acc_valid", "prop_valid"):
        assert torch.equal(getattr(dyn, k), getattr(got, k))


def test_split_adapted_thresholds_match_jax(models, chunk):
    jd, _, _, _ = models
    det = jpm.detect_regions(DET, jd, jnp.asarray(chunk.frames))
    tc = np.asarray([0.3, 0.6], np.float32)
    tl = np.asarray([0.45, 0.55], np.float32)
    want = jreg.split_regions_dynamic(
        det, theta_cls=jnp.asarray(tc), theta_loc=jnp.asarray(tl),
        theta_iou=0.3, theta_back=0.5)
    got = treg.split_regions_dynamic(
        {k: torch.as_tensor(np.array(v)) for k, v in det.items()},
        theta_cls=torch.as_tensor(tc), theta_loc=torch.as_tensor(tl),
        theta_iou=0.3, theta_back=0.5)
    for k in ("acc_valid", "prop_valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)


@pytest.mark.parametrize("n_valid", [0, 5, 17])
def test_classify_stages_same_split_match_jax(models, chunk, n_valid):
    jd, jc, _, tc = models
    frames = jnp.asarray(chunk.frames)
    split = jpm.detect_split(DET, J_PCFG, jd, frames)
    # force a known number of valid proposals (random init leaves few)
    rng = np.random.default_rng(n_valid)
    pv = np.zeros(split.prop_valid.shape, bool)
    pv.ravel()[rng.choice(pv.size, n_valid, replace=False)] = True
    split = split._replace(prop_valid=jnp.asarray(pv))
    tsplit = _torch_split(split)
    W = np.asarray(jc["W"])
    Ws = np.stack([W, 0.8 * W])
    fidx, ridx, n, bucket = jreg.compaction_indices(pv, (4, 8))
    idxs = np.zeros((3, bucket), np.int32)
    idxs[0], idxs[1] = fidx, ridx
    idxs[2, :n] = rng.integers(0, 2, n)
    tframes = torch.as_tensor(chunk.frames)
    stages = {
        "classify_regions": (
            jpm.classify_regions(CLF, J_PCFG, jc, jnp.asarray(W), frames,
                                 split),
            tpm.classify_regions(T_CLF, T_PCFG, tc, tc["W"], tframes,
                                 tsplit)),
        "classify_compacted": (
            jpm.classify_compacted(CLF, J_PCFG, jc, jnp.asarray(Ws), frames,
                                   split, jnp.asarray(idxs)),
            tpm.classify_compacted(T_CLF, T_PCFG, tc, torch.as_tensor(Ws),
                                   tframes, tsplit, torch.as_tensor(idxs))),
    }
    for name, (want, got) in stages.items():
        for k in ("fog_scores", "fog_features", "boxes"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=MODEL_ATOL, rtol=0,
                                       err_msg=f"{name}.{k}")
        exempt = _score_ties(want["fog_scores"]) & pv
        _assert_discrete_equal(want, {k: v.numpy() for k, v in got.items()},
                               exempt)
        if n_valid == 0:
            assert not got["fog_scores"].any()


def test_process_chunk_matches_jax(models, chunk):
    jd, jc, td, tc = models
    want = jpm.HighLowProtocol(DET, CLF).process_chunk(jd, jc, chunk.frames)
    got = tpm.HighLowProtocol(T_DET, T_CLF, device="cpu").process_chunk(
        td, tc, chunk.frames)
    # the decisions' inputs, from the JAX side, for the tie exemption
    enc = jpm.encode_low(J_PCFG, jnp.asarray(chunk.frames))
    det = jpm.detect_regions(DET, jd, enc.frames)
    loc = np.asarray(det["loc_scores"])
    cls_conf = np.asarray(det["cls_probs"]).max(-1)
    exempt = (_near(loc, J_PCFG.theta_loc) | _near(cls_conf, J_PCFG.theta_cls)
              | (_score_ties(want.fog_scores) & want.prop_valid))
    np.testing.assert_array_equal(got.prop_valid[~exempt],
                                  want.prop_valid[~exempt])
    _assert_discrete_equal(dataclasses.asdict(want), dataclasses.asdict(got),
                           exempt)
    for k in ("boxes", "fog_scores", "fog_features", "prop_boxes"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   atol=MODEL_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(got.wan_bytes, want.wan_bytes,
                               rtol=LATENCY_RTOL)
    assert got.coord_bytes == want.coord_bytes
    assert got.cloud_frames == want.cloud_frames
    for k, v in dataclasses.asdict(want.latency).items():
        np.testing.assert_allclose(getattr(got.latency, k), v,
                                   rtol=LATENCY_RTOL, err_msg=k)
    assert exempt.sum() < exempt.size // 4     # the exemption stays narrow
