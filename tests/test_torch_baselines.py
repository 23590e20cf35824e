"""The port's comparison baselines (MPEG, Glimpse, CloudSeg, DDS), its
framewise region split and its policy manager against the JAX package's,
on the CPU: the same chunks, the same (untrained) full-width
``vpaas_video`` detector weights.

The baselines' codec calls go through ``testing.CodecTap``: the port's
codec runs (its bytes are compared) but hands the JAX codec's frames on,
so that a coefficient rounding one step apart at a half-step tie does not
move everything after it; the tap checks that any codec difference is no
more than such a tie can make."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import baselines as jbl
from repro.configs.vpaas_video import CLASSIFIER, DETECTOR
from repro.core import regions as jreg
from repro.models import detector as jdet
from repro.serving import policies as jpol
from repro.video import codec as jcodec
from repro.video import synthetic
from repro_torch import baselines as tbl
from repro_torch import weights
from repro_torch.baselines import cloudseg as tcs
from repro_torch.configs import vpaas_video as tcfg
from repro_torch.core import regions as treg
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.kernels import ops
from repro_torch.serving import policies as tpol
from repro_torch.testing import (CODEC_ATOL, THRESHOLD_TIE, CodecTap,
                                 DetectorTies, assert_baseline_results_match)
from repro_torch.video import codec as tcodec

torch.set_num_threads(1)

# bench_protocol's workload, cut to 2 chunks x 4 frames per content type
DATASETS = {name: synthetic.dataset(2024 + i, name, 2, num_frames=4)
            for i, name in enumerate(synthetic.CONTENT_TYPES)}
BASELINES = ("MPEGBaseline", "GlimpseBaseline", "CloudSegBaseline",
             "DDSBaseline")
# with random weights some chunks have no round-2 region at DDS's default
# theta_loc = 0.5, and the fast dashcam content sends every frame at
# Glimpse's default trigger 0.02; these settings (Glimpse's is the JAX
# package's own test's, tests/test_protocol.py) exercise round 2 in every
# chunk and skip frames in every content type
BASELINE_KW = {"GlimpseBaseline": dict(diff_threshold=0.05),
               "DDSBaseline": dict(theta_loc=0.45)}


@pytest.fixture(scope="module")
def det_params():
    jd = jdet.init_detector(DETECTOR, jax.random.PRNGKey(0))
    return jd, weights.from_numpy_tree(jd, "cpu")


def _jax_codec(kind, frames, r, q, i):
    return np.asarray(getattr(jcodec, kind)(
        jnp.asarray(frames.cpu().numpy()), r, q).frames)


def _ties(det, theta_loc, theta_cls):
    """(F, N) positions whose acceptance rests within THRESHOLD_TIE of a
    threshold, from a detector output."""
    loc = np.asarray(det["loc_scores"])
    conf = np.asarray(det["cls_probs"]).max(-1)
    return ((np.abs(loc - theta_loc) <= THRESHOLD_TIE)
            | (np.abs(conf - theta_cls) <= THRESHOLD_TIE))


@pytest.mark.parametrize("content", sorted(DATASETS))
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_jax(det_params, name, content):
    jd, td = det_params
    kw = BASELINE_KW.get(name, {})
    want_sys = getattr(jbl, name)(DETECTOR, **kw)
    got_sys = getattr(tbl, name)(tcfg.DETECTOR, device="cpu", **kw)
    ops.reset_launch_counts()
    frames = sent = round2 = 0
    for chunk in DATASETS[content]:
        want = want_sys.process_chunk(jd, chunk.frames)
        with CodecTap(_jax_codec) as tap, DetectorTies(
                got_sys.theta_loc, got_sys.theta_cls) as ties:
            got = got_sys.process_chunk(td, chunk.frames)
        tap.tie_flips()
        exempt = ties.exempt(want.valid.shape)
        f = chunk.frames.shape[0]
        assert got.boxes.shape == (f, 256, 4)
        assert_baseline_results_match(want, got, exempt, f"{name} {content}")
        frames += f
        sent += got.cloud_frames
        round2 += got.cloud_rounds > 1.0
    if name == "DDSBaseline":                 # round 2 covered a region
        assert round2 > 0
    if name == "GlimpseBaseline":             # a frame was skipped
        assert sent < frames
    # the CPU run computed the kernels' plain versions
    assert ops.launch_counts() == {k: 0 for k in [*ops.KERNELS, *ops.VJPS]}


def test_framewise_split_matches_flush_split_and_jax(det_params):
    jd, _ = det_params
    kw = dict(theta_cls=0.85, theta_loc=0.5, theta_iou=0.3, theta_back=0.5)
    checked = 0
    for content, chunks in sorted(DATASETS.items()):
        enc = jcodec.encode_inter(jnp.asarray(chunks[0].frames), 0.8, 36)
        det = jdet.detect(DETECTOR, jd, enc.frames)
        want = jreg.split_regions(det, impl="ref", **kw)
        tdet = {k: torch.as_tensor(np.array(v)) for k, v in det.items()}
        got = treg.split_regions_framewise(tdet, **kw)
        flush = treg.split_regions(tdet, **kw)
        exempt = _ties(det, kw["theta_loc"], kw["theta_cls"])
        for k in ("acc_valid", "prop_valid", "acc_labels"):
            assert torch.equal(getattr(got, k), getattr(flush, k)), k
            w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
            assert not ((w != g) & ~exempt).any(), f"{content} {k}"
        checked += int(got.prop_valid.sum())
    assert checked > 0                         # the filter had work


@pytest.mark.parametrize("shape,out_hw", [((2, 77, 77, 3), (128, 128)),
                                          ((4, 128, 128, 3), (128, 128)),
                                          ((1, 64, 48, 3), (40, 56))])
def test_super_resolve_matches_jax(shape, out_hw):
    frames = np.random.default_rng(3).random(shape, dtype=np.float32)
    want = np.asarray(jbl.cloudseg.super_resolve(jnp.asarray(frames),
                                                 out_hw))
    got = tcs.super_resolve(torch.as_tensor(frames), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=CODEC_ATOL, rtol=0)
    # the cubic upscale alone; F.interpolate(mode="bicubic") is not it
    t, _, _, c = shape
    want_up = np.asarray(jax.image.resize(jnp.asarray(frames),
                                          (t, *out_hw, c), "cubic"))
    got_up = tcs.resize_cubic(torch.as_tensor(frames), out_hw).numpy()
    np.testing.assert_allclose(got_up, want_up, atol=CODEC_ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((64, 64), (128, 128)),
                                     ((128, 128), (64, 64)),
                                     ((77, 77), (128, 128))])
def test_codec_resize_matches_jax_both_ways(src, dst):
    frames = np.random.default_rng(4).random((2, *src, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(frames), (2, *dst, 3),
                                       "linear"))
    got = tcodec.resize(torch.as_tensor(frames), dst).numpy()
    np.testing.assert_allclose(got, want, atol=CODEC_ATOL, rtol=0)


def test_default_policies_match_jax():
    want, got = jpol.default_policies(), tpol.default_policies()
    assert got.list() == want.list()
    for name in want.list():
        assert name in got
        assert (got._policies[name].description
                == want._policies[name].description)
    built = {name: got.build(name, tcfg.DETECTOR, tcfg.CLASSIFIER,
                             device="cpu") for name in got.list()}
    assert isinstance(built["vpaas-highlow"], HighLowProtocol)
    for name, cls in (("mpeg", tbl.MPEGBaseline),
                      ("glimpse", tbl.GlimpseBaseline),
                      ("cloudseg", tbl.CloudSegBaseline),
                      ("dds", tbl.DDSBaseline)):
        assert isinstance(built[name], cls)
        assert built[name].device == torch.device("cpu")
    assert CLASSIFIER.num_classes == tcfg.CLASSIFIER.num_classes


def test_baselines_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default would build")
    pm = tpol.default_policies()
    for name in pm.list():
        with pytest.raises(RuntimeError, match="cuda"):
            pm.build(name, tcfg.DETECTOR, tcfg.CLASSIFIER)
