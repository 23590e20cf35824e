"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine that has only
PyTorch; there, skip the repository's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import set_reference_precision, weights
from repro_torch.configs import vpaas_video as cfg
from repro_torch.core.coordinator import MultiStreamCoordinator
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.kernels import crop_gather as cg
from repro_torch.kernels import iou_filter as ik
from repro_torch.kernels import onevsall as ov
from repro_torch.kernels import ops
from repro_torch.testing import (FILTER_CASES, FILTER_KW, MODEL_ATOL,
                                 ONEVSALL_ATOL, crop_cases, filter_case,
                                 onevsall_case)
from repro_torch.video import synthetic

pytestmark = pytest.mark.cuda

CROP_CASES = crop_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card to build and run the CUDA kernels")
    return torch.device("cuda")


def _t(arrays, device):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("f,n,m", FILTER_CASES + [(32, 256, 256)])
def test_region_filter_kernel_matches_plain(cuda, f, n, m):
    args = _t(filter_case(f, n, m), cuda)
    got = ik.region_filter_mask_batch(*args, **FILTER_KW)
    want = ik.region_filter_mask_batch_ref(*args, **FILTER_KW)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_crop_gather_kernel_matches_plain(cuda, case):
    frames, boxes, idxs, out_hw = CROP_CASES[case]
    args = _t((frames, boxes, idxs), cuda)
    got = cg.crop_gather(*args, out_hw=out_hw)
    want = cg.crop_gather_ref(*args, out_hw=out_hw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)              # bit for bit


@pytest.mark.parametrize("b,d,c,g", [(64, 17, 10, 1), (130, 33, 21, 1),
                                     (1024, 129, 8, 1), (128, 129, 8, 8),
                                     (300, 129, 8, 40), (128, 129, 8, 64),
                                     (512, 129, 8, 320)])
def test_onevsall_kernel_matches_plain(cuda, b, d, c, g):
    x, ws, widx = onevsall_case(b, d, c, g)
    x_t, ws_t = _t((x, ws), cuda)
    w_t = None if g == 1 else torch.as_tensor(widx, device=cuda)
    got = ov.onevsall_scores(x_t, ws_t, w_t)
    want = ov.onevsall_scores_ref(x_t, ws_t, w_t)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ONEVSALL_ATOL


def test_dispatch_launches_kernels_on_the_card(cuda):
    ops.reset_launch_counts()
    x, ws, _ = onevsall_case(8, 8, 4)
    ops.onevsall_scores(*_t((x, ws), cuda))
    ops.region_filter_mask_batch(*_t(filter_case(1, 8, 8), cuda), **FILTER_KW)
    frames, boxes, idxs, out_hw = CROP_CASES["oob-pad-rows"]
    ops.crop_gather(*_t((frames, boxes, idxs), cuda), out_hw=out_hw)
    assert ops.launch_counts() == {name: 1 for name in ops.KERNELS}


def test_fused_flush_of_64_streams_on_the_card(cuda, monkeypatch):
    # one flush stacks one readout per stream (G = 64) for K3; the card's
    # fused run agrees with the port's CPU run on the same chunks
    set_reference_precision()
    det = cfg.DetectorConfig(name="d", image_hw=(32, 32), widths=(8, 16))
    clf = cfg.ClassifierConfig(name="c", crop_hw=(16, 16), widths=(8, 16),
                               feature_dim=16)
    streams = [[synthetic.make_chunk(np.random.default_rng(200 + i),
                                     "traffic", num_frames=2, hw=(32, 32))]
               for i in range(64)]
    stacked = []
    readout = ops.onevsall_scores

    def spy(x, ws, widx=None):
        stacked.append((ws.device.type, ws.shape[0]))
        return readout(x, ws, widx)

    monkeypatch.setattr(ops, "onevsall_scores", spy)
    runs = {}
    for dev in ("cuda", "cpu"):
        multi = MultiStreamCoordinator(
            HighLowProtocol(det, clf, device=dev),
            weights.init_detector(det, torch.Generator().manual_seed(0), dev),
            weights.init_classifier(clf, torch.Generator().manual_seed(1),
                                    dev),
            streams, max_batch_chunks=64, batch_window=0.05,
            hot_path="fused", device=dev)
        ops.reset_launch_counts()
        multi.run(learn=False)
        runs[dev] = multi.scheduler
        if dev == "cuda":
            assert ops.launch_counts()["onevsall_scores"] == 1
    assert stacked == [("cuda", 64), ("cpu", 64)]
    for name, st in runs["cuda"].streams.items():
        (_, a, _), = st.results
        (_, b, _), = runs["cpu"].streams[name].results
        np.testing.assert_array_equal(a.prop_valid, b.prop_valid)
        np.testing.assert_allclose(a.fog_scores, b.fog_scores,
                                   atol=MODEL_ATOL, rtol=0)


def test_kernel_rejects_bad_operands(cuda):
    x, ws, _ = onevsall_case(8, 8, 4)
    with pytest.raises(ValueError, match="float32"):
        ov.onevsall_scores(*_t((x.astype(np.float64), ws), cuda))
    with pytest.raises(ValueError, match="CUDA"):
        ov.onevsall_scores(torch.as_tensor(x), torch.as_tensor(ws, device=cuda))
