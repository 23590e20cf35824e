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
from repro_torch.baselines import DDSBaseline, GlimpseBaseline
from repro_torch.configs import get_config
from repro_torch.configs import vpaas_video as cfg
from repro_torch.core.coordinator import MultiStreamCoordinator
from repro_torch.core.hitl import OracleAnnotator
from repro_torch.core.protocol import HighLowProtocol
from repro_torch.kernels import crop_gather as cg
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import iou_filter as ik
from repro_torch.kernels import iou_matrix as im
from repro_torch.kernels import nms as nm
from repro_torch.kernels import onevsall as ov
from repro_torch.kernels import onevsall_update as ou
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import region_filter_mask as rf
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import schema as sch
from repro_torch.models import transformer as tfm
from repro_torch.serving.server import LLMServer, Request
from repro_torch.learning import ContinualLearningPlane, LearningConfig
from repro_torch.testing import (ATTN_ATOL, ATTN_BF16_RTOL, ATTN_VJP_RTOL,
                                 DECODE_CASES, DECODE_WIDE_CASES,
                                 DECODE_DENSE_CASES, DECODE_DENSE_IDS,
                                 FLASH_DENSE_CASES, FLASH_DENSE_IDS,
                                 FLASH_D64_CASES, FLASH_D64_IDS,
                                 FLASH_WIDE_CASES, SSD_BF16_RTOL, bf16_err,
                                 FILTER_CASES, SSD_VJP_RTOL,
                                 FILTER_KW, FLASH_CASES, FLASH_DV_CASES,
                                 FLASH_EDGE_CASES, FLASH_MLA_CASES,
                                 FLASH_RAGGED_CASES, IOU_CASES,
                                 LEARN_RTOL, LLM_RTOL, MODEL_ATOL,
                                 ONEVSALL_ATOL, SSD_CASES, SSD_RTOL,
                                 UPDATE_ETA, UPDATE_RTOL, CodecTap,
                                 DetectorTies, assert_baseline_results_match,
                                 attention_case, crop_cases,
                                 crop_tile_cases, decode_case,
                                 filter_case, filter_corner_cases,
                                 frame_filter_case, iou_case, iou_nan_case,
                                 nms_corner_cases, onevsall_case,
                                 open_episode, rand_boxes, rel_err,
                                 replayed_instances, ssd_case, update_case)
from repro_torch.video import synthetic

pytestmark = pytest.mark.cuda

CROP_CASES = {**crop_cases(), **crop_tile_cases()}
# (b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, softcap, q_offset)
ATTN_GRAD_CASES = ([c[:6] + (c[5],) + c[6:] for c in FLASH_CASES
                    + FLASH_RAGGED_CASES] + FLASH_DV_CASES)


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


@pytest.mark.parametrize("b,n,m", IOU_CASES + [(32, 256, 256)])
def test_iou_matrix_kernel_matches_plain(cuda, b, n, m):
    a, c = _t(iou_case(b, n, m), cuda)
    got = im.iou_matrix(a, c)
    want = im.iou_matrix_ref(a, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)              # bit for bit
    if b == 1:
        assert torch.equal(im.iou_matrix(a[0], c[0]), want[0])


@pytest.mark.parametrize("n,m", [(64, 32), (130, 70), (256, 256)])
def test_frame_filter_kernel_matches_plain(cuda, n, m):
    args = _t(frame_filter_case(n, m), cuda)
    got = rf.region_filter_mask(*args, **FILTER_KW)
    want = rf.region_filter_mask_ref(*args, **FILTER_KW)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


FILTER_CORNERS = filter_corner_cases()


@pytest.mark.parametrize("case", sorted(FILTER_CORNERS))
def test_region_filter_kernel_corners(cuda, case):
    # the exactness corners (NaN coordinates, theta_iou <= 0, empty and
    # odd-sized accepted sets, ragged N, two passes, sparse and dense): K1
    # whole, K4b frame by frame, bit for bit
    arrays, kw = FILTER_CORNERS[case]
    args = _t(arrays, cuda)
    want = ik.region_filter_mask_batch_ref(*args, **kw)
    got = ik.region_filter_mask_batch(*args, **kw)
    frames = [rf.region_filter_mask(*[a[f] for a in args], **kw)
              for f in range(want.shape[0])]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(torch.stack(frames), want)


@pytest.mark.parametrize("accepted", [4, None])
def test_region_filter_kernel_flush_shape(cuda, accepted):
    # the fused flush's largest shape, at the serving path's density (4
    # valid accepted boxes a frame) and dense (80% valid)
    arrays = list(filter_case(32, 256, 256, seed=3))
    if accepted is not None:
        rng = np.random.default_rng(3)
        arrays[3] = np.argsort(rng.random((32, 256)), -1) < accepted
    args = _t(arrays, cuda)
    got = ik.region_filter_mask_batch(*args, **FILTER_KW)
    torch.cuda.synchronize()
    assert torch.equal(got, ik.region_filter_mask_batch_ref(*args,
                                                            **FILTER_KW))


@pytest.mark.parametrize("b,n,m", [(2, 40, 30), (32, 256, 256)])
def test_iou_matrix_kernel_propagates_nan(cuda, b, n, m):
    a, c = _t(iou_nan_case(b, n, m), cuda)
    got = im.iou_matrix(a, c)
    want = im.iou_matrix_ref(a, c)
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


NMS_CORNERS = nms_corner_cases()


@pytest.mark.parametrize("case", sorted(NMS_CORNERS))
def test_nms_kernel_corners(cuda, case):
    # every corner of the greedy loop: ops.nms_mask on the card (K4a, then
    # the NMS kernel) against the plain loop on the card, mask for mask
    boxes, scores, valid, thr = NMS_CORNERS[case]
    args = _t((boxes, scores, valid), cuda)
    got = ops.nms_mask(*args, thr)
    want = ref.nms_mask(*args, thr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("f,n,valid_frac", [(32, 256, 0.5), (32, 256, 1.0),
                                            (3, 600, 0.6), (2, 37, 0.9)])
def test_nms_kernel_matches_plain(cuda, f, n, valid_frac):
    # the flush's shape at half and full density, past SHARED_N (rows in
    # the global workspace), N % 4 != 0
    rng = np.random.default_rng(f + n)
    boxes, scores, valid = _t((rand_boxes(rng, (f, n)),
                               rng.random((f, n), dtype=np.float32),
                               rng.random((f, n)) < valid_frac), cuda)
    iou = im.iou_matrix(boxes, boxes)
    got = nm.nms_greedy(iou, scores, valid)
    want = nm.nms_greedy_ref(iou, scores, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_nms_mask_on_the_card_never_runs_the_plain_loop(cuda, monkeypatch):
    # one ops.nms_mask call is one K4a launch and one NMS kernel launch;
    # the eager loop is not reached on a CUDA tensor
    def plain_loop(*args, **kw):
        raise AssertionError("the plain greedy loop ran on a CUDA tensor")

    boxes, scores, valid, thr = NMS_CORNERS["dense-256"]
    args = _t((boxes, scores, valid), cuda)
    want = ref.nms_mask(*args, thr)
    monkeypatch.setattr(ref, "nms_greedy", plain_loop)
    monkeypatch.setattr(nm, "nms_greedy_ref", plain_loop)
    ops.reset_launch_counts()
    got = ops.nms_mask(*args, thr)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["iou_matrix"] == counts["nms_greedy"] == 1
    assert sum(counts.values()) == 2
    assert torch.equal(got, want)


def test_nms_kernel_rejects_bad_operands(cuda):
    boxes, scores, valid = _t(NMS_CORNERS["n37"][:3], cuda)
    iou = im.iou_matrix(boxes, boxes)
    for args, match in [((iou, scores.double(), valid), "float32"),
                        ((iou, scores, valid.to(torch.uint8)), "bool"),
                        ((iou, scores.cpu(), valid), "CUDA"),
                        ((iou[:, :5, :5], scores, valid), "expected iou")]:
        with pytest.raises(ValueError, match=match):
            nm.nms_greedy(*args)


@pytest.mark.parametrize("name", ["dds", "glimpse"])
def test_baseline_chunk_on_the_card_matches_cpu(cuda, name):
    # one full-width chunk: the card's run launches K4a (and, for DDS, K4b
    # once per frame) and equals the port's CPU run, which takes the
    # card's decoded frames so a codec half-step tie cannot move it
    set_reference_precision()
    det = cfg.DETECTOR
    chunk = synthetic.make_chunk(np.random.default_rng(14), "traffic",
                                 num_frames=4)
    cls = {"dds": DDSBaseline, "glimpse": GlimpseBaseline}[name]
    kw = (dict(theta_loc=0.45) if name == "dds"
          else dict(diff_threshold=0.05))
    res = {}
    for dev in ("cuda", "cpu"):
        system = cls(det, device=dev, **kw)
        params = weights.init_detector(det, torch.Generator().manual_seed(0),
                                       dev)
        ops.reset_launch_counts()
        if dev == "cuda":
            with CodecTap() as rec:
                res[dev] = system.process_chunk(params, chunk.frames)
            counts = ops.launch_counts()
            assert counts["iou_matrix"] == counts["nms_greedy"] > 0
            assert counts["region_filter_mask"] == (4 if name == "dds" else 0)
            assert counts["region_filter_mask_batch"] == 0
        else:
            with CodecTap(lambda kind, f, r, q, i: rec.frames[i]) as tap, \
                    DetectorTies(system.theta_loc, system.theta_cls) as ties:
                res[dev] = system.process_chunk(params, chunk.frames)
            assert ops.launch_counts() == {
                k: 0 for k in [*ops.KERNELS, *ops.VJPS]}
            tap.tie_flips()
    assert_baseline_results_match(res["cpu"], res["cuda"],
                                  ties.exempt(res["cpu"].valid.shape), name)


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
                                     (512, 129, 8, 320), (1024, 129, 8, 64),
                                     (1024, 129, 8, 320), (13, 129, 8, 1),
                                     (37, 33, 21, 5)])
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
    ops.flash_attention(*_t(attention_case(1, 8, 8, 2, 1, 32), cuda))
    q, kc, vc = _t(decode_case(1, 8, 2, 1, 32), cuda)
    ops.decode_attention(q, kc, vc, 4)
    x, dt, A, B, C, _ = ssd_case(1, 8, 2, 4, 4, init=False)
    ops.ssd_scan(*_t((x, dt, A, B, C), cuda), chunk=4)
    ops.onevsall_update(*_t(update_case(1, 8, 4), cuda), eta=UPDATE_ETA)
    iou = ops.iou_matrix(*_t(iou_case(2, 8, 8), cuda))
    ops.region_filter_mask(*_t(frame_filter_case(8, 8), cuda), **FILTER_KW)
    ops.nms_greedy(iou, torch.rand(2, 8, device=cuda),
                   torch.ones(2, 8, dtype=torch.bool, device=cuda))
    assert ops.launch_counts() == {**{name: 1 for name in ops.KERNELS},
                                   **{name: 0 for name in ops.VJPS}}
    boxes, _ = _t(iou_case(2, 8, 8), cuda)
    ops.nms_mask(boxes, torch.rand(2, 8, device=cuda),
                 torch.ones(2, 8, dtype=torch.bool, device=cuda))
    counts = ops.launch_counts()                     # NMS runs K4a, then
    assert counts["iou_matrix"] == counts["nms_greedy"] == 2   # its kernel


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


@pytest.mark.parametrize("b,d1,c", [(1, 129, 8), (256, 129, 8),
                                    (2048, 129, 8), (130, 17, 10),
                                    (300, 65, 4)])
def test_onevsall_update_kernel_matches_plain(cuda, b, d1, c):
    # the learner's single-row step, a label-budget replay, the trainer's
    # max_buffer, ragged tiles at C = 10, and a K5 shape of the JAX tests
    x, y, w = _t(update_case(b, d1, c), cuda)
    got = ou.onevsall_update(x, y, w, eta=UPDATE_ETA)
    want = ou.onevsall_update_ref(x, y, w, eta=UPDATE_ETA)
    torch.cuda.synchronize()
    assert rel_err(got.cpu(), want.cpu()) <= UPDATE_RTOL


def test_onevsall_update_kernel_is_bit_identical_run_to_run(cuda):
    # no float atomics: the gate and rollback compare and restore W bits
    x, y, w = _t(update_case(2048, 129, 8), cuda)
    first = ou.onevsall_update(x, y, w, eta=UPDATE_ETA)
    for _ in range(5):
        assert torch.equal(ou.onevsall_update(x, y, w, eta=UPDATE_ETA),
                           first)


@pytest.mark.parametrize("n,d1,c,passes,one_block", [
    (16, 129, 8, 2, True), (256, 129, 8, 2, True), (37, 17, 10, 3, True),
    (5, 65, 40, 2, True), (6, 129, 100, 2, False)])
def test_onevsall_replay_equals_single_step_launches(cuda, n, d1, c, passes,
                                                     one_block):
    # one launch of the replay (a persistent block; past shared memory,
    # the launcher's own loop) gives the bits of a loop of one-row launches
    xs, ys, w = _t(update_case(n, d1, c, seed=5), cuda)
    got = ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA, passes=passes)
    loop = w
    for _ in range(passes):
        for i in range(n):
            loop = ou.onevsall_update(xs[i:i + 1], ys[i:i + 1], loop,
                                      eta=UPDATE_ETA)
    want = ou.onevsall_replay_ref(xs, ys, w, eta=UPDATE_ETA, passes=passes)
    torch.cuda.synchronize()
    assert ou.replay_in_one_block(d1, c) == one_block
    assert torch.equal(got, loop)
    assert rel_err(got.cpu(), want.cpu()) <= LEARN_RTOL
    assert torch.equal(ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA,
                                          passes=passes), got)


def test_onevsall_replay_in_a_cuda_graph(cuda):
    # captured once, a replay of the graph recomputes the K5 replay (and a
    # batch step through its workspace) from the inputs' new values
    xs, ys, w = _t(update_case(64, 129, 8, seed=6), cuda)
    xb, yb, _ = _t(update_case(300, 129, 8, seed=7), cuda)
    ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA, passes=2)  # warm-up
    ou.onevsall_update(xb, yb, w, eta=UPDATE_ETA)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA, passes=2)
        out_b = ou.onevsall_update(xb, yb, w, eta=UPDATE_ETA)
    xs.mul_(0.5)
    xb.mul_(0.5)
    w.add_(0.01)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ou.onevsall_replay(xs, ys, w, eta=UPDATE_ETA,
                                               passes=2))
    assert torch.equal(out_b, ou.onevsall_update(xb, yb, w, eta=UPDATE_ETA))


def test_learning_plane_on_the_card_matches_cpu(cuda):
    # the per-site plane with Eq. 9 ensemble serving and threshold
    # adaptation on the reduced configs: cam0's episode trains through K5
    # on the card, and every discrete outcome equals the CPU run's
    set_reference_precision()
    det = cfg.DetectorConfig(name="d", image_hw=(32, 32), widths=(8, 16))
    clf = cfg.ClassifierConfig(name="c", crop_hw=(16, 16), widths=(8, 16),
                               feature_dim=16)
    streams = [[synthetic.drifted_chunk(np.random.default_rng(1300 + i),
                                        "traffic", drift=float(i == 0),
                                        num_frames=2, hw=(32, 32))
                for _ in range(4)] for i in range(3)]
    lcfg = LearningConfig(label_budget=36, labels_per_round=8,
                          sentinel_per_chunk=1, min_batch=2, min_holdout=2,
                          per_site=True, ensemble_serving=True,
                          sentinel_mode="active", adapt_theta_cls=0.3,
                          adapt_theta_loc=0.3)
    runs = {}
    for dev in ("cuda", "cpu"):
        plane = ContinualLearningPlane(
            clf.num_classes, lcfg,
            annotator=OracleAnnotator(iou_threshold=0.0, budget=36))
        multi = MultiStreamCoordinator(
            HighLowProtocol(det, clf, device=dev),
            weights.init_detector(det, torch.Generator().manual_seed(0), dev),
            weights.init_classifier(clf, torch.Generator().manual_seed(1),
                                    dev),
            streams, max_batch_chunks=3, batch_window=0.05,
            learning_plane=plane, device=dev)
        open_episode(plane, multi.scheduler, "cam0")
        ops.reset_launch_counts()
        multi.run(learn=True)
        runs[dev] = (plane, multi.scheduler, ops.launch_counts(), ou.steps)
    (plane, sched, counts, k5_steps), (cpu_plane, cpu_sched, cpu_counts,
                                       cpu_steps) = runs["cuda"], runs["cpu"]
    assert cpu_steps == 0
    assert plane.summary() == cpu_plane.summary()
    assert [e["event"] for e in sched.monitor.events] == [
        e["event"] for e in cpu_sched.monitor.events]
    steps = lcfg.passes * replayed_instances(sched.graph.zoo,
                                             "fog-classifier[cam0]")
    rounds = sum(site["trainer"]["rounds"]
                 for site in plane.summary()["sites"].values())
    # one K5 launch per training round (batch_update call), each a replay
    # of passes x the round's buffer
    assert counts["onevsall_update"] == rounds > 0
    assert k5_steps == steps > 0
    assert cpu_counts == {name: 0 for name in [*ops.KERNELS, *ops.VJPS]}
    for name, st in sched.streams.items():
        assert rel_err(st.W, cpu_sched.streams[name].W) <= LEARN_RTOL


def test_kernel_rejects_bad_operands(cuda):
    x, ws, _ = onevsall_case(8, 8, 4)
    with pytest.raises(ValueError, match="float32"):
        ov.onevsall_scores(*_t((x.astype(np.float64), ws), cuda))
    with pytest.raises(ValueError, match="CUDA"):
        ov.onevsall_scores(torch.as_tensor(x), torch.as_tensor(ws, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        ov.onevsall_scores(*_t((x, ws), cuda),
                           torch.zeros(3, dtype=torch.int32, device=cuda))


def test_crop_gather_rejects_bad_operands(cuda):
    # check_operands names the operand and the fault before any pointer
    # reaches the launcher
    frames, boxes, idxs, out_hw = CROP_CASES["sweep-6x9"]
    fr, bx, ix = _t((frames, boxes, idxs), cuda)
    strided = bx.transpose(0, 1).contiguous().transpose(0, 1)
    for args, match in [((fr.double(), bx, ix), "frames: expected"),
                        ((fr, bx, ix.cpu()), "idxs: expected a CUDA"),
                        ((fr, bx, ix.long()), "int32"),
                        ((fr, bx[..., :3], ix), "shape"),
                        ((fr, strided, ix), "contiguous")]:
        with pytest.raises(ValueError, match=match):
            cg.crop_gather(*args, out_hw=out_hw)


def test_launch_lands_on_the_current_stream(cuda):
    # the launch path reads the current stream's raw handle on every call:
    # on a side stream the kernel queues behind that stream's work (x2 is
    # written only after a sleep there), and inside a CUDA graph capture it
    # is captured, so a replay recomputes it from new inputs
    x, ws, _ = onevsall_case(1024, 129, 8)
    x_t, ws_t = _t((x, ws), cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)
        x2 = x_t * 2
        got = ov.onevsall_scores(x2, ws_t)
    s.synchronize()
    assert float((got - ov.onevsall_scores_ref(x_t * 2, ws_t)).abs().max()) \
        <= ONEVSALL_ATOL
    graph = torch.cuda.CUDAGraph()
    ov.onevsall_scores(x_t, ws_t)                  # warm-up off the graph
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = ov.onevsall_scores(x_t, ws_t)
    x_t.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert float((out - ov.onevsall_scores_ref(x_t, ws_t)).abs().max()) \
        <= ONEVSALL_ATOL


def _sync_err(got, want):
    torch.cuda.synchronize()
    return float((got - want).abs().max())


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_RAGGED_CASES + [
    (1, 384, 512, 32, 32, 112, True, None, None, 0),      # zamba2 prefill
    (1, 128, 192, 8, 4, 256, True, 64, 50.0, 0),          # GQA/window/cap
    (3, 24, 64, 4, 2, 64, True, 20, 30.0, [0, 17, 40]),   # per-row offset
    (1, 384, 512, 32, 16, 128, True, 64, 50.0, 0),        # d = 128
    (2, 130, 300, 8, 2, 96, True, None, None, [170, 0])])
def test_flash_attention_kernel_matches_plain(cuda, case):
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    got = fa.flash_attention(q, k, v, **kw)
    assert _sync_err(got, fa.flash_attention_ref(q, k, v, **kw)) <= ATTN_ATOL


@pytest.mark.parametrize("case", FLASH_DV_CASES + [
    (1, 384, 512, 16, 16, 192, 128, True, None, None, 0),   # deepseek MLA
    (2, 130, 300, 4, 4, 96, 64, True, None, None, [170, 0])])
def test_flash_attention_kernel_takes_a_value_head_dim(cuda, case):
    # on the 3xTF32 tensor-core kernel, QK and V each at its own width
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    assert fa.on_tensor_cores(d, d_v)
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    got = fa.flash_attention(q, k, v, **kw)
    assert got.shape == (b, s_q, n_q, d_v)
    assert _sync_err(got, fa.flash_attention_ref(q, k, v, **kw)) <= ATTN_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES,
                         ids=[f"edge{i}" for i in range(len(FLASH_EDGE_CASES))])
def test_flash_attention_kernels_at_tile_edges(cuda, case, dtype):
    # the tensor-core kernels' tile edges (testing.FLASH_EDGE_CASES), each
    # dtype within its tolerance
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = (t.to(dtype) for t in
               _t(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v), cuda))
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (b, s_q, n_q, d_v) and got.dtype == dtype
    if dtype == torch.float32:
        assert _sync_err(got, want) <= ATTN_ATOL
    else:
        assert bf16_err(got, want) <= ATTN_BF16_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_replays_in_a_cuda_graph(cuda, dtype):
    # K6 at zamba2's cache prefill, captured once: a replay recomputes from
    # the inputs' new values (the bf16 kernel's tensor maps hold the
    # operands' addresses, which a graph keeps)
    q, k, v = (t.to(dtype) for t in
               _t(attention_case(1, 384, 512, 32, 32, 112), cuda))
    off = torch.zeros((), dtype=torch.int32, device=cuda)
    fa.flash_attention(q, k, v, q_offset=off)      # warm-up off the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    fa.launches = 0
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, q_offset=off)
    assert fa.launches == 1
    q.mul_(-0.5)
    v.add_(1.0)
    off.fill_(128)
    graph.replay()
    want = fa.flash_attention_ref(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert _sync_err(out, want) <= ATTN_ATOL
    else:
        assert bf16_err(out, want) <= ATTN_BF16_RTOL


def test_flash_attention_rejects_a_wrong_value_shape(cuda):
    q, k, v = _t(attention_case(1, 8, 16, 2, 2, 96, d_v=64), cuda)
    with pytest.raises(ValueError, match="v: expected shape"):
        fa.flash_attention(q, k, v[:, :8])           # fewer keys than k
    with pytest.raises(ValueError, match="head dims 64/96"):
        fa.flash_attention(q[..., :64], k[..., :64],
                           torch.zeros(1, 16, 2, 96, device=cuda))


@pytest.mark.parametrize("case", DECODE_CASES + [
    (4, 512, 32, 32, 112, [384, 390, 1, 500], None, None),  # zamba2 decode
    (4, 512, 16, 8, 256, [384, 1, 64, 512], 64, 50.0),      # GQA/window/cap
    (2, 96, 16, 1, 64, [96, 40], None, None)])              # group of 16
def test_decode_attention_kernel_matches_plain(cuda, case):
    b, S, n_q, n_kv, d, clen, window, cap = case
    q, kc, vc = _t(decode_case(b, S, n_q, n_kv, d), cuda)
    cl = torch.as_tensor(clen, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=cap)
    got = da.decode_attention(q, kc, vc, cl, **kw)
    want = da.decode_attention_ref(q, kc, vc, cl, **kw)
    assert _sync_err(got, want) <= ATTN_ATOL


@pytest.mark.parametrize("case", SSD_CASES + [
    (1, 384, 112, 64, 64, 256, False, False),     # zamba2 prefill
    (2, 300, 8, 64, 128, 256, True, False),       # mamba2's state width
    (1, 250, 2, 16, 16, 100, True, True),         # chunk 100
    (2, 300, 2, 64, 64, 256, True, True),         # 4 source tiles a chunk
    (1, 130, 2, 64, 128, 256, False, True),       # n 128, 3 tiles
    (1, 90, 2, 16, 24, 32, True, False)])         # n % 16 == 8
def test_ssd_scan_kernel_matches_plain(cuda, case):
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, init, weak=weak)
    args = _t((x, dt, A, B, C), cuda)
    st = None if st is None else torch.as_tensor(st, device=cuda)
    y, fin = sk.ssd_scan(*args, chunk=chunk, initial_state=st)
    y_ref, fin_ref = sk.ssd_scan_ref(*args, chunk=chunk, initial_state=st)
    torch.cuda.synchronize()
    assert rel_err(y.cpu(), y_ref.cpu()) <= SSD_RTOL
    assert rel_err(fin.cpu(), fin_ref.cpu()) <= SSD_RTOL


# mamba2-2.7b's K8 shape at 14 rows of 32,768 steps: x and y hold 14 x
# 32,768 x 80 x 64 = 2.35e9 elements, past 2^31; row 12 crosses element
# 2^31 and row 13 (from element 2,181,038,080) lies wholly past it
SSD_PAST_2_31 = (14, 32768, 80, 64, 128, 256)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_scan_kernel_past_2_31_elements(cuda, dtype):
    # y and the final state of rows 0, 12 and 13 against the plain version
    # run on that row alone (with its own initial state): every global
    # offset of the state, pass and output kernels past 2^31 elements
    b, s, h, p, n, chunk = SSD_PAST_2_31
    assert (b - 1) * s * h * p > 2 ** 31 > (b - 2) * s * h * p
    kind = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, s, h, p), generator=gen, device=cuda).to(kind)
    dt = torch.rand((b, s, h), generator=gen, device=cuda) * 0.1
    A = -torch.rand((h,), generator=gen, device=cuda) - 0.5
    B, C = ((torch.randn((b, s, n), generator=gen, device=cuda) * 0.3
             ).to(kind) for _ in "BC")
    st = torch.randn((b, h, p, n), generator=gen, device=cuda) * 0.1
    assert sk.path(p, n) == "tensor cores"
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    assert y.dtype == kind and y.numel() > 2 ** 31
    for r in (0, b - 2, b - 1):
        y_ref, fin_ref = sk.ssd_scan_ref(
            x[r:r + 1], dt[r:r + 1], A, B[r:r + 1], C[r:r + 1], chunk=chunk,
            initial_state=st[r:r + 1])
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y[r]).all())
        if kind == BF:
            assert bf16_err(y[r:r + 1], y_ref) <= SSD_BF16_RTOL, r
        else:
            scale = max(1.0, float(y_ref.abs().max()))
            assert _sync_err(y[r:r + 1], y_ref) / scale <= SSD_RTOL, r
        scale = max(1.0, float(fin_ref.abs().max()))
        assert _sync_err(fin[r:r + 1], fin_ref) / scale <= SSD_RTOL, r
        del y_ref, fin_ref


ZAMBA2_DECODE = (4, 512, 32, 32, 112, [385, 390, 395, 399])
ZAMBA2_PREFILL = (1, 384, 112, 64, 64, 256)


def _zamba2_decode(cuda):
    b, S, n_q, n_kv, d, clen = ZAMBA2_DECODE
    q, kc, vc = _t(decode_case(b, S, n_q, n_kv, d), cuda)
    return q, kc, vc, torch.as_tensor(clen, dtype=torch.int32, device=cuda)


def _zamba2_prefill(cuda):
    b, s, h, p, n, _ = ZAMBA2_PREFILL
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, True, weak=True)
    return _t((x, dt, A, B, C, st), cuda)


def test_decode_and_ssd_kernels_are_bit_identical_run_to_run(cuda):
    # the split-KV partials and the SSD's chunk states merge in a fixed
    # order, with no float atomics
    q, kc, vc, cl = _zamba2_decode(cuda)
    assert da.splits(4, 512, 32, None) == (64, 8)
    first = da.decode_attention(q, kc, vc, cl)
    assert all(torch.equal(da.decode_attention(q, kc, vc, cl), first)
               for _ in range(3))
    x, dt, A, B, C, st = _zamba2_prefill(cuda)
    chunk = ZAMBA2_PREFILL[-1]
    assert sk.path(64, 64) == "tensor cores"
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    for _ in range(3):
        y2, fin2 = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
        assert torch.equal(y2, y) and torch.equal(fin2, fin)


def test_decode_and_ssd_kernels_replay_in_a_cuda_graph(cuda):
    # both launchers run several kernels and allocate a workspace per call:
    # captured once, a replay recomputes from the inputs' new values
    q, kc, vc, cl = _zamba2_decode(cuda)
    x, dt, A, B, C, st = _zamba2_prefill(cuda)
    chunk = ZAMBA2_PREFILL[-1]
    da.decode_attention(q, kc, vc, cl)             # warm-up off the graph
    sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, kc, vc, cl)
        y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    q.mul_(-0.5)
    vc.add_(1.0)
    cl.sub_(7)
    x.mul_(0.5)
    st.mul_(-1.0)
    graph.replay()
    assert _sync_err(out, da.decode_attention_ref(q, kc, vc, cl)) \
        <= ATTN_ATOL
    y_ref, fin_ref = sk.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                     initial_state=st)
    torch.cuda.synchronize()
    assert rel_err(y.cpu(), y_ref.cpu()) <= SSD_RTOL
    assert rel_err(fin.cpu(), fin_ref.cpu()) <= SSD_RTOL


# ---------------------------------------------------------------------------
# K6 and K7 in float32 past d = 128: the column-warp and bulk kernels, at
# gemma2-9b's serving shapes and every d > 128 case
# ---------------------------------------------------------------------------
# (b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, softcap, q_offset)
GEMMA2_PREFILLS = [(1, 384, 512, 16, 8, 256, 256, True, None, 50.0, 0),
                   (1, 384, 512, 16, 8, 256, 256, True, 4096, 50.0, 0),
                   (1, 384, 512, 32, 16, 256, 256, True, 64, 50.0, 0)]
WIDE_FLASH = (GEMMA2_PREFILLS + FLASH_WIDE_CASES
              + [c[:6] + (c[5],) + c[6:] for c in FLASH_CASES
                 + FLASH_RAGGED_CASES if c[5] > 128]
              + [c for c in FLASH_EDGE_CASES if c[5] > 128 and c[5] == c[6]])
# (b, S, n_q, n_kv, d, cache_len, window, softcap)
GEMMA2_DECODES = [(4, 512, 16, 8, 256, [385, 390, 395, 399], None, 50.0),
                  (4, 512, 16, 8, 256, [385, 390, 395, 399], 4096, 50.0),
                  (4, 512, 32, 16, 256, [385, 390, 395, 399], 64, 50.0)]
WIDE_DECODE = (GEMMA2_DECODES + [c for c, _ in DECODE_WIDE_CASES]
               + [c for c in DECODE_CASES if c[4] > 128])


@pytest.mark.parametrize("case", WIDE_FLASH,
                         ids=[f"wide{i}" for i in range(len(WIDE_FLASH))])
def test_flash_attention_column_warps_match_plain(cuda, case):
    # float32 K6 past d = 128 on the column-warp 3xTF32 kernel: within
    # ATTN_ATOL of the plain version, the same bits on a second call
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    assert fa.on_tensor_cores(d, d_v)
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    fa.launches = 0
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == 1
    assert _sync_err(got, fa.flash_attention_ref(q, k, v, **kw)) <= ATTN_ATOL
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("case", WIDE_DECODE,
                         ids=[f"wide{i}" for i in range(len(WIDE_DECODE))])
def test_decode_attention_bulk_kernel_matches_plain(cuda, case):
    # float32 K7 past d = 128 on the bulk kernel (one launch, the splits
    # merged by each row's last block): within ATTN_ATOL, bit-identical
    # run to run
    b, S, n_q, n_kv, d, clen, window, cap = case
    q, kc, vc = _t(decode_case(b, S, n_q, n_kv, d), cuda)
    assert da.on_bulk(q, kc, vc)
    cl = torch.as_tensor(np.broadcast_to(np.asarray(clen), (b,)).copy(),
                         dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=cap)
    da.launches = 0
    got = da.decode_attention(q, kc, vc, cl, **kw)
    assert da.launches == 1
    assert _sync_err(got, da.decode_attention_ref(q, kc, vc, cl, **kw)) \
        <= ATTN_ATOL
    assert all(torch.equal(da.decode_attention(q, kc, vc, cl, **kw), got)
               for _ in range(3))


def test_decode_attention_bulk_splits_fill_the_card(cuda):
    # one 192 KB block an SM; gemma2's serving decode (4 rows x 2 blocks of
    # 4 kv-heads) in one wave: 16 splits of 32 slots, 128 blocks on the
    # 132 SMs
    q, kc, vc = _t(decode_case(4, 512, 16, 8, 256), cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert da.resident_blocks(256, q.get_device(), torch.float32) == sms
    assert da.plan(q, kc, vc, None) == da.bulk_splits(4, 512, 8, None, sms)
    if sms == 132:
        assert da.plan(q, kc, vc, None) == (32, 16)


def test_wide_attention_kernels_replay_in_a_cuda_graph(cuda):
    # gemma2's float32 prefill and decode step, captured once after a
    # warm-up: a replay recomputes from the inputs' new values (the bulk
    # kernel's arrival counts are back at 0 after every launch)
    b, s_q, s_kv, n_q, n_kv, d, _, causal, window, cap, _ = GEMMA2_PREFILLS[0]
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d), cuda)
    off = torch.zeros((), dtype=torch.int32, device=cuda)
    fkw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    b, S, n_q, n_kv, d, clen, window, cap = GEMMA2_DECODES[0]
    qd, kc, vc = _t(decode_case(b, S, n_q, n_kv, d), cuda)
    cl = torch.as_tensor(clen, dtype=torch.int32, device=cuda)
    dkw = dict(window=window, softcap=cap)
    fa.flash_attention(q, k, v, **fkw)             # warm-up off the graph
    da.decode_attention(qd, kc, vc, cl, **dkw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    fa.launches = da.launches = 0
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, **fkw)
        dout = da.decode_attention(qd, kc, vc, cl, **dkw)
    assert fa.launches == da.launches == 1
    # new values as the zamba2 graph test's, then new queries and lengths
    # again: the second replay also needs the arrival counts back at 0
    q.mul_(-0.5)
    v.add_(1.0)
    off.fill_(64)
    vc.add_(1.0)
    for _ in range(2):
        qd.mul_(-0.5)
        cl.sub_(7)
        graph.replay()
        assert _sync_err(out, fa.flash_attention_ref(q, k, v, **fkw)) \
            <= ATTN_ATOL
        assert _sync_err(dout, da.decode_attention_ref(qd, kc, vc, cl,
                                                       **dkw)) <= ATTN_ATOL


def test_wide_attention_kernels_refuse_operands_that_require_grad(cuda):
    # K7 is forward only: a d = 256 cache that requires grad raises through
    # ops and launches nothing; K6 takes such operands only through
    # FlashAttention (the kernel forward, the plain VJP backward)
    q, kc, vc = _t(decode_case(2, 64, 4, 2, 256), cuda)
    kc.requires_grad_(True)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward only"):
        ops.decode_attention(q, kc, vc, 40, softcap=50.0)
    assert sum(ops.launch_counts().values()) == 0
    with torch.no_grad():
        ops.decode_attention(q, kc, vc, 40, softcap=50.0)
    assert ops.launch_counts()["decode_attention"] == 1
    qf, k, v = _t(attention_case(1, 40, 64, 4, 2, 256), cuda)
    k.requires_grad_(True)
    ops.reset_launch_counts()
    out = ops.flash_attention(qf, k, v, softcap=50.0)
    assert out.requires_grad
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_vjp"] == 0
    out.sum().backward()
    assert ops.launch_counts()["flash_attention_vjp"] == 1
    torch.cuda.synchronize()
    assert k.grad is not None and bool(torch.isfinite(k.grad).all())


# ---------------------------------------------------------------------------
# K6, K7 and K8 on bf16 operands (the launch path's compute dtype)
# ---------------------------------------------------------------------------
BF = torch.bfloat16


def _bf(arrays, device):
    return [None if a is None else torch.as_tensor(a, device=device).to(BF)
            for a in arrays]


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_RAGGED_CASES + [
    (1, 384, 512, 32, 32, 112, True, None, None, 0),      # zamba2 prefill
    (1, 128, 192, 8, 4, 256, True, 64, 50.0, 0),          # d = 256
    (3, 24, 64, 4, 2, 64, True, 20, 30.0, [0, 17, 40]),   # per-row offset
    (1, 384, 512, 32, 16, 128, True, 64, 50.0, 0),        # d = 128
    (2, 130, 300, 8, 2, 96, True, None, None, [170, 0]),
    (1, 384, 512, 16, 8, 256, True, None, 50.0, 0),       # gemma2 prefill
    (2, 300, 700, 16, 8, 256, True, 256, 50.0, [400, 0])])
def test_flash_attention_bf16_kernels_match_plain(cuda, case):
    # every d = d_v up to 256 on the bf16 wgmma kernel
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    q, k, v = _bf(attention_case(b, s_q, s_kv, n_q, n_kv, d), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    assert fa.on_tensor_cores(d, d, BF)
    fa.launches = 0
    got = fa.flash_attention(q, k, v, **kw)
    assert got.dtype == BF and fa.launches == 1
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bf16_err(got, want) <= ATTN_BF16_RTOL


@pytest.mark.parametrize("case", FLASH_DV_CASES + [
    (1, 384, 512, 16, 16, 192, 128, True, None, None, 0)])  # deepseek MLA
def test_flash_attention_bf16_kernel_takes_a_value_head_dim(cuda, case):
    # bf16 with d_v < d on the wgmma kernel (MLA's 192 / 128 at <NWG, 12,
    # 8>), one launch a call
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    assert fa.on_tensor_cores(d, d_v, BF)
    q, k, v = _bf(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    fa.launches = 0
    got = fa.flash_attention(q, k, v, **kw)
    assert got.dtype == BF and got.shape == (b, s_q, n_q, d_v)
    assert fa.launches == 1
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bf16_err(got, want) <= ATTN_BF16_RTOL


@pytest.mark.parametrize("case", FLASH_MLA_CASES + [
    (6, 1024, 1024, 16, 16, 192, 128, True, None, None, 0)],  # 128-row blocks
    ids=[f"mla{i}" for i in range(len(FLASH_MLA_CASES) + 1)])
def test_flash_attention_bf16_mla_kernel_at_tile_edges(cuda, case):
    # MLA's value head dim on the wgmma kernel at its tile edges and at
    # unaligned dims (padded by the wrapper), and on two warpgroups
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    assert fa.on_tensor_cores(d, d_v, BF)
    q, k, v = _bf(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    got = fa.flash_attention(q, k, v, **kw)
    assert got.dtype == BF and got.shape == (b, s_q, n_q, d_v)
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bf16_err(got, want) <= ATTN_BF16_RTOL


def test_flash_attention_bf16_mla_replays_in_a_cuda_graph(cuda):
    # MLA's bf16 prefill (d 192 over d_v 128) captured once: a replay
    # recomputes from the inputs' new values
    q, k, v = _bf(attention_case(1, 384, 512, 16, 16, 192, d_v=128), cuda)
    off = torch.zeros((), dtype=torch.int32, device=cuda)
    fa.flash_attention(q, k, v, q_offset=off)      # warm-up off the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    fa.launches = 0
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, q_offset=off)
    assert fa.launches == 1
    q.mul_(-0.5)
    v.add_(1.0)
    off.fill_(128)
    graph.replay()
    want = fa.flash_attention_ref(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert out.shape == (1, 384, 16, 128)
    assert bf16_err(out, want) <= ATTN_BF16_RTOL


@pytest.mark.parametrize("case", FLASH_D64_CASES + [
    # musicgen-medium's 24 / 24 heads at d 64: its causal self-attention
    # (a few rows of prefill_32k's shape, the plain version's scores a few
    # GB), its cross-attention over 256 context keys and its cross decode
    (1, 2048, 2048, 24, 24, 64, 64, True, None, None, 0),
    (2, 4096, 256, 24, 24, 64, 64, False, None, None, 0),
    (7, 1, 256, 24, 24, 64, 64, False, None, None, 0)],
    ids=FLASH_D64_IDS + ["musicgen-self", "musicgen-cross",
                         "musicgen-cross-decode"])
def test_flash_attention_bf16_d64_kernels_match_plain(cuda, case):
    # bf16 at d <= 64: the persistent warp-specialised kernel, the one-row
    # kernel at s_q = 1; one launch, counted as a d <= 64 one; the same
    # bits again
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = _bf(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v,
                                 seed=13), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    assert fa.instance(b, s_q, n_q, d, d_v).startswith(
        "flash_attention_row_kernel<" if s_q == 1
        else "flash_attention_ws_kernel<")
    ops.reset_launch_counts()
    got = fa.flash_attention(q, k, v, **kw)
    assert ops.d64_launch_counts() == {"flash_attention_bf16_d64": 1}
    assert got.dtype == BF and got.shape == (b, s_q, n_q, d_v)
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bf16_err(got, want) <= ATTN_BF16_RTOL
    assert torch.equal(fa.flash_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("s_q", [1, 1000], ids=["row", "persistent"])
def test_flash_attention_bf16_d64_replays_in_a_cuda_graph(cuda, s_q):
    # the d <= 64 kernels captured once and replayed twice: the same result
    # both times (the persistent kernel's static order of work items needs
    # nothing reset between replays), and a replay recomputes from the
    # inputs' new values
    q, k, v = _bf(attention_case(2, s_q, 600, 24, 24, 64), cuda)
    off = torch.full((2,), 600 - s_q, dtype=torch.int32, device=cuda)
    fa.flash_attention(q, k, v, q_offset=off)      # warm-up off the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    fa.launches_d64 = 0
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, q_offset=off)
    assert fa.launches_d64 == 1
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    assert bf16_err(first, fa.flash_attention_ref(q, k, v, q_offset=off)) \
        <= ATTN_BF16_RTOL
    q.mul_(-0.5)
    v.add_(1.0)
    graph.replay()
    want = fa.flash_attention_ref(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert bf16_err(out, want) <= ATTN_BF16_RTOL


@pytest.mark.parametrize("args,want", [
    ((6, 32768, 32, 112, 112), "flash_attention_wgmma_kernel<2, 7, 7>"),
    ((1, 384, 32, 112, 112), "flash_attention_wgmma_kernel<1, 7, 7>"),
    ((2, 1, 8, 112, 112), "flash_attention_wgmma_kernel<1, 7, 7>"),
    ((9, 32768, 28, 128, 128), "flash_attention_wgmma_kernel<2, 8, 8>"),
    ((6, 32768, 16, 192, 128), "flash_attention_wgmma_kernel<2, 12, 8>"),
    ((3, 32768, 16, 256, 256), "flash_attention_wgmma_kernel<2, 16, 16>"),
    ((6, 32768, 24, 64, 64), "flash_attention_ws_kernel<4>"),
    ((7, 1, 24, 64, 64), "flash_attention_row_kernel<4>")])
def test_flash_attention_bf16_instances_on_the_card(cuda, args, want):
    # the built library's routes: d 112, d 128, MLA and d 256 keep their
    # wgmma instances; d <= 64 takes the new kernels
    assert fa.instance(*args) == want


# the bf16 TMA kernel's cases (every CPU emulation case of
# test_decode_attention_source_bf16_tma, which fixes the SM count there)
DECODE_TMA_CASES = [
    (1, 640, 4, 4, 64, [640], None, None),           # the ring wraps
    (2, 590, 8, 2, 112, [590, 333], None, None),     # partial last stage
    (2, 512, 4, 2, 64, [40, 512], 150, None),        # empty window splits
    (3, 200, 6, 3, 32, [1, 150, 200], None, 30.0),   # softcap, d = 32
    (2, 300, 8, 2, 128, [300, 150], 70, None),       # d = 128, a window
    (2, 96, 4, 2, 64, [0, 96], None, None),          # an empty row
    (2, 160, 2, 2, 112, [160, 77], None, None),      # group 1
    (2, 160, 4, 2, 112, [160, 77], None, None),      # group 2
    (1, 130, 8, 2, 64, [130], None, None),           # group 4
    (1, 130, 16, 2, 64, [130], None, 20.0),          # group 8
    (2, 96, 16, 1, 64, [96, 40], None, None),        # group 16
    (1, 70, 32, 1, 64, [70], None, None),            # group 32
    (2, 150, 16, 8, 256, [150, 61], 48, 50.0),       # d = 256, a window
    (1, 200, 16, 8, 256, [200], None, 50.0)]         # d = 256


@pytest.mark.parametrize("case", DECODE_CASES + [
    (4, 512, 32, 32, 112, [384, 390, 1, 500], None, None),  # zamba2 decode
    (4, 512, 16, 8, 256, [384, 1, 64, 512], 64, 50.0),
    (4, 512, 16, 8, 256, [385, 390, 395, 399], None, 50.0),  # gemma2 decode
    (2, 96, 16, 1, 36, [96, 40], None, None)]               # d % 8 != 0
    + DECODE_TMA_CASES)
def test_decode_attention_bf16_kernel_matches_plain(cuda, case):
    # d % 8 == 0 (every d up to 256) on the TMA kernel, d = 36 on the other
    b, S, n_q, n_kv, d, clen, window, cap = case
    q, kc, vc = _bf(decode_case(b, S, n_q, n_kv, d), cuda)
    assert da.on_tma(q, kc, vc) == (d % 8 == 0)
    cl = torch.as_tensor(clen, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=cap)
    got = da.decode_attention(q, kc, vc, cl, **kw)
    assert got.dtype == BF
    want = da.decode_attention_ref(q, kc, vc, cl, **kw)
    torch.cuda.synchronize()
    assert bf16_err(got, want) <= ATTN_BF16_RTOL
    assert torch.equal(da.decode_attention(q, kc, vc, cl, **kw), got)


@pytest.mark.parametrize("case", SSD_CASES + [
    (1, 384, 112, 64, 64, 256, False, False),     # zamba2 prefill
    (2, 300, 8, 64, 128, 256, True, False),       # mamba2's state width
    (1, 250, 2, 16, 16, 100, True, True),         # chunk 100
    (2, 300, 2, 64, 64, 256, True, True),         # 4 source tiles a chunk
    (1, 130, 2, 64, 128, 256, False, True),       # n 128, 3 tiles
    (1, 90, 2, 16, 24, 32, True, False)])         # n % 16 == 8
def test_ssd_scan_bf16_kernel_matches_plain(cuda, case):
    # x, B and C bf16; dt, A and the states float32
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, init, weak=weak)
    x, B, C = _bf((x, B, C), cuda)
    dt, A = _t((dt, A), cuda)
    st = None if st is None else torch.as_tensor(st, device=cuda)
    y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    assert y.dtype == BF and fin.dtype == torch.float32
    y_ref, fin_ref = sk.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                     initial_state=st)
    torch.cuda.synchronize()
    assert bf16_err(y, y_ref) <= SSD_BF16_RTOL
    assert rel_err(fin.cpu(), fin_ref.cpu()) <= SSD_RTOL
    y2, fin2 = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    assert torch.equal(y2, y) and torch.equal(fin2, fin)


def test_bf16_head_dim_256_runs_on_the_hopper_kernels(cuda):
    # gemma2-9b's d = 256 in bf16: K6 on the wgmma kernel, K7 on the TMA
    # kernel (whose library answers a resident count), neither on the
    # CUDA-core kernels; its decode_32k splits fill the card
    assert fa.on_tensor_cores(256, 256, BF)
    props = torch.cuda.get_device_properties(cuda)
    assert da.resident_blocks(256) == \
        props.multi_processor_count * da.TMA_BLOCKS_PER_SM
    q, kc, vc = _bf(decode_case(5, 64, 16, 8, 256), cuda)
    assert da.on_tma(q, kc, vc)
    per, nsplit = da.splits(5, 32768, 8, None, da.resident_blocks(256))
    blocks = 5 * 2 * nsplit
    assert per % 16 == 0 and per * nsplit >= 32768
    assert blocks / (da.resident_blocks(256)
                     * -(-blocks // da.resident_blocks(256))) >= da.WAVE_FILL


def test_decode_attention_bf16_splits_fill_the_card(cuda):
    # the TMA kernel's splits: whole waves of the card's resident blocks
    q, kc, vc, cl = _zamba2_decode(cuda)
    q, kc, vc = (t.to(BF) for t in (q, kc, vc))
    assert da.on_tma(q, kc, vc)
    resident = da.resident_blocks(112)
    props = torch.cuda.get_device_properties(cuda)
    assert resident == props.multi_processor_count * da.TMA_BLOCKS_PER_SM
    # the dry run plans an H100's splits by its SM count: the card's own
    if props.multi_processor_count == da.H100.sms:
        assert da.plan(q, kc, vc, None) == da.plan(q, kc, vc, None,
                                                   da.H100_RESIDENT)
    per, nsplit = da.splits(4, 512, 32, None, resident)
    blocks = 4 * 32 * nsplit
    assert per % 64 == 0 and blocks <= resident * -(-blocks // resident)
    assert blocks / (resident * -(-blocks // resident)) >= da.WAVE_FILL


def test_decode_and_ssd_bf16_kernels_replay_in_a_cuda_graph(cuda):
    # the bf16 launchers (K7's TMA maps hold the caches' addresses): a
    # replay of the captured calls recomputes from the inputs' new values
    q, kc, vc, cl = _zamba2_decode(cuda)
    q, kc, vc = (t.to(BF) for t in (q, kc, vc))
    x, dt, A, B, C, st = _zamba2_prefill(cuda)
    x, B, C = (t.to(BF) for t in (x, B, C))
    chunk = ZAMBA2_PREFILL[-1]
    da.decode_attention(q, kc, vc, cl)             # warm-up off the graph
    sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, kc, vc, cl)
        y, fin = sk.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st)
    q.mul_(-0.5)
    vc.add_(1.0)
    cl.sub_(7)
    x.mul_(0.5)
    st.mul_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert bf16_err(out, da.decode_attention_ref(q, kc, vc, cl)) \
        <= ATTN_BF16_RTOL
    y_ref, fin_ref = sk.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                     initial_state=st)
    torch.cuda.synchronize()
    assert bf16_err(y, y_ref) <= SSD_BF16_RTOL
    assert rel_err(fin.cpu(), fin_ref.cpu()) <= SSD_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_decode_and_ssd_launchers_record_timing_events(cuda, dtype):
    # handed events, K7's launcher records 3 (split, combine) and K8's 4
    # (state, pass, output); the next launch records none
    from repro_torch.kernels import _build
    q, kc, vc, cl = _zamba2_decode(cuda)
    x, dt, A, B, C, st = _zamba2_prefill(cuda)
    q, kc, vc, x, B, C = (t.to(dtype) for t in (q, kc, vc, x, B, C))
    for call, n in ((lambda: da.decode_attention(q, kc, vc, cl), 3),
                    (lambda: sk.ssd_scan(x, dt, A, B, C, chunk=256), 4)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        for e in ev:
            e.record()
        torch.cuda.synchronize()
        _build.time_next_launch(ev)
        call()
        assert _build.launch_events_recorded() == n
        ev[-1].synchronize()
        assert all(ev[i].elapsed_time(ev[i + 1]) > 0 for i in range(n - 1))
        call()
        assert _build.launch_events_recorded() == n   # the last timed one


@pytest.mark.parametrize("route,dtype,d,d_v", [
    ("mma", torch.float32, 128, 128), ("cols", torch.float32, 256, 256),
    ("wgmma", BF, 128, 128), ("simt", BF, 256, 128)])
def test_flash_attention_launchers_record_timing_events(cuda, route, dtype,
                                                        d, d_v):
    # handed two events, each K6 launcher (3xTF32 mma, column warps,
    # wgmma, CUDA cores) records one before and one after its one device
    # kernel; the next, untimed launch records none
    from repro_torch.kernels import _build
    assert fa.on_tensor_cores(d, d_v, dtype) == (route != "simt")
    q, k, v = (t.to(dtype) for t in _t(attention_case(
        2, 200, 300, 8, 2, d, d_v=d_v), cuda))
    call = lambda: fa.flash_attention(q, k, v, q_offset=100)  # noqa: E731
    call()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for e in ev:
        e.record()
    torch.cuda.synchronize()
    _build.time_next_launch(ev)
    call()
    assert _build.launch_events_recorded() == 2
    ev[-1].synchronize()
    assert ev[0].elapsed_time(ev[1]) > 0
    call()
    assert _build.launch_events_recorded() == 2   # the last timed one
    _build.time_next_launch([])                     # nothing handed: none
    call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_DENSE_CASES, ids=FLASH_DENSE_IDS)
def test_flash_attention_kernels_at_dense_heads(cuda, case, dtype):
    # qwen2-7b's and starcoder2-7b's GQA groups of 7 and 9 at d = 128
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    q, k, v = (t.to(dtype) for t in _t(attention_case(
        b, s_q, s_kv, n_q, n_kv, d, seed=11), cuda))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    if dtype == BF:
        assert bf16_err(got, want) <= ATTN_BF16_RTOL
    else:
        assert _sync_err(got, want) <= ATTN_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_DENSE_CASES, ids=DECODE_DENSE_IDS)
def test_decode_attention_kernels_at_dense_heads(cuda, case, dtype):
    b, S, n_q, n_kv, d, clen, window, cap = case
    q, kc, vc = (t.to(dtype) for t in _t(decode_case(b, S, n_q, n_kv, d,
                                                     seed=11), cuda))
    cl = torch.as_tensor(clen, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=cap)
    got = da.decode_attention(q, kc, vc, cl, **kw)
    want = da.decode_attention_ref(q, kc, vc, cl, **kw)
    if dtype == BF:
        assert bf16_err(got, want) <= ATTN_BF16_RTOL
    else:
        assert _sync_err(got, want) <= ATTN_ATOL
    assert torch.equal(da.decode_attention(q, kc, vc, cl, **kw), got)


def test_llm_kernels_refuse_float16_and_mixed_operands(cuda):
    # nothing converts: float16, or bf16 beside float32 where the kernel
    # wants one dtype, raises before a launch
    q, k, v = _t(attention_case(1, 16, 16, 2, 1, 32), cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="share one dtype"):
        ops.flash_attention(q.to(BF), k, v)
    qd, kc, vc = _t(decode_case(1, 32, 2, 1, 32), cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.decode_attention(qd.half(), kc.half(), vc.half(), 8)
    x, dt, A, B, C = _t(ssd_case(1, 32, 2, 8, 8, False)[:5], cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.ssd_scan(x.half(), dt, A, B.half(), C.half(), chunk=16)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(x.to(BF), dt.to(BF), A, B.to(BF), C.to(BF), chunk=16)
    assert all(n == 0 for n in ops.launch_counts().values())


@pytest.mark.parametrize("case", ATTN_GRAD_CASES[:5] + ATTN_GRAD_CASES[-2:],
                         ids=[f"attn{i}" for i in range(7)])
def test_flash_attention_bf16_gradients_are_the_plain_vjp(cuda, case):
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = _bf(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    ops.reset_launch_counts()
    out = _grad_check(cuda, lambda: ops.flash_attention(q, k, v, **kw),
                      lambda: fa.flash_attention_ref(q, k, v, **kw),
                      (q, k, v), (True, True, True), 1)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_vjp"] == 1
    (got, g_got), (want, g_want) = out["kernel"], out["plain"]
    assert got[0].dtype == BF
    assert bf16_err(got[0], want[0]) <= ATTN_BF16_RTOL
    # the backward is the plain version's VJP itself, on the same bf16
    # operands and cotangent: the same bits
    for x, w in zip(g_got, g_want):
        assert x.dtype == BF and torch.equal(x, w)


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=[f"ssd{i}" for i in range(len(SSD_CASES))])
def test_ssd_scan_bf16_gradients_are_the_plain_vjp(cuda, case):
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, init, weak=weak)
    x, B, C = _bf((x, B, C), cuda)
    dt, A = _t((dt, A), cuda)
    st = None if st is None else torch.as_tensor(st, device=cuda)
    operands = (x, dt, A, B, C, st)
    needs = (True, True, True, True, True, init)
    ops.reset_launch_counts()
    out = _grad_check(
        cuda, lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                   initial_state=st),
        lambda: sk.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                initial_state=st), operands, needs, 2)
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_vjp"] == 1
    (got, g_got), (want, g_want) = out["kernel"], out["plain"]
    assert bf16_err(got[0], want[0]) <= SSD_BF16_RTOL
    assert rel_err(got[1].cpu(), want[1].cpu()) <= SSD_RTOL
    for a, w in zip(g_got, g_want):
        assert a.dtype == w.dtype and torch.equal(a, w)


def test_bf16_make_step_train_step_runs_on_the_card(cuda):
    # the launcher's step (make_step, remat, AdamW) on bf16 parameters of
    # qwen2-smoke and zamba2-smoke: K6 and K8 launched on bf16 operands,
    # their VJPs behind them; the loss finite and on the card what it is
    # on the CPU (an average: bf16 noise in the logits does not move it
    # past BF16_LLM_RTOL); the parameters stay bf16, the moments float32
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.testing import BF16_LLM_RTOL, leaf_rel_err, llm_batch
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamW, tree_leaves
    set_reference_precision()
    assert specs.COMPUTE_DTYPE == BF
    for name, want in (("qwen2-7b-smoke", {"flash_attention": 2 * 2,
                                          "flash_attention_bf16": 2 * 2,
                                          "flash_attention_vjp": 2}),
                       ("zamba2-7b-smoke", {"flash_attention": 2,
                                            "flash_attention_bf16": 2,
                                            "ssd_scan": 15,
                                            "ssd_scan_bf16": 15,
                                            "flash_attention_vjp": 1,
                                            "ssd_scan_vjp": 8})):
        cfg_llm = get_config(name)
        cpu_params = tfm.init_params(cfg_llm, 0, "cpu", BF)
        batch = llm_batch(cfg_llm, 2, 40, seed=4)
        fn = specs.make_step(cfg_llm, ShapeConfig("t", 40, 2, "train"),
                             lr=1e-3)[0]
        losses = {}
        for dev in ("cpu", cuda):
            params = sch.tree_map(lambda t: t.to(dev), cpu_params)
            ops.reset_launch_counts()
            new, state, m = fn(params, AdamW(lr=1e-3).init(params),
                               train_loop.to_device(batch, dev))
            losses[dev] = float(m["loss"])
            counts = {**ops.launch_counts(), **ops.bf16_launch_counts()}
            if dev != "cpu":
                assert {k: v for k, v in counts.items() if v} == want, name
                assert all(t.dtype == BF for t in tree_leaves(new))
                assert all(t.dtype == torch.float32
                           for t in tree_leaves(state.mu))
        assert np.isfinite(losses[cuda])
        assert leaf_rel_err(losses[cuda], losses["cpu"]) <= BF16_LLM_RTOL


def test_llm_kernels_reject_bad_operands(cuda):
    q, k, v = _t(attention_case(1, 8, 8, 2, 1, 32), cuda)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, v, q_offset=torch.zeros(3, device=cuda,
                                                         dtype=torch.int32))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 8, 2, 288, device=cuda)
        fa.flash_attention(big, big[:, :, :1], big[:, :, :1])
    x, dt, A, B, C, _ = ssd_case(1, 8, 2, 80, 4, init=False)
    with pytest.raises(ValueError, match="head dim"):
        sk.ssd_scan(*_t((x, dt, A, B, C), cuda), chunk=4)


def test_zamba2_smoke_served_on_the_card_matches_cpu(cuda):
    # the same weights (drawn on the CPU, copied to the card) and requests
    # through LLMServer on both devices
    set_reference_precision()
    cfg_llm = get_config("zamba2-7b-smoke")
    cpu_params = tfm.init_params(cfg_llm, 0, "cpu")
    runs = {}
    for dev, p in (("cpu", cpu_params),
                   ("cuda", sch.tree_map(lambda t: t.to(cuda), cpu_params))):
        srv = LLMServer(cfg_llm, p, num_slots=2, max_seq=64, eos_token=-1)
        rng = np.random.default_rng(0)
        for i in range(3):
            srv.submit(Request(i, rng.integers(0, cfg_llm.vocab_size, 40),
                               max_new_tokens=5))
        ops.reset_launch_counts()
        done = srv.run_until_drained()
        runs[dev] = (done, ops.launch_counts(),
                     len(srv.monitor.series["active_requests"]))
    (cpu_done, cpu_counts, _), (done, counts, steps) = runs["cpu"], runs["cuda"]
    assert cpu_counts == {name: 0 for name in [*ops.KERNELS,
                                               *ops.VJPS]}   # plain on CPU
    # one shared-attention block: K6 per prefill, K7 per decode step; eight
    # Mamba2 layers: K8 eight times per prefill
    assert steps > 0
    assert counts["flash_attention"] == 3
    assert counts["decode_attention"] == steps
    assert counts["ssd_scan"] == 8 * 3
    assert len(done) == 3
    for a, b in zip(done, cpu_done):
        assert a.output == b.output
        assert abs(a.confidence - b.confidence) <= LLM_RTOL


def test_deepseek_smoke_served_on_the_card_matches_cpu(cuda):
    # MoE + MLA through LLMServer: K6 per layer per prefill (MLA's d 96 /
    # d_v 64 on the CUDA-core kernel), no K7 (the absorbed decode)
    set_reference_precision()
    cfg_llm = get_config("deepseek-v2-lite-16b-smoke")
    cpu_params = tfm.init_params(cfg_llm, 0, "cpu")
    runs = {}
    for dev, p in (("cpu", cpu_params),
                   ("cuda", sch.tree_map(lambda t: t.to(cuda), cpu_params))):
        srv = LLMServer(cfg_llm, p, num_slots=2, max_seq=64, eos_token=-1)
        rng = np.random.default_rng(0)
        for i in range(3):
            srv.submit(Request(i, rng.integers(0, cfg_llm.vocab_size, 40),
                               max_new_tokens=5))
        ops.reset_launch_counts()
        runs[dev] = (srv.run_until_drained(), ops.launch_counts())
    (cpu_done, _), (done, counts) = runs["cpu"], runs["cuda"]
    assert counts["flash_attention"] == cfg_llm.num_layers * 3
    assert counts["decode_attention"] == counts["ssd_scan"] == 0
    for a, b in zip(done, cpu_done):
        assert a.output == b.output
        assert abs(a.confidence - b.confidence) <= LLM_RTOL


def test_musicgen_smoke_on_the_card_matches_cpu(cuda):
    # cross-attention over stub context through prefill / decode_step: a
    # self and a cross K6 per layer at prefill, a cross K6 and a K7 per
    # layer at decode; both devices decode the CPU's greedy tokens
    from repro_torch.models import stubs
    set_reference_precision()
    cfg_llm = get_config("musicgen-medium-smoke")
    cpu_params = tfm.init_params(cfg_llm, 0, "cpu")
    ctx = stubs.frontend_embeddings(cfg_llm, 2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg_llm.vocab_size, (2, 30)))
    fed, out = [], {}
    for dev in ("cpu", "cuda"):
        p = sch.tree_map(lambda t: t.to(dev), cpu_params)
        ops.reset_launch_counts()
        logits, cache = tfm.prefill(cfg_llm, p, toks.to(dev),
                                    tfm.init_cache(cfg_llm, 2, 40, dev),
                                    ctx_embed=ctx.to(dev))
        steps = [logits.cpu()]
        for i in range(3):
            if dev == "cpu":
                fed.append(steps[-1].argmax(-1, keepdim=True))
            logits, cache = tfm.decode_step(
                cfg_llm, p, fed[i].to(dev), cache,
                torch.full((2,), 30 + i, device=dev), ctx_embed=ctx.to(dev))
            steps.append(logits[:, 0].cpu())
        out[dev] = (steps, ops.launch_counts())
    (want, cpu_counts), (got, counts) = out["cpu"], out["cuda"]
    n = cfg_llm.num_layers
    assert counts["flash_attention"] == 2 * n + 3 * n
    assert counts["decode_attention"] == 3 * n
    assert cpu_counts["flash_attention"] == 0
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w.numpy()) <= LLM_RTOL


# ---------------------------------------------------------------------------
# the kernels are forward only, K6 and K8 differentiable through their
# plain versions' VJPs; training on the card
# ---------------------------------------------------------------------------
def test_kernels_refuse_operands_that_require_grad(cuda):
    x, ws, _ = onevsall_case(8, 8, 4)
    x, ws = _t((x, ws), cuda)
    q, kc, vc = _t(decode_case(1, 8, 2, 1, 32), cuda)
    fargs = _t(filter_case(1, 8, 8), cuda)
    calls = {"K3": (lambda: ops.onevsall_scores(x, ws), ws),
             "K7": (lambda: ops.decode_attention(q, kc, vc, 4), kc),
             "K1": (lambda: ops.region_filter_mask_batch(*fargs,
                                                         **FILTER_KW),
                    fargs[0])}
    for name, (call, t) in calls.items():
        t.requires_grad_(True)
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match="forward only"):
            call()
        assert sum(ops.launch_counts().values()) == 0, name
        with torch.no_grad():                   # no graph asked for: runs
            call()
        t.requires_grad_(False)
        call()
        torch.cuda.synchronize()
        assert sum(ops.launch_counts().values()) == 2, name


def _grad_check(cuda, call, plain, operands, needs, seed):
    """``call`` (through ``ops``) and ``plain`` on the same CUDA operands,
    ``needs`` of them requiring grad: (forward outputs, gradients) of each,
    against one seeded cotangent per output."""
    for t, need in zip(operands, needs):
        if t is not None:
            t.requires_grad_(need)
    leaves = [t for t, need in zip(operands, needs) if need]
    out = {}
    for what, fn in (("kernel", call), ("plain", plain)):
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        cots = [torch.randn(r.shape, generator=gen, device=cuda)
                for r in res]
        out[what] = ([r.detach() for r in res],
                     torch.autograd.grad(res, leaves, cots))
    return out


@pytest.mark.parametrize("case", ATTN_GRAD_CASES,
                         ids=[f"attn{i}" for i in range(len(ATTN_GRAD_CASES))])
def test_flash_attention_gradients_on_the_card_are_the_plain_vjp(cuda, case):
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = _t(attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v), cuda)
    kw = dict(causal=causal, window=window, softcap=cap,
              q_offset=torch.as_tensor(off, device=cuda))
    ops.reset_launch_counts()
    out = _grad_check(cuda, lambda: ops.flash_attention(q, k, v, **kw),
                      lambda: fa.flash_attention_ref(q, k, v, **kw),
                      (q, k, v), (True, True, True), 1)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_vjp"] == 1
    (got, g_got), (want, g_want) = out["kernel"], out["plain"]
    assert float((got[0] - want[0]).abs().max()) <= ATTN_ATOL
    for x, w in zip(g_got, g_want):
        assert rel_err(x.detach().cpu().numpy(),
                       w.detach().cpu().numpy()) <= ATTN_VJP_RTOL


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=[f"ssd{i}" for i in range(len(SSD_CASES))])
def test_ssd_scan_gradients_on_the_card_are_the_plain_vjp(cuda, case):
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = (None if a is None else
                          torch.as_tensor(a, device=cuda) for a in
                          ssd_case(b, s, h, p, n, init, weak=weak))
    operands = (x, dt, A, B, C, st)
    needs = (True, True, True, True, True, init)
    ops.reset_launch_counts()
    out = _grad_check(
        cuda, lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                   initial_state=st),
        lambda: sk.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                initial_state=st), operands, needs, 2)
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_vjp"] == 1
    (got, g_got), (want, g_want) = out["kernel"], out["plain"]
    for a, w in zip(got, want):
        assert rel_err(a.cpu().numpy(), w.cpu().numpy()) <= SSD_RTOL
    for a, w in zip(g_got, g_want):
        assert rel_err(a.detach().cpu().numpy(),
                       w.detach().cpu().numpy()) <= SSD_VJP_RTOL


def test_zamba2_smoke_train_step_on_the_card_matches_cpu(cuda):
    # the 9-layer zamba2-smoke: one make_train_step step with remat, K6
    # and K8 forward on the card (twice: remat recomputes the block) and
    # their plain VJPs backward, against the same step on the CPU
    from repro_torch.testing import (LLM_GRAD_CARD_RTOL,
                                     assert_train_params_close, leaf_rel_err,
                                     llm_batch)
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamW
    set_reference_precision()
    cfg_llm = get_config("zamba2-7b-smoke")
    cpu_params = tfm.init_params(cfg_llm, 0, "cpu")
    batch = llm_batch(cfg_llm, 2, 40, seed=4)
    runs = {}
    for dev in ("cpu", cuda):
        params = sch.tree_map(lambda t: t.to(dev), cpu_params)
        opt = AdamW(lr=1e-3)
        ops.reset_launch_counts()
        dbatch = train_loop.to_device(batch, dev)
        grads = train_loop.llm_grads(cfg_llm, params, dbatch)[1]
        new, _, m = train_loop.make_train_step(cfg_llm, opt)(
            params, opt.init(params), dbatch)
        runs[dev] = (weights._flatten(new, hwio=False),
                     weights._flatten(grads, hwio=False), float(m["loss"]),
                     ops.launch_counts())
    (p, g, loss, counts), (p0, g0, loss0, cpu_counts) = runs[cuda], runs["cpu"]
    # two calls (llm_grads, the step), each a forward, a remat forward of
    # the one block and a backward
    assert counts["flash_attention"] == 2 * 2
    assert counts["ssd_scan"] == 2 * (1 + 2 * 7)
    assert counts["flash_attention_vjp"] == 2 * 1
    assert counts["ssd_scan_vjp"] == 2 * 8
    assert all(n == 0 for n in cpu_counts.values())
    assert leaf_rel_err(loss, loss0) <= 1e-5
    for k in g0:
        assert leaf_rel_err(g[k], g0[k]) <= LLM_GRAD_CARD_RTOL, k
    assert_train_params_close(p, p0, g0, 1e-3, 1, "zamba2-smoke",
                              rtol=LLM_GRAD_CARD_RTOL)


def test_classifier_loss_on_the_card_has_gradients(cuda):
    from repro_torch.training import data, train_loop
    set_reference_precision()
    params = weights.init_classifier(cfg.CLASSIFIER,
                                     torch.Generator().manual_seed(0), cuda)
    batch = train_loop.to_device(
        next(data.classifier_batches(cfg.CLASSIFIER, 16, 0)), cuda)
    ops.reset_launch_counts()
    grads, (loss, _) = train_loop.classifier_grads(cfg.CLASSIFIER, params,
                                                   batch)
    assert ops.launch_counts()["onevsall_scores"] == 0
    assert torch.isfinite(loss)
    for g in (grads["W"], grads["proj"], grads["conv0"]["w"]):
        assert g.is_cuda and torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("name", ["detector", "fallback", "classifier"])
def test_train_step_on_the_card_matches_cpu_and_itself(cuda, name):
    from repro_torch.testing import (assert_train_runs_match, train_run,
                                     train_runs_identical)
    set_reference_precision()
    card = train_run(name, cuda, 1)
    assert train_runs_identical(card, train_run(name, cuda, 1))
    assert_train_runs_match(card, train_run(name, "cpu", 1), name)


def test_sharded_fused_run_with_store_on_the_card_matches_cpu(cuda):
    # K = 2 shards with the claim-check store on: the store holds the
    # encoded frames as CUDA tensors; results within MODEL_ATOL of the CPU
    from repro_torch.serving.ingest import ArtifactStore
    set_reference_precision()
    det = cfg.DetectorConfig(name="d", image_hw=(32, 32), widths=(8, 16))
    clf = cfg.ClassifierConfig(name="c", crop_hw=(16, 16), widths=(8, 16),
                               feature_dim=16)
    streams = [[synthetic.make_chunk(np.random.default_rng(300 + 10 * i + j),
                                     "traffic", num_frames=2, hw=(32, 32))
                for j in range(2)] for i in range(6)]
    runs = {}
    for dev in ("cuda", "cpu"):
        multi = MultiStreamCoordinator(
            HighLowProtocol(det, clf, device=dev),
            weights.init_detector(det, torch.Generator().manual_seed(0), dev),
            weights.init_classifier(clf, torch.Generator().manual_seed(1),
                                    dev),
            streams, max_batch_chunks=2, batch_window=0.05,
            hot_path="fused", num_shards=2, use_store=True, device=dev)
        ops.reset_launch_counts()
        multi.run(learn=False)
        multi.scheduler.drain()
        runs[dev] = multi
        stored = [e.payload for e in multi.scheduler.store._entries.values()]
        assert stored and all(isinstance(p, torch.Tensor)
                              and p.device.type == dev for p in stored)
        if dev == "cuda":
            assert ops.launch_counts()["region_filter_mask_batch"] > 0
    for name, st in runs["cuda"].scheduler.streams.items():
        other = runs["cpu"].scheduler.streams[name]
        assert len(st.results) == len(other.results) == 2
        for (c1, a, m1), (c2, b, m2) in zip(st.results, other.results):
            assert c1 is c2 and m1 == m2
            np.testing.assert_array_equal(a.prop_valid, b.prop_valid)
            np.testing.assert_allclose(a.fog_scores, b.fog_scores,
                                       atol=MODEL_ATOL, rtol=0)
            np.testing.assert_allclose(a.boxes, b.boxes, atol=MODEL_ATOL,
                                       rtol=0)


def test_integrity_store_repairs_a_corrupted_cuda_payload(cuda):
    from repro_torch.serving.ingest import ArtifactCorrupted, ArtifactStore
    store = ArtifactStore(integrity=True)
    payload = torch.rand(2, 8, 8, 3, device=cuda)
    ref = store.put(payload, key="k0")
    assert ref.nbytes == payload.numel() * 4 and ref.dtype == torch.float32
    assert store.get(ref) is payload
    store.corrupt("k0")
    bad = store._entries["k0"].payload
    assert bad.is_cuda and bad.dtype == payload.dtype
    assert bad.data_ptr() != payload.data_ptr()
    assert not torch.equal(bad, payload)
    with pytest.raises(ArtifactCorrupted):
        store.get(ref)
    store.repair("k0", payload.clone())
    assert torch.equal(store.get(ref), payload)
    assert store.stats["corruptions_detected"] == 1
    assert store.stats["corruptions_repaired"] == 1


# ---------------------------------------------------------------------------
# the dry run's steps (launch/specs.py, launch/dryrun.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_on_the_card_match_cpu(cuda, monkeypatch,
                                                        dtype):
    # make_step's prefill, then one decode step over its cache (rewriting
    # its last slot, so it attends over all of it): K6 and K8
    # once per attention / SSM layer of the prefill, K7 once per attention
    # layer of the step; meta operands launch nothing.  In float32 (set
    # here) the logits agree end to end; in bf16 (the default) each layer
    # the card applies agrees with the CPU's on the CPU's own inputs
    # (testing.LayerTap: bf16 noise grows through the random-weight
    # zamba2-smoke past any fixed bound) and the logits are finite
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.testing import BF16_LLM_RTOL, LayerTap, replay_layers
    dtype = getattr(torch, dtype)
    monkeypatch.setattr(specs, "COMPUTE_DTYPE", dtype)
    set_reference_precision()
    cfg_llm = get_config("zamba2-7b-smoke")
    cpu_params = tfm.init_params(cfg_llm, 0, "cpu", dtype)
    b, s = 2, 48
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg_llm.vocab_size, (b, s)))
    prefill = specs.make_step(cfg_llm, ShapeConfig("p", s, b, "prefill"))[0]
    decode = specs.make_step(cfg_llm, ShapeConfig("d", s, b, "decode"))[0]
    runs, taps = {}, {"prefill": LayerTap(), "decode": LayerTap()}
    for dev in ("cpu", cuda):
        params = sch.tree_map(lambda t: t.to(dev), cpu_params)
        ops.reset_launch_counts()
        with taps["prefill"] if dev == "cpu" else LayerTap():
            logits, cache = prefill(params, toks.to(dev))
        pre = ops.launch_counts()
        ops.reset_launch_counts()
        with taps["decode"] if dev == "cpu" else LayerTap():
            step, _ = decode(params, toks[:, -1:].to(dev), cache,
                             torch.tensor(s - 1, device=dev))
        runs[dev] = (logits.float().cpu(), step.float().cpu(), pre,
                     ops.launch_counts())
    (l0, d0, _, _), (l1, d1, pre, dec) = runs["cpu"], runs[cuda]
    assert pre["flash_attention"] == 1 and pre["ssd_scan"] == 8
    assert dec["decode_attention"] == 1 and dec["ssd_scan"] == 0
    if dtype == torch.float32:
        assert rel_err(l1.numpy(), l0.numpy()) <= LLM_RTOL
        assert rel_err(d1.numpy(), d0.numpy()) <= LLM_RTOL
    else:
        assert torch.isfinite(l1).all() and torch.isfinite(d1).all()
        for what, tap in taps.items():
            assert len(tap.calls) == 9, what
            for i, (kind, err, cache_err, _) in enumerate(
                    replay_layers(cfg_llm, tap.calls, cuda)):
                assert max(err, cache_err) <= BF16_LLM_RTOL, \
                    f"{what} layer {i} ({kind}): {err:.2e}, {cache_err:.2e}"
    ops.reset_launch_counts()
    meta = torch.empty((1, 8, 2, 16), device="meta")
    assert ops.flash_attention(meta, meta, meta).is_meta
    assert all(n == 0 for n in ops.launch_counts().values())


def test_dryrun_runs_a_small_cut_on_the_card(cuda):
    # run_one on zamba2-7b-smoke (9 layers, narrow): the abstract pass,
    # then the step on the card at the batch it picked, in bf16 (every
    # launch a bf16 one)
    from repro_torch.launch import dryrun
    for shape, want in (("decode_32k", {"decode_attention": 1,
                                        "decode_attention_bf16": 1}),
                        ("prefill_32k", {"flash_attention": 1,
                                         "flash_attention_bf16": 1,
                                         "ssd_scan": 8, "ssd_scan_bf16": 8})):
        r = dryrun.run_one("zamba2-7b-smoke", shape, device="cuda",
                           verbose=False, save=False)
        card = r["card"]
        assert r["fits"] and card["batch"] == r["max_batch"] >= 1
        assert {k: v for k, v in card["launches"].items() if v} == want
        assert card["finite"] and card["ms"] > 0 and card["floor_ms"] > 0
        assert card["peak_bytes"] > 0 and card["predicted_peak_bytes"] > 0
        # a decode step's time is the median of DECODE_CALLS calls
        calls = dryrun.DECODE_CALLS if shape == "decode_32k" else 1
        assert card["calls"] == calls
        assert card["ms_min"] <= card["ms"] <= card["ms_max"]
        assert card["over_floor"] == card["ms"] / card["floor_ms"]
