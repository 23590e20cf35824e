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
from repro_torch.kernels import onevsall as ov
from repro_torch.kernels import onevsall_update as ou
from repro_torch.kernels import ops
from repro_torch.kernels import region_filter_mask as rf
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import schema as sch
from repro_torch.models import transformer as tfm
from repro_torch.serving.server import LLMServer, Request
from repro_torch.learning import ContinualLearningPlane, LearningConfig
from repro_torch.testing import (ATTN_ATOL, DECODE_CASES, FILTER_CASES,
                                 FILTER_KW, FLASH_CASES, FLASH_RAGGED_CASES,
                                 IOU_CASES,
                                 LEARN_RTOL, LLM_RTOL, MODEL_ATOL,
                                 ONEVSALL_ATOL, SSD_CASES, SSD_RTOL,
                                 UPDATE_ETA, UPDATE_RTOL, CodecTap,
                                 DetectorTies, assert_baseline_results_match,
                                 attention_case, crop_cases,
                                 crop_tile_cases, decode_case,
                                 filter_case, frame_filter_case, iou_case,
                                 onevsall_case, open_episode, rel_err,
                                 replayed_instances, ssd_case, update_case)
from repro_torch.video import synthetic

pytestmark = pytest.mark.cuda

CROP_CASES = {**crop_cases(), **crop_tile_cases()}


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
            assert counts["iou_matrix"] > 0
            assert counts["region_filter_mask"] == (4 if name == "dds" else 0)
            assert counts["region_filter_mask_batch"] == 0
        else:
            with CodecTap(lambda kind, f, r, q, i: rec.frames[i]) as tap, \
                    DetectorTies(system.theta_loc, system.theta_cls) as ties:
                res[dev] = system.process_chunk(params, chunk.frames)
            assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
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
    ops.iou_matrix(*_t(iou_case(2, 8, 8), cuda))
    ops.region_filter_mask(*_t(frame_filter_case(8, 8), cuda), **FILTER_KW)
    assert ops.launch_counts() == {name: 1 for name in ops.KERNELS}
    boxes, _ = _t(iou_case(2, 8, 8), cuda)
    ops.nms_mask(boxes, torch.rand(2, 8, device=cuda),
                 torch.ones(2, 8, dtype=torch.bool, device=cuda))
    assert ops.launch_counts()["iou_matrix"] == 2    # NMS runs K4a


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
    assert cpu_counts == {name: 0 for name in ops.KERNELS}
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
    (2, 300, 8, 64, 128, 256, True, False)])      # mamba2's state width
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
    assert cpu_counts == {name: 0 for name in ops.KERNELS}    # plain on CPU
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
