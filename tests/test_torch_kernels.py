"""The port's kernel layer on the CPU: each plain PyTorch version against
the JAX function it ports, run as the JAX package's own tests run it
(Pallas interpret mode and the jnp oracle).  The CUDA kernels are held
against these plain versions on the card by tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import iou_filter as jik
from repro.kernels import onevsall as jov
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.testing import (CROP_ATOL, FILTER_CASES, FILTER_KW,
                                 IOU_CASES, ONEVSALL_ATOL, crop_cases,
                                 filter_case, filter_corner_cases,
                                 frame_filter_case, iou_case, iou_nan_case,
                                 nms_corner_cases, onevsall_case,
                                 rand_boxes)

torch.set_num_threads(1)


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


# ---------------------------------------------------------------------------
# K1 region_filter_mask_batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("f,n,m", FILTER_CASES)
def test_region_filter_plain_matches_jax(f, n, m):
    case = filter_case(f, n, m)
    jargs = [jnp.asarray(a) for a in case]
    want_ref = np.asarray(jops.region_filter_mask_batch(
        *jargs, impl="ref", **FILTER_KW))
    want_kernel = np.asarray(jops.region_filter_mask_batch(
        *jargs, impl="interpret", **FILTER_KW))
    got = ops.region_filter_mask_batch(*_t(case), **FILTER_KW).numpy()
    assert got.shape == (f, n) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_kernel)


def test_region_filter_runtime_thresholds_match_static():
    # the port's kernel takes thresholds at run time: per-frame location
    # thresholds folded into the validity mask (theta_loc=-inf in the
    # kernel) equal the JAX per-frame reference filter
    boxes, pv, acc, av, loc = filter_case(3, 64, 64, seed=7)
    tl = np.asarray([0.3, 0.5, 0.7], np.float32)
    want = np.stack([np.asarray(jref.region_filter_mask(
        jnp.asarray(boxes[i]), jnp.asarray(loc[i] >= tl[i]),
        jnp.asarray(acc[i]), jnp.asarray(av[i]), jnp.asarray(loc[i]),
        theta_loc=float(tl[i]), theta_iou=0.3, theta_back=0.5))
        for i in range(3)])
    b, l_, a, av_ = _t([boxes, loc, acc, av])
    got = ops.region_filter_mask_batch(
        b, l_ >= torch.as_tensor(tl)[:, None], a, av_, l_,
        theta_loc=float("-inf"), theta_iou=0.3, theta_back=0.5)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K4a iou_matrix and K4b region_filter_mask (single frame)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,n,m", IOU_CASES)
def test_iou_matrix_plain_matches_jax(b, n, m):
    a, c = iou_case(b, n, m)
    got = ops.iou_matrix(*_t((a, c))).numpy()
    assert got.shape == (b, n, m) and got.dtype == np.float32
    want_ref = np.asarray(jref.iou_matrix(jnp.asarray(a), jnp.asarray(c)))
    np.testing.assert_allclose(got, want_ref, atol=1e-6, rtol=0)
    for i in range(b):                     # the Pallas kernel is 2-D
        want_kernel = np.asarray(jik.iou_matrix(
            jnp.asarray(a[i]), jnp.asarray(c[i]), bn=64, bm=64,
            interpret=True))
        np.testing.assert_allclose(got[i], want_kernel, atol=1e-6, rtol=0)
    assert ops.iou_matrix(*_t((a[0], c[0]))).shape == (n, m)


@pytest.mark.parametrize("n,m", [(64, 32), (130, 70)])
def test_frame_filter_plain_matches_jax(n, m):
    case = frame_filter_case(n, m)
    want = np.asarray(jik.region_filter_mask(
        *(jnp.asarray(a) for a in case), bn=64, bm=64, interpret=True,
        **FILTER_KW))
    got = ops.region_filter_mask(*_t(case), **FILTER_KW).numpy()
    assert got.shape == (n,) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


FILTER_CORNERS = filter_corner_cases()


@pytest.mark.parametrize("case", sorted(FILTER_CORNERS))
def test_region_filter_plain_corners_match_jax(case):
    # the kernels' exactness corners, NaN coordinates among them: the
    # port's plain version (what K1 and K4b equal bit for bit) against the
    # JAX reference frame by frame, and the Pallas kernel on the NaN cases
    arrays, kw = FILTER_CORNERS[case]
    frames = [[jnp.asarray(a[i]) for a in arrays]
              for i in range(arrays[0].shape[0])]
    want = np.stack([np.asarray(jref.region_filter_mask(*fr, **kw))
                     for fr in frames])
    got = ops.region_filter_mask_batch(*_t(arrays), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if case.startswith("nan"):
        np.testing.assert_array_equal(got, np.stack([np.asarray(
            jik.region_filter_mask(*fr, bn=64, bm=64, interpret=True, **kw))
            for fr in frames]))


def test_iou_matrix_plain_propagates_nan_as_jax():
    a, c = iou_nan_case()
    got = ops.iou_matrix(*_t((a, c))).numpy()
    want = np.asarray(jref.iou_matrix(jnp.asarray(a), jnp.asarray(c)))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# K2 crop_gather
# ---------------------------------------------------------------------------
CROP_CASES = crop_cases()
# the Pallas kernel in interpret mode and the eager (op-by-op) JAX program
# cost seconds per shape: run both on one case of each kind (padded
# bucket, OOB pad rows, past the largest bucket); every case runs the
# jitted oracle
CROP_SLOW_CHECKS = {"sweep-6x9", "oob-pad-rows", "bucket-32"}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_crop_gather_plain_matches_jax(case):
    frames, boxes, idxs, out_hw = CROP_CASES[case]
    jargs = (jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(idxs))
    got = ops.crop_gather(*_t((frames, boxes, idxs)), out_hw=out_hw).numpy()
    assert got.shape == (idxs.shape[1], *out_hw, 3)
    want_ref = np.asarray(jref.crop_gather(*jargs, out_hw=out_hw))
    np.testing.assert_allclose(got, want_ref, atol=CROP_ATOL, rtol=0)
    if case in CROP_SLOW_CHECKS:
        want_kernel = np.asarray(jops.crop_gather(*jargs, out_hw=out_hw,
                                                  impl="interpret"))
        np.testing.assert_allclose(got, want_kernel, atol=CROP_ATOL, rtol=0)
        with jax.disable_jit():
            want_eager = np.asarray(jref.crop_gather(*jargs, out_hw=out_hw))
        np.testing.assert_array_equal(got, want_eager)  # same ops, order
    if case == "oob-pad-rows":
        # pad rows clip to the last frame's region-0 crop
        np.testing.assert_array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# K3 onevsall_scores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,d,c", [(64, 17, 10), (130, 33, 21), (8, 8, 4)])
def test_onevsall_plain_matches_jax(b, d, c):
    x, ws, _ = onevsall_case(b, d, c)
    want = np.asarray(jov.onevsall_scores(jnp.asarray(x), jnp.asarray(ws[0]),
                                          interpret=True))
    got = ops.onevsall_scores(*_t((x, ws))).numpy()
    np.testing.assert_allclose(got, want, atol=ONEVSALL_ATOL, rtol=0)


def test_onevsall_widx_matches_classify_multi_einsum():
    x, ws, widx = onevsall_case(37, 17, 8, g=5, seed=3)
    # repro.models.classifier.classify_multi's readout
    want = np.asarray(jax.nn.sigmoid(jnp.einsum(
        "bd,bdc->bc", jnp.asarray(x), jnp.asarray(ws)[jnp.asarray(widx)])))
    got = ops.onevsall_scores(*_t((x, ws, widx))).numpy()
    np.testing.assert_allclose(got, want, atol=ONEVSALL_ATOL, rtol=0)


@pytest.mark.parametrize("g", [64, 320])
def test_onevsall_many_readouts_match_classify_multi_einsum(g):
    # a 64-stream flush stacks 64 readouts; the ensemble path flattens
    # G * T snapshots
    x, ws, widx = onevsall_case(256, 129, 8, g=g, seed=4)
    want = np.asarray(jax.nn.sigmoid(jnp.einsum(
        "bd,bdc->bc", jnp.asarray(x), jnp.asarray(ws)[jnp.asarray(widx)])))
    got = ops.onevsall_scores(*_t((x, ws, widx))).numpy()
    np.testing.assert_allclose(got, want, atol=ONEVSALL_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# dispatch and the plain NMS loop
# ---------------------------------------------------------------------------
def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    x, ws, _ = onevsall_case(8, 8, 4)
    ops.onevsall_scores(*_t((x, ws)))
    ops.region_filter_mask_batch(*_t(filter_case(1, 8, 8)), **FILTER_KW)
    frames, boxes, idxs, out_hw = CROP_CASES["oob-pad-rows"]
    ops.crop_gather(*_t((frames, boxes, idxs)), out_hw=out_hw)
    ops.iou_matrix(*_t(iou_case(2, 8, 8)))
    ops.region_filter_mask(*_t(frame_filter_case(8, 8)), **FILTER_KW)
    boxes = torch.as_tensor(rand_boxes(np.random.default_rng(0), (2, 8)))
    ops.nms_mask(boxes, torch.rand(2, 8), torch.ones(2, 8, dtype=bool))
    ops.nms_greedy(ops.iou_matrix(boxes, boxes), torch.rand(2, 8),
                   torch.ones(2, 8, dtype=bool))
    assert "nms_greedy" in ops.KERNELS
    assert ops.launch_counts() == {name: 0 for name in [*ops.KERNELS,
                                                        *ops.VJPS]}


def test_nms_plain_matches_jax():
    rng = np.random.default_rng(5)
    boxes = rand_boxes(rng, (3, 40))
    scores = rng.random((3, 40), dtype=np.float32)
    valid = rng.random((3, 40)) > 0.3
    want = np.stack([np.asarray(jref.nms_mask(
        jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]),
        0.45)) for i in range(3)])
    got = tref.nms_mask(*_t((boxes, scores, valid)), 0.45)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("f,n", [(3, 40), (2, 256)])
def test_nms_through_dispatch_matches_jax(f, n):
    # ops.nms_mask (the IoU matrix through ops.iou_matrix, then the greedy
    # loop) against the JAX reference mapped over frames; duplicate boxes
    # with equal scores exercise the first-max tie-break
    rng = np.random.default_rng(11 + n)
    boxes = rand_boxes(rng, (f, n))
    boxes[:, 1] = boxes[:, 0]
    scores = rng.random((f, n), dtype=np.float32)
    scores[:, 1] = scores[:, 0]
    valid = rng.random((f, n)) > 0.3
    want = np.asarray(jax.vmap(lambda b, s, v: jops.nms_mask(
        b, s, v, iou_threshold=0.45))(*map(jnp.asarray,
                                           (boxes, scores, valid))))
    got = ops.nms_mask(*_t((boxes, scores, valid)), 0.45)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tref.nms_mask(*_t((boxes, scores, valid)), 0.45))


NMS_CORNERS = nms_corner_cases()


@pytest.mark.parametrize("case", sorted(NMS_CORNERS))
def test_nms_plain_corners_match_jax(case):
    # the greedy loop's exact corners (ties, -0.0, NaN scores and
    # coordinates, -1e30 / -inf scores, an IoU at the threshold and one ulp
    # either side, N = 1, 37, 256): the plain loop and ops.nms_mask on the
    # CPU against the JAX greedy loop mapped over frames
    boxes, scores, valid, thr = NMS_CORNERS[case]
    want = np.asarray(jax.vmap(lambda b, s, v: jops.nms_mask(
        b, s, v, iou_threshold=thr))(*map(jnp.asarray,
                                          (boxes, scores, valid))))
    args = _t((boxes, scores, valid))
    got = tref.nms_mask(*args, thr)
    assert got.shape == valid.shape and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.nms_mask(*args, thr), got)
    if case == "iou-at-threshold":
        # the constructed IoUs are float32(0.45) and one ulp either side
        iou = tref.iou_matrix(args[0], args[0])[:, 0, 1]
        t = np.float32(0.45)
        assert iou.tolist() == [t, np.nextafter(t, np.float32(1)),
                                np.nextafter(t, np.float32(0))]
        assert got[:, 1].tolist() == [False, False, True]
