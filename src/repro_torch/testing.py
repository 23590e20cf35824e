"""Tolerances and seeded kernel cases shared by the port's tests (the CPU
tests against the JAX package and the on-card kernel tests) and
``chip_smoke.py``.  Each tolerance states why it is not zero."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.regions import compaction_indices
from repro_torch.models import moe
from repro_torch.video import codec

# codec frames: a resize + DCT round trip; PyTorch and XLA sum the
# antialiased resize taps and the 8x8 transforms in different orders
CODEC_ATOL = 1e-5
# codec bytes: a coefficient sitting at a rounding half-point may quantize
# one step apart, which moves the exp-Golomb bit count by a few bits
NBYTES_RTOL = 1e-4
# detector / classifier float outputs: convolutions and matmuls accumulate
# in another order than XLA's
MODEL_ATOL = 1e-5
# crop gather, plain version vs the *jitted* JAX program.  The port equals
# the JAX program evaluated eagerly bit for bit (the tests check that too),
# but XLA's compiled form rounds a sample position one ulp differently at
# some pixels, which moves a floor() across an integer: one ulp of a
# position below 128 is at most 2**-17 and pixel values lie in [0, 1]
CROP_ATOL = 2.0 ** -17
# one-vs-all readout: the kernel's fmaf dot product sums K = d+1 terms in
# another order than a BLAS matmul
ONEVSALL_ATOL = 1e-6
# K5 proximal update, as a fraction of the output's scale (rel_err): the
# kernel sums each residual's d+1 products and the gradient's B rows in
# another order than the plain version's two matmuls; one step, nothing
# compounds
UPDATE_RTOL = 1e-5
# the learner's readout W after a whole replay (2 passes over up to 2048
# instances, one K5 step each) or a whole learning-plane run, as a fraction
# of W's scale (rel_err): each step's rounding differences carry into the
# next, and the steps are large at full width (the classifier's features
# have |x|^2 ~ 1.1e3, so eta |x|^2 ~ 330 and a logit near 0 moves its
# head's update by the features' own float error).  Measured on the CPU
# against the JAX package (tests/test_torch_learning.py): 4.8e-7 for
# batch_update over 2048 clustered instances x 2 passes, 1.3e-6 for the
# reduced plane runs, 4.5e-6 for the full-width plane run
LEARN_RTOL = 1e-4
# anything downstream of the Eq. 9 ridge solve (omega, the ensemble's
# scores), as a fraction of its scale: A and b are sums over N x C products
# taken in another order, and the solve multiplies their rounding by the
# condition number of A + vI, which is large because the snapshots of one
# learner's trajectory are nearly collinear.  Measured on the CPU against
# the JAX package (tests/test_torch_learning.py, 5 snapshots, cond 3.3e4):
# omega 1.8e-3 apart, the ensemble's scores 4.6e-5, top-1 labels equal
OMEGA_RTOL = 1e-2
# flash / decode attention: the q.k dot products over d and the softmax
# sums over the keys run in another order (online, tile by tile) than the
# plain version's einsum and softmax; logits are O(1), outputs averages of
# O(1) values
ATTN_ATOL = 1e-5
# SSD scan, as a fraction of the output's largest magnitude: every decay
# exp(cum_i - cum_j) is a difference of two in-chunk cumulative sums, each
# rounded to float32, so a decay carries a relative error of about one ulp
# of |cum| (cumsums summed in another order: a parallel scan, a serial
# float sum, or a double sum rounded once)
SSD_RTOL = 1e-4
# the LLM kernels on bfloat16 operands against their plain versions on the
# same bf16 operands (bf16_err, as a fraction of the largest value in each
# output row, with no floor): both sum in float32 and round the output to
# bf16 once, so a value whose float32 sum lies near a rounding boundary may
# round one bf16 ulp apart -- at most 2^-7 of the value, so at most 2^-7 of
# its row's largest, however small the row's values are.  K6's p.v keeps p
# to ~2^-16 (two bf16 halves), far inside that; K8 adds its float32
# tolerance (SSD_RTOL) before the rounding.  Measured on the CPU, the
# plain versions against the Pallas kernels in interpret mode
# (tests/test_torch_bf16.py): K6 2.36e-3, K7 0, K8 6.17e-3; on an H100,
# the kernels against the plain versions at every path and test-case
# shape and at the dry run's 32k shapes (chip_smoke.phase_*_bf16,
# phase_dryrun_kernels): K6 7.75e-3 and K8 7.81e-3, both at 6 x 32k (one
# ulp where a row's largest value is a power of two), K7 2.43e-3
BF16_ULP = 2.0 ** -7
ATTN_BF16_RTOL = BF16_ULP
SSD_BF16_RTOL = BF16_ULP + SSD_RTOL
# the JAX package's jnp oracles (repro.kernels.ref) round the softmax's p
# to the operands' dtype before p.v (probs.astype(q.dtype)), where its
# Pallas kernels keep p float32, as the port's plain versions and kernels
# do; in bf16 the two differ by about one bf16 ulp of p in each of the
# s_kv terms of the sum.  The reference's own bf16 tolerance for its
# kernels against those oracles (tests/test_kernels.py) is this
BF16_REF_RTOL = 2e-2
# LLM forwards on bf16 parameters, the port against the JAX package at
# dtype=bfloat16, as a fraction of max(1, scale) (rel_err): the reference's
# own tolerance for two bf16 programs of one model (tests/test_extras.py,
# microbatched against one batch).  Every bf16 op rounds, and the two
# packages round at slightly other places (XLA's CPU backend expands the
# logistic of silu into 1 / (1 + exp(-x)) with a rounding after each op,
# and the f32 sums of a bf16 matmul run in another order), so a layer's
# output may differ by an ulp or two of its scale: measured layer by
# layer on identical inputs (tests/test_torch_bf16.py), at most 1.4e-2.
# Through a whole model those differences grow as any bf16 noise does: at
# -smoke width with random weights, one bf16 ulp added to one embedding
# entry moves the JAX package's own logits by 1.6e-1 of their scale on
# zamba2, 2.2e-2 on deepseek-v2-lite, 1.4e-2 on qwen2, 1.2e-2 on mamba2
# and musicgen.  So each layer (and its cache) is held to this on the JAX
# layer's own inputs, the loss end to end (measured 2.7e-3 at most), and
# the logits end to end where a model is not that sensitive (qwen2
# 1.5e-2, musicgen 1.6e-2 against the Pallas kernels in interpret mode)
BF16_LLM_RTOL = 3e-2
# one gradient leaf of a bf16 train step on the card against the CPU's,
# ||g - g0|| / ||g0|| (its size and direction at once; chip_smoke's
# launcher check).  The bf16 rounding noise that grows through the model
# (BF16_LLM_RTOL) moves single gradient entries far: measured on an H100
# at zamba2-7b's full width cut to 9 layers, 128 tokens, the worst leaf
# 0.291 (an SSM layer's D, 112 entries, each a sum over the tokens), the
# median 0.111, and the same step with no kernel at all (K6 and K8 on
# their plain versions) 0.295 and 0.102: the spread is the bf16
# program's own between the two devices.  A missing leaf is 1 off, a
# reversed one 2, one scaled by 1.5 or 0.5 is 0.5 off
BF16_GRAD_RTOL = 0.5
# MoE layer output, as a fraction of its scale (rel_err): the router's
# and the experts' products sum d_model and moe_d_ff terms in another order
# than XLA's, and a token's k expert rows are summed in the routed order;
# routing itself is equal (no probability lies within float error of
# another on the tests' inputs, and exact ties break alike)
MOE_RTOL = 1e-5
# LLM logits, as a fraction of the largest reference logit: float32 through
# a whole model (SSM decays as above in every Mamba2 layer, matmuls of
# thousands of terms summed in another order, renormalised by RMSNorm), so
# each package's float32 forward is itself this far from a float64 one;
# greedy tokens are compared wherever the top-2 logit gap exceeds this
# share of the scale
LLM_RTOL = 1e-3
# LLM training: the loss and each gradient leaf as a fraction of its scale
# (leaf_rel_err), against the JAX package on the CPU at -smoke sizes.  The
# backward sums over batch and sequence in another order than XLA's, and
# through every Mamba2 layer the SSD's decays are rounded differences of
# cumsums (SSD_RTOL), so a float32 gradient is itself this far from
# another summation order's.  Measured (tests/test_torch_llm_training.py):
# losses within 1.4e-6; gradients within 2.3e-5 for every family but
# zamba2, whose SSM leaves reach 3.8e-4
LLM_GRAD_RTOL = 1e-3
# LLM training, the card against the CPU (gradient leaves and parameters
# after a step, as for LLM_GRAD_RTOL): at full width the float32 program
# is this sensitive to summation order by itself.  Measured on an H100
# (chip_smoke.phase_llm_train_reference) on zamba2-7b cut to 9 layers at
# full width, 1 x 256 tokens: the plain program on the card, no kernel at
# all, 1.76e-3 from the CPU; with K6 and K8 forward 1.52e-3; losses within
# 1e-6 relative.  The 9-layer zamba2-smoke (tests/test_torch_cuda.py)
# 1.08e-3
LLM_GRAD_CARD_RTOL = 1e-2
# the plain versions' VJPs (flash_attention_vjp, ssd_scan_vjp) against
# jax.vjp of the JAX references, as a fraction of max(1, scale) (rel_err):
# the same sums in another order.  Measured on the CPU: attention 5.3e-7,
# SSD 5.2e-6 (its decays as SSD_RTOL says)
ATTN_VJP_RTOL = 1e-5
SSD_VJP_RTOL = 1e-4
# simulated latencies and byte counts derived from the codec's bytes
LATENCY_RTOL = 1e-4
# video-model training (losses, gradients, parameters after a few steps),
# as a fraction of each tensor's scale (leaf_rel_err): a weight gradient
# sums over the batch and every position (up to 16 x 64 x 64 terms) in
# another order than XLA's or cuDNN's.  Measured on the CPU against the JAX
# package (tests/test_torch_training.py): losses 1.6e-7 apart, gradients
# 1.7e-6 of their leaf's scale, parameters after 3 steps 6e-8; on an H100
# against the CPU at full width (chip_smoke.py, cuDNN's deterministic
# algorithms): losses 3.4e-7, the detector's first gradients 3.7e-5,
# parameters after 3 steps 5.4e-6.  Parameters get one allowance more
# (assert_train_params_close): Adam's first step moves an entry by about
# lr * sign(g), so an entry whose first gradient lies within its float
# error of zero (TRAIN_RTOL of the leaf's gradient scale) may step the
# other way on another device.  That is not a port bug; such entries may
# differ by 2 * lr * steps
TRAIN_RTOL = 1e-4
# a discrete output (valid, label, source) may differ only where the float
# that decides it lies this close to its threshold
THRESHOLD_TIE = 1e-5

# the §IV.B thresholds the kernel cases run with
FILTER_KW = dict(theta_loc=0.4, theta_iou=0.3, theta_back=0.5)


def rand_boxes(rng: np.random.Generator, shape) -> np.ndarray:
    """Random xyxy boxes in [0, 1]: (*shape, 4) float32."""
    pts = rng.random(tuple(shape) + (2, 2), dtype=np.float32)
    return np.concatenate([pts.min(-2), pts.max(-2)], -1)


# ---------------------------------------------------------------------------
# K1 region filter cases: (proposals, prop_valid, accepted, acc_valid, loc)
# ---------------------------------------------------------------------------
FILTER_CASES = [(1, 64, 64), (3, 64, 32), (4, 130, 70), (2, 256, 256)]


def filter_case(f: int, n: int, m: int, seed: int = 0):
    rng = np.random.default_rng(seed + 1000 * f + n)
    return (rand_boxes(rng, (f, n)), rng.random((f, n)) > 0.2,
            rand_boxes(rng, (f, m)), rng.random((f, m)) > 0.2,
            rng.random((f, n), dtype=np.float32))


def frame_filter_case(n: int, m: int, seed: int = 0):
    """One frame's K4b case: ``filter_case`` at F = 1, frame axis dropped."""
    return tuple(a[0] for a in filter_case(1, n, m, seed))


def _valid_count(rng, f: int, m: int, k: int) -> np.ndarray:
    """(F, M) masks with exactly ``k`` valid slots a frame, at random."""
    av = np.zeros((f, m), bool)
    for i in range(f):
        av[i, rng.choice(m, k, replace=False)] = True
    return av


def _nan_coords(rng, boxes, mask, k: int) -> np.ndarray:
    """``boxes`` with one NaN coordinate (each of x1, y1, x2, y2 in turn) in
    ``k`` of the (F, N) slots where ``mask`` holds."""
    boxes = boxes.copy()
    slots = np.argwhere(mask)
    for i, (f, n) in enumerate(slots[rng.choice(len(slots), k,
                                                replace=False)]):
        boxes[f, n, i % 4] = np.nan
    return boxes


def filter_corner_cases() -> Dict[str, Tuple[tuple, dict]]:
    """name -> ((proposals (F, N, 4), prop_valid (F, N), accepted (F, M, 4),
    acc_valid (F, M), loc (F, N)), thresholds): the region filter's exact
    corners, for K1 whole and for K4b frame by frame.  NaN coordinates in
    a valid accepted box, an invalid one and a proposal, and a valid
    accepted box of NaN area (a NaN IoU or area drops the proposal in the
    reference, as ``jnp.max`` propagates it);
    theta_iou <= 0 (the max starts at 0, so every proposal drops); no,
    one, and 7 / 13 / 37 valid accepted boxes a frame (not multiples of a
    warp's 32 lanes); ragged N; an all-rejected and an all-kept
    8-proposal tile; more accepted boxes than one staging pass (256); the
    serving path's sparse accepted sets (a few boxes after NMS, the
    proposals being the accepted boxes themselves) and a dense 80% case."""
    kw = dict(FILTER_KW)
    cases = {}
    # the fault as first seen: the NaN box drops both proposals
    cases["nan-first-seen"] = ((
        np.array([[[.1, .1, .5, .5], [.2, .2, .3, .3]]], np.float32),
        np.ones((1, 2), bool),
        np.array([[[np.nan, .6, .9, .9], [.6, .6, .9, .9]]], np.float32),
        np.ones((1, 2), bool), np.full((1, 2), .9, np.float32)), kw)
    rng = np.random.default_rng(77)
    p, pv, a, av, loc = filter_case(3, 40, 48, seed=5)
    first = np.zeros_like(av)
    first[0] = True                # frames 1 and 2 keep some proposals
    cases["nan-valid-acc"] = ((p, pv, _nan_coords(rng, a, av & first, 2),
                               av, loc), kw)
    cases["nan-invalid-acc"] = ((p, pv, _nan_coords(rng, a, ~av, 6), av,
                                 loc), kw)
    # a valid accepted box of area inf x 0 = NaN: its IoU with a proposal
    # it does not meet is 0 / NaN
    a_inf, av_inf = a.copy(), av.copy()
    a_inf[0, 0], av_inf[0, 0] = (0.7, 0.7, np.inf, 0.7), True
    cases["nan-area-acc"] = ((p, pv, a_inf, av_inf, loc), kw)
    cases["nan-proposal"] = ((_nan_coords(rng, p, pv, 8), pv, a, av, loc),
                             kw)
    p, pv, a, av, loc = filter_case(2, 40, 32, seed=6)
    cases["theta-iou-zero"] = ((p, pv, a, av, loc), dict(kw, theta_iou=0.0))
    cases["theta-iou-negative"] = ((p, pv, a, av, loc),
                                   dict(kw, theta_iou=-0.25))
    cases["no-valid-acc"] = ((p, pv, a, np.zeros_like(av), loc), kw)
    # no pair to walk: only the max's initial 0 drops them
    cases["theta-iou-zero-no-acc"] = ((p, pv, a, np.zeros_like(av), loc),
                                      dict(kw, theta_iou=0.0))
    for k in (1, 7, 13, 37):
        p, pv, a, _, loc = filter_case(2, 40, 64, seed=k)
        cases[f"acc-{k}"] = ((p, pv, a, _valid_count(rng, 2, 64, k), loc),
                             kw)
    cases["ragged-n"] = (filter_case(2, 13, 20, seed=8), kw)
    # three 8-proposal tiles: all below theta_loc, all kept (small boxes
    # far from every accepted box), mixed
    p, pv, a, av, loc = filter_case(1, 24, 32, seed=9)
    pv[:, :16] = True
    loc[:, :8] = 0.1
    loc[:, 8:16] = 0.9
    p[:, 8:16] = rand_boxes(rng, (1, 8)) * 0.1
    a[:] = 0.5 + rand_boxes(rng, (1, 32)) * 0.5
    cases["tiles-rejected-kept"] = ((p, pv, a, av, loc), kw)
    cases["two-passes"] = (filter_case(2, 20, 300, seed=10), kw)
    p, pv, a, _, loc = filter_case(4, 256, 256, seed=11)
    cases["sparse"] = ((p, pv, a, _valid_count(rng, 4, 256, 3), loc), kw)
    cases["dense"] = (filter_case(4, 256, 256, seed=12), kw)
    boxes, _, _, _, loc = filter_case(4, 256, 256, seed=13)
    acc = _valid_count(rng, 4, 256, 5)
    cases["serving"] = ((boxes, loc >= kw["theta_loc"], boxes, acc, loc), kw)
    return cases


def iou_nan_case(b: int = 2, n: int = 40, m: int = 30, seed: int = 0):
    """``iou_case`` with NaN coordinates in a few boxes of each side: the
    IoU of every pair that holds one is NaN, as in the reference."""
    a, c = iou_case(b, n, m, seed)
    rng = np.random.default_rng(seed + 99)
    a = _nan_coords(rng, a, np.ones(a.shape[:2], bool), 4)
    c = _nan_coords(rng, c, np.ones(c.shape[:2], bool), 4)
    return a, c


# ---------------------------------------------------------------------------
# greedy NMS cases: (boxes (F, N, 4), scores (F, N), valid (F, N), threshold)
# ---------------------------------------------------------------------------
# (d, b) with fl(d / b) at float32(0.45) and one ulp either side: the IoU of
# [0, 0, 1, b s] and [0, 0, 1, d s] (s a power of two) is d s / b s with
# every product and the union exact, so it rounds once to fl(d / b)
NMS_IOU_AT_THRESHOLD = {"equal": (9, 20), "ulp-above": (686345, 1525211),
                        "ulp-below": (471865, 1048589)}


def _nms_case(rng, f: int, n: int, valid_frac: float):
    return (rand_boxes(rng, (f, n)), rng.random((f, n), dtype=np.float32),
            rng.random((f, n)) < valid_frac)


def nms_corner_cases() -> Dict[str, Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, float]]:
    """name -> (boxes (F, N, 4), scores (F, N), valid (F, N), threshold):
    the greedy loop's exact corners, for ``nms_mask`` and the NMS kernel.
    Duplicate boxes with equal scores (the first index wins); -0.0 against
    0.0 (a tie); a valid NaN score (the frame keeps nothing) and an invalid
    one (ignored); valid scores at -1e30 and -inf (never kept) beside +inf
    and -9.9e29; NaN coordinates (a NaN IoU never suppresses); an IoU at
    exactly float32(0.45) and one ulp either side; heavy ties; thresholds
    0 and 1; all invalid; N = 1, N = 37 (not a multiple of 4 or 32) and a
    dense N = 256."""
    rng = np.random.default_rng(91)
    thr = 0.45
    cases = {}
    boxes, scores, valid = _nms_case(rng, 2, 8, 1.0)
    boxes[:, 1] = boxes[:, 0]
    boxes[:, 3] = boxes[:, 4] = boxes[:, 2]
    scores[:, 1] = scores[:, 0]
    scores[:, 3] = scores[:, 4] = scores[:, 2]
    cases["duplicates-equal-scores"] = (boxes, scores, valid, thr)
    box = np.array([.2, .2, .6, .7], np.float32)
    boxes = np.broadcast_to(box, (3, 3, 4)).copy()
    scores = np.array([[-0.0, 0.0, 0.0], [0.0, -0.0, -0.0],
                       [-0.0, -0.0, 0.0]], np.float32)
    cases["negative-zero"] = (boxes, scores, np.ones((3, 3), bool), thr)
    boxes, scores, valid = _nms_case(rng, 2, 8, 0.7)
    valid[0, 3] = True
    scores[0, 3] = np.nan
    cases["nan-score-valid"] = (boxes, scores, valid, thr)
    boxes, scores, valid = _nms_case(rng, 2, 8, 0.7)
    valid[:, 2] = False
    scores[:, 2] = np.nan
    cases["nan-score-invalid"] = (boxes, scores, valid, thr)
    boxes = rand_boxes(rng, (2, 6)) * 0.1 + np.arange(6, dtype=np.float32
                                                       )[:, None] * 0.15
    boxes[1, 1] = boxes[1, 0]           # a -1e30 box on a kept one
    scores = np.array([[0.5, -1e30, -np.inf, 0.3, -9.9e29, np.inf],
                       [0.5, -1e30, -np.inf, -1e30, 0.2, -np.inf]],
                      np.float32)
    cases["neg-1e30-and-inf"] = (boxes, scores, np.ones((2, 6), bool), thr)
    boxes, scores, valid = _nms_case(rng, 2, 40, 0.8)
    cases["nan-coords"] = (_nan_coords(rng, boxes, valid, 8), scores, valid,
                           thr)
    s = np.float32(2.0 ** -23)
    boxes = np.zeros((3, 2, 4), np.float32)
    for f, (d, b) in enumerate(NMS_IOU_AT_THRESHOLD.values()):
        boxes[f, 0] = (0, 0, 1, b * s)
        boxes[f, 1] = (0, 0, 1, d * s)
    cases["iou-at-threshold"] = (boxes, np.tile(np.float32([.9, .5]), (3, 1)),
                                 np.ones((3, 2), bool), thr)
    boxes, _, valid = _nms_case(rng, 2, 64, 0.8)
    scores = rng.integers(0, 4, (2, 64)).astype(np.float32) / 4
    cases["ties"] = (boxes, scores, valid, thr)
    cases["threshold-zero"] = (*_nms_case(rng, 2, 40, 0.8), 0.0)
    boxes, scores, valid = _nms_case(rng, 2, 40, 0.8)
    boxes[:, 5] = boxes[:, 6]
    cases["threshold-one"] = (boxes, scores, valid, 1.0)
    cases["all-invalid"] = (*_nms_case(rng, 2, 16, 0.0), thr)
    boxes, scores, valid = _nms_case(rng, 3, 1, 1.0)
    valid[1] = False
    cases["n1"] = (boxes, scores, valid, thr)
    boxes, scores, valid = _nms_case(rng, 3, 37, 0.7)
    boxes[:, 36] = boxes[:, 0]
    cases["n37"] = (boxes, scores, valid, thr)
    cases["dense-256"] = (*_nms_case(rng, 4, 256, 0.9), thr)
    return cases


# ---------------------------------------------------------------------------
# K4a IoU cases: (B, N, M) -- the JAX package's IoU sweep (B = 1) and the
# flush's NMS shape
# ---------------------------------------------------------------------------
IOU_CASES = [(1, 64, 32), (1, 200, 100), (1, 13, 7), (1, 256, 256),
             (4, 256, 256)]


def iou_case(b: int, n: int, m: int, seed: int = 0):
    """(boxes_a (B, N, 4), boxes_b (B, M, 4)), with exact duplicates,
    nested boxes and zero-area boxes among them (IoU 1, and the union's
    1e-9 floor)."""
    rng = np.random.default_rng(seed + 7 * n + m)
    a, c = rand_boxes(rng, (b, n)), rand_boxes(rng, (b, m))
    k = min(n, m) // 4
    a[:, k:2 * k, 2:] = a[:, k:2 * k, :2]                # zero-area
    c[:, :2 * k] = a[:, :2 * k]                          # duplicates
    return a, c


# ---------------------------------------------------------------------------
# K2 crop gather cases: (frames, boxes, idxs, out_hw), the cases of the JAX
# package's crop-kernel tests
# ---------------------------------------------------------------------------
def _crop_case(f, n, hw, valid_frac, seed):
    rng = np.random.default_rng(seed)
    frames = rng.random((f, *hw, 3), dtype=np.float32)
    boxes = rand_boxes(rng, (f, n))
    boxes[0, 0] = [0.5, 0.5, 0.5, 0.5]        # zero-area
    boxes[0, 1] = [0.0, 0.0, 1.0, 1.0]        # full frame
    pv = rng.random((f, n)) < valid_frac
    return frames, boxes, pv


def _plan(pv, buckets=(4, 8, 16, 32, 64, 128)) -> np.ndarray:
    fidx, ridx, _, bucket = compaction_indices(pv, buckets)
    idxs = np.zeros((3, bucket), np.int32)
    idxs[0], idxs[1] = fidx, ridx
    return idxs


def crop_cases() -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    Tuple[int, int]]]:
    cases = {}
    for f, n, hw, out_hw, frac in [
            (6, 9, (32, 32), (16, 16), 0.3),    # generic padded bucket
            (4, 16, (24, 40), (8, 8), 0.0),     # empty flush: all OOB pad
            (3, 5, (16, 16), (16, 16), 1.0),    # all valid, non-square
            (8, 12, (32, 32), (16, 16), 0.5),
            (5, 30, (48, 48), (16, 16), 0.9)]:  # past the largest bucket
        frames, boxes, pv = _crop_case(f, n, hw, frac, f * 1000 + n)
        cases[f"sweep-{f}x{n}"] = (frames, boxes, _plan(pv), out_hw)
    frames, boxes, _ = _crop_case(3, 4, (16, 16), 0.0, 11)
    cases["oob-pad-rows"] = (frames, boxes, np.array(
        [[3, 3, 0, 2], [0, 0, 0, 1], [0, 0, 0, 0]], np.int32), (8, 8))
    frames, boxes, _ = _crop_case(4, 8, (16, 16), 0.0, 12)
    for n_set in (0, 4, 5, 32):                 # bucket boundaries (4, 8)
        pv = np.zeros((4, 8), bool)
        pv.ravel()[:n_set] = True
        cases[f"bucket-{n_set}"] = (frames, boxes, _plan(pv, (4, 8)), (8, 8))
    return cases


def crop_tile_cases() -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray,
                                         Tuple[int, int]]]:
    """K2 cases whose crop is not a whole number of the CUDA kernel's
    128-pixel tiles: 13 x 11 = 143 pixels of 3 channels (every other bucket
    row's output starts off 16-byte alignment) and 9 x 15 = 135 pixels of 5
    channels (the taps load in two passes of 4 channels), each bucket with
    out-of-bounds pad rows."""
    cases = {}
    for f, n, hw, ch, out_hw, seed in [(3, 6, (20, 24), 3, (13, 11), 21),
                                       (2, 4, (16, 16), 5, (9, 15), 22)]:
        rng = np.random.default_rng(seed)
        frames = rng.random((f, *hw, ch), dtype=np.float32)
        boxes = rand_boxes(rng, (f, n))
        boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]    # full frame
        cases[f"tile-{out_hw[0]}x{out_hw[1]}x{ch}"] = (
            frames, boxes, _plan(rng.random((f, n)) < 0.6), out_hw)
    return cases


# ---------------------------------------------------------------------------
# K3 one-vs-all cases: (x, ws, widx)
# ---------------------------------------------------------------------------
def onevsall_case(b: int, d: int, c: int, g: int = 1, seed: int = 0):
    """Unit-normal rows against readouts scaled 1/sqrt(d), as the
    classifier's fan-in init scales W: the logits stay O(1) at any d, so
    the summation-order error stays within ONEVSALL_ATOL."""
    rng = np.random.default_rng(seed + b * 7 + d)
    x = rng.normal(size=(b, d)).astype(np.float32)
    ws = (rng.normal(size=(g, d, c)) / np.sqrt(d)).astype(np.float32)
    widx = rng.integers(0, g, b).astype(np.int32)
    return x, ws, widx


# ---------------------------------------------------------------------------
# K5 proximal update cases: (x, y, w) -- the learner's features (ReLU
# outputs plus the bias-absorbing 1), one-hot labels, a fan-in scaled W
# ---------------------------------------------------------------------------
UPDATE_ETA = 0.3          # the learner's default step


def update_case(b: int, d1: int, c: int, seed: int = 0):
    rng = np.random.default_rng(seed + 11 * b + d1)
    x = np.maximum(rng.normal(size=(b, d1)), 0.0).astype(np.float32)
    x[:, -1] = 1.0
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, b)]
    w = (rng.normal(size=(d1, c)) / np.sqrt(d1)).astype(np.float32)
    return x, y, w


# ---------------------------------------------------------------------------
# K6 flash attention cases:
# (b, s_q, s_kv, n_q, n_kv, d, causal, window, softcap, q_offset)
# ---------------------------------------------------------------------------
FLASH_CASES = [
    (2, 64, 64, 4, 2, 64, True, None, None, 0),        # GQA, causal
    (1, 48, 96, 2, 2, 112, True, None, None, 0),       # cache prefill, d=112
    (2, 40, 80, 4, 2, 32, True, 16, 20.0, 24),         # window, softcap, offset
    (1, 24, 40, 4, 2, 256, False, None, None, 0),      # non-causal, d=256
    (1, 16, 16, 2, 1, 64, True, 4, None, 30),          # rows fully masked
]


# s_q and s_kv not multiples of the tensor-core kernel's 64-row query tile
# and 32-key tile; d = 36 and d = 18 padded with zeros to 64 and 32 (d = 18
# also takes the 4-byte cp.async path)
FLASH_RAGGED_CASES = [
    (2, 70, 45, 4, 2, 36, True, None, None, 0),
    (1, 67, 99, 2, 2, 112, False, None, None, 0),
    (1, 65, 97, 2, 1, 18, True, 24, 15.0, 33),
]


# K6 with a value head dim of its own (MLA's prefill): on the 3xTF32
# tensor-core kernel in float32, on the CUDA-core kernel in bf16:
# (b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, softcap, q_offset)
FLASH_DV_CASES = [
    (1, 40, 64, 4, 4, 192, 128, True, None, None, 8),   # deepseek's dims
    (2, 24, 48, 4, 4, 96, 64, True, None, None, 0),     # its -smoke dims
    (1, 37, 53, 4, 2, 96, 40, False, None, 20.0, 0),    # ragged, GQA, cap
    (2, 33, 70, 2, 1, 64, 48, True, 16, None, [5, 30]),  # d <= 128, window
]


# K6 at the edges of the tensor-core kernels' tiles (query tiles of 32, 64
# and 128 rows, key tiles of 64 and 96, 64-column TMA boxes), in
# FLASH_DV_CASES' layout: s_q = 1
# with per-row offsets; s_q and s_kv off every tile size; d = 18, 36 and
# 112 (zero-padded columns); rows with no valid key beside rows with some
# in one tile; a window that closes whole key tiles; GQA groups of 1, 2
# and 4; MLA's 192 / 128 and its -smoke 96 / 64; gemma2-9b's d = 256
# (16 q-heads over 8, causal, a window shorter than s_kv, softcap 50;
# s_q past a 128-row block, s_kv past 64-key tiles)
FLASH_EDGE_CASES = [
    (2, 1, 300, 8, 2, 112, 112, True, None, None, [299, 100]),
    (1, 200, 333, 4, 4, 18, 18, True, None, None, 133),
    (2, 129, 257, 8, 4, 36, 36, False, None, 20.0, 0),
    (1, 300, 700, 8, 2, 112, 112, True, 100, None, 400),
    (1, 130, 200, 4, 2, 112, 112, True, 32, None, 180),
    (1, 257, 513, 16, 4, 128, 128, True, None, 30.0, 256),
    (1, 200, 264, 16, 16, 192, 128, True, None, None, 64),
    (2, 100, 300, 16, 16, 96, 64, True, None, None, [200, 0]),
    (1, 130, 200, 16, 8, 256, 256, True, 72, 50.0, 70),
]


# K6 in float32 past d = 128 (the column-warp kernel: 32-row blocks, 32-key
# tiles, each warp a 64-column quarter of the padded 256), in
# FLASH_EDGE_CASES' layout: s_q and s_kv off the 32-row and 32-key tiles;
# GQA groups of 1, 2 and 4; a window that closes whole tiles for a row
# group; softcap 50; rows with no valid key beside rows with some;
# per-row offsets; d = 200 (zero columns past it) and d = 130 (4-byte
# copies)
FLASH_WIDE_CASES = [
    (1, 45, 77, 4, 2, 256, 256, True, None, None, 0),
    (2, 33, 70, 4, 4, 256, 256, True, None, 50.0, 0),
    (1, 40, 96, 8, 2, 256, 256, False, None, 50.0, 0),
    (1, 64, 200, 4, 2, 256, 256, True, 40, 50.0, 120),
    (1, 40, 64, 4, 2, 256, 256, True, 4, 50.0, 50),
    (3, 24, 64, 4, 2, 256, 256, True, 20, 30.0, [0, 17, 40]),
    (1, 35, 50, 2, 1, 200, 200, True, None, None, 10),
    (1, 20, 37, 2, 2, 130, 130, False, 16, None, 20),
]


def attention_case(b, s_q, s_kv, n_q, n_kv, d, seed=0, d_v=None):
    """Unit-normal q, k, v: (b, s_q, n_q, d), (b, s_kv, n_kv, d) and
    (b, s_kv, n_kv, d_v), d_v = d unless given."""
    rng = np.random.default_rng(seed + 31 * s_q + d)
    return (rng.normal(size=(b, s_q, n_q, d)).astype(np.float32),
            rng.normal(size=(b, s_kv, n_kv, d)).astype(np.float32),
            rng.normal(size=(b, s_kv, n_kv, d_v or d)).astype(np.float32))


# ---------------------------------------------------------------------------
# K7 decode attention cases: (b, S, n_q, n_kv, d, cache_len, window, softcap)
# ---------------------------------------------------------------------------
DECODE_CASES = [
    (2, 128, 8, 2, 64, [37, 128], None, None),          # per-row lengths
    (3, 96, 6, 3, 32, [1, 50, 96], None, 30.0),         # softcap
    (2, 160, 4, 4, 112, 100, 32, None),                 # scalar len, window
    (1, 64, 4, 2, 256, [64], None, 50.0),               # d=256
    (2, 32, 2, 1, 64, [0, 5], None, None),              # an empty row
    (2, 160, 16, 8, 256, [160, 61], 48, 50.0),          # gemma2's d, window
]


# K7 in float32 past d = 128 (the bulk kernel: tiles of 8 slots of 4
# kv-heads, the splits merged by each row's last block): (case, SMs of an
# emulated card, which size the splits).  Lengths 1 and S; a window that
# leaves splits empty; an empty row (the mean of V); several waves of
# splits (5 SMs); GQA groups of 1, 4 and 8 (two group parts a kv-head);
# 2 kv-heads (half a block); d = 192 and 132; more splits than the merge
# takes into shared memory at once (38 of 23 at a group of 2, 25 of 11 at
# a group of 4)
DECODE_WIDE_CASES = [
    ((1, 300, 4, 2, 256, [290], None, 50.0), 132),
    ((1, 200, 8, 2, 256, [190], None, None), 132),
    ((2, 100, 4, 2, 256, [1, 100], None, None), 132),
    ((2, 256, 16, 8, 256, [40, 256], 100, 50.0), 132),
    ((2, 64, 4, 2, 256, [0, 64], None, None), 132),
    ((2, 200, 16, 8, 256, [200, 123], None, 50.0), 5),
    ((1, 64, 8, 8, 256, [60], None, None), 132),
    ((1, 96, 16, 4, 256, [96], 50, None), 3),
    ((1, 80, 16, 2, 256, [77], None, 30.0), 132),
    ((2, 90, 6, 3, 192, [90, 45], None, None), 2),
    ((1, 70, 4, 4, 132, [70], None, 50.0), 132),
]


def decode_case(b, S, n_q, n_kv, d, seed=0):
    """Unit-normal q (b, n_q, d) and caches (b, S, n_kv, d)."""
    rng = np.random.default_rng(seed + 17 * S + d)
    return (rng.normal(size=(b, n_q, d)).astype(np.float32),
            rng.normal(size=(b, S, n_kv, d)).astype(np.float32),
            rng.normal(size=(b, S, n_kv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# K8 SSD scan cases: (b, s, h, p, n, chunk, with_initial_state, weak_decay)
# ---------------------------------------------------------------------------
SSD_CASES = [
    (2, 64, 3, 8, 16, 16, True, False),
    (1, 100, 2, 16, 8, 32, False, False),   # s not a multiple of the chunk
    (2, 37, 4, 4, 4, 16, True, False),
    (1, 80, 2, 64, 64, 64, True, False),    # zamba2's p = n = 64, partial chunk
    # zamba2's prefill with Mamba2's own dt range: the decay reaches across
    # the kernel's 64-step tiles, the two chunks and the initial state
    (1, 384, 112, 64, 64, 256, True, True),
]


def ssd_case(b, s, h, p, n, init=True, seed=0, weak=False):
    """(x, dt, A, B, C, initial_state or None) with the JAX package's test
    distributions: dt = softplus(N(0,1)), A = -exp(N(0,1)), B and C
    0.5 N(0,1), an initial state 0.1 N(0,1).  ``weak`` draws dt instead
    log-uniform in [1e-3, 0.1], as Mamba2 initialises it, so that a typical
    head decays by about 1/e only every few dozen steps."""
    rng = np.random.default_rng(seed + 13 * s + p)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    if weak:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), size=(b, s, h)))
    else:
        dt = np.log1p(np.exp(rng.normal(size=(b, s, h))))
    dt = dt.astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    B = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    C = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    st = ((0.1 * rng.normal(size=(b, h, p, n))).astype(np.float32)
          if init else None)
    return x, dt, A, B, C, st


def llm_batch(cfg, b: int, s: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A training batch from numpy: tokens and labels (b, s) int32 with
    every seventh label masked (-1), and for a config with frontend
    context 0.02 N(0, 1) embeddings (b, num_ctx_tokens, ctx_dim)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, ::7] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.num_ctx_tokens:
        batch["ctx_embed"] = (0.02 * rng.normal(size=(
            b, cfg.num_ctx_tokens, cfg.ctx_dim or cfg.d_model))
        ).astype(np.float32)
    return batch


def open_episode(plane, scheduler, name: str, t: float = 0.0):
    """Force stream ``name``'s learning site into adaptation as a drift event
    opens an episode: the pre-episode readout anchors Eq. 9's snapshot
    lineage and the episode's detector thresholds apply.  Random-init models
    give the drift detector no signal, so the tests and the on-card checks
    open the episode by hand (as the JAX package's own plane tests force
    the adaptation state).  Works on either package's plane."""
    site = plane._site_for(scheduler.streams[name])
    site.state = "adapt"
    site.episodes += 1
    site.trainer.seed_snapshot(plane._live_W(site), plane._live_version(site))
    plane._apply_theta(site, scheduler, name, t)
    return site


def replayed_instances(zoo, model: str) -> int:
    """Instances the background trainer replayed over all of ``model``'s
    rounds (its candidates' ``lineage["replayed"]``): each costs one K5 step
    per pass."""
    return sum(zoo.get_version(model, v).lineage.get("replayed", 0)
               for v in zoo.versions(model))


class CodecTap:
    """Hand the port's codec calls a reference's decoded frames.

    The codec rounds every 8x8 DCT coefficient to its quantisation step.
    A coefficient within float error of a half-step (measured: 3.9e-8 of a
    step, on a full-width chunk at QP 10) rounds one step apart in two
    programs that sum the transform in another order; that moves one
    block's pixels by up to a quarter step and the detector's outputs far
    past ``MODEL_ATOL``.  To compare what follows the codec, each call of
    ``codec.encode`` / ``codec.encode_inter`` inside the tap runs the port's
    codec as usual (its bytes are kept) and, when ``reference`` is given,
    returns ``reference(kind, frames, r, q, i)``'s frames for its i-th call
    instead, recording how far the port's own frames were from them.
    ``frames`` collects the port's own decoded frames, on the host."""

    def __init__(self, reference: Optional[Callable] = None):
        self.reference = reference
        self.frames: List[np.ndarray] = []
        self.calls: List[dict] = []
        self._saved = {}

    def __enter__(self):
        for kind in ("encode", "encode_inter"):
            self._saved[kind] = getattr(codec, kind)
            setattr(codec, kind, self._tap(kind, self._saved[kind]))
        return self

    def __exit__(self, *exc):
        for kind, fn in self._saved.items():
            setattr(codec, kind, fn)
        return False

    def _tap(self, kind, fn):
        def tapped(frames, r, q):
            enc = fn(frames, r, q)
            own = enc.frames.detach().cpu().numpy()
            self.frames.append(own)
            if self.reference is None:
                return enc
            ref = np.array(self.reference(kind, frames, r, q,
                                          len(self.frames) - 1),
                           np.float32)
            diff = np.abs(own - ref)
            self.calls.append(dict(kind=kind, r=r, q=q,
                                   max_diff=float(diff.max()),
                                   share=float((diff > CODEC_ATOL).mean()),
                                   step=codec.qp_to_step(q)))
            return enc._replace(
                frames=torch.as_tensor(ref, device=enc.frames.device))
        return tapped

    def tie_flips(self) -> int:
        """The calls whose frames were more than ``CODEC_ATOL`` from the
        reference's.  Raises where the difference is more than a flipped
        coefficient can make: over one quantisation step, or on more than
        1% of the pixels."""
        flips = 0
        for c in self.calls:
            if c["max_diff"] <= CODEC_ATOL:
                continue
            if c["max_diff"] > c["step"] or c["share"] > 0.01:
                raise AssertionError(f"codec frames differ beyond a tie: "
                                     f"{c}")
            flips += 1
        return flips


class DetectorTies:
    """Record the tie positions of every detector pass that the baselines
    make inside the context: the (F, N) positions whose location score or
    class confidence lies within ``THRESHOLD_TIE`` of the baseline's
    ``theta_loc`` / ``theta_cls``, where another summation order may
    decide the other way.  :meth:`exempt` takes the union of the passes
    recorded since its last call."""

    MODULES = ("mpeg", "glimpse", "cloudseg", "dds")

    def __init__(self, theta_loc: float, theta_cls: float):
        self.theta_loc, self.theta_cls = theta_loc, theta_cls
        self.masks: List[np.ndarray] = []
        self._saved = {}

    def __enter__(self):
        import importlib
        for name in self.MODULES:
            mod = importlib.import_module(f"repro_torch.baselines.{name}")
            self._saved[mod] = mod.run_detector
            mod.run_detector = self._spy(mod.run_detector)
        return self

    def __exit__(self, *exc):
        for mod, fn in self._saved.items():
            mod.run_detector = fn
        return False

    def _spy(self, run):
        def spy(det_cfg, params, frames):
            det = run(det_cfg, params, frames)
            loc = det["loc_scores"].detach().cpu().numpy()
            conf = det["cls_probs"].amax(-1).detach().cpu().numpy()
            self.masks.append(
                (np.abs(loc - self.theta_loc) <= THRESHOLD_TIE)
                | (np.abs(conf - self.theta_cls) <= THRESHOLD_TIE))
            return det
        return spy

    def exempt(self, shape) -> np.ndarray:
        out = np.zeros(shape, bool)
        for m in self.masks:
            out |= m              # a one-frame pass: every frame it reaches
        self.masks = []
        return out


def assert_baseline_results_match(want, got, exempt: np.ndarray,
                                  what: str = "") -> None:
    """Two ``BaselineResult``s of one chunk: ``valid`` and ``labels`` equal
    away from the ``exempt`` tie positions (which must stay under a
    quarter of the grid), boxes within ``MODEL_ATOL``, the same cloud
    frames and rounds, bytes within ``NBYTES_RTOL``, every latency field
    within ``LATENCY_RTOL``; boxes finite."""
    import dataclasses
    if not np.isfinite(got.boxes).all():
        raise AssertionError(f"{what}: non-finite boxes")
    if got.boxes.shape != want.boxes.shape:
        raise AssertionError(f"{what}: boxes {got.boxes.shape} vs "
                             f"{want.boxes.shape}")
    if exempt.sum() >= exempt.size // 4:
        raise AssertionError(f"{what}: {int(exempt.sum())} tie positions")
    for k in ("valid", "labels"):
        if ((getattr(want, k) != getattr(got, k)) & ~exempt).any():
            raise AssertionError(f"{what}: {k} differs away from ties")
    np.testing.assert_allclose(got.boxes, want.boxes, atol=MODEL_ATOL,
                               rtol=0, err_msg=what)
    if (got.cloud_frames, got.cloud_rounds) != (want.cloud_frames,
                                                want.cloud_rounds):
        raise AssertionError(f"{what}: cloud frames / rounds "
                             f"{got.cloud_frames}/{got.cloud_rounds} vs "
                             f"{want.cloud_frames}/{want.cloud_rounds}")
    np.testing.assert_allclose(got.wan_bytes, want.wan_bytes,
                               rtol=NBYTES_RTOL, err_msg=what)
    for k, v in dataclasses.asdict(want.latency).items():
        np.testing.assert_allclose(getattr(got.latency, k), v,
                                   rtol=LATENCY_RTOL, err_msg=f"{what} {k}")


def leaf_rel_err(got, want) -> float:
    """max |got - want| as a share of max |want| (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = float(np.abs(got - want).max(initial=0.0))
    return diff / float(np.abs(want).max(initial=0.0)) if diff else 0.0


def assert_train_params_close(got: Dict[str, np.ndarray],
                              want: Dict[str, np.ndarray],
                              grads: Dict[str, np.ndarray], lr: float,
                              steps: int, what: str,
                              rtol: float = TRAIN_RTOL) -> float:
    """Flat parameter trees after ``steps`` optimizer steps, within
    ``rtol`` of each leaf's scale, plus ``2 * lr * steps`` on the entries
    whose first-step gradient (``grads``, the same keys) lies within
    ``rtol`` of its leaf's gradient scale (see TRAIN_RTOL).  ``rtol`` is
    the gradients' own tolerance: TRAIN_RTOL for the video models,
    LLM_GRAD_RTOL for an LLM (a zero-initialised leaf after one step is
    ``lr`` times its gradient).  Returns the largest error as a share of
    its leaf's scale away from those entries."""
    if not got.keys() == want.keys() == grads.keys():
        raise AssertionError(f"{what}: the trees' keys differ")
    worst = 0.0
    for k in want:
        g, w, p = (np.asarray(x, np.float64)
                   for x in (grads[k], want[k], got[k]))
        if p.shape != w.shape or not np.isfinite(p).all():
            raise AssertionError(f"{what} {k}: shape {p.shape} vs {w.shape}"
                                 " or non-finite")
        scale = np.abs(w).max(initial=0.0)
        near = np.abs(g) <= rtol * np.abs(g).max(initial=0.0)
        err = np.abs(p - w)
        bound = rtol * scale + np.where(near, 2 * lr * steps, 0.0)
        if (err > bound).any():
            raise AssertionError(f"{what} {k}: {err.max():.3e} apart, over "
                                 f"{rtol} of the scale {scale:.3e}")
        if scale and (~near).any():
            worst = max(worst, float(err[~near].max()) / scale)
    return worst


# the training loops' learning rate, and the full-width runs held card
# against CPU: (config name, batch size) per model, tests/test_system.py's
TRAIN_LR = 1e-3
TRAIN_MODELS = {"detector": ("DETECTOR", 16), "fallback":
                ("FALLBACK_DETECTOR", 8), "classifier": ("CLASSIFIER", 64)}


def train_run(name: str, device, steps: int, seed: int = 5):
    """``steps`` steps of one full-width video model's step function
    (``train_loop.detector_step`` / ``classifier_step``, AdamW as the loops
    build it) on ``device``, from the model's initial parameters drawn on
    the CPU from ``seed`` and the loop's first clean batches.  Returns
    ``(params, first-step grads, losses)``, the trees flat and on the
    host (``weights._flatten``)."""
    from repro_torch import weights
    from repro_torch.configs import vpaas_video
    from repro_torch.training import data, train_loop
    from repro_torch.training.optimizer import AdamW
    cfg_name, batch_size = TRAIN_MODELS[name]
    cfg = getattr(vpaas_video, cfg_name)
    gen = torch.Generator().manual_seed(seed)
    if name == "classifier":
        params = weights.init_classifier(cfg, gen, device)
        batches = data.classifier_batches(cfg, batch_size, seed)
        grads_fn, step_fn = (train_loop.classifier_grads,
                             train_loop.classifier_step)
    else:
        params = weights.init_detector(cfg, gen, device)
        batches = data.detector_batches(cfg, batch_size, seed, "all")
        grads_fn, step_fn = train_loop.detector_grads, train_loop.detector_step
    opt = AdamW(lr=TRAIN_LR, weight_decay=1e-4)
    state = opt.init(params)
    losses, grads = [], None
    for _ in range(steps):
        batch = train_loop.to_device(next(batches), device)
        if grads is None:
            grads = weights._flatten(grads_fn(cfg, params, batch)[0])
        params, state, m = step_fn(cfg, opt, params, state, batch)
        losses.append(float(m["loss"]))
    return weights._flatten(params), grads, losses


def assert_train_runs_match(got, want, what: str) -> Dict[str, float]:
    """Two :func:`train_run` results: losses and first-step gradients
    within TRAIN_RTOL of their scale, parameters by
    :func:`assert_train_params_close`.  Returns the largest errors."""
    (p, g, loss), (p0, g0, loss0) = got, want
    err = {"loss": max(leaf_rel_err(a, b) for a, b in zip(loss, loss0)),
           "grads": max(leaf_rel_err(g[k], g0[k]) for k in g0)}
    if len(loss) != len(loss0) or g.keys() != g0.keys() or max(
            err.values()) > TRAIN_RTOL:
        raise AssertionError(f"{what}: losses or first gradients apart: "
                             f"{err} (TRAIN_RTOL {TRAIN_RTOL})")
    err["params"] = assert_train_params_close(p, p0, g0, TRAIN_LR,
                                              len(loss0), what)
    return err


def train_runs_identical(a, b) -> bool:
    """Two :func:`train_run` results equal bit for bit."""
    (p, g, loss), (p0, g0, loss0) = a, b
    return loss == loss0 and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in y)
        for x, y in ((p, p0), (g, g0)))


def rel_err(got, want) -> float:
    """max |got - want| as a share of max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def bf16_err(got, want) -> float:
    """The largest |got - want| as a share of the largest |want| in its row
    (the last axis), on the tensors' own device: the measure of
    ATTN_BF16_RTOL and SSD_BF16_RTOL.  A bf16 output rounds each value to
    its own ulp, at most 2^-7 of it, so a row of small values is held to
    its own ulps as a row of large ones is (no floor); a row of zeros is
    held to equality."""
    got, want = (torch.as_tensor(t).float() for t in (got, want))
    diff = (got - want).abs()
    scale = want.abs().amax(-1, keepdim=True).expand_as(diff)
    return float(torch.where(diff > 0, diff / scale, 0.0).max()) \
        if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# MoE routing near-ties (card vs CPU LLM checks)
# ---------------------------------------------------------------------------
# a gap between a token's k-th and (k+1)-th routing probability below this
# share of the probabilities' scale (1) is a tie: float noise between two
# devices' forwards can swap the two experts there, and with a capacity
# factor the swap moves drops too
ROUTER_TIE = 1e-5


class RouterTap:
    """Records every MoE layer's input while active (wraps
    ``moe.moe_apply``, which the transformer calls through the module), so
    that a failed check can re-run the layers' routers
    (:func:`router_margin`)."""

    def __init__(self):
        self.calls: List[Tuple[Any, torch.Tensor, torch.Tensor]] = []

    def __enter__(self):
        self._orig = moe.moe_apply

        def tapped(cfg, params, x, **kw):
            self.calls.append((cfg, params["router"], x.detach()))
            return self._orig(cfg, params, x, **kw)
        moe.moe_apply = tapped
        return self

    def __exit__(self, *exc):
        moe.moe_apply = self._orig
        return False


def router_margin(calls) -> float:
    """The smallest gap between a token's k-th and (k+1)-th routing
    probability over every token and MoE layer of ``calls`` (inf without
    one): where it is below ROUTER_TIE, two devices may route apart."""
    gaps = [float(torch.softmax((x @ router).float(), -1)
                  .sort(dim=-1, descending=True).values
                  .diff(dim=-1)[..., cfg.num_experts_per_tok - 1]
                  .abs().min())
            for cfg, router, x in calls]
    return min(gaps, default=float("inf"))


class LayerTap:
    """Records every layer the transformer applies while active (wraps
    ``transformer._apply_layer``, which its forward looks up at call
    time): the layer's kind, its parameters, its inputs (the residual
    stream, positions, context, index, and a copy of its cache as it was)
    and its outputs, so that :func:`replay_layers` can apply each layer
    again on another device to the very same inputs.  In bf16 a whole
    model's rounding noise can grow past any fixed bound (BF16_LLM_RTOL);
    one layer's does not.  Tap a forward without grad: a rematerialised
    block would be recorded twice."""

    def __init__(self):
        self.calls: List[Dict[str, Any]] = []

    def __enter__(self):
        from repro_torch.models import transformer as tfm
        self._tfm, self._orig = tfm, tfm._apply_layer

        def copy(tree):
            return None if not tree else {k: v.detach().clone()
                                          for k, v in tree.items()}

        def tapped(cfg, kind, params, x, *, cache, **kw):
            before = copy(cache)
            out = self._orig(cfg, kind, params, x, cache=cache, **kw)
            self.calls.append(dict(kind=kind, params=params, x=x.detach(),
                                   kw=kw, cache=before,
                                   out=out[0].detach(),
                                   new_cache=copy(out[1])))
            return out
        tfm._apply_layer = tapped
        return self

    def __exit__(self, *exc):
        self._tfm._apply_layer = self._orig
        return False


def replay_layers(cfg, calls, device) -> List[Tuple[str, float, float]]:
    """Each layer of a :class:`LayerTap`'s ``calls`` applied again on
    ``device`` to its recorded inputs and parameters, moved there: (kind,
    the output's rel_err against the recorded one, the worst rel_err of
    its new cache's tensors), each as a fraction of max(1, scale)."""
    from repro_torch.models import transformer as tfm

    def to(t):
        if isinstance(t, dict):
            return {k: to(v) for k, v in t.items()}
        return t.to(device) if isinstance(t, torch.Tensor) else t

    def f(t) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    out = []
    for c in calls:
        with torch.no_grad():
            got, got_cache, _ = tfm._apply_layer(
                cfg, c["kind"], to(c["params"]), to(c["x"]),
                cache=to(c["cache"]), **to(c["kw"]))
        cache_err = max((rel_err(f(got_cache[k]), f(v))
                         for k, v in (c["new_cache"] or {}).items()),
                        default=0.0)
        out.append((c["kind"], rel_err(f(got), f(c["out"])), cache_err))
    return out


# ---------------------------------------------------------------------------
# serving-plane comparisons (sharded, tenancy, chaos): results and reports
# ---------------------------------------------------------------------------
# throughput-report keys that read the host's clock: never compared
REPORT_WALL_KEYS = ("wall", "per_s", "overhead")
# keys only the sharded wrapper (or an attached store) reports
SHARD_ONLY_KEYS = frozenset(("shards", "steals", "store", "store_spills",
                             "batch_stolen", "batch_adopted"))
# the ChunkResult arrays two bitwise-equal runs share
RESULT_ARRAYS = ("boxes", "labels", "valid", "fog_features", "fog_scores")


def report_mismatches(rep_a: dict, rep_b: dict, *, peaks: bool = True,
                      ignore=SHARD_ONLY_KEYS) -> List[str]:
    """Keys of two throughput reports whose values differ, past the
    host-clock keys and ``ignore``.  ``peaks=False`` also passes the
    partition-dependent gauges (which buffers are live at once, per-shard
    occupancy spans, the event count), as the JAX package's sharded tests
    do; ``sched_finalizes`` stays exact."""
    skip = list(REPORT_WALL_KEYS)
    if not peaks:
        skip += ["peak", "occupancy", "sched_events"]
    return sorted(k for k in (set(rep_a) | set(rep_b)) - set(ignore)
                  if not any(s in k for s in skip)
                  and rep_a.get(k) != rep_b.get(k))


def results_mismatch(st_a, st_b, *, arrays=RESULT_ARRAYS) -> Optional[str]:
    """None when two streams finalized the same chunk objects in the same
    modes with bitwise-equal ``arrays``, latencies and byte counts; else
    what differs first."""
    if len(st_a.results) != len(st_b.results):
        return f"{len(st_a.results)} vs {len(st_b.results)} results"
    for i, ((c1, r1, m1), (c2, r2, m2)) in enumerate(
            zip(st_a.results, st_b.results)):
        if c1 is not c2 or m1 != m2:
            return f"result {i}: chunk or mode differs"
        for name in arrays:
            if not np.array_equal(getattr(r1, name), getattr(r2, name)):
                return f"result {i}: {name} differs"
        for name in ("wan_bytes", "coord_bytes"):
            if getattr(r1, name) != getattr(r2, name):
                return f"result {i}: {name} differs"
        if r1.latency.total != r2.latency.total:
            return f"result {i}: latency differs"
    return None


def conservation_errors(streams: Dict[str, Any],
                        submitted: Dict[str, List[Any]]) -> List[str]:
    """Streams whose finalized chunks are not exactly the submitted chunk
    objects, each once and in order (stolen, requeued or not)."""
    return [name for name, chunks in submitted.items()
            if [id(c) for c, _, _ in streams[name].results]
            != [id(c) for c in chunks]]
