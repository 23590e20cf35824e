"""Tolerances and seeded kernel cases shared by the port's tests (the CPU
tests against the JAX package and the on-card kernel tests) and
``chip_smoke.py``.  Each tolerance states why it is not zero."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.regions import compaction_indices

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
# simulated latencies and byte counts derived from the codec's bytes
LATENCY_RTOL = 1e-4
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
