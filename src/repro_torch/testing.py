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
# LLM logits, as a fraction of the largest reference logit: float32 through
# a whole model (SSM decays as above in every Mamba2 layer, matmuls of
# thousands of terms summed in another order, renormalised by RMSNorm), so
# each package's float32 forward is itself this far from a float64 one;
# greedy tokens are compared wherever the top-2 logit gap exceeds this
# share of the scale
LLM_RTOL = 1e-3
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


def attention_case(b, s_q, s_kv, n_q, n_kv, d, seed=0):
    """Unit-normal q, k, v: (b, s_q, n_q, d), (b, s_kv, n_kv, d) x 2."""
    rng = np.random.default_rng(seed + 31 * s_q + d)
    return (rng.normal(size=(b, s_q, n_q, d)).astype(np.float32),
            rng.normal(size=(b, s_kv, n_kv, d)).astype(np.float32),
            rng.normal(size=(b, s_kv, n_kv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# K7 decode attention cases: (b, S, n_q, n_kv, d, cache_len, window, softcap)
# ---------------------------------------------------------------------------
DECODE_CASES = [
    (2, 128, 8, 2, 64, [37, 128], None, None),          # per-row lengths
    (3, 96, 6, 3, 32, [1, 50, 96], None, 30.0),         # softcap
    (2, 160, 4, 4, 112, 100, 32, None),                 # scalar len, window
    (1, 64, 4, 2, 256, [64], None, 50.0),               # d=256
    (2, 32, 2, 1, 64, [0, 5], None, None),              # an empty row
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


def rel_err(got, want) -> float:
    """max |got - want| as a share of max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
