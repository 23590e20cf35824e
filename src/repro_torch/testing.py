"""Tolerances and seeded kernel cases shared by the port's tests (the CPU
tests against the JAX package and the on-card kernel tests) and
``chip_smoke.py``.  Each tolerance states why it is not zero."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.regions import compaction_indices
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


def frame_filter_case(n: int, m: int, seed: int = 0):
    """One frame's K4b case: ``filter_case`` at F = 1, frame axis dropped."""
    return tuple(a[0] for a in filter_case(1, n, m, seed))


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


def rel_err(got, want) -> float:
    """max |got - want| as a share of max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
