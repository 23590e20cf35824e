"""Procedural video datasets with ground truth (DashCam / Drone / Traffic).

Classes are distinguished by *texture* (class-specific stripe frequency and
orientation), not by silhouette: aggressive QP quantization destroys the
high-frequency texture (classification signal) while the object silhouette
(localization signal) survives — this is how the paper's Key Observation 2
emerges from data here instead of being hard-coded.

Content types mirror the paper's Table I datasets:
  * dashcam — few, large, fast objects
  * drone   — many small objects, slow global drift
  * traffic — many medium objects, slow, dense
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

NUM_CLASSES = 8


@dataclass(frozen=True)
class ContentType:
    name: str
    num_objects: Tuple[int, int]      # min/max simultaneous objects
    size: Tuple[float, float]         # min/max object size (frame fraction)
    speed: Tuple[float, float]        # min/max speed (frame fraction / frame)


CONTENT_TYPES: Dict[str, ContentType] = {
    "dashcam": ContentType("dashcam", (2, 4), (0.18, 0.30), (0.010, 0.030)),
    "drone": ContentType("drone", (4, 8), (0.08, 0.14), (0.004, 0.012)),
    "traffic": ContentType("traffic", (5, 10), (0.10, 0.18), (0.003, 0.010)),
}


@dataclass
class VideoChunk:
    frames: np.ndarray                # (T, H, W, 3) float32 in [0,1]
    gt_boxes: np.ndarray              # (T, M, 4) xyxy in [0,1]
    gt_labels: np.ndarray             # (T, M) int32, -1 padding
    content: str


def _texture(cls: int, yy: np.ndarray, xx: np.ndarray,
             rng: np.random.Generator, drift: float = 0.0) -> np.ndarray:
    """Class-signature texture: 4 high-frequency pattern types x 2 bands.

    The class is encoded ONLY in fine texture (wavelength 2.7-4 px at the
    native 128 px resolution); orientation and phase are random per instance.
    Resolution downscaling + QP quantization destroy exactly this band while
    the object silhouette survives -> Key Observation 2 emerges from data.

    ``drift`` migrates the two frequency bands toward each other's position
    (object appearances change over time, §V data drift): at drift=1 the
    bands have fully SWAPPED.  Localization is untouched; a classifier
    trained at drift=0 systematically mislabels the frequency bit — and a
    *last-layer* update can fully recover it (the features still separate
    the bands; only the readout mapping is stale).  Avoid drift=0.5, where
    the bands coincide and no readout can help."""
    ptype, fbit = divmod(cls, 2)
    freq = 32.0 + 16.0 * drift if fbit == 0 else 48.0 - 16.0 * drift
    angle = rng.uniform(0, np.pi)
    phase0 = rng.uniform(0, 2 * np.pi)
    u = np.cos(angle) * xx + np.sin(angle) * yy
    v = -np.sin(angle) * xx + np.cos(angle) * yy
    su = np.sin(2 * np.pi * freq * u + phase0)
    sv = np.sin(2 * np.pi * freq * v + phase0)
    if ptype == 0:       # stripes
        pat = su
    elif ptype == 1:     # checkerboard
        pat = su * sv
    elif ptype == 2:     # dots (sparse bright spots)
        pat = np.where((su > 0.3) & (sv > 0.3), 1.0, -0.6)
    else:                # cross-hatch
        pat = 0.5 * (np.sign(su) + np.sign(sv))
    return 0.5 + 0.45 * np.clip(pat, -1.0, 1.0)


# Only TWO tints across eight classes: color alone identifies just one bit;
# the class signal lives in the high-frequency texture, which QP
# quantization destroys (-> Key Observation 2 emerges from data).
_CLASS_TINT = np.array(
    [[0.85, 0.55, 0.45], [0.5, 0.65, 0.85]], dtype=np.float32)


def class_tint(cls: int) -> np.ndarray:
    # tint follows the PATTERN-TYPE parity, never the frequency bit: the
    # frequency band stays the only signal for the low class bit, so it is
    # (a) destroyed by LQ encoding and (b) shifted by data drift
    return _CLASS_TINT[(cls // 2) % 2]


def make_chunk(
    rng: np.random.Generator,
    content: str = "traffic",
    *,
    num_frames: int = 16,
    hw: Tuple[int, int] = (128, 128),
    max_objects: int = 10,
    texture_drift: float = 0.0,
) -> VideoChunk:
    ct = CONTENT_TYPES[content]
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")

    # background: smooth low-frequency gradient + mild noise
    bg_phase = rng.uniform(0, 2 * np.pi, 3)
    bg = np.stack([0.45 + 0.15 * np.sin(2 * np.pi * (0.7 * xx + 0.4 * yy)
                                        + p) for p in bg_phase], -1)

    k = int(rng.integers(ct.num_objects[0], ct.num_objects[1] + 1))
    k = min(k, max_objects)
    cls = rng.integers(0, NUM_CLASSES, k)
    size = rng.uniform(*ct.size, k)
    pos = rng.uniform(0.15, 0.85, (k, 2))
    ang = rng.uniform(0, 2 * np.pi, k)
    spd = rng.uniform(*ct.speed, k)
    vel = np.stack([np.cos(ang), np.sin(ang)], -1) * spd[:, None]

    frames = np.empty((num_frames, h, w, 3), np.float32)
    boxes = np.full((num_frames, max_objects, 4), 0.0, np.float32)
    labels = np.full((num_frames, max_objects), -1, np.int32)

    tex = [_texture(int(c), yy, xx, rng, drift=texture_drift) for c in cls]
    for t in range(num_frames):
        img = bg + rng.normal(0, 0.015, bg.shape).astype(np.float32)
        for i in range(k):
            cxy = pos[i] + vel[i] * t
            cxy = 0.5 + 0.5 * np.sin(np.pi * (cxy - 0.5))   # soft bounce
            half = size[i] / 2
            x1, y1 = cxy[0] - half, cxy[1] - half
            x2, y2 = cxy[0] + half, cxy[1] + half
            mask = ((xx >= x1) & (xx <= x2) & (yy >= y1) & (yy <= y2))
            col = tex[i][..., None] * class_tint(int(cls[i]))
            img = np.where(mask[..., None], col, img)
            boxes[t, i] = np.clip([x1, y1, x2, y2], 0.0, 1.0)
            labels[t, i] = cls[i]
        frames[t] = np.clip(img, 0.0, 1.0)
    return VideoChunk(frames, boxes, labels, content)


def dataset(
    seed: int,
    content: str,
    num_chunks: int,
    **kw,
) -> List[VideoChunk]:
    rng = np.random.default_rng(seed)
    return [make_chunk(rng, content, **kw) for _ in range(num_chunks)]


def chunk_stream(seed: int, content: str, **kw) -> Iterator[VideoChunk]:
    rng = np.random.default_rng(seed)
    while True:
        yield make_chunk(rng, content, **kw)


def drifted_chunk(rng: np.random.Generator, content: str = "traffic",
                  drift: float = 0.5, **kw) -> VideoChunk:
    """Data-drift variant (§V): class textures shift bands over time (new
    object appearances).  Silhouettes — and hence the cloud detector's
    localization — are untouched; the fog classifier trained at drift=0
    degrades and the HITL loop must recover it (Fig. 13a).

    ``drift`` in [0,1] interpolates toward the shifted distribution.
    """
    chunk = make_chunk(rng, content, texture_drift=drift, **kw)
    # plus a mild illumination component
    gain = 1.0 - 0.08 * drift
    frames = np.clip(gain * chunk.frames, 0.0, 1.0)
    return VideoChunk(frames.astype(np.float32), chunk.gt_boxes,
                      chunk.gt_labels, chunk.content)
