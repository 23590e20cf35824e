"""Data pipelines: synthetic token streams (LLM training) and video-model
training batches (detector / classifier pre-training), port of
``repro.training.data``.

Host numpy over :mod:`repro_torch.video.synthetic`, which equals the
reference's generator, so every batch here is bit-equal to the JAX
package's from the same seed.  The training loops move each batch to the
device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro_torch.video import synthetic


# ---------------------------------------------------------------------------
# Token streams (language-model substrate)
# ---------------------------------------------------------------------------
@dataclass
class TokenStream:
    """Synthetic but *learnable* token stream: a random first-order Markov
    chain over the vocabulary; next-token structure exists, so training loss
    decreasing is a meaningful signal."""
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)   # transition table cap
        self._v = v
        self._next = rng.integers(0, v, size=(v, self.branching))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + 1)
        while True:
            toks = np.empty((self.batch_size, self.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, self._v, self.batch_size)
            choice = rng.integers(0, self.branching,
                                  (self.batch_size, self.seq_len))
            for t in range(self.seq_len):
                toks[:, t + 1] = self._next[toks[:, t], choice[:, t]]
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_for(cfg: ModelConfig, batch_size: int, seq_len: int,
              seed: int = 0) -> Dict[str, np.ndarray]:
    return next(iter(TokenStream(cfg.vocab_size, seq_len, batch_size, seed)))


# ---------------------------------------------------------------------------
# Video-model batches
# ---------------------------------------------------------------------------
def detector_batches(det_cfg: DetectorConfig, batch_size: int, seed: int = 0,
                     content: str = "traffic",
                     degrade: Tuple[float, int] | None = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Frames + gt boxes/labels for detector training.

    ``degrade=(r, q)`` additionally yields codec-degraded frames so the
    detector trains on BOTH qualities (the cloud model must localize on
    low-quality input — protocol RQ1)."""
    rng = np.random.default_rng(seed)
    kinds = list(synthetic.CONTENT_TYPES) if content == "all" else [content]
    while True:
        frames, boxes, labels = [], [], []
        while len(frames) < batch_size:
            ch = synthetic.make_chunk(rng, str(rng.choice(kinds)),
                                      num_frames=2, hw=det_cfg.image_hw)
            for t in range(ch.frames.shape[0]):
                frames.append(ch.frames[t])
                boxes.append(ch.gt_boxes[t])
                labels.append(ch.gt_labels[t])
        yield {"images": np.stack(frames[:batch_size]),
               "gt_boxes": np.stack(boxes[:batch_size]),
               "gt_labels": np.stack(labels[:batch_size])}


def bilinear_resize(img, out_hw):
    """(h, w, c) bilinear resize — matches the serving-side crop kernel."""
    h, w = out_hw
    ih, iw = img.shape[:2]
    ys = np.linspace(0, ih - 1, h)
    xs = np.linspace(0, iw - 1, w)
    y0 = np.clip(ys.astype(int), 0, max(ih - 2, 0))
    x0 = np.clip(xs.astype(int), 0, max(iw - 2, 0))
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).astype(img.dtype)


def classifier_batches(clf_cfg: ClassifierConfig, batch_size: int,
                       seed: int = 0, drift: float = 0.0,
                       box_jitter: float = 0.1
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Object crops + labels for the fog classifier.

    Crops use bilinear resize and jittered boxes, matching what the serving
    path produces from detector proposals."""
    rng = np.random.default_rng(seed)
    while True:
        crops, labels = [], []
        while len(crops) < batch_size:
            if drift > 0:
                ch = synthetic.drifted_chunk(rng, "traffic", drift=drift,
                                             num_frames=1, hw=(128, 128))
            else:
                ch = synthetic.make_chunk(rng, "traffic", num_frames=1,
                                          hw=(128, 128))
            fh, fw = ch.frames.shape[1:3]
            for i in range(ch.gt_boxes.shape[1]):
                if ch.gt_labels[0, i] < 0:
                    continue
                box = ch.gt_boxes[0, i].copy()
                if box_jitter:
                    size = max(box[2] - box[0], box[3] - box[1])
                    box += rng.uniform(-box_jitter, box_jitter, 4) * size
                x1, y1, x2, y2 = np.clip(box, 0.0, 1.0)
                xa, xb = int(x1 * fw), max(int(x2 * fw), int(x1 * fw) + 2)
                ya, yb = int(y1 * fh), max(int(y2 * fh), int(y1 * fh) + 2)
                crop = ch.frames[0, ya:yb, xa:xb]
                crops.append(bilinear_resize(crop, clf_cfg.crop_hw))
                labels.append(ch.gt_labels[0, i])
        yield {"crops": np.stack(crops[:batch_size]).astype(np.float32),
               "labels": np.asarray(labels[:batch_size], np.int32)}
