"""Quality control: the transform codec behind F_v(r, q) (paper Eq. 2),
PyTorch port of ``repro.video.codec``.

The paper adjusts video quality with FFmpeg (resolution scale + H.264 QP).
We reproduce the same byte/quality trade-off with a real transform codec:

  encode(frames, r, q):
    1. downscale by resolution factor r  (bilinear, antialiased)
    2. 8x8 block DCT per channel
    3. uniform quantization with H.264-style step  2^((q - 4) / 6)
    4. byte estimate from an exp-Golomb-style code-length model over the
       quantized coefficients (derived from data, not hard-coded)
    5. decode = dequantize -> inverse DCT -> upscale back

The protocol layer consumes only (frames_out, bytes) — exactly the F_v(r, q)
abstraction of Eq. 2.  Frames are (T, H, W, 3) NHWC tensors; ``nbytes`` is a
0-d tensor on the frames' device (read with ``float()`` where the host needs
it).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 8


class EncodedChunk(NamedTuple):
    frames: torch.Tensor        # decoded (degraded) frames (T, H, W, 3)
    nbytes: torch.Tensor        # 0-d float: estimated compressed size
    r: float
    q: int


@functools.lru_cache(maxsize=None)
def _dct_matrix(n: int = BLOCK) -> np.ndarray:
    k = np.arange(n)
    mat = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1)
                                    * k[:, None] / (2 * n))
    mat[0] /= np.sqrt(2.0)
    return mat.astype(np.float32)


def qp_to_step(q) -> float:
    """H.264-style quantization step (doubles every 6 QP), in float32."""
    e = (np.float32(q) - np.float32(4.0)) / np.float32(6.0)
    return float(np.power(np.float32(2.0), e) / np.float32(64.0))


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """(T, H, W, C) -> (T, H/8, W/8, C, 8, 8)."""
    t, h, w, c = x.shape
    x = x.reshape(t, h // BLOCK, BLOCK, w // BLOCK, BLOCK, c)
    return x.permute(0, 1, 3, 5, 2, 4)


def _unblockify(x: torch.Tensor) -> torch.Tensor:
    t, hb, wb, c, _, _ = x.shape
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(t, hb * BLOCK, wb * BLOCK, c)


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    t, h, w, c = x.shape
    ph = (-h) % BLOCK
    pw = (-w) % BLOCK
    if ph or pw:
        # "edge" padding of the bottom/right border
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
        x = x.permute(0, 2, 3, 1)
    return x, (h, w)


def resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "linear")`` on NHWC: half-pixel bilinear
    that antialiases when it downsamples (a triangle filter widened by the
    scale factor) -- ``antialias=True`` in torch."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def code_length_bits(coef: torch.Tensor) -> torch.Tensor:
    """Exp-Golomb-style bit cost of integer coefficients (byte model)."""
    a = coef.abs()
    bits = torch.where(a > 0, 2.0 * torch.ceil(torch.log2(a + 1.0)) + 1.0,
                       0.0)
    # run-length proxy for zeros: ~0.06 bits per zero coefficient
    bits = bits + torch.where(a == 0, 0.0625, 0.0)
    return bits.sum()


@functools.lru_cache(maxsize=8)
def _dct_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dct_matrix()).to(device)


def _dct(blocks: torch.Tensor) -> torch.Tensor:
    d = _dct_on(blocks.device)
    return d @ blocks @ d.T                         # einsum ij,...jk,lk


def _idct(coef: torch.Tensor) -> torch.Tensor:
    d = _dct_on(coef.device)
    return d.T @ coef @ d                           # einsum ji,...jk,kl


def _shrink(frames: torch.Tensor, r: float) -> torch.Tensor:
    t, h0, w0, c = frames.shape
    if r == 1.0:
        return frames
    hs, ws = max(BLOCK, int(h0 * r)), max(BLOCK, int(w0 * r))
    return resize(frames, (hs, ws))


def encode(frames: torch.Tensor, r: float, q: int) -> EncodedChunk:
    """frames (T, H, W, 3) float in [0,1]; r in (0,1]; q = QP (0..51)."""
    t, h0, w0, c = frames.shape
    small, (h, w) = _pad_to_block(_shrink(frames, r))
    coef = _dct(_blockify(small - 0.5))
    step = qp_to_step(q)
    quant = torch.round(coef / step)

    nbits = code_length_bits(quant)
    # decode side
    rec = _idct(quant * step) + 0.5
    rec = _unblockify(rec)[:, :h, :w]
    if r != 1.0:
        rec = resize(rec, (h0, w0))
    rec = rec.clamp(0.0, 1.0)
    return EncodedChunk(rec, nbits / 8.0, r, int(q))


def encode_inter(frames: torch.Tensor, r: float, q: int) -> EncodedChunk:
    """Closed-loop inter-frame (P-frame) coding: each frame encodes the
    DCT-quantized residual against the previous *reconstructed* frame, so
    static content costs ~nothing — the H.264 temporal-compression behavior
    the intra-only ``encode`` misses.  Same (frames, bytes) contract; the
    reference's ``lax.scan`` over frames is a loop here."""
    t, h0, w0, c = frames.shape
    small, (h, w) = _pad_to_block(_shrink(frames, r))
    step = qp_to_step(q)

    prev = torch.full_like(small[0], 0.5)   # intra-frame = residual vs gray
    recs, bits = [], []
    for i in range(t):
        blocks = _blockify((small[i] - prev)[None])
        quant = torch.round(_dct(blocks) / step)
        bits.append(code_length_bits(quant))
        rec_res = _unblockify(_idct(quant * step))[0]
        prev = (prev + rec_res).clamp(0.0, 1.0)
        recs.append(prev)
    out = torch.stack(recs)[:, :h, :w]
    if r != 1.0:
        out = resize(out, (h0, w0))
    return EncodedChunk(out.clamp(0.0, 1.0), torch.stack(bits).sum() / 8.0,
                        r, int(q))

