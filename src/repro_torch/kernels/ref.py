"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``: the
video path's IoU matrix, region filter, crop gather and NMS, and the LLM
path's flash attention, decode attention and Mamba2 SSD scan).

These are the semantic ground truth of the port's CUDA kernels: the CPU
tests run them against the JAX package, and ``chip_smoke.py`` holds each
kernel against them on the card.  The kernel wrappers in
:mod:`repro_torch.kernels.ops` run them only for tensors on the CPU.

Every op here is a separate eager PyTorch op, so each multiply and add is
rounded on its own -- the property the IoU, region filter and crop gather
kernels reproduce bit for bit.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Pairwise IoU + region filter mask (the paper's §IV.B filter hot spot)
# ---------------------------------------------------------------------------
def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """boxes: (..., N, 4) as (x1, y1, x2, y2). Returns (..., N, M)."""
    a = boxes_a.float()
    b = boxes_b.float()
    ax1, ay1, ax2, ay2 = [a[..., :, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [b[..., None, :, i] for i in range(4)]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return inter / union.clamp_min(1e-9)


def nms_greedy(iou: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float = 0.45) -> torch.Tensor:
    """The greedy loop of non-maximum suppression over a given IoU matrix.

    iou (..., N, N), scores (..., N), valid (..., N) -> keep (..., N).
    The loop runs N steps on whole (..., N) tensors -- every frame of a
    flush advances together, and nothing reads back to the host.  It is the
    plain version of the NMS kernel (``kernels/nms.py``), which runs in its
    place on the card; the JAX package runs it as one ``fori_loop``."""
    n = iou.shape[-1]
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    ar = torch.arange(n, device=iou.device)
    keep = torch.zeros_like(valid)
    alive = valid.clone()
    for _ in range(n):
        masked = torch.where(alive, scores, neg)
        idx = masked.argmax(-1, keepdim=True)            # (..., 1) first max
        has = masked.gather(-1, idx) > neg               # (..., 1)
        sel = ar == idx                                  # (..., N)
        keep |= has & sel
        row = iou.gather(-2, idx[..., None].expand(*idx.shape, n))[..., 0, :]
        suppress = (row >= iou_threshold) | sel
        alive = torch.where(has, alive & ~suppress, alive)
    return keep


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float = 0.45) -> torch.Tensor:
    """Greedy non-maximum suppression over the last axis; fixed shape.

    boxes (..., N, 4), scores (..., N), valid (..., N) -> keep (..., N):
    the plain IoU matrix, then :func:`nms_greedy`."""
    return nms_greedy(iou_matrix(boxes, boxes), scores, valid, iou_threshold)


def region_filter_mask(
    proposals: torch.Tensor,     # (..., N, 4)
    prop_valid: torch.Tensor,    # (..., N) bool
    accepted: torch.Tensor,      # (..., M, 4)
    acc_valid: torch.Tensor,     # (..., M) bool
    loc_scores: torch.Tensor,    # (..., N)
    *,
    theta_loc: float,
    theta_iou: float,
    theta_back: float,
    frame_area: float = 1.0,
) -> torch.Tensor:
    """The paper's three-stage filter as one fused mask computation.

    Leading axes broadcast, so a (F, N) flush is one call: this is the plain
    version of the batched kernel as well as of the single-frame filter."""
    keep = prop_valid & (loc_scores >= theta_loc)
    iou = iou_matrix(proposals, accepted)                # (..., N, M)
    iou = torch.where(acc_valid[..., None, :], iou, 0.0)
    keep &= iou.amax(-1).clamp_min(0.0) < theta_iou      # initial=0.0
    w = (proposals[..., 2] - proposals[..., 0]).clamp_min(0.0)
    h = (proposals[..., 3] - proposals[..., 1]).clamp_min(0.0)
    keep &= (w * h / frame_area) <= theta_back
    return keep


# ---------------------------------------------------------------------------
# Bilinear crop gather (the compacted classify path's crop stage)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _crop_lin(n: int) -> np.ndarray:
    """The [0, 1] sample grid as a host-computed float32 literal -- the same
    fixed bit pattern the JAX package bakes in (``np.linspace``, never an
    on-device linspace whose rounding may differ)."""
    return np.linspace(0.0, 1.0, n, dtype=np.float32)


@functools.lru_cache(maxsize=32)
def _crop_lin_on(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_crop_lin(n)).to(device)


def crop_lin(n: int, device) -> torch.Tensor:
    """``_crop_lin(n)`` on ``device``, uploaded once per (n, device)."""
    return _crop_lin_on(n, torch.device(device))


def bilinear_crops(frames: torch.Tensor,    # (F, H, W, C)
                   fmap: torch.Tensor,      # (K,) in-range frame index
                   boxes: torch.Tensor,     # (K, 4) xyxy in [0, 1]
                   out_hw: Tuple[int, int],
                   *,
                   lin_y: Optional[torch.Tensor] = None,
                   lin_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear-resample K boxes to ``out_hw``; returns (K, oh, ow, C).

    Follows ``repro.kernels.ref.bilinear_crops`` tap for tap: the baked
    float32 sample grid, sample positions ``ya + yb``, floor and clip,
    zero-valued out-of-frame taps, weights ``(wy * wx) * tap`` and the sum
    order ``((t00 + t01) + t10) + t11``, each op rounded on its own."""
    f, h_img, w_img, ch = frames.shape
    k = boxes.shape[0]
    oh, ow = out_hw
    if lin_y is None:
        lin_y = crop_lin(oh, frames.device)
    if lin_x is None:
        lin_x = crop_lin(ow, frames.device)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    ya = (y1 * (h_img - 1))[:, None]                        # (K, 1)
    yb = ((y2 - y1) * (h_img - 1))[:, None] * lin_y          # (K, oh)
    xa = (x1 * (w_img - 1))[:, None]
    xb = ((x2 - x1) * (w_img - 1))[:, None] * lin_x
    ys = ya + yb
    xs = xa + xb
    yy = ys[:, :, None].expand(k, oh, ow).reshape(k, oh * ow)
    xx = xs[:, None, :].expand(k, oh, ow).reshape(k, oh * ow)
    y_lo_f = torch.floor(yy)
    x_lo_f = torch.floor(xx)
    wy_hi = yy - y_lo_f
    wy_lo = 1 - wy_hi
    wx_hi = xx - x_lo_f
    wx_lo = 1 - wx_hi
    y_lo = y_lo_f.to(torch.int64)
    x_lo = x_lo_f.to(torch.int64)
    y_hi = y_lo + 1
    x_hi = x_lo + 1
    fk = fmap.to(torch.int64)[:, None]

    def term(yi, wy, xi, wx):
        # mode='constant': out-of-frame taps contribute 0
        valid = (yi >= 0) & (yi < h_img) & (xi >= 0) & (xi < w_img)
        yc = yi.clamp(0, h_img - 1)
        xc = xi.clamp(0, w_img - 1)
        contrib = torch.where(valid[..., None], frames[fk, yc, xc], 0.0)
        return (wy * wx)[..., None] * contrib

    t00 = term(y_lo, wy_lo, x_lo, wx_lo)
    t01 = term(y_lo, wy_lo, x_hi, wx_hi)
    t10 = term(y_hi, wy_hi, x_lo, wx_lo)
    t11 = term(y_hi, wy_hi, x_hi, wx_hi)
    out = ((t00 + t01) + t10) + t11
    return out.reshape(k, oh, ow, ch)


def crop_gather(frames: torch.Tensor,       # (F, H, W, C) HQ frames
                boxes: torch.Tensor,        # (F, N, 4) proposal boxes
                idxs: torch.Tensor,         # (>=2, B) compaction indices
                *, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain compacted crop gather: (B, oh, ow, C).

    ``idxs[0] / idxs[1]`` are the flush's (frame, region) rows; pad rows
    carry the out-of-bounds frame index F and clip to the last frame."""
    f, n = boxes.shape[0], boxes.shape[1]
    fidx = idxs[0].long().clamp(0, f - 1)
    ridx = idxs[1].long().clamp(0, n - 1)
    return bilinear_crops(frames, fidx, boxes[fidx, ridx], out_hw)



# ---------------------------------------------------------------------------
# Flash attention (prefill), GQA, causal, optional sliding window + softcap
# ---------------------------------------------------------------------------
def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else cap * torch.tanh(x / cap)


def flash_attention(
    q: torch.Tensor,            # (b, s_q, n_q, d)
    k: torch.Tensor,            # (b, s_kv, n_kv, d)
    v: torch.Tensor,            # (b, s_kv, n_kv, d_v); d_v may differ (MLA)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset=0,                 # int, 0-d or (b,) tensor
) -> torch.Tensor:
    """``repro.kernels.ref.flash_attention``; masked logits are the finite
    NEG_INF, so a row with every key masked averages V uniformly.  A (b,)
    ``q_offset`` gives each batch row its own query positions (the
    reference adds the offset to ``arange(s_q)`` and is right only for a
    scalar)."""
    b, s_q, n_q, d = q.shape
    _, s_kv, n_kv, _ = k.shape
    d_v = v.shape[-1]
    groups = n_q // n_kv
    scale = d ** -0.5
    qf = q.float().reshape(b, s_q, n_kv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    logits = _softcap(logits, softcap)
    off = torch.as_tensor(q_offset, device=q.device).long().reshape(-1, 1)
    q_pos = torch.arange(s_q, device=q.device)[None, :] + off   # (b|1, s_q)
    k_pos = torch.arange(s_kv, device=q.device)
    rel = q_pos[:, :, None] - k_pos[None, None, :]             # (b|1, sq, sk)
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s_q, n_q, d_v).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention: one query token vs a (possibly partially filled) cache
# ---------------------------------------------------------------------------
def decode_attention(
    q: torch.Tensor,            # (b, n_q, d)
    k_cache: torch.Tensor,      # (b, S, n_kv, d)
    v_cache: torch.Tensor,      # (b, S, n_kv, d)
    cache_len,                  # int, 0-d or (b,): number of valid slots
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    b, n_q, d = q.shape
    _, S, n_kv, _ = k_cache.shape
    d_v = v_cache.shape[-1]
    groups = n_q // n_kv
    scale = d ** -0.5
    qf = q.float().reshape(b, n_kv, groups, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    logits = _softcap(logits, softcap)
    pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device).long().reshape(-1, 1)
    valid = pos[None, :] < clen                           # (b|1, S)
    if window is not None:
        valid &= pos[None, :] >= (clen - window)
    valid = valid.expand(b, S)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.float())
    return out.reshape(b, n_q, d_v).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) chunked scan
# ---------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k]."""
    t = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_scan(
    x: torch.Tensor,            # (b, s, h, p)   head inputs
    dt: torch.Tensor,           # (b, s, h)      softplus'd step sizes
    A: torch.Tensor,            # (h,)           negative decay rates
    B: torch.Tensor,            # (b, s, n)      input maps (n_groups=1)
    C: torch.Tensor,            # (b, s, n)      output maps
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,   # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b,s,h,p), final_state (b,h,p,n)): the reference's chunked
    SSD algorithm with the sequence zero-padded to a chunk multiple."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dtype = x.dtype
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    s_pad = x.shape[1]
    c = s_pad // chunk

    xf = x.float().reshape(b, c, chunk, h, p)
    dtf = dt.float().reshape(b, c, chunk, h)
    Bf = B.float().reshape(b, c, chunk, n)
    Cf = C.float().reshape(b, c, chunk, n)
    dA = (dtf * A.float()[None, None, None, :]).movedim(-1, 2)  # (b,c,h,q)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA))                          # (b,c,h,q,q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)    # (b,c,q,k)
    dtx = xf * dtf[..., None]                           # (b,c,k,h,p)
    w = scores[:, :, None] * L                          # (b,c,h,q,k)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", w, dtx)

    # 2. chunk states: decay from position k to the chunk's end
    cums = torch.cumsum(dA, dim=-1)                     # (b,c,h,q)
    decay_states = torch.exp(cums[..., -1:] - cums)     # (b,c,h,q)
    states = torch.einsum("bckn,bchk,bckhp->bchpn", Bf, decay_states, dtx)

    # 3. inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(cums[..., -1])              # (b,c,h)
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    prev = []
    for i in range(c):
        prev.append(st)                                 # state entering i
        st = st * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, 1)                  # (b,c,h,p,n)

    # 4. inter-chunk output: y_off[q] = C_q . (decay_in(q) * prev_state)
    decay_in = torch.exp(cums)                          # (b,c,h,q)
    y_off = torch.einsum("bcqn,bchq,bchpn->bcqhp", Cf, decay_in, prev_states)

    y = (y_diag + y_off).reshape(b, s_pad, h, p)[:, :s]
    return y.to(dtype), st


def ssd_step(
    x: torch.Tensor,            # (b, h, p)
    dt: torch.Tensor,           # (b, h)
    A: torch.Tensor,            # (h,)
    B: torch.Tensor,            # (b, n)
    C: torch.Tensor,            # (b, n)
    state: torch.Tensor,        # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrent step (decode).  No kernel: the JAX package runs
    this plain on every backend too."""
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf * A[None, :])                    # (b,h)
    upd = torch.einsum("bhp,bn->bhpn", xf * dtf[..., None], B.float())
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y.to(x.dtype), new_state
