"""Device dispatch over the port's CUDA kernels and their plain versions.

There is no ``impl`` knob: a wrapper launches the hand-written CUDA kernel
for a CUDA tensor and computes the plain PyTorch version only for a tensor
that lies on the CPU.  No path runs the plain version on a CUDA tensor, and
nothing falls back when a kernel fails to build or launch -- it raises.

Each kernel module keeps a plain-integer launch count (``launches``), bumped
where the kernel is launched and nowhere else; :func:`launch_counts` and
:func:`reset_launch_counts` read and zero them, so a run can show that the
serving path went through the kernels.  K5 also counts its replays and the
proximal steps its launches ran (``onevsall_update.replays`` and
``.steps``, zeroed with the launches): a replay is one launch of many
steps.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import crop_gather as _cg
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import iou_filter as _ik
from repro_torch.kernels import iou_matrix as _im
from repro_torch.kernels import onevsall as _ov
from repro_torch.kernels import onevsall_update as _ou
from repro_torch.kernels import ref
from repro_torch.kernels import region_filter_mask as _rf
from repro_torch.kernels import ssd_scan as _sk

KERNELS = {"region_filter_mask_batch": _ik, "crop_gather": _cg,
           "onevsall_scores": _ov, "iou_matrix": _im,
           "region_filter_mask": _rf, "onevsall_update": _ou,
           "flash_attention": _fa, "decode_attention": _da, "ssd_scan": _sk}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    _ou.replays = _ou.steps = 0


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def region_filter_mask_batch(proposals, prop_valid, accepted, acc_valid,
                             loc_scores, *, theta_loc: float,
                             theta_iou: float, theta_back: float,
                             frame_area: float = 1.0) -> torch.Tensor:
    """Whole-flush §IV.B filter over a (F, N) region grid (K1)."""
    kw = dict(theta_loc=theta_loc, theta_iou=theta_iou,
              theta_back=theta_back, frame_area=frame_area)
    if _on_card(proposals):
        return _ik.region_filter_mask_batch(proposals, prop_valid, accepted,
                                            acc_valid, loc_scores, **kw)
    return _ik.region_filter_mask_batch_ref(proposals, prop_valid, accepted,
                                            acc_valid, loc_scores, **kw)


def iou_matrix(boxes_a, boxes_b) -> torch.Tensor:
    """Pairwise IoU (K4a): (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    if _on_card(boxes_a):
        return _im.iou_matrix(boxes_a, boxes_b)
    return _im.iou_matrix_ref(boxes_a, boxes_b)


def nms_mask(boxes, scores, valid, iou_threshold: float = 0.45
             ) -> torch.Tensor:
    """Greedy NMS over the last axis: the IoU matrix through K4a, then the
    greedy loop, which is plain PyTorch on every device (the JAX package
    has no kernel for it either)."""
    return ref.nms_greedy(iou_matrix(boxes, boxes), scores, valid,
                          iou_threshold)


def region_filter_mask(proposals, prop_valid, accepted, acc_valid,
                       loc_scores, *, theta_loc: float, theta_iou: float,
                       theta_back: float, frame_area: float = 1.0
                       ) -> torch.Tensor:
    """Single-frame §IV.B filter (K4b): (N, 4) vs (M, 4) -> (N,) bool."""
    kw = dict(theta_loc=theta_loc, theta_iou=theta_iou,
              theta_back=theta_back, frame_area=frame_area)
    if _on_card(proposals):
        return _rf.region_filter_mask(proposals, prop_valid, accepted,
                                      acc_valid, loc_scores, **kw)
    return _rf.region_filter_mask_ref(proposals, prop_valid, accepted,
                                      acc_valid, loc_scores, **kw)


def crop_gather(frames, boxes, idxs, *,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Compacted crop gather (K2): (F,H,W,C) x (F,N,4) x (>=2,B) ->
    (B,oh,ow,C)."""
    if _on_card(frames):
        return _cg.crop_gather(frames, boxes, idxs, out_hw=out_hw)
    return _cg.crop_gather_ref(frames, boxes, idxs, out_hw=out_hw)


def onevsall_scores(x, ws, widx: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One-vs-all readout (K3): sigmoid(x @ ws[widx]) per row."""
    if _on_card(x):
        return _ov.onevsall_scores(x, ws, widx)
    return _ov.onevsall_scores_ref(x, ws, widx)


def onevsall_update(x, y, w, *, eta: float) -> torch.Tensor:
    """Fused proximal step (K5): w - eta * x^T (sigmoid(x w) - y)."""
    if _on_card(x):
        return _ou.onevsall_update(x, y, w, eta=eta)
    return _ou.onevsall_update_ref(x, y, w, eta=eta)


def onevsall_replay(xs, ys, w, *, eta: float, passes: int = 1
                    ) -> torch.Tensor:
    """``passes`` passes of one-row proximal steps over xs / ys in order
    (K5): one launch on the card; on the CPU the loop of one-row
    :func:`onevsall_update` calls it equals bit for bit."""
    if _on_card(xs):
        return _ou.onevsall_replay(xs, ys, w, eta=eta, passes=passes)
    for _ in range(passes):
        for i in range(xs.shape[0]):
            w = onevsall_update(xs[i][None], ys[i][None], w, eta=eta)
    return w


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset=0) -> torch.Tensor:
    """GQA prefill attention (K6); ``q_offset`` an int, 0-d or (b,)."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if _on_card(q):
        return _fa.flash_attention(q, k, v, **kw)
    return _fa.flash_attention_ref(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One token against the cache (K7); ``cache_len`` scalar or (b,)."""
    kw = dict(window=window, softcap=softcap)
    if _on_card(q):
        return _da.decode_attention(q, k_cache, v_cache, cache_len, **kw)
    return _da.decode_attention_ref(q, k_cache, v_cache, cache_len, **kw)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64, initial_state=None):
    """Mamba2 SSD chunked scan (K8) -> (y, final_state)."""
    kw = dict(chunk=chunk, initial_state=initial_state)
    if _on_card(x):
        return _sk.ssd_scan(x, dt, A, B, C, **kw)
    return _sk.ssd_scan_ref(x, dt, A, B, C, **kw)


def ssd_step(x, dt, A, B, C, state):
    """Single recurrent SSD step (decode).  Plain PyTorch on every device:
    the JAX package has no Pallas kernel for it either."""
    return ref.ssd_step(x, dt, A, B, C, state)
