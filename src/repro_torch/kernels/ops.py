"""Device dispatch over the port's CUDA kernels and their plain versions.

There is no ``impl`` knob: a wrapper launches the hand-written CUDA kernel
for a CUDA tensor and computes the plain PyTorch version only for a tensor
that lies on the CPU.  Nothing falls back when a kernel fails to build or
launch -- it raises.

The kernels are forward only, like the reference's ``pallas_call``, which
has no differentiation rule.  Two of them sit on the LLM training path,
and there the reference differentiates its plain version (``impl="ref"``
under ``jax.grad``): on a CUDA operand that requires grad while grad mode
is on, :func:`flash_attention` (K6) and :func:`ssd_scan` (K8) go through
``FlashAttention`` / ``SSDScan``, whose forward launches the kernel and
whose backward is the VJP of the plain version, recomputed on the card.
That backward is the one place the plain version runs on CUDA tensors.
Every other kernel wrapper raises on such an operand.

Each kernel module keeps a plain-integer launch count (``launches``), bumped
where the kernel is launched and nowhere else; :func:`launch_counts` and
:func:`reset_launch_counts` read and zero them, so a run can show that the
serving path went through the kernels.  K6 and K8 also count their plain
VJPs (``vjps``, reported as ``flash_attention_vjp`` and ``ssd_scan_vjp``),
and K6, K7 and K8 the launches among theirs on bf16 operands
(``launches_bf16``, reported by :func:`bf16_launch_counts` as
``<name>_bf16``).  On a CUDA bf16 operand
K6, K7 and K8 launch their bf16 kernels; float16 raises, and nothing
converts an operand to another dtype.
K5 also counts its replays and the proximal steps its launches ran
(``onevsall_update.replays`` and ``.steps``, zeroed with the launches): a
replay is one launch of many steps.

A ``meta`` tensor takes the plain version too, as shape evaluation: it
computes nothing, so it is no fallback.  The roofline's counters
(:mod:`repro_torch.roofline.analysis`) run a whole step on meta tensors;
each kernel call there runs inside a region they see (:func:`_plain`), so
the byte and memory counts charge the kernel's operands, outputs and
workspace and not the plain version's intermediates, and the floor K6's,
K7's and K8's own operations (their modules' ``work``).  A meta operand of
K6 or K8 that requires grad goes through the card's Function with that
region as its forward (``_MetaFlashAttention``, ``_MetaSSDScan``): the
backward then recomputes the plain version's VJP outside the region, so
the counters see what the card holds and moves there (the recomputed
forward's score or decay tensors), and the forward's intermediates stay
uncounted, as the card never holds them.  Every other device but the CPU
and CUDA raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import crop_gather as _cg
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import iou_filter as _ik
from repro_torch.kernels import iou_matrix as _im
from repro_torch.kernels import nms as _nms
from repro_torch.kernels import onevsall as _ov
from repro_torch.kernels import onevsall_update as _ou
from repro_torch.kernels import ref
from repro_torch.kernels import region_filter_mask as _rf
from repro_torch.kernels import ssd_scan as _sk

KERNELS = {"region_filter_mask_batch": _ik, "crop_gather": _cg,
           "onevsall_scores": _ov, "iou_matrix": _im,
           "region_filter_mask": _rf, "onevsall_update": _ou,
           "flash_attention": _fa, "decode_attention": _da, "ssd_scan": _sk,
           "nms_greedy": _nms}
# the kernels whose backward is their plain version's VJP, by count name
VJPS = {"flash_attention_vjp": _fa, "ssd_scan_vjp": _sk}
# the kernels that take bf16 operands: their bf16 launches, by count name
BF16 = {"flash_attention_bf16": _fa, "decode_attention_bf16": _da,
        "ssd_scan_bf16": _sk}


# the counters watching kernel calls on meta tensors; each has
# ``kernel_enter(name)`` and ``kernel_exit(name, operands, outputs,
# workspace_bytes, work)`` (roofline.analysis.StepCounter adds itself while
# open)
META_OBSERVERS: List = []


def launch_counts() -> Dict[str, int]:
    return {**{name: mod.launches for name, mod in KERNELS.items()},
            **{name: mod.vjps for name, mod in VJPS.items()}}


def bf16_launch_counts() -> Dict[str, int]:
    """The launches of K6, K7 and K8 on bf16 operands (among those
    :func:`launch_counts` counts), by ``<name>_bf16``."""
    return {name: mod.launches_bf16 for name, mod in BF16.items()}


def d64_launch_counts() -> Dict[str, int]:
    """K6's bf16 launches at d <= 64 (among ``flash_attention_bf16``'s):
    the persistent kernel's and the one-row kernel's."""
    return {"flash_attention_bf16_d64": _fa.launches_d64}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    for mod in VJPS.values():
        mod.vjps = 0
    for mod in BF16.values():
        mod.launches_bf16 = 0
    _fa.launches_d64 = 0
    _ou.replays = _ou.steps = 0


def _wants_grad(*operands) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in operands)


def _on_card(t: torch.Tensor, *operands) -> bool:
    """True for a CUDA ``t``, False for a CPU or meta one.  The kernels are
    forward only, like the reference's ``pallas_call``, which has no
    differentiation rule: a CUDA operand that requires grad while grad mode
    is on raises instead of silently returning a result with no graph."""
    if t.is_cuda:
        if _wants_grad(t, *operands):
            raise RuntimeError(
                "the port's CUDA kernels are forward only and cannot be "
                "differentiated; call them under torch.no_grad() or on "
                "tensors that do not require grad")
        return True
    if t.device.type not in ("cpu", "meta"):
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _plain(name: str, fn, *args, workspace_bytes: int = 0, work=None,
           **kw):
    """``fn(*args, **kw)``, the plain version of kernel ``name``.  On meta
    tensors it runs inside a kernel region that the ``META_OBSERVERS`` see:
    ``workspace_bytes`` is what the kernel would allocate beside its
    outputs, and ``work(*args, **kw)`` the (products, other, bf16 products,
    products with one bf16 operand) operations it would do (None: the plain
    version's count stands)."""
    if not (args[0].is_meta and META_OBSERVERS):
        return fn(*args, **kw)
    operands = [a for a in (*args, *kw.values())
                if isinstance(a, torch.Tensor)]
    for obs in META_OBSERVERS:
        obs.kernel_enter(name)
    out = fn(*args, **kw)
    counted = None if work is None else work(*args, **kw)
    for obs in reversed(META_OBSERVERS):
        obs.kernel_exit(name, operands, out, workspace_bytes, counted)
    return out


class _MetaFlashAttention(_fa.FlashAttention):
    """``FlashAttention`` on meta tensors: the kernel region forward, the
    plain version's VJP recomputed backward (not counted as a VJP: meta
    runs nothing)."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap, q_offset):
        return _plain("flash_attention", _fa.flash_attention_ref, q, k, v,
                      work=_fa.work, causal=causal, window=window,
                      softcap=softcap, q_offset=q_offset)


class _MetaSSDScan(_sk.SSDScan):
    """``SSDScan`` on meta tensors, as :class:`_MetaFlashAttention`."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk, initial_state):
        return _plain("ssd_scan", _sk.ssd_scan_ref, x, dt, A, B, C,
                      workspace_bytes=_sk.workspace_bytes(x, B, chunk),
                      work=_sk.work, chunk=chunk,
                      initial_state=initial_state)


def region_filter_mask_batch(proposals, prop_valid, accepted, acc_valid,
                             loc_scores, *, theta_loc: float,
                             theta_iou: float, theta_back: float,
                             frame_area: float = 1.0) -> torch.Tensor:
    """Whole-flush §IV.B filter over a (F, N) region grid (K1)."""
    kw = dict(theta_loc=theta_loc, theta_iou=theta_iou,
              theta_back=theta_back, frame_area=frame_area)
    if _on_card(proposals, accepted, loc_scores):
        return _ik.region_filter_mask_batch(proposals, prop_valid, accepted,
                                            acc_valid, loc_scores, **kw)
    return _plain("region_filter_mask_batch",
                  _ik.region_filter_mask_batch_ref, proposals, prop_valid,
                  accepted, acc_valid, loc_scores, **kw)


def iou_matrix(boxes_a, boxes_b) -> torch.Tensor:
    """Pairwise IoU (K4a): (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    if _on_card(boxes_a, boxes_b):
        return _im.iou_matrix(boxes_a, boxes_b)
    return _plain("iou_matrix", _im.iou_matrix_ref, boxes_a, boxes_b)


def nms_greedy(iou, scores, valid, iou_threshold: float = 0.45
               ) -> torch.Tensor:
    """The greedy loop of NMS over a given IoU matrix: (..., N, N),
    (..., N), (..., N) -> (..., N) keep."""
    if _on_card(iou, scores):
        return _nms.nms_greedy(iou, scores, valid, iou_threshold)
    return _plain("nms_greedy", _nms.nms_greedy_ref, iou, scores, valid,
                  iou_threshold)


def nms_mask(boxes, scores, valid, iou_threshold: float = 0.45
             ) -> torch.Tensor:
    """Greedy NMS over the last axis: the IoU matrix (K4a), then the greedy
    loop over it (the NMS kernel on the card; two launches a call)."""
    return nms_greedy(iou_matrix(boxes, boxes), scores, valid, iou_threshold)


def region_filter_mask(proposals, prop_valid, accepted, acc_valid,
                       loc_scores, *, theta_loc: float, theta_iou: float,
                       theta_back: float, frame_area: float = 1.0
                       ) -> torch.Tensor:
    """Single-frame §IV.B filter (K4b): (N, 4) vs (M, 4) -> (N,) bool."""
    kw = dict(theta_loc=theta_loc, theta_iou=theta_iou,
              theta_back=theta_back, frame_area=frame_area)
    if _on_card(proposals, accepted, loc_scores):
        return _rf.region_filter_mask(proposals, prop_valid, accepted,
                                      acc_valid, loc_scores, **kw)
    return _plain("region_filter_mask", _rf.region_filter_mask_ref,
                  proposals, prop_valid, accepted, acc_valid, loc_scores,
                  **kw)


def crop_gather(frames, boxes, idxs, *,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Compacted crop gather (K2): (F,H,W,C) x (F,N,4) x (>=2,B) ->
    (B,oh,ow,C)."""
    if _on_card(frames, boxes):
        return _cg.crop_gather(frames, boxes, idxs, out_hw=out_hw)
    return _plain("crop_gather", _cg.crop_gather_ref, frames, boxes, idxs,
                  out_hw=out_hw)


def onevsall_scores(x, ws, widx: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One-vs-all readout (K3): sigmoid(x @ ws[widx]) per row."""
    if _on_card(x, ws):
        return _ov.onevsall_scores(x, ws, widx)
    return _plain("onevsall_scores", _ov.onevsall_scores_ref, x, ws, widx)


def onevsall_update(x, y, w, *, eta: float) -> torch.Tensor:
    """Fused proximal step (K5): w - eta * x^T (sigmoid(x w) - y)."""
    if _on_card(x, y, w):
        return _ou.onevsall_update(x, y, w, eta=eta)
    return _plain("onevsall_update", _ou.onevsall_update_ref, x, y, w,
                  eta=eta)


def onevsall_replay(xs, ys, w, *, eta: float, passes: int = 1
                    ) -> torch.Tensor:
    """``passes`` passes of one-row proximal steps over xs / ys in order
    (K5): one launch on the card; on the CPU the loop of one-row
    :func:`onevsall_update` calls it equals bit for bit."""
    if _on_card(xs, ys, w):
        return _ou.onevsall_replay(xs, ys, w, eta=eta, passes=passes)
    for _ in range(passes):
        for i in range(xs.shape[0]):
            w = onevsall_update(xs[i][None], ys[i][None], w, eta=eta)
    return w


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset=0) -> torch.Tensor:
    """GQA prefill attention (K6); ``q_offset`` an int, 0-d or (b,); v may
    have a head dim of its own, no larger than q's and k's (MLA).  On the
    card with an operand that requires grad: the kernel forward, the plain
    version's VJP backward."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if (q.is_cuda or q.is_meta) and _wants_grad(q, k, v):
        fn = _fa.FlashAttention if q.is_cuda else _MetaFlashAttention
        return fn.apply(q, k, v, causal, window, softcap, q_offset)
    if _on_card(q, k, v):
        return _fa.flash_attention(q, k, v, **kw)
    return _plain("flash_attention", _fa.flash_attention_ref, q, k, v,
                  work=_fa.work, **kw)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One token against the cache (K7); ``cache_len`` scalar or (b,)."""
    kw = dict(window=window, softcap=softcap)
    if _on_card(q, k_cache, v_cache):
        return _da.decode_attention(q, k_cache, v_cache, cache_len, **kw)
    return _plain("decode_attention", _da.decode_attention_ref, q, k_cache,
                  v_cache, cache_len,
                  workspace_bytes=_da.workspace_bytes(
                      q, k_cache, v_cache, window, _da.H100_RESIDENT),
                  work=_da.work, **kw)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64, initial_state=None):
    """Mamba2 SSD chunked scan (K8) -> (y, final_state).  On the card with
    an operand that requires grad: the kernel forward, the plain version's
    VJP backward (both outputs may carry a cotangent)."""
    kw = dict(chunk=chunk, initial_state=initial_state)
    if (x.is_cuda or x.is_meta) and _wants_grad(x, dt, A, B, C,
                                                initial_state):
        fn = _sk.SSDScan if x.is_cuda else _MetaSSDScan
        return fn.apply(x, dt, A, B, C, chunk, initial_state)
    if _on_card(x, dt, A, B, C, initial_state):
        return _sk.ssd_scan(x, dt, A, B, C, **kw)
    return _plain("ssd_scan", _sk.ssd_scan_ref, x, dt, A, B, C,
                  workspace_bytes=_sk.workspace_bytes(x, B, chunk),
                  work=_sk.work, **kw)


def ssd_step(x, dt, A, B, C, state):
    """Single recurrent SSD step (decode).  Plain PyTorch on every device:
    the JAX package has no Pallas kernel for it either."""
    return ref.ssd_step(x, dt, A, B, C, state)
