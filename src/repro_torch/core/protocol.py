"""High-and-Low Video Streaming — the paper's §IV protocol, decomposed into
serverless *stage functions*; PyTorch port of ``repro.core.protocol``.

One chunk flows client -> fog -> cloud -> fog:

  1. client ships HQ video to the co-located fog (LAN; negligible bytes
     against the WAN budget),
  2. fog re-encodes to LOW quality (r_low, q_low) and ships that to the
     cloud (the only WAN upload — this is the bandwidth win),
  3. the cloud detector returns (a) confident detections, accepted directly
     as labels, and (b) coordinates of uncertain regions (bytes ~ 0),
  4. the fog crops the uncertain regions from its cached HQ frames and
     classifies them with the lightweight one-vs-all pipeline (no extra
     cloud cost — RQ2), dynamic batching included,
  5. crops + predictions are queued for the §V HITL loop.

Each hop is a **stage function** the serving layer dispatches as an
independent serverless function (``repro_torch.serving.graph``):

  ``encode_low``        fog quality control        (fog.encode_low)
  ``detect_regions``    heavy cloud detector       (cloud.detect) — batchable
                        across concurrent streams along the frame axis
  ``split_uncertain``   §IV.B three-stage filter   (cloud side of detect)
  ``classify_regions``  HQ crop + one-vs-all merge (fog.classify_regions)

The serving hot path fuses stages so tensors stay on the device end to end
(``hot_path="fused"``): ``detect_split`` (detect + split over the packed
cross-stream batch) and ``classify_compacted`` (only the flush's valid
proposals are cropped and classified, cross-stream, with per-stream
readouts, and scattered back).

Unlike the JAX package there is no ``impl`` switch and no jit plumbing:
the kernels run on the card for CUDA tensors and their plain versions run
for CPU tensors (:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.configs.vpaas_video import ClassifierConfig, DetectorConfig
from repro_torch.core import regions as reg
from repro_torch.core.bandwidth import (CLOUD, FOG, CostModel, DeviceProfile,
                                        LatencyBreakdown, NetworkModel)
from repro_torch.kernels import ops
from repro_torch.models import classifier as clf_mod
from repro_torch.models import detector as det_mod
from repro_torch.video import codec


def to_host(t) -> np.ndarray:
    """Device value -> numpy (``np.asarray`` raises on a CUDA tensor)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@dataclass(frozen=True)
class ProtocolConfig:
    # quality control (paper §VI settings: first-round QP 36, RS 0.8)
    r_low: float = 0.8
    q_low: int = 36
    # §IV.B filter thresholds
    theta_cls: float = 0.85
    theta_loc: float = 0.5
    theta_iou: float = 0.3
    theta_back: float = 0.5
    # fog classifier acceptance
    fog_min_conf: float = 0.5
    # closed-loop inter-frame coding (H.264-faithful temporal compression)
    inter_coding: bool = True


@dataclass
class ChunkResult:
    boxes: np.ndarray            # (F, N, 4) final detections
    labels: np.ndarray           # (F, N)
    valid: np.ndarray            # (F, N) bool
    source: np.ndarray           # (F, N) 0=cloud-accepted 1=fog-classified
    wan_bytes: float
    coord_bytes: float
    cloud_frames: int
    latency: LatencyBreakdown
    # HITL hand-off
    fog_features: np.ndarray     # (F, N, d+1)
    prop_boxes: np.ndarray       # (F, N, 4)
    prop_valid: np.ndarray       # (F, N)
    fog_scores: np.ndarray       # (F, N, C)


# ---------------------------------------------------------------------------
# Stage functions (each one a dispatchable serverless function)
# ---------------------------------------------------------------------------
def encode_low(pcfg: ProtocolConfig, frames_hq: torch.Tensor
               ) -> codec.EncodedChunk:
    """fog.encode_low — quality-control re-encode to (r_low, q_low)."""
    enc_fn = codec.encode_inter if pcfg.inter_coding else codec.encode
    return enc_fn(frames_hq, pcfg.r_low, pcfg.q_low)


def detect_regions(det_cfg: DetectorConfig, det_params,
                   frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """cloud.detect — the heavy detector on LOW-quality frames.

    The leading axis is a plain frame batch: frames from *multiple
    concurrent streams* may be concatenated (and zero-padded to a bucket)
    into one call; per-frame outputs are independent, so callers slice the
    result back apart."""
    return det_mod.detect(det_cfg, det_params, frames)


def split_uncertain(pcfg: ProtocolConfig, det: Dict[str, torch.Tensor]
                    ) -> Tuple[reg.RegionSplit, torch.Tensor]:
    """cloud side of detect — §IV.B split into accepted vs uncertain."""
    split = reg.split_regions(
        det, theta_cls=pcfg.theta_cls, theta_loc=pcfg.theta_loc,
        theta_iou=pcfg.theta_iou, theta_back=pcfg.theta_back)
    return split, reg.coordinate_bytes(split)


def detect_split(det_cfg: DetectorConfig, pcfg: ProtocolConfig, det_params,
                 frames: torch.Tensor) -> reg.RegionSplit:
    """cloud.detect_split — fused detector + §IV.B split, one dispatch.

    Takes the packed cross-stream frame batch and returns the full-batch
    :class:`~repro_torch.core.regions.RegionSplit`.  Both the split filter
    and the detector are per-frame independent, so slicing the fused output
    per chunk equals running ``split_uncertain`` on each chunk's detector
    slice — but the scheduler needs one host transfer (the validity mask)
    per flush instead of O(chunks) scalar reads."""
    det = det_mod.detect(det_cfg, det_params, frames)
    return reg.split_regions(
        det, theta_cls=pcfg.theta_cls, theta_loc=pcfg.theta_loc,
        theta_iou=pcfg.theta_iou, theta_back=pcfg.theta_back)


# PyTorch has no buffer donation: the donated stage is the same function
detect_split_donated = detect_split


def detect_split_dynamic(det_cfg: DetectorConfig, pcfg: ProtocolConfig,
                         det_params, frames: torch.Tensor,
                         theta_cls: torch.Tensor, theta_loc: torch.Tensor
                         ) -> reg.RegionSplit:
    """Fused detect + split with per-frame (per-site) thresholds.

    Used when a flush packs streams whose ``theta_cls`` / ``theta_loc``
    were adapted away from the global config: the (F,) theta vectors ride
    in as tensors.  With every frame at the config defaults the output
    equals :func:`detect_split`."""
    det = det_mod.detect(det_cfg, det_params, frames)
    return reg.split_regions_dynamic(
        det, theta_cls=theta_cls, theta_loc=theta_loc,
        theta_iou=pcfg.theta_iou, theta_back=pcfg.theta_back)


def _merge_fog(pcfg: ProtocolConfig, split: reg.RegionSplit,
               fog_scores: torch.Tensor, fog_feats: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """Shared cloud-accepted + fog-classified merge.

    ``fog_scores`` / ``fog_feats`` are zero at invalid proposal positions
    (masked or scatter-initialised), so the merge — and therefore the whole
    ChunkResult — is deterministic there regardless of which classify path
    produced them."""
    fog_labels = fog_scores.argmax(dim=-1).to(torch.int32)   # first max
    fog_conf = fog_scores.amax(dim=-1)
    fog_valid = split.prop_valid & (fog_conf >= pcfg.fog_min_conf)
    labels = torch.where(split.acc_valid, split.acc_labels, fog_labels)
    valid = split.acc_valid | fog_valid
    source = (~split.acc_valid).to(torch.int32)   # 0=cloud 1=fog
    return {"boxes": split.acc_boxes, "labels": labels, "valid": valid,
            "source": source, "fog_features": fog_feats,
            "fog_scores": fog_scores}


def classify_regions(clf_cfg: ClassifierConfig, pcfg: ProtocolConfig,
                     clf_params, W, frames_hq: torch.Tensor,
                     split: reg.RegionSplit) -> Dict[str, torch.Tensor]:
    """fog.classify_regions — HQ crop + one-vs-all classify + merge.

    The full-budget reference path: every region slot in the F x N grid is
    cropped and classified.  Outputs at invalid proposal positions are
    masked to zero so the compacted path (which never computes them)
    scatters into an identical result."""
    crops = reg.crop_batch(frames_hq, split.prop_boxes, clf_cfg.crop_hw)
    f, n = crops.shape[0], crops.shape[1]
    flat = crops.reshape(f * n, *crops.shape[2:])
    out = clf_mod.classify(clf_cfg, clf_params, flat, W=W)
    mask = split.prop_valid[..., None]
    fog_scores = torch.where(mask, out["scores"].reshape(f, n, -1), 0.0)
    fog_feats = torch.where(mask, out["features"].reshape(f, n, -1), 0.0)
    return _merge_fog(pcfg, split, fog_scores, fog_feats)


def _crop_bucket(clf_cfg: ClassifierConfig, frames_hq: torch.Tensor,
                 split: reg.RegionSplit, idxs: torch.Tensor) -> torch.Tensor:
    """The compacted classify stages' crop step: (B, h, w, 3).

    Always crops only the B bucket rows (the crop-gather kernel on the card,
    its plain version on the CPU) — the same pixels the reference's
    shared-grid materialize-then-gather produces."""
    return ops.crop_gather(frames_hq, split.prop_boxes, idxs,
                           out_hw=clf_cfg.crop_hw)


def _scatter(rows: torch.Tensor, f: int, n: int, fidx: torch.Tensor,
             ridx: torch.Tensor) -> torch.Tensor:
    """Scatter (B, D) rows into a zero (F, N, D) grid; pad rows (frame index
    F) land in a spill frame that is sliced off — no host sync."""
    grid = torch.zeros((f + 1, n, rows.shape[-1]), dtype=rows.dtype,
                       device=rows.device)
    grid[fidx.long(), ridx.long()] = rows
    return grid[:f]


def classify_compacted(clf_cfg: ClassifierConfig, pcfg: ProtocolConfig,
                       clf_params, Ws: torch.Tensor, frames_hq: torch.Tensor,
                       split: reg.RegionSplit, idxs: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """fog.classify_batched — compacted cross-stream classify.

    ``idxs`` is one (3, B) int32 upload — rows ``(fidx, ridx, widx)``.
    ``(fidx, ridx)`` index the valid proposals of the whole flush (padded to
    a bucket with out-of-bounds rows: gathers clip, scatters drop), and
    ``widx`` picks each crop's per-stream readout from the stacked ``Ws``
    (G, d+1, C).  Only the gathered bucket rows pay crop and backbone cost;
    the scores/features are scattered back into zero-initialised grids."""
    fidx, ridx, widx = idxs[0], idxs[1], idxs[2]
    gathered = _crop_bucket(clf_cfg, frames_hq, split, idxs)
    out = clf_mod.classify_multi(clf_cfg, clf_params, gathered, Ws, widx)
    f, n = split.prop_valid.shape
    fog_scores = _scatter(out["scores"], f, n, fidx, ridx)
    fog_feats = _scatter(out["features"], f, n, fidx, ridx)
    return _merge_fog(pcfg, split, fog_scores, fog_feats)


def classify_ensemble(clf_cfg: ClassifierConfig, pcfg: ProtocolConfig,
                      clf_params, snaps: torch.Tensor, omega: torch.Tensor,
                      frames_hq: torch.Tensor, split: reg.RegionSplit
                      ) -> Dict[str, torch.Tensor]:
    """fog.classify_ensemble — Eq. (9) snapshot-ensemble classify + merge.

    The full-budget single-stream stage: every region slot is cropped, one
    backbone pass feeds all T stacked snapshots, and the per-crop score is
    the omega-weighted sigmoid combination."""
    crops = reg.crop_batch(frames_hq, split.prop_boxes, clf_cfg.crop_hw)
    f, n = crops.shape[0], crops.shape[1]
    flat = crops.reshape(f * n, *crops.shape[2:])
    out = clf_mod.classify_ensemble(clf_cfg, clf_params, flat, snaps, omega)
    mask = split.prop_valid[..., None]
    fog_scores = torch.where(mask, out["scores"].reshape(f, n, -1), 0.0)
    fog_feats = torch.where(mask, out["features"].reshape(f, n, -1), 0.0)
    return _merge_fog(pcfg, split, fog_scores, fog_feats)


def classify_compacted_ensemble(clf_cfg: ClassifierConfig,
                                pcfg: ProtocolConfig, clf_params,
                                snaps: torch.Tensor, omegas: torch.Tensor,
                                frames_hq: torch.Tensor,
                                split: reg.RegionSplit, idxs: torch.Tensor
                                ) -> Dict[str, torch.Tensor]:
    """fog.classify_ensemble_batched — compacted cross-stream Eq. (9).

    The ensemble twin of :func:`classify_compacted`: same (3, B) gather
    plan (``widx`` now picks a per-stream snapshot *lineage* from ``snaps``
    (G, T, d+1, C) with ridge weights ``omegas`` (G, T)), same scatter-back
    into zero grids."""
    fidx, ridx, widx = idxs[0], idxs[1], idxs[2]
    gathered = _crop_bucket(clf_cfg, frames_hq, split, idxs)
    out = clf_mod.classify_ensemble_multi(clf_cfg, clf_params, gathered,
                                          snaps, omegas, widx)
    f, n = split.prop_valid.shape
    fog_scores = _scatter(out["scores"], f, n, fidx, ridx)
    fog_feats = _scatter(out["features"], f, n, fidx, ridx)
    return _merge_fog(pcfg, split, fog_scores, fog_feats)


def assemble_result(split: reg.RegionSplit, merged: Dict[str, torch.Tensor],
                    *, wan_bytes: float, coord_bytes: float,
                    cloud_frames: int, latency: LatencyBreakdown
                    ) -> ChunkResult:
    """Shared result assembly for the sequential and graph execution paths."""
    return ChunkResult(
        boxes=to_host(merged["boxes"]), labels=to_host(merged["labels"]),
        valid=to_host(merged["valid"]), source=to_host(merged["source"]),
        wan_bytes=float(wan_bytes), coord_bytes=float(coord_bytes),
        cloud_frames=cloud_frames, latency=latency,
        fog_features=to_host(merged["fog_features"]),
        prop_boxes=to_host(split.prop_boxes),
        prop_valid=to_host(split.prop_valid),
        fog_scores=to_host(merged["fog_scores"]))


# ---------------------------------------------------------------------------
# Sequential protocol runner with bytes / latency / cost accounting
# ---------------------------------------------------------------------------
@dataclass
class HighLowProtocol:
    det_cfg: DetectorConfig
    clf_cfg: ClassifierConfig
    pcfg: ProtocolConfig = field(default_factory=ProtocolConfig)
    network: NetworkModel = field(default_factory=NetworkModel)
    cost_model: CostModel = field(default_factory=CostModel)
    fog: DeviceProfile = FOG
    cloud: DeviceProfile = CLOUD
    # where the stages compute; "cuda" runs the hand-written kernels
    device: str = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)

    def process_chunk(self, det_params, clf_params, frames_hq: np.ndarray,
                      W=None) -> ChunkResult:
        fhq = torch.as_tensor(frames_hq, device=self.device)
        enc = encode_low(self.pcfg, fhq)
        det = detect_regions(self.det_cfg, det_params, enc.frames)
        split, coord_bytes = split_uncertain(self.pcfg, det)
        W = clf_params["W"] if W is None else torch.as_tensor(
            W, device=self.device)
        merged = classify_regions(self.clf_cfg, self.pcfg, clf_params, W,
                                  fhq, split)

        f = frames_hq.shape[0]
        n_crops = int(split.prop_valid.sum())
        lat = LatencyBreakdown(
            quality_control=self.fog.encode_time(f),
            transmission=(self.network.wan_time(float(enc.nbytes))
                          + self.network.wan_time(float(coord_bytes))),
            cloud_inference=self.cloud.detect_time(f),
            fog_inference=self.fog.classify_time(max(n_crops, 1)),
        )
        return assemble_result(split, merged, wan_bytes=float(enc.nbytes),
                               coord_bytes=float(coord_bytes),
                               cloud_frames=f, latency=lat)

    def cloud_cost(self, result: ChunkResult) -> float:
        # RQ2: one cloud detector pass per frame, nothing else
        return self.cost_model.cost(result.cloud_frames, rounds=1.0)


def detections_for_metrics(res: ChunkResult, frame: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (boxes, labels) arrays for the F1 accumulator."""
    keep = res.valid[frame]
    return res.boxes[frame][keep], res.labels[frame][keep]
