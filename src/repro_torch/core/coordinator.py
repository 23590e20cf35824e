"""Cloud-fog coordinators: thin front ends over the serverless function graph
(§III.C fog server coordinator + §III.D dispatcher).

The orchestration itself lives in ``repro_torch.serving.graph``: protocol stages
are registered functions dispatched through the executor/router substrate,
scheduled by an event-driven clock, with cross-stream batching of the cloud
detector.  The coordinators here only wire streams into that graph:

  * :class:`CloudFogCoordinator` — the single-stream coordinator (bit-identical
    to the sequential ``HighLowProtocol`` path): policy execution, HITL
    incremental learning, fault tolerance (cloud outage -> fog fallback).
  * :class:`MultiStreamCoordinator` — N concurrent camera streams sharing
    the cloud detector through the cross-stream batcher + autoscaler.

PyTorch port of ``repro.core.coordinator``.  Both coordinators run on the
protocol's device (``device="cuda"`` by default; the tests pass "cpu").
A stream's inline learner is the port's
:class:`~repro_torch.core.incremental.IncrementalLearner`: the scheduler's
``hitl.collect`` stage hands it the stream's device-resident readout, so
its proximal updates launch the fused update kernel K5 on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.baselines.common import threshold_detections
from repro_torch.configs.vpaas_video import FALLBACK_DETECTOR
from repro_torch.core.bandwidth import LatencyBreakdown, NetworkModel
from repro_torch.core.hitl import OracleAnnotator
from repro_torch.core.incremental import IncrementalLearner
from repro_torch.core.protocol import ChunkResult, HighLowProtocol, to_host
from repro_torch.models import detector as det_mod
from repro_torch.serving.batching import CrossStreamBatcher
from repro_torch.serving.fault import FaultTolerantCoordinator
from repro_torch.serving.graph import GraphScheduler, StreamState, VideoFunctionGraph
from repro_torch.serving.monitor import Monitor
from repro_torch.video.metrics import F1Accumulator


@dataclass
class CoordinatorResult:
    f1: Dict[str, float]
    bandwidth: float
    cloud_cost: float
    latencies: List[float]
    modes: List[str]
    learner_summary: Dict[str, float]


def _check_device(protocol: HighLowProtocol, device) -> None:
    if torch.device(device).type != protocol.device.type:
        raise ValueError(f"coordinator device {device!r} differs from the "
                         f"protocol's {protocol.device}")


def fog_fallback_result(protocol: HighLowProtocol, fallback_params,
                        clf_params, frames: np.ndarray,
                        fallback_cfg=None) -> ChunkResult:
    """Cloud is down: run the small fog detector locally (Fig. 15).

    The HITL hand-off arrays keep the *real* classifier shapes (feature dim
    d+1 from the one-vs-all weight matrix, C score columns) so downstream
    consumers — the learner, result concatenation — never shape-mismatch
    after an outage."""
    det = det_mod.detect(fallback_cfg or FALLBACK_DETECTOR, fallback_params,
                         torch.as_tensor(frames, device=protocol.device))
    boxes, labels, valid = threshold_detections(det, 0.5, 0.25)
    f = frames.shape[0]
    lat = LatencyBreakdown(fog_inference=protocol.fog.detect_time(f))
    n = boxes.shape[1]
    feat_dim, num_classes = clf_params["W"].shape
    return ChunkResult(
        boxes=boxes, labels=labels, valid=valid,
        source=np.full((f, n), 2), wan_bytes=0.0, coord_bytes=0.0,
        cloud_frames=0, latency=lat,
        fog_features=np.zeros((f, n, feat_dim), np.float32),
        prop_boxes=boxes,
        prop_valid=np.zeros((f, n), bool),
        fog_scores=np.zeros((f, n, num_classes), np.float32))


class CloudFogCoordinator:
    """End-to-end single-stream coordinator: chunks in, detections + metrics +
    learning out.  A thin shell over the function graph: one stream, one
    fog node, immediate (window=0) detector dispatch — the event order then
    degenerates to the strict sequential path."""

    def __init__(self, protocol: HighLowProtocol, det_params, clf_params,
                 *, fallback_params=None, fallback_cfg=None,
                 learner: Optional[IncrementalLearner] = None,
                 annotator: OracleAnnotator = None,
                 network: NetworkModel = None, monitor: Monitor = None,
                 hot_path: str = "fused", learning_plane=None,
                 device="cuda"):
        _check_device(protocol, device)
        self.protocol = protocol
        self.det_params = det_params
        self.clf_params = clf_params
        self.fallback_params = fallback_params
        self.fallback_cfg = fallback_cfg
        self.learner = learner
        self.annotator = annotator or OracleAnnotator()
        self.network = network or protocol.network
        self.monitor = monitor or Monitor()
        self.fault = FaultTolerantCoordinator(self.network)
        self.graph = VideoFunctionGraph(protocol, det_params, clf_params)
        self.scheduler = GraphScheduler(
            self.graph, network=self.network, monitor=self.monitor,
            batcher=CrossStreamBatcher(max_chunks=1, window=0.0),
            hot_path=hot_path,
            fault=self.fault, fallback_fn=self._fog_fallback)
        self.plane = learning_plane
        if learning_plane is not None:
            learning_plane.attach(self.scheduler)
        self._stream = self.scheduler.add_stream(
            "cam0", W=to_host(clf_params["W"]), learner=learner,
            annotator=self.annotator)

    # -- state the HITL loop / tests observe ---------------------------------
    @property
    def W(self) -> np.ndarray:
        return self._stream.W

    @W.setter
    def W(self, value) -> None:
        self._stream.W = to_host(value)

    @property
    def clock(self) -> float:
        return self._stream.clock

    # ------------------------------------------------------------------
    def _fog_fallback(self, frames: np.ndarray) -> ChunkResult:
        return fog_fallback_result(self.protocol, self.fallback_params,
                                   self.clf_params, frames,
                                   fallback_cfg=self.fallback_cfg)

    # ------------------------------------------------------------------
    def process_chunk(self, chunk, *, learn: bool = True) -> ChunkResult:
        self.scheduler.submit(self._stream, chunk, learn=learn)
        self.scheduler.run_until_idle()
        _, res, _ = self._stream.results[-1]
        return res

    # ------------------------------------------------------------------
    def run(self, chunks, *, learn: bool = True) -> CoordinatorResult:
        f1 = F1Accumulator()
        lats, modes = [], []
        total_bytes = 0.0
        cost = 0.0
        for chunk in chunks:
            res = self.process_chunk(chunk, learn=learn)
            for t in range(chunk.frames.shape[0]):
                keep = res.valid[t]
                f1.update(res.boxes[t][keep], res.labels[t][keep],
                          chunk.gt_boxes[t], chunk.gt_labels[t])
            lats.append(res.latency.total)
            modes.append(self.fault.mode)
            total_bytes += res.wan_bytes + res.coord_bytes
            cost += self.protocol.cloud_cost(res)
        learner_summary = {}
        if self.learner is not None:
            learner_summary = {"labels_used": self.learner.labels_used,
                               "updates": self.learner.updates_done}
        return CoordinatorResult(f1.summary(), total_bytes, cost, lats,
                                 modes, learner_summary)


# ---------------------------------------------------------------------------
# Multi-camera execution
# ---------------------------------------------------------------------------
@dataclass
class StreamSpec:
    """One camera's workload: its chunks and (optional) per-site HITL state.

    ``slo`` is the stream's end-to-end per-chunk latency target (seconds,
    simulated; None = best-effort / coordinator default) and ``weight`` its
    fair-queueing weight (higher = more detector service under backlog)."""
    name: str
    chunks: Sequence
    learner: Optional[IncrementalLearner] = None
    annotator: Optional[OracleAnnotator] = None
    slo: Optional[float] = None
    weight: float = 1.0


class MultiStreamCoordinator:
    """N concurrent camera streams over a shared cloud detector pool.

    Streams advance on the event-driven clock; their detector invocations
    are batched across streams (deadline-driven when streams carry SLOs,
    fixed-window otherwise), sharded across ``cloud_replicas`` health-
    checked replicas, real queue depths drive the autoscaler (which can
    scale devices or whole replicas), and each stream keeps its own fog
    node, model cache W, and incremental learner."""

    def __init__(self, protocol: HighLowProtocol, det_params, clf_params,
                 streams: Sequence[Union[StreamSpec, Sequence]], *,
                 fallback_params=None, fallback_cfg=None,
                 network: NetworkModel = None,
                 monitor: Monitor = None, max_batch_chunks: int = 8,
                 batch_window: float = 0.02, cloud_devices: int = 1,
                 cloud_replicas: int = 1, slo: Optional[float] = None,
                 deadline_batching: bool = True,
                 adaptive_margin: bool = True,
                 cold_start_s: float = 0.0,
                 scale_unit: Optional[str] = None,
                 hot_path: str = "fused",
                 autoscaler=None, fault: FaultTolerantCoordinator = None,
                 learning_plane=None, num_shards: int = 1,
                 use_store: bool = False, device="cuda"):
        _check_device(protocol, device)
        self.protocol = protocol
        self.clf_params = clf_params
        self.fallback_params = fallback_params
        self.fallback_cfg = fallback_cfg
        self.network = network or protocol.network
        self.monitor = monitor or Monitor()
        self.graph = VideoFunctionGraph(protocol, det_params, clf_params)
        if scale_unit is None:
            # with a replica pool the autoscaler manages replicas; a single
            # executor keeps the legacy in-place device scaling
            scale_unit = "replicas" if cloud_replicas > 1 else "devices"
        sched_kw = dict(
            network=self.network, monitor=self.monitor,
            cloud_devices=cloud_devices, cloud_replicas=cloud_replicas,
            autoscaler=autoscaler, scale_unit=scale_unit,
            deadline_batching=deadline_batching,
            adaptive_margin=adaptive_margin, cold_start_s=cold_start_s,
            hot_path=hot_path,
            fault=fault, fallback_fn=self._fog_fallback)
        if num_shards > 1 or use_store:
            # thousand-stream mode: K per-shard event loops + claim-check
            # ingestion over one shared replica pool (serving.shards)
            from repro_torch.serving.shards import ShardedScheduler
            self.scheduler = ShardedScheduler(
                self.graph, num_shards=num_shards, use_store=use_store,
                batcher_factory=lambda i: CrossStreamBatcher(
                    max_chunks=max_batch_chunks, window=batch_window),
                **sched_kw)
        else:
            self.scheduler = GraphScheduler(
                self.graph,
                batcher=CrossStreamBatcher(max_chunks=max_batch_chunks,
                                           window=batch_window),
                **sched_kw)
        self.plane = learning_plane
        if learning_plane is not None:
            # the continual-learning plane replaces per-stream inline HITL
            learning_plane.attach(self.scheduler)
        self.specs: List[StreamSpec] = []
        self._states: List[StreamState] = []
        for i, s in enumerate(streams):
            spec = s if isinstance(s, StreamSpec) else StreamSpec(
                name=f"cam{i}", chunks=list(s))
            self.specs.append(spec)
            self._states.append(self.scheduler.add_stream(
                spec.name, W=to_host(clf_params["W"]),
                learner=spec.learner, annotator=spec.annotator,
                slo=spec.slo if spec.slo is not None else slo,
                weight=spec.weight))

    def _fog_fallback(self, frames: np.ndarray) -> ChunkResult:
        return fog_fallback_result(self.protocol, self.fallback_params,
                                   self.clf_params, frames,
                                   fallback_cfg=self.fallback_cfg)

    # ------------------------------------------------------------------
    def run(self, *, learn: bool = True) -> Dict[str, CoordinatorResult]:
        for spec, state in zip(self.specs, self._states):
            for chunk in spec.chunks:
                self.scheduler.submit(state, chunk, learn=learn)
        self.scheduler.run_until_idle()
        return self.results()

    def results(self) -> Dict[str, CoordinatorResult]:
        """Per-stream metrics over everything finalized so far (offline
        bookkeeping — callers that time the serving drain call this after
        stopping the clock)."""
        out: Dict[str, CoordinatorResult] = {}
        for spec, state in zip(self.specs, self._states):
            f1 = F1Accumulator()
            lats, modes = [], []
            total_bytes = 0.0
            cost = 0.0
            for chunk, res, mode in state.results:
                for t in range(chunk.frames.shape[0]):
                    keep = res.valid[t]
                    f1.update(res.boxes[t][keep], res.labels[t][keep],
                              chunk.gt_boxes[t], chunk.gt_labels[t])
                lats.append(res.latency.total)
                modes.append(mode)
                total_bytes += res.wan_bytes + res.coord_bytes
                cost += self.protocol.cloud_cost(res)
            learner_summary = {}
            if spec.learner is not None:
                learner_summary = {"labels_used": spec.learner.labels_used,
                                   "updates": spec.learner.updates_done}
            out[spec.name] = CoordinatorResult(
                f1.summary(), total_bytes, cost, lats, modes,
                learner_summary)
        return out

    def report(self) -> Dict[str, float]:
        """Cross-stream batching + detect-stage throughput + scaling stats."""
        rep = self.scheduler.throughput_report()
        if self.plane is not None:
            rep["learning"] = self.plane.summary()
        return rep
