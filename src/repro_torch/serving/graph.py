"""Function-graph execution of the High-Low protocol (§III serverless view).

The paper frames the pipeline as serverless *functions* ("model inference",
re-encode, region-classify) orchestrated across client/fog/cloud.  This
module makes that literal: the protocol's stage functions are registered in
a :class:`~repro_torch.serving.registry.FunctionRegistry` under tier-qualified
names and dispatched through :class:`~repro_torch.serving.executor.Executor` /
:class:`~repro_torch.serving.router.Router`:

  ``fog.encode_low``        quality control on the per-camera fog node
  ``cloud.detect``          heavy detector — **batched across streams**
  ``fog.classify_regions``  HQ crop + one-vs-all classify + merge
  ``hitl.collect``          §V feedback collection + incremental update

Execution is **event-driven**: a priority queue of per-stream events
(ingest -> flush -> finalize) replaces the old coordinator's scalar clock,
so N camera streams advance concurrently on one simulated timeline.  The
cloud-detector stage runs through a :class:`CrossStreamBatcher` that packs
frames from concurrent chunks into padded detector calls (Tangram-style
batched serverless inference) and feeds the *real* queue depth to the
autoscaler on every dispatch.  At fleet scale the event loop is no longer
one heap: :class:`~repro_torch.serving.shards.ShardedScheduler` runs K of
these schedulers over disjoint stream sets on a merged timeline, and with a
claim-check :class:`~repro_torch.serving.ingest.ArtifactStore` attached the
queued events carry payload *references* instead of frame tensors —
resolved once per flush, at assembly time (see ``_dispatch``).

The serving plane is **SLO-aware and multi-replica**: streams carry a
per-chunk latency SLO (deadline-driven flush — the batch is held open only
while the tightest pending deadline can still be met given the estimated
service time) and a fair-queueing weight (WFQ batch-assembly order), each
flush is sharded into frame-balanced sub-batches routed concurrently
across the :class:`~repro_torch.serving.router.Router`'s health-checked detector
replicas, the autoscaler can add/remove whole replicas
(``scale_unit="replicas"``), and a replica that dies mid-run has its
sub-batch re-queued to survivors (or the fog fallback) with no chunk lost.

The default ``hot_path="fused"`` keeps the detect->split->classify dataflow
**device-resident**: ``encode_low`` output never round-trips through numpy,
cross-stream packing is a device-side concat+pad, the cloud stage is the
fused ``cloud.detect_split`` (one dispatch and **one** blocking
device->host read — the proposal-validity mask — per flush, instead of a
``block_until_ready`` plus two scalar syncs per chunk), the fog stage is
the compacted ``fog.classify_batched`` (only the flush's valid proposals
are gathered into one bucketed crop batch and classified cross-stream with
per-stream readouts, scattered back into the full result grid), per-stream
readouts are uploaded once and refreshed only on hot-swap/learner update,
and chunk results stay device-side futures queued in ``_inflight`` until
their finalize event drains them — so flush k's detect overlaps flush
k-1's host-side result materialization.  ``hot_path="sync"`` preserves the
pre-fusion synchronous path (the benchmark baseline).

PyTorch port of ``repro.serving.graph``: device values are torch tensors
on the protocol's device (``HighLowProtocol.device``), uploads are
``torch.as_tensor(x, device=...)`` and every device->host read goes through
:func:`~repro_torch.core.protocol.to_host`.  The fused path keeps exactly
one blocking read per flush (the proposal-validity mask).

With one stream and a zero batching window the event order degenerates to
the strict sequential path, and because the stage functions agree
bit-for-bit, results are identical to ``HighLowProtocol.process_chunk``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import protocol as protocol_mod
from repro_torch.core import regions as reg
from repro_torch.core.bandwidth import LatencyBreakdown, NetworkModel
from repro_torch.core.hitl import OracleAnnotator
from repro_torch.core.protocol import ChunkResult, HighLowProtocol, to_host
from repro_torch.serving.batching import (CrossStreamBatcher, DetectRequest,
                                    pack_frames, pack_frames_device)
from repro_torch.serving.executor import Executor
from repro_torch.serving.ingest import (ArtifactCorrupted, ArtifactStore,
                                  ClaimCheck, content_key)
from repro_torch.serving.monitor import Monitor
from repro_torch.serving.registry import Dispatcher, FunctionRegistry, ModelZoo
from repro_torch.serving.router import Router
from repro_torch.serving.tenancy import TenantChunkResult

STAGE_ENCODE = "fog.encode_low"
STAGE_DETECT = "cloud.detect"
STAGE_DETECT_SPLIT = "cloud.detect_split"      # fused detect + §IV.B split
STAGE_DETECT_SPLIT_DON = "cloud.detect_split_donated"  # donates the batch
STAGE_DETECT_SPLIT_DYN = "cloud.detect_split_dynamic"  # per-frame thetas
STAGE_CLASSIFY = "fog.classify_regions"
STAGE_CLASSIFY_BATCH = "fog.classify_batched"  # compacted cross-stream
STAGE_CLASSIFY_ENS = "fog.classify_ensemble"   # Eq. 9 snapshot ensemble
STAGE_CLASSIFY_ENS_BATCH = "fog.classify_ensemble_batched"
STAGE_CLASSIFY_VIEW = "fog.classify_view"      # per-stream slice accounting
STAGE_COLLECT = "hitl.collect"
STAGES = (STAGE_ENCODE, STAGE_DETECT, STAGE_DETECT_SPLIT,
          STAGE_DETECT_SPLIT_DON, STAGE_DETECT_SPLIT_DYN, STAGE_CLASSIFY,
          STAGE_CLASSIFY_BATCH, STAGE_CLASSIFY_ENS, STAGE_CLASSIFY_ENS_BATCH,
          STAGE_CLASSIFY_VIEW, STAGE_COLLECT)


# ---------------------------------------------------------------------------
# The graph: protocol stages as registered serverless functions
# ---------------------------------------------------------------------------
@dataclass
class VideoFunctionGraph:
    """Registers the High-Low stages + models into the serving substrate."""
    protocol: HighLowProtocol
    det_params: Any
    clf_params: Any
    registry: FunctionRegistry = field(default_factory=FunctionRegistry)
    zoo: ModelZoo = field(default_factory=ModelZoo)

    def __post_init__(self):
        p = self.protocol
        self.registry.register(STAGE_ENCODE, self._encode, kind="preprocess",
                               tier="fog")
        self.registry.register(STAGE_DETECT, self._detect, kind="inference",
                               tier="cloud", batchable=True)
        self.registry.register(STAGE_DETECT_SPLIT, self._detect_split,
                               kind="inference", tier="cloud",
                               batchable=True, fused=True)
        self.registry.register(STAGE_DETECT_SPLIT_DON,
                               self._detect_split_donated,
                               kind="inference", tier="cloud",
                               batchable=True, fused=True)
        self.registry.register(STAGE_DETECT_SPLIT_DYN,
                               self._detect_split_dynamic,
                               kind="inference", tier="cloud",
                               batchable=True, fused=True)
        self.registry.register(STAGE_CLASSIFY, self._classify,
                               kind="inference", tier="fog")
        self.registry.register(STAGE_CLASSIFY_BATCH, self._classify_batched,
                               kind="inference", tier="fog", batchable=True)
        self.registry.register(STAGE_CLASSIFY_ENS, self._classify_ensemble,
                               kind="inference", tier="fog", ensemble=True)
        self.registry.register(STAGE_CLASSIFY_ENS_BATCH,
                               self._classify_ensemble_batched,
                               kind="inference", tier="fog", batchable=True,
                               ensemble=True)
        # accounting stage: a fog node's share of the batched classify is a
        # lazy device-side slice of the shared result (no compute)
        self.registry.register(STAGE_CLASSIFY_VIEW, lambda views: views,
                               kind="postprocess", tier="fog")
        self.registry.register(STAGE_COLLECT, self._collect,
                               kind="postprocess", tier="fog")
        self.zoo.register("cloud-detector", self.det_params, p.det_cfg)
        self.zoo.register("fog-classifier", self.clf_params, p.clf_cfg)
        self.dispatcher = Dispatcher(self.registry, self.zoo)
        self.dispatcher.dispatch("cloud", STAGE_DETECT)
        self.dispatcher.dispatch("cloud", STAGE_DETECT_SPLIT)
        self.dispatcher.dispatch("cloud", STAGE_DETECT_SPLIT_DON)
        self.dispatcher.dispatch("cloud", STAGE_DETECT_SPLIT_DYN)
        self.dispatcher.dispatch("cloud", "cloud-detector")
        for name in (STAGE_ENCODE, STAGE_CLASSIFY, STAGE_CLASSIFY_BATCH,
                     STAGE_CLASSIFY_ENS, STAGE_CLASSIFY_ENS_BATCH,
                     STAGE_CLASSIFY_VIEW, STAGE_COLLECT, "fog-classifier"):
            self.dispatcher.dispatch("fog", name)

    # -- stage callables (close over configs/params) ------------------------
    def _encode(self, frames_hq):
        return protocol_mod.encode_low(
            self.protocol.pcfg,
            torch.as_tensor(frames_hq, device=self.protocol.device))

    def _detect(self, frames):
        return protocol_mod.detect_regions(self.protocol.det_cfg,
                                           self.det_params, frames)

    def _detect_split(self, frames):
        return protocol_mod.detect_split(self.protocol.det_cfg,
                                         self.protocol.pcfg,
                                         self.det_params, frames)

    def _detect_split_donated(self, frames):
        return protocol_mod.detect_split_donated(self.protocol.det_cfg,
                                                 self.protocol.pcfg,
                                                 self.det_params, frames)

    def _detect_split_dynamic(self, frames, theta_cls, theta_loc):
        return protocol_mod.detect_split_dynamic(
            self.protocol.det_cfg, self.protocol.pcfg, self.det_params,
            frames, theta_cls, theta_loc)

    def _classify_batched(self, frames_hq, split, Ws, idxs):
        return protocol_mod.classify_compacted(
            self.protocol.clf_cfg, self.protocol.pcfg, self.clf_params, Ws,
            frames_hq, split, idxs)

    def _classify(self, frames_hq, split, W):
        return protocol_mod.classify_regions(
            self.protocol.clf_cfg, self.protocol.pcfg, self.clf_params, W,
            frames_hq, split)

    def _classify_ensemble(self, frames_hq, split, snaps, omega):
        return protocol_mod.classify_ensemble(
            self.protocol.clf_cfg, self.protocol.pcfg, self.clf_params,
            snaps, omega, frames_hq, split)

    def _classify_ensemble_batched(self, frames_hq, split, snaps, omegas,
                                   idxs):
        return protocol_mod.classify_compacted_ensemble(
            self.protocol.clf_cfg, self.protocol.pcfg, self.clf_params,
            snaps, omegas, frames_hq, split, idxs)

    def _collect(self, stream: "StreamState", chunk, res: ChunkResult) -> int:
        """HITL feedback for one finished chunk; returns 1 on a W update."""
        learner = stream.learner
        annotator = stream.annotator
        for t in range(chunk.frames.shape[0]):
            idx = np.nonzero(res.prop_valid[t])[0]
            if not len(idx):
                continue
            labels = annotator.label_regions(
                res.prop_boxes[t][idx], chunk.gt_boxes[t], chunk.gt_labels[t])
            for i, lab in zip(idx, labels):
                # skip BACKGROUND (inspected, no object) and UNLABELED
                # (annotator budget exhausted — never inspected)
                if lab >= 0:
                    learner.collect(res.fog_features[t, i], int(lab))
        newW, updated = learner.maybe_update(stream.W_device())
        if updated:
            stream.W = to_host(newW)   # fog model-cache refresh
            return 1
        return 0


# ---------------------------------------------------------------------------
# Per-stream state
# ---------------------------------------------------------------------------
@dataclass
class StreamState:
    """One camera stream: its fog node, model cache, and HITL state.

    ``slo`` is the stream's end-to-end per-chunk latency target (seconds,
    simulated; None = best-effort), and ``weight`` its fair-queueing weight —
    a high-weight camera's chunks preempt backlog from bulk streams in the
    cross-stream batcher."""
    name: str
    W: np.ndarray
    fog_exec: Executor
    learner: Any = None
    annotator: Any = None
    # device the stream's readouts are uploaded to (the protocol's)
    device: Any = "cpu"
    slo: Optional[float] = None
    weight: float = 1.0
    # owning TenantSpec (tenancy.py); None = the implicit default tenant
    # running the High-Low pipeline — the exact pre-tenancy code paths.
    # A tenant with a custom pipeline routes this stream's flushes through
    # ``_dispatch_tenant`` instead of the detect/classify hot path.
    tenant: Any = None
    clock: float = 0.0
    busy: bool = False
    # adaptive SLO headroom: EWMA of observed deadline attainment drives the
    # per-stream margin between its configured bounds (high attainment ->
    # tighter margin -> more batching; misses -> margin widens fast)
    slo_margin: float = 0.1
    att_ewma: float = 1.0
    # owning shard scheduler (ShardedScheduler): a finalize that runs on a
    # stealing shard must hand the stream's next ingest back to its owner's
    # event loop, not the thief's.  None = the single-scheduler case.
    owner: Any = None
    # per-site detector thresholds (drift adaptation): None = the global
    # ProtocolConfig value, so defaults stay bit-compatible.  A flush whose
    # streams all use defaults takes the static fused stage; any override
    # routes through cloud.detect_split_dynamic with per-frame thetas.
    theta_cls: Optional[float] = None
    theta_loc: Optional[float] = None
    pending: Deque[Tuple[Any, bool]] = field(default_factory=deque)
    results: List[Tuple[Any, ChunkResult, str]] = field(default_factory=list)
    # Eq. 9 ensemble serving: when set, the stream's classify stage scores
    # crops against the whole snapshot lineage (snaps (T, d+1, C) weighted
    # by omega (T,)) instead of the single readout W.  ``W`` stays the
    # latest-snapshot readout — the learning plane keeps rescoring label
    # candidates against it — and a later W hot-swap supersedes (clears)
    # the ensemble.
    snaps: Optional[np.ndarray] = None
    omega: Optional[np.ndarray] = None
    # device-resident readout cache: W is uploaded once and re-uploaded only
    # when the host-side array object changes (hot-swap / learner update),
    # not per chunk.  Identity tracking rather than a setter keeps every
    # existing `stream.W = ...` call site correct.
    w_uploads: int = 0
    _W_dev: Any = None
    _W_src: Any = None
    e_uploads: int = 0
    _E_dev: Any = None
    _E_src: Any = None

    def W_device(self):
        if self._W_dev is None or self._W_src is not self.W:
            self._W_dev = torch.as_tensor(self.W, device=self.device)
            self._W_src = self.W
            self.w_uploads += 1
        return self._W_dev

    @property
    def ensemble(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.snaps is None:
            return None
        return self.snaps, self.omega

    def set_ensemble(self, snaps, omega) -> None:
        snaps = to_host(snaps)
        omega = to_host(omega).astype(snaps.dtype)
        assert snaps.ndim == 3 and omega.shape == (snaps.shape[0],)
        self.snaps, self.omega = snaps, omega

    def clear_ensemble(self) -> None:
        self.snaps = self.omega = None
        self._E_dev = self._E_src = None

    def ensemble_device(self):
        """(snaps, omega) uploaded once per set_ensemble, identity-cached
        like ``W_device``."""
        if self._E_dev is None or self._E_src is not self.snaps:
            self._E_dev = (torch.as_tensor(self.snaps, device=self.device),
                           torch.as_tensor(self.omega, device=self.device))
            self._E_src = self.snaps
            self.e_uploads += 1
        return self._E_dev


# ---------------------------------------------------------------------------
# Per-field lazy flush results
# ---------------------------------------------------------------------------
class _FlushBundle:
    """One flush's device-side results, materialized per *field* on demand.

    A field's first access downloads its device buffer once for the whole
    flush (id-deduped: the detector boxes back ``acc_boxes`` AND
    ``merged["boxes"]`` — one buffer, one copy); every chunk then slices
    numpy views.  Fields nothing reads are never downloaded — a HITL-off
    run finalizes without ever paying for ``fog_features``."""

    def __init__(self, split, merged, stats: dict, field_downloads: dict):
        self.split, self.merged = split, merged
        self._stats = stats
        self._field_downloads = field_downloads
        self._cache: Dict[int, np.ndarray] = {}
        self._touched = False
        # retention bookkeeping (GraphScheduler.max_retained_bundles):
        # chunks of this flush not yet finalized, and the id-deduped bytes
        # of the device buffers this bundle keeps alive while unsealed
        self.pending = 0
        self.sealed = False
        seen: Dict[int, int] = {}
        for v in (list(merged.values())
                  + [getattr(split, f) for f in split._fields]):
            if not isinstance(v, np.ndarray):
                seen[id(v)] = v.nbytes
        self.device_bytes = sum(seen.values())

    def field(self, name: str) -> np.ndarray:
        if self.sealed:
            arr = self._host.get(name)
            if arr is None:
                raise RuntimeError(
                    f"field {name!r} first accessed after its flush bundle "
                    "was sealed (max_retained_bundles exceeded); consume "
                    "results at finalize or raise the retention cap")
            return arr
        src = (self.merged[name] if name in self.merged
               else getattr(self.split, name))
        if isinstance(src, np.ndarray):
            return src                 # already materialized + swapped in
        arr = self._cache.get(id(src))
        if arr is None:
            arr = self._cache[id(src)] = to_host(src)
            self._field_downloads[name] = (
                self._field_downloads.get(name, 0) + 1)
            if not self._touched:
                self._touched = True
                self._stats["result_downloads"] += 1
        if name in self.merged:
            # swap the host copy in for the device ref so the downloaded
            # buffer can free — the big per-flush grids (fog_features,
            # fog_scores) live only in ``merged``; split fields stay
            # device-side because the RegionSplit tuple aliases them
            self.merged[name] = arr
        return arr

    def seal(self) -> None:
        """Drop every device reference this bundle holds.

        Fields already downloaded stay available (the host copies move to
        ``_host``); a *first* access after sealing raises — by then the
        scheduler has decided this flush's device memory must free.  Called
        only on fully-finalized bundles past the retention cap."""
        if self.sealed:
            return
        host: Dict[str, np.ndarray] = {}
        for name, v in self.merged.items():
            if isinstance(v, np.ndarray):
                host[name] = v
        for name in self.split._fields:
            src = getattr(self.split, name)
            if isinstance(src, np.ndarray):
                host[name] = src
            else:
                arr = self._cache.get(id(src))
                if arr is not None:
                    host[name] = arr
        self._host = host
        self.split = self.merged = None
        self._cache.clear()
        self.sealed = True


class LazyChunkResult:
    """Duck-typed :class:`~repro_torch.core.protocol.ChunkResult` whose array
    fields materialize from the flush bundle on first attribute access.

    Scalars (bytes, latency, frame counts) are eager — the scheduler's
    bookkeeping reads them on the finalize path — while the arrays stay
    device-side until a consumer (F1 evaluation, the learning plane, a
    test) actually touches them.  Once read, the numpy slice is cached on
    the instance, so repeated access costs one dict hit."""

    _ARRAY_FIELDS = frozenset((
        "boxes", "labels", "valid", "source", "fog_features", "fog_scores",
        "prop_boxes", "prop_valid"))

    def __init__(self, bundle: _FlushBundle, sl: slice, *, wan_bytes: float,
                 coord_bytes: float, cloud_frames: int, latency):
        self._bundle, self._sl = bundle, sl
        self.wan_bytes = float(wan_bytes)
        self.coord_bytes = float(coord_bytes)
        self.cloud_frames = cloud_frames
        self.latency = latency

    def __getattr__(self, name: str):
        # only reached when normal lookup misses: the lazy array fields
        if name not in LazyChunkResult._ARRAY_FIELDS:
            raise AttributeError(name)
        val = self._bundle.field(name)[self._sl]
        setattr(self, name, val)        # cache: __getattr__ never re-fires
        return val


# ---------------------------------------------------------------------------
# Event-driven scheduler
# ---------------------------------------------------------------------------
class GraphScheduler:
    """Priority-queue scheduler over the function graph.

    Events: ``ingest`` (chunk enters its stream's fog node), ``flush``
    (cross-stream batcher dispatches the cloud detector), ``finalize``
    (chunk result lands; HITL runs; the stream pulls its next chunk).
    """

    def __init__(self, graph: VideoFunctionGraph, *,
                 network: Optional[NetworkModel] = None,
                 monitor: Optional[Monitor] = None,
                 batcher: Optional[CrossStreamBatcher] = None,
                 cloud_devices: int = 1, cloud_replicas: int = 1,
                 autoscaler=None, scale_unit: str = "devices",
                 deadline_batching: bool = True, slo_margin: float = 0.1,
                 adaptive_margin: bool = True,
                 margin_bounds: Tuple[float, float] = (0.05, 0.5),
                 margin_alpha: float = 0.25,
                 cold_start_s: float = 0.0,
                 hot_path: str = "fused",
                 crop_buckets: Tuple[int, ...] = (4, 8, 16, 32, 64, 128),
                 max_retained_bundles: Optional[int] = 256,
                 fault=None, fallback_fn: Optional[Callable] = None,
                 hedging: bool = True, hedge_slack: float = 0.1,
                 router: Optional[Router] = None,
                 seq_counter=None,
                 store: Optional[ArtifactStore] = None,
                 pick_policy: str = "least",
                 cost_model=None,
                 fog_queueing: bool = False,
                 hitl_cost_s: float = 0.0,
                 warm_pool=None):
        assert hot_path in ("fused", "sync")
        proto = graph.protocol
        self.graph = graph
        self.network = network or proto.network
        self.monitor = monitor or Monitor()
        # explicit None check: an empty batcher is falsy (it has __len__)
        self.batcher = (batcher if batcher is not None
                        else CrossStreamBatcher(max_chunks=1, window=0.0))
        if self.batcher.service_model is None:
            # deadline-driven flush needs an estimate of batch service time
            self.batcher.service_model = proto.cloud.detect_time

        def _make_replica(i: int) -> Executor:
            return Executor("cloud" if i == 0 else f"cloud-{i}",
                            graph.registry, proto.cloud,
                            num_devices=cloud_devices)

        if router is not None:
            # sharded mode: every shard dispatches into ONE shared detector
            # replica pool (and one autoscaler) instead of building its own
            self.router = router
            self.cloud_executor = router.replicas[0].executor
        else:
            replicas = [_make_replica(i)
                        for i in range(max(1, cloud_replicas))]
            self.cloud_executor = replicas[0]   # primary (never retired)
            self.router = Router(replicas, monitor=self.monitor,
                                 autoscaler=autoscaler,
                                 scale_unit=scale_unit,
                                 replica_factory=_make_replica,
                                 cold_start_s=cold_start_s,
                                 pick_policy=pick_policy)
        self.autoscaler = autoscaler
        # claim-check plane: when set, _arrive publishes the encoded chunk
        # here and the batcher queue holds only ClaimCheck references; the
        # payloads are resolved (and the claims released) in _dispatch
        self.store = store
        self.deadline_batching = deadline_batching
        # headroom fraction of the SLO held back when deriving the detect
        # deadline: estimates (service time, downstream work, device wait)
        # carry error, and a batch held open to the exact deadline misses
        # on any slip.  ``slo_margin`` is each stream's *initial* margin;
        # with ``adaptive_margin`` it then tracks an EWMA of the stream's
        # observed deadline attainment between ``margin_bounds``.
        self.slo_margin = slo_margin
        self.adaptive_margin = adaptive_margin
        self.margin_bounds = margin_bounds
        self.margin_alpha = margin_alpha
        # continual-learning plane hook (ContinualLearningPlane.attach)
        self.plane = None
        self.fault = fault
        self.fallback_fn = fallback_fn
        # --- chaos plane ---------------------------------------------------
        # hedged dispatch: when the primary replica's service-rate EWMA says
        # this sub-batch will straggle past the flush's detect deadline, a
        # speculative duplicate is booked on the best alternate replica and
        # whichever completion comes first wins.  The primary wins exact
        # ties (same deterministic (t, seq) discipline as sharding) and the
        # decision is gated on an attached fault schedule, so a fault-free
        # or idle-injector run never hedges and stays bitwise-identical.
        self.hedging = hedging
        self.hedge_slack = hedge_slack
        # flapped-replica readmission: health probes with exponential
        # backoff, only for outages the injector marks transient
        self.probe_base = 0.05
        self.probe_max = 1.0
        self._probing: set = set()
        # reported unconditionally (zeros on fault-free runs) so plain and
        # idle-injector throughput reports stay key-for-key identical
        self.chaos_stats = {"hedges": 0, "hedge_wins": 0,
                            "hedge_busy_s": 0.0, "probes": 0, "readmits": 0,
                            "requeues": 0, "corruptions_repaired": 0}
        # estimate of the post-detect work (coords download + fog classify)
        # a chunk still faces; the detect deadline is the stream SLO minus
        # this.  Tracked as a fast-up/slow-down EWMA of observed values so
        # the flush policy stays conservative: under-holding a batch only
        # costs batching efficiency, over-holding misses the SLO.
        self._downstream_est = (self.network.wan_time(0.0)
                                + proto.fog.classify_time(8))
        self.streams: Dict[str, StreamState] = {}
        self._events: List[Tuple[float, int, str, dict]] = []
        # shards share one counter so same-time events across shard heaps
        # keep a global, deterministic tie-break order
        self._seq = seq_counter if seq_counter is not None \
            else itertools.count()
        # event-loop wall accounting: step_wall_s brackets every step();
        # model_wall_s brackets _dispatch (payload assembly + model calls),
        # so (step - model) / finalizes is the per-chunk *scheduling*
        # overhead — the flatness metric gated by bench_shard_scale
        self.sched_stats = {"events": 0, "finalizes": 0,
                            "step_wall_s": 0.0, "model_wall_s": 0.0}
        # wall-clock accounting for the detect stage (throughput lever)
        self.detect_stats = {"calls": 0, "frames": 0, "padded_frames": 0,
                             "wall_s": 0.0}
        # (start, service) of every detect dispatch, held here because a
        # replica retired by scale-down takes its ExecutionRecords with it
        self._detect_windows: List[Tuple[float, float]] = []
        # --- device-resident hot path -------------------------------------
        # "fused": one cloud.detect_split dispatch + ONE blocking host read
        # (the validity mask) per flush, compacted cross-stream classify,
        # results kept as device futures until their finalize event.
        # "sync": the pre-fusion baseline (per-chunk split + scalar syncs +
        # full-budget classify + block_until_ready) for A/B benchmarking.
        self.hot_path = hot_path
        self.crop_buckets = crop_buckets
        self.device = proto.device
        # PyTorch has no buffer donation: the donated stage stays registered
        # (an alias of the plain one) but is never routed to
        self.donate_detect = False
        # shared executor for the compacted cross-stream classify call (the
        # per-stream share is accounted on each stream's own fog executor)
        self.fog_batch_exec = Executor("fog-batch", graph.registry, proto.fog)
        # bounded memo for the stacked ensemble upload, keyed on the
        # flush's readout-group composition: deadline-driven batching
        # produces a handful of recurring flush mixes, each of which
        # should upload its (snaps, omegas) device stack once.  Values
        # hold strong refs to the source arrays, so an id in a live key
        # can never be recycled.  A hot-swap changes a source's identity
        # and naturally misses.
        self._ens_cache: Dict[Tuple[int, ...],
                              Tuple[List[Any], Tuple[Any, Any]]] = {}
        self._ens_cache_cap = 16
        # device-side results awaiting materialization at their finalize
        # event — the in-flight future queue that lets flush k's detect
        # overlap flush k-1's host-side result handling
        self._inflight: Deque[dict] = deque()
        # host_syncs counts *blocking* device->host reads on the dispatch
        # path (the reads that stall the accelerator feed; the per-chunk
        # result downloads happen later, at finalize, and are counted as
        # result_downloads)
        self.hot_path_stats = {"flushes": 0, "host_syncs": 0,
                               "result_downloads": 0, "crops_classified": 0,
                               "crops_budget": 0, "inflight_peak": 0,
                               "ensemble_flushes": 0, "ensemble_uploads": 0,
                               "bundles_sealed": 0, "bundles_retained_peak": 0,
                               "bundle_bytes": 0, "bundle_bytes_peak": 0}
        # bounded flush-bundle retention: a long-running service finalizes
        # far more flushes than any consumer revisits, and each unsealed
        # bundle pins its flush's device buffers.  Once more than
        # ``max_retained_bundles`` bundles are alive, the oldest fully-
        # finalized ones are sealed (device refs dropped; downloaded host
        # copies kept) so device residency stays flat.  ``None`` disables.
        self.max_retained_bundles = max_retained_bundles
        self._bundles: Deque[_FlushBundle] = deque()
        # per-field result download counts (fused path): the lazy-bundle
        # regression ledger — a HITL-off run must show zero fog_features /
        # fog_scores downloads here
        self.field_downloads: Dict[str, int] = {}
        # --- tenancy (tenancy.py) ------------------------------------------
        # cost_model: per-tenant monetary metering.  Pure accounting — it
        # never moves an event time, so attaching one leaves the schedule
        # bitwise-identical.  fog_queueing (opt-in) folds a stream's real
        # fog-executor queueing delay into its reported latency instead of
        # the pre-tenancy instantaneous-accounting convention.  hitl_cost_s
        # prices HITL collect work on the fog node's *background* lane
        # (Executor priority="background"), where it can never head-of-line
        # block the stream's own serving work.
        self.cost_model = cost_model
        if cost_model is not None:
            self.router.cost_model = cost_model
            cost_model.observe_pool(0.0, self.router.healthy_count())
        self.fog_queueing = fog_queueing
        self.hitl_cost_s = hitl_cost_s
        # --- warm-pool management plane (autoscaler.WarmPoolPolicy) --------
        # every arrival feeds the policy's per-tenant forecasters; the
        # policy schedules "warm" check events (shed after a burst drains,
        # prewarm ahead of the next predicted burst) so cold starts land
        # off the critical path.  None, or an attached-but-disabled policy,
        # schedules nothing — the event timeline stays bitwise-identical
        # to the policy-free scheduler (bench_coldstart gates this at 1
        # and K shards).  Sharded runs share ONE policy instance (like the
        # router); warm_stats is per-shard and sums in the merged report.
        self.warm_pool = warm_pool
        self.warm_stats = {"prewarm_events": 0, "replicas_prewarmed": 0,
                           "shed_events": 0, "spinup_replica_s": 0.0}
        # custom-pipeline dispatch ledger, kept apart from hot_path_stats so
        # tenant flushes never skew host-syncs-per-flush style ratios
        self.tenant_stats = {"flushes": 0, "chunks": 0, "frames": 0}

    # ------------------------------------------------------------------
    def add_stream(self, name: str, *, W, learner=None, annotator=None,
                   slo: Optional[float] = None,
                   weight: float = 1.0, tenant=None) -> StreamState:
        fog_exec = Executor(f"fog-{name}", self.graph.registry,
                            self.graph.protocol.fog)
        lo, hi = self.margin_bounds
        att0 = 1.0 - (min(max(self.slo_margin, lo), hi) - lo) / max(hi - lo,
                                                                    1e-9)
        st = StreamState(name=name, W=to_host(W), fog_exec=fog_exec,
                         learner=learner, device=self.device,
                         annotator=annotator or OracleAnnotator(),
                         slo=slo, weight=weight, tenant=tenant,
                         slo_margin=self.slo_margin, att_ewma=att0)
        self.streams[name] = st
        if self.cost_model is not None and tenant is not None:
            self.cost_model.register(tenant)
        return st

    def _tenant_name(self, stream: StreamState) -> str:
        return stream.tenant.name if stream.tenant is not None else "default"

    def submit(self, stream: StreamState, chunk, *, learn: bool = True
               ) -> None:
        stream.pending.append((chunk, learn))
        self._pull_next(stream)

    def _pull_next(self, stream: StreamState) -> None:
        if stream.busy or not stream.pending:
            return
        chunk, learn = stream.pending.popleft()
        stream.busy = True
        # sharded mode: the next ingest belongs on the owner shard's event
        # loop even when this finalize ran on a stealing shard
        owner = stream.owner if stream.owner is not None else self
        owner._push(stream.clock, "ingest",
                    dict(stream=stream, chunk=chunk, learn=learn))

    def _push(self, t: float, action: str, data: dict) -> None:
        heapq.heappush(self._events, (t, next(self._seq), action, data))

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self._events) or len(self.batcher) > 0

    def _peek_key(self) -> Optional[Tuple[float, int]]:
        """(t, seq) of this scheduler's next event, or None when idle.

        The stranded-request safety net (requests queued but no event —
        guards any residual deadline arithmetic slip) surfaces as a
        max-seq key at the batcher's deadline, so a merged multi-shard
        loop orders it after every real event at that time."""
        if self._events:
            ev = self._events[0]
            return (ev[0], ev[1])
        if len(self.batcher):
            nd = self.batcher.next_deadline()
            return (nd if nd is not None else 0.0, sys.maxsize)
        return None

    def step(self) -> bool:
        """Process ONE event (or the safety net); False when fully idle.

        ``run_until_idle`` is ``while step()`` — the ShardedScheduler
        interleaves steps of K of these loops on a merged timeline."""
        if not self._events:
            if not len(self.batcher):
                return False
            w0 = time.perf_counter()
            # safety net: no event left but requests still queued — a
            # stranded request must never be silently dropped
            t = self.batcher.next_deadline()
            self._run_batch(t, self.batcher.take(t))
            self.sched_stats["events"] += 1
            self.sched_stats["step_wall_s"] += time.perf_counter() - w0
            return True
        w0 = time.perf_counter()
        t, _, action, data = heapq.heappop(self._events)
        if action == "ingest":
            self._ingest(t, **data)
        elif action == "arrive":
            self._arrive(t, **data)
        elif action == "flush":
            self._flush(t)
        elif action == "probe":
            self._probe(t, **data)
        elif action == "warm":
            self._warm_check(t)
        else:
            self._finalize(t, data)
        self.sched_stats["events"] += 1
        self.sched_stats["step_wall_s"] += time.perf_counter() - w0
        return True

    def run_until_idle(self) -> None:
        """Drain the event queue (all submitted chunks reach finalize)."""
        while self.step():
            pass

    def drain(self) -> None:
        """Run to idle and assert the claim-check plane leaked nothing.

        Every terminal path — normal dispatch, replica-failure requeue,
        fog fallback, tenant pipelines — must have released its claims by
        the time the event loop empties; a nonzero refcount here is a
        leak, not a pending consumer."""
        self.run_until_idle()
        if self.store is not None:
            leaked = self.store.live_refs()
            if leaked:
                raise AssertionError(
                    f"claim-check leak: {len(leaked)} artifact(s) still "
                    f"referenced at drain: {leaked}")

    # ------------------------------------------------------------------
    def _ingest(self, t: float, stream: StreamState, chunk,
                learn: bool) -> None:
        mode = "cloud"
        if self.fault is not None:
            mode = self.fault.heartbeat(t)
        if mode != "cloud":
            res = self.fallback_fn(chunk.frames)
            self._push(t + res.latency.total, "finalize",
                       dict(stream=stream, chunk=chunk, res=res, mode=mode,
                            learn=learn, t0=t))
            return

        proto = self.graph.protocol
        f = chunk.frames.shape[0]
        qc = proto.fog.encode_time(f)
        enc, _ = stream.fog_exec.run(STAGE_ENCODE, chunk.frames, now=t,
                                     model_time=qc)
        self._push(t, "arrive", dict(stream=stream, chunk=chunk,
                                     learn=learn, enc=enc, qc=qc))

    def _arrive(self, t: float, stream: StreamState, chunk, learn: bool,
                enc, qc: float) -> None:
        """Arrival bookkeeping, split from ingest by a same-sim-time event:
        when several streams ingest in one burst (start-up, post-flush),
        every encode dispatches to the device *before* the first byte-count
        read blocks on one of them, so the host's nbytes reads overlap the
        other chunks' in-flight encodes instead of serializing them.  Same
        simulated times and ordering (same-time events pop in push order);
        ``float(enc.nbytes)`` stays the one unavoidable ingest-side read."""
        wan_bytes = float(enc.nbytes)
        wan_up = self.network.wan_time(wan_bytes, t=t)
        arrival = t + qc + wan_up
        frames = (enc.frames if self.hot_path == "fused"
                  else to_host(enc.frames))
        if self.store is not None:
            # claim-check publish: the encoded frames enter the artifact
            # store once (content-addressed — a pooled chunk re-published
            # by any stream dedups to one payload) and the batcher queue
            # entry carries only the reference; _dispatch resolves it at
            # flush-assembly time and releases the claim after dispatch
            frames = self.store.put(frames, key=self._artifact_key(chunk),
                                    now=t)
        req = DetectRequest(
            frames=frames, arrival=arrival, stream=stream,
            weight=stream.weight,
            meta=dict(chunk=chunk, learn=learn, t0=t, qc=qc, wan_up=wan_up,
                      wan_bytes=wan_bytes))
        if stream.slo is not None and self.deadline_batching:
            req.deadline = (t + stream.slo * (1.0 - stream.slo_margin)
                            - self._downstream_est)
        self.batcher.submit(req)
        self._push(arrival, "flush", {})
        nd = self.batcher.next_deadline()
        if nd is not None and nd > arrival + 1e-12:
            self._push(nd, "flush", {})
        if self.warm_pool is not None:
            # feed the per-tenant arrival forecaster and (when the policy
            # is enabled) keep a warm-pool check event scheduled; a
            # disabled policy observes but never schedules, leaving the
            # event timeline untouched
            self.warm_pool.observe(t, chunk.frames.shape[0],
                                   self._tenant_name(stream))
            self._schedule_warm_check(t)

    def _artifact_key(self, chunk) -> str:
        """Content address of a chunk's encoded payload.

        Digest of the *source* HQ host bytes plus the encode parameters
        (hashing the encoded device array would cost a device->host sync).
        Encoding is deterministic, so equal keys imply bitwise-equal
        payloads and dedup is safe.  Memoized on the chunk object; the
        cached key is salt-checked so one chunk shared across schedulers
        with different encode configs never aliases."""
        pcfg = self.graph.protocol.pcfg
        salt = (f"{pcfg.r_low}:{pcfg.q_low}:{int(pcfg.inter_coding)}:"
                f"{self.hot_path}")
        cached = getattr(chunk, "_artifact_key", None)
        if cached is not None and cached[0] == salt:
            return cached[1]
        key = content_key(np.asarray(chunk.frames), salt)
        try:
            chunk._artifact_key = (salt, key)
        except (AttributeError, TypeError):
            pass                        # unmemoizable chunk type: rehash
        return key

    def _flush(self, t: float) -> None:
        while self.batcher.ready(t):
            self._run_batch(t, self.batcher.take(t))
        if len(self.batcher):
            # deadline-driven flushes move earlier as the queue grows (the
            # estimated service time rises); keep an event at the horizon
            nd = self.batcher.next_deadline()
            if nd is not None and nd > t + 1e-12:
                self._push(nd, "flush", {})

    # ------------------------------------------------------------------
    def _run_batch(self, t: float, reqs: List[DetectRequest]) -> None:
        """Shard one flush across healthy replicas and dispatch each shard.

        With one replica (or one request) the flush runs as a single batch —
        the bit-identical single-stream path.  With R healthy replicas the
        chunks are partitioned into ≤R frame-balanced sub-batches, each
        routed to its own replica, so they run concurrently on the
        simulated clock (the cloud ML server's load-balanced replica pool)."""
        if not reqs:
            return
        if any(r.stream.tenant is not None
               and r.stream.tenant.pipeline is not None for r in reqs):
            # multi-tenant flush: the batcher already decided cross-tenant
            # WFQ order, so partitioning by pipeline here preserves each
            # tenant's fair share; custom pipelines dispatch through their
            # own cloud/fog stages on the SAME replica pool + fog executors
            default_reqs: List[DetectRequest] = []
            by_pipe: Dict[str, Tuple[Any, List[DetectRequest]]] = {}
            for r in reqs:
                pipe = (r.stream.tenant.pipeline
                        if r.stream.tenant is not None else None)
                if pipe is None:
                    default_reqs.append(r)
                else:
                    by_pipe.setdefault(pipe.name, (pipe, []))[1].append(r)
            pipe_groups = list(by_pipe.values())
            for gi, (pipe, group) in enumerate(pipe_groups):
                try:
                    self._dispatch_tenant(t, group, pipe)
                except Exception:
                    self._release_claims(
                        [r for _, g in pipe_groups[gi + 1:] for r in g]
                        + default_reqs, t)
                    raise
            reqs = default_reqs
            if not reqs:
                return
        k = min(self.router.healthy_count(), len(reqs))
        if k <= 1:
            groups = [reqs]
        else:
            groups = [[] for _ in range(k)]
            loads = [0] * k
            for r in reqs:            # greedy, preserves WFQ order in-group
                j = min(range(k), key=lambda i: (loads[i], i))
                groups[j].append(r)
                loads[j] += r.frames.shape[0]
        for gi, g in enumerate(groups):
            try:
                self._dispatch(t, g)
            except Exception:
                # terminal abort: sibling sub-batches of this flush were
                # already popped from the batcher, so their claims die
                # with it (drain() asserts refcounts return to zero)
                self._release_claims([r for g2 in groups[gi + 1:]
                                      for r in g2], t)
                raise

    def _release_claims(self, reqs: List[DetectRequest], t: float) -> None:
        if self.store is None:
            return
        for r in reqs:
            if isinstance(r.frames, ClaimCheck):
                self.store.release(r.frames, now=t)

    def _fallback_batch(self, t: float, reqs: List[DetectRequest]) -> None:
        """No healthy replica survives: run each chunk on the fog detector."""
        if self.fallback_fn is None:
            # terminal path: the flush dies here, so its claims must not
            # outlive it (drain() asserts refcounts return to zero)
            if self.store is not None:
                for req in reqs:
                    if isinstance(req.frames, ClaimCheck):
                        self.store.release(req.frames, now=t)
            raise RuntimeError("no healthy replicas and no fog fallback")
        for req in reqs:
            if self.store is not None and isinstance(req.frames, ClaimCheck):
                self.store.release(req.frames, now=t)
            chunk = req.meta["chunk"]
            res = self.fallback_fn(chunk.frames)
            self._push(t + res.latency.total, "finalize",
                       dict(stream=req.stream, chunk=chunk, res=res,
                            mode="fog-fallback", learn=req.meta["learn"],
                            t0=req.meta["t0"]))

    def _dispatch(self, t: float, reqs: List[DetectRequest]) -> None:
        proto = self.graph.protocol
        m0 = time.perf_counter()
        # artifact-corruption faults fire at flush assembly: flip stored
        # payload bytes now, so the integrity-checked resolve below detects
        # and repairs every one of them before it can reach the detector
        if self.store is not None and self.fault is not None:
            due_fn = getattr(self.fault, "due_corruptions", None)
            if due_fn is not None:
                keys, seen = [], set()
                for r in reqs:
                    if (isinstance(r.frames, ClaimCheck)
                            and r.frames.key not in seen):
                        seen.add(r.frames.key)
                        keys.append(r.frames.key)
                for i in range(due_fn(t, len(keys))):
                    self.store.corrupt(keys[i])
        # pick a replica; health-check it against the fault schedule first
        # (the schedule is keyed by the replica's stable uid, not its pool
        # position — positions shift when the autoscaler resizes the pool)
        while True:
            idx = self.router.pick()
            if idx is None:
                self._fallback_batch(t, reqs)
                return
            uid = self.router.replicas[idx].uid
            if self.fault is not None and self.fault.replica_down(uid, t):
                self.router.mark_unhealthy(idx, now=t)
                self.fault.note_replica_failure(uid, t, requeued=0)
                self._schedule_probe(uid, t)
                continue
            break
        fused = self.hot_path == "fused"
        # claim-check resolve: flush assembly is the ONE place payloads are
        # pulled from the store.  A single-request flush passes the stored
        # array object straight through pack_frames_device, preserving the
        # zero-copy identity shortcut.
        if self.store is not None:
            payloads = [self._resolve_payload(r, t) for r in reqs]
        else:
            payloads = [r.frames for r in reqs]
        if fused:
            batch, slices, pad = pack_frames_device(
                payloads, buckets=self.batcher.pad_buckets)
        else:
            batch, slices, pad = pack_frames(
                [to_host(p) for p in payloads],
                buckets=self.batcher.pad_buckets)
        n_frames = batch.shape[0]
        svc = proto.cloud.detect_time(n_frames)
        rep = self.router.replicas[idx]
        est_start = max(t, min(rep.executor.busy_until))
        if self.fault is not None:
            # straggler windows stretch the true service time; flap/death
            # windows interrupt it.  Both are keyed on where the service
            # actually sits on the replica's device horizon, not on `t`.
            mult = self.fault.service_multiplier(uid, est_start)
            svc_eff = svc * mult if mult != 1.0 else svc
            fail_t = self.fault.fail_time_in(uid, est_start,
                                             est_start + svc_eff)
        else:
            svc_eff, fail_t = svc, None
        if fail_t is not None:
            # the replica dies (or flaps out) while this sub-batch is in
            # service: its work is lost, the outage is detected at the
            # failure time, and the chunks re-queue to surviving replicas
            # (arrival and fair-queueing position preserved — nothing is
            # dropped).  Their claims were not released, so the re-flush
            # resolves the same stored payloads again.  A transient flap
            # additionally starts a health-probe chain so the replica
            # re-admits once its window closes.
            self.router.mark_unhealthy(idx, now=fail_t)
            self.fault.note_replica_failure(uid, fail_t,
                                            requeued=len(reqs))
            self.chaos_stats["requeues"] += len(reqs)
            self._schedule_probe(uid, fail_t)
            for r in reqs:
                r.not_before = fail_t
                r.retries += 1
                self.batcher.submit(r)
            self._push(fail_t, "flush", {})
            return
        if self.store is not None:
            # dispatch is committed: the batch owns the frame data now, so
            # the claims drop and idle payloads age toward TTL eviction
            for r in reqs:
                self.store.release(r.frames, now=t)
            self.store.sweep(t)
        # real queue depth (frames still waiting / in flight to the cloud)
        queue_depth = self.batcher.pending_frames
        if self.cost_model is not None:
            self.cost_model.observe_pool(t, self.router.healthy_count())
        # per-dispatch timeout = the flush's SLO slack (tightest pending
        # detect deadline), and the hedge decision: a primary whose
        # service-rate EWMA says this sub-batch will both straggle (beyond
        # the slack threshold) and miss that deadline gets a speculative
        # duplicate on the best alternate replica, first-result-wins
        deadline = min((r.deadline for r in reqs if r.deadline is not None),
                       default=None)
        timeout = max(0.0, deadline - t) if deadline is not None else None
        hedge = None
        if (self.hedging and self.fault is not None
                and deadline is not None and rep.rate_ewma is not None):
            est_svc = rep.rate_ewma * n_frames
            if (est_svc > svc * (1.0 + self.hedge_slack)
                    and est_start + est_svc > deadline):
                hedge = self._pick_hedge(t, idx, svc, n_frames,
                                         est_start + est_svc)
        self.hot_path_stats["flushes"] += 1
        if fused:
            self._dispatch_fused(t, reqs, slices, pad, batch, svc_eff, idx,
                                 queue_depth, timeout, hedge)
        else:
            self._dispatch_sync(t, reqs, slices, pad, batch, svc_eff, idx,
                                queue_depth, timeout, hedge)
        # observed per-frame service rate feeds the next hedge decision;
        # one-dispatch lag is the realistic detector dynamic (a straggler
        # is spotted by its first slow completion, then hedged around)
        obs = svc_eff / max(n_frames, 1)
        rep.rate_ewma = (obs if rep.rate_ewma is None
                         else 0.5 * rep.rate_ewma + 0.5 * obs)
        self.sched_stats["model_wall_s"] += time.perf_counter() - m0

    def _resolve_payload(self, req: DetectRequest, t: float):
        """Resolve one request's claim; repair a corrupted payload.

        The store's content hash catches flipped bytes at flush assembly;
        encoding is deterministic, so re-deriving from the source chunk
        reconstructs the original payload bitwise (a forced re-put) and
        the flush proceeds with zero garbage served.  The repair costs no
        simulated time: it models the fog tier re-sending a chunk that is
        still in its local buffer, which is dwarfed by the detect service
        time already on the clock."""
        try:
            return self.store.get(req.frames)
        except ArtifactCorrupted:
            enc = self.graph._encode(req.meta["chunk"].frames)
            fresh = (enc.frames if self.hot_path == "fused"
                     else to_host(enc.frames))
            self.store.repair(req.frames.key, fresh)
            self.chaos_stats["corruptions_repaired"] += 1
            self.monitor.log_event("artifact_repair", t=t,
                                   key=req.frames.key)
            return self.store.get(req.frames)

    def _pick_hedge(self, t: float, primary: int, svc: float,
                    n_frames: int, primary_est_done: float
                    ) -> Optional[Tuple[int, float]]:
        """Best alternate replica for a speculative duplicate, or None.

        Deterministic: candidates are scored by estimated completion
        (service-rate EWMA; nominal when unobserved) with uid as the
        tie-break, and a candidate must beat the primary's estimate —
        hedging onto an equally-slow pool only burns device time.
        Replicas the fault schedule marks down, known-straggling, or
        dying mid-hedge are skipped (the hedge must *cover* the fault,
        not re-roll it).  Returns ``(pool_index, true_service_time)``."""
        best = None
        for i, r in enumerate(self.router.replicas):
            if i == primary or not r.healthy:
                continue
            uid = r.uid
            if self.fault.replica_down(uid, t):
                continue
            start = max(t, min(r.executor.busy_until))
            mult = self.fault.service_multiplier(uid, start)
            h_svc = svc * mult if mult != 1.0 else svc
            if self.fault.fail_time_in(uid, start, start + h_svc) is not None:
                continue
            est_rate = (r.rate_ewma if r.rate_ewma is not None
                        else svc / max(n_frames, 1))
            if est_rate * n_frames > svc * (1.0 + self.hedge_slack):
                continue                     # known straggler itself
            est_done = start + est_rate * n_frames
            if est_done >= primary_est_done - 1e-12:
                continue                     # no expected win
            if best is None or (est_done, uid) < best[:2]:
                best = (est_done, uid, i, h_svc)
        return None if best is None else (best[2], best[3])

    def _route_detect(self, stage: str, args: tuple, *, t: float,
                      svc: float, idx: int, queue_depth: int,
                      timeout: Optional[float], hedge):
        """Route the detect stage, optionally covered by a hedge.

        The hedge duplicate books real device time on the alternate
        replica (``Router.hedge``) but never re-runs the detector — the
        primary's result is reused bitwise, only the completion-time race
        differs.  The primary wins exact ties, so hedging can only move a
        completion *earlier*.  Returns ``(out, done, svc_winner,
        hedge_billed_svc_or_None)``."""
        out, done, _ = self.router.route(stage, *args, now=t,
                                         model_time=svc,
                                         queue_depth=queue_depth,
                                         replica=idx, timeout=timeout)
        self._detect_windows.append((done - svc, svc))
        h_billed = None
        if hedge is not None:
            h_idx, h_svc = hedge
            h_start, h_done = self.router.hedge(h_idx, now=t,
                                                model_time=h_svc)
            self._detect_windows.append((h_start, h_svc))
            self.chaos_stats["hedges"] += 1
            self.chaos_stats["hedge_busy_s"] += h_svc
            h_billed = h_svc
            self.monitor.log_event("hedge", t=t, primary=idx,
                                   alternate=h_idx, svc=svc,
                                   hedge_svc=h_svc)
            if h_done < done - 1e-12:
                done, svc = h_done, h_svc
                self.chaos_stats["hedge_wins"] += 1
        return out, done, svc, h_billed

    def _schedule_probe(self, uid: int, t: float) -> None:
        """Start a health-probe chain for a transiently-down replica."""
        if self.fault is None or uid in self._probing:
            return
        trans = getattr(self.fault, "transient", None)
        if trans is None or not trans(uid, t):
            return                    # permanent death: probing is wasted
        self._probing.add(uid)
        self._push(t + self.probe_base, "probe",
                   dict(uid=uid, interval=self.probe_base))

    def _probe(self, t: float, uid: int, interval: float) -> None:
        """One health probe: re-admit the replica or back off and retry.

        Backoff doubles up to ``probe_max`` so a long flap costs O(log)
        probe events, not a busy-wait.  In sharded runs several shards may
        run chains for the same uid; ``Router.readmit`` is idempotent and
        the healthy check below retires duplicate chains, so the replica
        re-admits exactly once."""
        self.chaos_stats["probes"] += 1
        idx = next((i for i, r in enumerate(self.router.replicas)
                    if r.uid == uid), None)
        if idx is None or self.router.replicas[idx].healthy:
            self._probing.discard(uid)      # retired, or another shard won
            return
        if self.fault is not None and self.fault.replica_down(uid, t):
            nxt = min(interval * 2.0, self.probe_max)
            self._push(t + nxt, "probe", dict(uid=uid, interval=nxt))
            return
        self._probing.discard(uid)
        if self.router.readmit(idx, now=t):
            self.chaos_stats["readmits"] += 1
            self.monitor.log_event("replica_readmit", t=t, replica=uid)
        if len(self.batcher):
            # backlog that piled up behind the outage flushes immediately
            self._push(t, "flush", {})

    # -- warm-pool plane ------------------------------------------------
    def _schedule_warm_check(self, now: float) -> None:
        """Ask the warm-pool policy when it next wants to act and book a
        ``warm`` event there.  The policy deduplicates (at most one
        outstanding check, bounded fires per observation epoch), so the
        chain self-terminates once traffic stops and ``run_until_idle``
        always drains."""
        pol = self.warm_pool
        if pol is None or not pol.enabled:
            return
        ft = pol.next_check(now)
        if ft is not None:
            self._push(ft, "warm", {})

    def _warm_check(self, t: float) -> None:
        """One warm-pool actuation: prewarm ahead of a forecast burst or
        shed idle keep-alive replicas past the break-even horizon.  Runs
        off the data path — the spin-up happens *before* the burst lands,
        which is the whole point."""
        pol = self.warm_pool
        pol.fired()
        target = pol.target_replicas(t)
        cur = self.router.healthy_count()
        if target > cur:
            self.router.scale_replicas(target, now=t, prewarm=True)
            added = self.router.healthy_count() - cur
            if added > 0:
                self.warm_stats["prewarm_events"] += 1
                self.warm_stats["replicas_prewarmed"] += added
                self.warm_stats["spinup_replica_s"] += (
                    added * self.router.cold_start_s)
                if self.cost_model is not None:
                    self.cost_model.note_prewarm(
                        t, added, self.router.cold_start_s)
        elif target < cur:
            self.router.scale_replicas(target, now=t)
            if self.router.healthy_count() < cur:
                self.warm_stats["shed_events"] += 1
        self._schedule_warm_check(t)

    def _dispatch_sync(self, t: float, reqs: List[DetectRequest], slices,
                       pad: int, batch, svc: float, idx: int,
                       queue_depth: int, timeout: Optional[float] = None,
                       hedge=None) -> None:
        """Pre-fusion baseline: blocking detect, one ``split_uncertain``
        call plus two scalar device syncs per chunk, full-budget
        classify, immediate result materialization."""
        proto = self.graph.protocol
        n_frames = batch.shape[0]
        w0 = time.perf_counter()
        det, done, svc_w, h_billed = self._route_detect(
            STAGE_DETECT, (torch.as_tensor(batch, device=self.device),),
            t=t, svc=svc, idx=idx, queue_depth=queue_depth, timeout=timeout,
            hedge=hedge)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.hot_path_stats["host_syncs"] += 1
        self.detect_stats["calls"] += 1
        self.detect_stats["frames"] += n_frames - pad
        self.detect_stats["padded_frames"] += pad
        self.detect_stats["wall_s"] += time.perf_counter() - w0
        start = done - svc_w

        for req, sl in zip(reqs, slices):
            det_i = {k: v[sl] for k, v in det.items()}
            pcfg_req = proto.pcfg
            if (req.stream.theta_cls is not None
                    or req.stream.theta_loc is not None):
                # per-site thresholds: a frozen-config replace stays
                # hashable, so the handful of distinct per-site configs
                # each compile split_uncertain once
                pcfg_req = dataclasses.replace(
                    pcfg_req,
                    theta_cls=(req.stream.theta_cls
                               if req.stream.theta_cls is not None
                               else pcfg_req.theta_cls),
                    theta_loc=(req.stream.theta_loc
                               if req.stream.theta_loc is not None
                               else pcfg_req.theta_loc))
            split, coord_bytes = protocol_mod.split_uncertain(pcfg_req,
                                                              det_i)
            wan_down = self.network.wan_time(float(coord_bytes), t=done)
            n_crops = int(to_host(split.prop_valid).sum())
            self.hot_path_stats["host_syncs"] += 2   # the two scalar reads
            clf_time = proto.fog.classify_time(max(n_crops, 1))
            obs = wan_down + clf_time
            self._downstream_est = (obs if obs > self._downstream_est
                                    else 0.9 * self._downstream_est
                                    + 0.1 * obs)
            stream = req.stream
            chunk = req.meta["chunk"]
            self.hot_path_stats["crops_classified"] += split.prop_valid.numel()
            self.hot_path_stats["crops_budget"] += split.prop_valid.numel()
            if stream.ensemble is not None:
                snaps_dev, omega_dev = stream.ensemble_device()
                merged, done_c = stream.fog_exec.run(
                    STAGE_CLASSIFY_ENS,
                    torch.as_tensor(chunk.frames, device=self.device), split,
                    snaps_dev, omega_dev, now=done + wan_down,
                    model_time=clf_time)
            else:
                merged, done_c = stream.fog_exec.run(
                    STAGE_CLASSIFY,
                    torch.as_tensor(chunk.frames, device=self.device), split,
                    torch.as_tensor(stream.W, device=self.device),
                    now=done + wan_down,
                    model_time=clf_time)
            # fog_queueing: the wait for the stream's fog device (busy with
            # an earlier chunk) joins the reported latency; default keeps
            # the pre-tenancy instantaneous-accounting convention
            fog_wait = (max(0.0, done_c - clf_time - (done + wan_down))
                        if self.fog_queueing else 0.0)
            if self.cost_model is not None:
                f = req.frames.shape[0]
                tname = self._tenant_name(stream)
                self.cost_model.charge_cloud(
                    tname, frames=f, invocations=f,
                    busy_s=svc * f / max(n_frames - pad, 1), t=t)
                if h_billed is not None:
                    # a hedge is a real invocation: its duplicate device
                    # time lands in the tenant's ledger either way the
                    # race resolves
                    self.cost_model.charge_hedge(
                        tname, invocations=f,
                        busy_s=h_billed * f / max(n_frames - pad, 1), t=t)
                self.cost_model.charge_fog(tname, clf_time, t)
            lat = LatencyBreakdown(
                quality_control=req.meta["qc"],
                transmission=req.meta["wan_up"] + wan_down,
                cloud_inference=svc_w,
                fog_inference=clf_time,
                queue_wait=max(0.0, start - req.arrival) + fog_wait)
            res = protocol_mod.assemble_result(
                split, merged, wan_bytes=req.meta["wan_bytes"],
                coord_bytes=float(coord_bytes),
                cloud_frames=req.frames.shape[0], latency=lat)
            self.hot_path_stats["host_syncs"] += 1   # eager materialization
            self._push(req.meta["t0"] + lat.total, "finalize",
                       dict(stream=stream, chunk=chunk, res=res,
                            mode="cloud", learn=req.meta["learn"],
                            t0=req.meta["t0"]))

    def _dispatch_fused(self, t: float, reqs: List[DetectRequest], slices,
                        pad: int, batch, svc: float, idx: int,
                        queue_depth: int, timeout: Optional[float] = None,
                        hedge=None) -> None:
        """Device-resident hot path: one fused detect+split dispatch, ONE
        blocking host read (the validity mask) per flush, one compacted
        cross-stream classify dispatch, and per-chunk results left as
        device futures drained at their finalize events."""
        proto = self.graph.protocol
        n_frames = batch.shape[0]
        w0 = time.perf_counter()
        dyn = any(r.stream.theta_cls is not None
                  or r.stream.theta_loc is not None for r in reqs)
        if dyn:
            # per-site thresholds in play: per-frame theta vectors ride
            # into the dynamic fused stage as traced args (thetas only
            # enter elementwise comparisons, so tracing them is exact);
            # detector pad rows keep the global defaults
            tc = np.full(n_frames, proto.pcfg.theta_cls, np.float32)
            tl = np.full(n_frames, proto.pcfg.theta_loc, np.float32)
            for r, sl in zip(reqs, slices):
                if r.stream.theta_cls is not None:
                    tc[sl] = r.stream.theta_cls
                if r.stream.theta_loc is not None:
                    tl[sl] = r.stream.theta_loc
            split, done, svc_w, h_billed = self._route_detect(
                STAGE_DETECT_SPLIT_DYN,
                (batch, torch.as_tensor(tc, device=self.device),
                 torch.as_tensor(tl, device=self.device)), t=t, svc=svc,
                idx=idx, queue_depth=queue_depth, timeout=timeout,
                hedge=hedge)
        else:
            # donate the packed batch only when it is the dispatch-owned
            # multi-request concat; a single-request flush passes the
            # encode-output / store-held array through untouched
            stage = (STAGE_DETECT_SPLIT_DON
                     if self.donate_detect and len(reqs) > 1
                     else STAGE_DETECT_SPLIT)
            split, done, svc_w, h_billed = self._route_detect(
                stage, (batch,), t=t, svc=svc, idx=idx,
                queue_depth=queue_depth, timeout=timeout, hedge=hedge)
        # THE flush's single blocking device->host read: per-chunk coord
        # bytes, crop counts, and the compaction gather plan are all
        # derived from this one (F, N) bool mask on the host
        pv = to_host(split.prop_valid)
        self.hot_path_stats["host_syncs"] += 1
        self.detect_stats["calls"] += 1
        self.detect_stats["frames"] += n_frames - pad
        self.detect_stats["padded_frames"] += pad
        self.detect_stats["wall_s"] += time.perf_counter() - w0
        start = done - svc_w

        # detector padding rows carry no chunk: drop them before building
        # the gather plan (a zero-frame can still excite a random detector)
        f_real = n_frames - pad
        pv = pv[:f_real]
        counts = pv.sum(axis=1)
        split_real = (reg.RegionSplit(*(v[:f_real] for v in split))
                      if pad else split)
        fidx, ridx, n_valid, bucket = reg.compaction_indices(
            pv, self.crop_buckets)
        self.hot_path_stats["crops_classified"] += bucket
        self.hot_path_stats["crops_budget"] += int(pv.size)

        # pack the cached HQ frames: host-side video sources, so concat on
        # the host and pay ONE upload per flush (not one device_put per
        # chunk), and stack the distinct per-stream readouts
        if len(reqs) == 1:
            hq_batch = torch.as_tensor(reqs[0].meta["chunk"].frames,
                                       device=self.device)
        else:
            hq_batch = torch.as_tensor(np.concatenate(
                [np.asarray(r.meta["chunk"].frames) for r in reqs], axis=0),
                device=self.device)
        w_group: Dict[int, int] = {}
        group_streams: List[StreamState] = []
        req_w = np.empty(len(reqs), np.int32)
        frame_req = np.empty(f_real, np.int32)
        use_ens = any(r.stream.snaps is not None for r in reqs)
        for qi, (r, sl) in enumerate(zip(reqs, slices)):
            key = (id(r.stream.snaps) if r.stream.snaps is not None
                   else id(r.stream.W))
            if key not in w_group:
                w_group[key] = len(group_streams)
                group_streams.append(r.stream)
            req_w[qi] = w_group[key]
            frame_req[sl] = qi
        # one (3, B) index upload: (fidx, ridx, widx) rows
        idxs = np.zeros((3, bucket), np.int32)
        idxs[0] = fidx
        idxs[1] = ridx
        if n_valid:
            idxs[2, :n_valid] = req_w[frame_req[fidx[:n_valid]]]

        clf_time = proto.fog.classify_time(max(n_valid, 1))
        if use_ens:
            # Eq. 9 ensemble serving: widx picks a per-stream snapshot
            # lineage; plain single-readout streams ride along as the
            # zero-padded degenerate lineage [W] / omega=[1.0] (bitwise-
            # identical scores, see classify_compacted_ensemble)
            snaps_dev, omegas_dev = self._ensemble_stack(group_streams)
            self.hot_path_stats["ensemble_flushes"] += 1
            merged, _ = self.fog_batch_exec.run(
                STAGE_CLASSIFY_ENS_BATCH, hq_batch, split_real, snaps_dev,
                omegas_dev, torch.as_tensor(idxs, device=self.device),
                now=done,
                model_time=clf_time)
        else:
            ws_list = [s.W_device() for s in group_streams]
            Ws = (ws_list[0][None] if len(ws_list) == 1
                  else torch.stack(ws_list))
            merged, _ = self.fog_batch_exec.run(
                STAGE_CLASSIFY_BATCH, hq_batch, split_real, Ws,
                torch.as_tensor(idxs, device=self.device), now=done,
                model_time=clf_time)

        # the whole flush's results travel as ONE device-side bundle whose
        # fields materialize lazily: a consumer's first touch of a field
        # downloads that buffer once for the whole flush and every chunk
        # slices numpy views — fields nothing reads are never downloaded
        bundle = _FlushBundle(split_real, merged, self.hot_path_stats,
                              self.field_downloads)
        bundle.pending = len(reqs)
        self._bundles.append(bundle)
        hps = self.hot_path_stats
        hps["bundle_bytes"] += bundle.device_bytes
        hps["bundle_bytes_peak"] = max(hps["bundle_bytes_peak"],
                                       hps["bundle_bytes"])
        hps["bundles_retained_peak"] = max(hps["bundles_retained_peak"],
                                           len(self._bundles))
        # residency time series (sim clock): the steady-state bench asserts
        # this stays flat under bounded retention
        self.monitor.record("bundle_bytes", float(hps["bundle_bytes"]), t)
        for req, sl in zip(reqs, slices):
            n_crops = int(counts[sl].sum())
            coord_bytes = 9.0 * n_crops
            wan_down = self.network.wan_time(coord_bytes, t=done)
            clf_time = proto.fog.classify_time(max(n_crops, 1))
            obs = wan_down + clf_time
            self._downstream_est = (obs if obs > self._downstream_est
                                    else 0.9 * self._downstream_est
                                    + 0.1 * obs)
            stream = req.stream
            chunk = req.meta["chunk"]
            # the stream's share of the batched classify: pure accounting
            # on its own fog node's clock (the compute already ran batched)
            _, done_c = stream.fog_exec.run(STAGE_CLASSIFY_VIEW, sl,
                                            now=done + wan_down,
                                            model_time=clf_time)
            fog_wait = (max(0.0, done_c - clf_time - (done + wan_down))
                        if self.fog_queueing else 0.0)
            if self.cost_model is not None:
                f = req.frames.shape[0]
                tname = self._tenant_name(stream)
                self.cost_model.charge_cloud(
                    tname, frames=f, invocations=f,
                    busy_s=svc * f / max(f_real, 1), t=t)
                if h_billed is not None:
                    # a hedge is a real invocation: its duplicate device
                    # time lands in the tenant's ledger either way the
                    # race resolves
                    self.cost_model.charge_hedge(
                        tname, invocations=f,
                        busy_s=h_billed * f / max(f_real, 1), t=t)
                self.cost_model.charge_fog(tname, clf_time, t)
            lat = LatencyBreakdown(
                quality_control=req.meta["qc"],
                transmission=req.meta["wan_up"] + wan_down,
                cloud_inference=svc_w,
                fog_inference=clf_time,
                queue_wait=max(0.0, start - req.arrival) + fog_wait)
            res = LazyChunkResult(
                bundle, sl, wan_bytes=req.meta["wan_bytes"],
                coord_bytes=coord_bytes,
                cloud_frames=req.frames.shape[0], latency=lat)
            self._inflight.append(res)
            self.hot_path_stats["inflight_peak"] = max(
                self.hot_path_stats["inflight_peak"], len(self._inflight))
            self._push(req.meta["t0"] + lat.total, "finalize",
                       dict(stream=stream, chunk=chunk, res=res,
                            inflight=True, mode="cloud",
                            learn=req.meta["learn"], t0=req.meta["t0"]))

    def _dispatch_tenant(self, t: float, reqs: List[DetectRequest],
                         pipe) -> None:
        """Dispatch one tenant pipeline's share of a flush: a batched cloud
        stage through the shared replica pool, then each chunk's fog merge
        stage on its stream's own fog executor.

        Mirrors ``_dispatch``'s claim-check discipline (resolve at assembly,
        release at commit) and detect-window accounting, but keeps its
        counters in ``tenant_stats`` so the High-Low hot-path ratios stay
        clean.  Custom pipelines do not participate in the fault-schedule
        fallback (that path re-encodes for the fog *detector*, which a
        non-detection graph doesn't have)."""
        m0 = time.perf_counter()
        idx = self.router.pick()
        if idx is None:
            # terminal path (tenant pipelines have no fog fallback): the
            # claims must not outlive the flush that dies here
            if self.store is not None:
                for r in reqs:
                    if isinstance(r.frames, ClaimCheck):
                        self.store.release(r.frames, now=t)
            raise RuntimeError(
                f"no healthy replicas for tenant pipeline {pipe.name!r}")
        if self.store is not None:
            payloads = [self._resolve_payload(r, t) for r in reqs]
        else:
            payloads = [r.frames for r in reqs]
        batch, slices, pad = pack_frames_device(
            payloads, buckets=self.batcher.pad_buckets)
        if self.store is not None:
            for r in reqs:
                self.store.release(r.frames, now=t)
            self.store.sweep(t)
        n_frames = batch.shape[0]
        f_real = n_frames - pad
        svc = n_frames / pipe.cloud_fps
        queue_depth = self.batcher.pending_frames
        if self.cost_model is not None:
            self.cost_model.observe_pool(t, self.router.healthy_count())
        deadline = min((r.deadline for r in reqs if r.deadline is not None),
                       default=None)
        timeout = max(0.0, deadline - t) if deadline is not None else None
        out, done, _ = self.router.route(
            pipe.cloud_stage, batch, now=t, model_time=svc,
            queue_depth=queue_depth, replica=idx, timeout=timeout)
        start = done - svc
        self._detect_windows.append((start, svc))
        self.tenant_stats["flushes"] += 1
        self.tenant_stats["chunks"] += len(reqs)
        self.tenant_stats["frames"] += f_real

        for req, sl in zip(reqs, slices):
            stream = req.stream
            chunk = req.meta["chunk"]
            f = req.frames.shape[0]
            out_sl = out[sl]
            coord_bytes = float(getattr(out_sl, "nbytes", 8 * f))
            wan_down = self.network.wan_time(coord_bytes, t=done)
            fog_time = f / pipe.fog_fps
            result, done_c = stream.fog_exec.run(
                pipe.fog_stage, chunk.frames, out_sl,
                now=done + wan_down, model_time=fog_time)
            fog_wait = (max(0.0, done_c - fog_time - (done + wan_down))
                        if self.fog_queueing else 0.0)
            lat = LatencyBreakdown(
                quality_control=req.meta["qc"],
                transmission=req.meta["wan_up"] + wan_down,
                cloud_inference=svc,
                fog_inference=fog_time,
                queue_wait=max(0.0, start - req.arrival) + fog_wait)
            billed = pipe.billed(result, f)
            if self.cost_model is not None:
                tname = self._tenant_name(stream)
                self.cost_model.charge_cloud(
                    tname, frames=f, invocations=billed,
                    busy_s=svc * f / max(f_real, 1), t=t)
                self.cost_model.charge_fog(tname, fog_time, t)
            res = TenantChunkResult(
                result, wan_bytes=req.meta["wan_bytes"],
                coord_bytes=coord_bytes + pipe.out_bytes(result, f),
                cloud_frames=billed, latency=lat)
            self._push(req.meta["t0"] + lat.total, "finalize",
                       dict(stream=stream, chunk=chunk, res=res,
                            mode="cloud", learn=req.meta["learn"],
                            t0=req.meta["t0"]))
        self.sched_stats["model_wall_s"] += time.perf_counter() - m0

    def _finalize(self, t: float, data: dict) -> None:
        stream, chunk = data["stream"], data["chunk"]
        res = data["res"]
        self.sched_stats["finalizes"] += 1
        if data.get("inflight"):
            # retire the in-flight future: its arrays stay device-side in
            # the flush bundle until a consumer touches a field, so the
            # device ran ahead on later flushes while this result waited
            # for its event.  Identity scan, not deque.remove: == on lazy
            # results would trigger attribute materialization.
            for i, p in enumerate(self._inflight):
                if p is res:
                    del self._inflight[i]
                    break
        t0 = data["t0"]
        self.monitor.record("latency", res.latency.total, t0)
        self.monitor.record("wan_bytes", res.wan_bytes, t0)
        self.monitor.incr("cloud_frames", res.cloud_frames)
        tenant_tagged = stream.tenant is not None or self.cost_model is not None
        if tenant_tagged:
            # per-tenant attribution: tagged latency/attainment series feed
            # throughput_report()["tenants"] and the noisy-neighbor gate
            tname = self._tenant_name(stream)
            self.monitor.record(f"latency:{tname}", res.latency.total, t0)
        if self.cost_model is not None:
            tname = self._tenant_name(stream)
            self.cost_model.charge_egress(
                tname, res.wan_bytes + res.coord_bytes, t0)
            self.cost_model.note_chunk(tname)
        if stream.slo is not None:
            met = res.latency.total <= stream.slo + 1e-9
            self.monitor.record("slo_attained", 1.0 if met else 0.0, t0)
            if tenant_tagged:
                self.monitor.record(f"slo_attained:{self._tenant_name(stream)}",
                                    1.0 if met else 0.0, t0)
            self.monitor.record("slo_margin",
                                stream.slo - res.latency.total, t0)
            if self.adaptive_margin:
                a = self.margin_alpha
                stream.att_ewma = ((1.0 - a) * stream.att_ewma
                                   + a * (1.0 if met else 0.0))
                lo, hi = self.margin_bounds
                stream.slo_margin = lo + (hi - lo) * (1.0 - stream.att_ewma)
        if (self.plane is None and data["learn"]
                and stream.learner is not None
                and data["mode"] == "cloud"
                and not stream.learner.budget_exhausted):
            # HITL feedback runs on the fog node's BACKGROUND lane: the
            # stream's next chunk is never head-of-line blocked behind
            # collect work, and a nonzero hitl_cost_s
            # prices the labeling/update time into the tenant's fog spend
            # without touching any serving-path completion time
            updated, done_c = stream.fog_exec.run(
                STAGE_COLLECT, stream, chunk, res, now=t,
                model_time=self.hitl_cost_s, priority="background")
            if self.cost_model is not None and self.hitl_cost_s > 0:
                self.cost_model.charge_fog(self._tenant_name(stream),
                                           self.hitl_cost_s, done_c)
            if updated:
                self.monitor.incr("model_updates")
        stream.clock = t
        stream.results.append((chunk, res, data["mode"]))
        stream.busy = False
        if self.plane is not None and data["learn"]:
            # the continual-learning plane runs beside serving: labeling and
            # training cost background time, never this chunk's latency
            self.plane.on_chunk(self, stream, chunk, res, t, data["mode"])
        if data.get("inflight"):
            # last: every consumer that runs *at* finalize (HITL collect,
            # the learning plane) has touched its fields by now
            res._bundle.pending -= 1
            self._maybe_seal()
        self._pull_next(stream)

    def _maybe_seal(self) -> None:
        """Seal oldest fully-finalized bundles past the retention cap."""
        cap = self.max_retained_bundles
        if cap is None:
            return
        hps = self.hot_path_stats
        while len(self._bundles) > cap and self._bundles[0].pending == 0:
            b = self._bundles.popleft()
            hps["bundle_bytes"] -= b.device_bytes
            b.seal()
            hps["bundles_sealed"] += 1

    # ------------------------------------------------------------------
    def _ensemble_stack(self, group_streams: List[StreamState]):
        """Stacked (G, T, d+1, C) snapshot lineages + (G, T) omegas for one
        flush's readout groups, zero-padded to the flush's longest lineage.

        Memoized on the source arrays' identities: a steady flush mix
        uploads the stack once; a hot-swap (new W / new ensemble object on
        any stream) misses and rebuilds.  The cache holds strong references
        to the sources so an id can never be recycled under the key."""
        srcs = [(s.snaps if s.snaps is not None else s.W)
                for s in group_streams]
        key = tuple(id(s) for s in srcs)
        hit = self._ens_cache.get(key)
        if hit is not None:
            return hit[1]
        lineages = []
        for s in group_streams:
            if s.snaps is not None:
                lineages.append((np.asarray(s.snaps, np.float32),
                                 np.asarray(s.omega, np.float32)))
            else:
                W = np.asarray(s.W, np.float32)
                lineages.append((W[None], np.ones(1, np.float32)))
        t_max = max(sn.shape[0] for sn, _ in lineages)
        d, c = lineages[0][0].shape[1:]
        snaps = np.zeros((len(lineages), t_max, d, c), np.float32)
        omegas = np.zeros((len(lineages), t_max), np.float32)
        for gi, (sn, om) in enumerate(lineages):
            snaps[gi, : sn.shape[0]] = sn
            omegas[gi, : om.shape[0]] = om
        out = (torch.as_tensor(snaps, device=self.device),
               torch.as_tensor(omegas, device=self.device))
        self._ens_cache[key] = (srcs, out)
        while len(self._ens_cache) > self._ens_cache_cap:
            self._ens_cache.pop(next(iter(self._ens_cache)))
        # upload-regression ledger for the fused path: recurring flush
        # mixes should hit the memo — a climbing count means cache thrash
        self.hot_path_stats["ensemble_uploads"] += 1
        return out

    # ------------------------------------------------------------------
    def _swap_targets(self, stream: Optional[str]) -> List[StreamState]:
        if stream is None:
            return list(self.streams.values())
        return [self.streams[stream]]

    def hot_swap(self, W, *, version=None, t: Optional[float] = None,
                 stream: Optional[str] = None) -> int:
        """Swap a new fog-classifier readout into live streams' classify
        stage, mid-run and without stalling.

        ``stream`` names a single camera to swap (per-site promotion: a
        drift episode in camera k must touch only camera k's readout);
        ``None`` keeps the original swap-everywhere behaviour.  Chunks
        whose classify stage already dispatched finish on the old weights;
        everything dispatched after this call uses the new ones — no chunk
        is dropped, duplicated, or delayed by the swap.  A readout swap
        supersedes any Eq. 9 ensemble the target stream was serving.
        Returns the number of in-flight chunks the swap left untouched."""
        W = to_host(W)
        targets = self._swap_targets(stream)
        inflight = sum(1 for s in targets if s.busy)
        for s in targets:
            s.W = W.copy()             # per-stream cache refresh
            s.clear_ensemble()
        self.monitor.incr("hot_swaps")
        self.monitor.log_event("hot_swap", t=t if t is not None else 0.0,
                               version=version, inflight=inflight,
                               stream=stream)
        return inflight

    def set_stream_thresholds(self, stream: str, *,
                              theta_cls: Optional[float] = None,
                              theta_loc: Optional[float] = None,
                              t: Optional[float] = None) -> None:
        """Override one stream's detector split thresholds mid-run.

        ``None`` restores the global :class:`ProtocolConfig` default for
        that threshold (the bit-compatible state).  Chunks already past
        their detect dispatch keep the thresholds they ran with; the next
        flush containing this stream routes through the dynamic fused
        stage (or a per-site config replace on the sync path)."""
        st = self.streams[stream]
        st.theta_cls = theta_cls
        st.theta_loc = theta_loc
        self.monitor.log_event("stream_thresholds",
                               t=t if t is not None else 0.0,
                               stream=stream, theta_cls=theta_cls,
                               theta_loc=theta_loc)

    def hot_swap_ensemble(self, snaps, omega, *, version=None,
                          t: Optional[float] = None,
                          stream: Optional[str] = None) -> int:
        """Swap an Eq. 9 snapshot ensemble into live serving.

        The stream's classify stage switches to the multi-readout
        ``fog.classify_ensemble`` / ``fog.classify_ensemble_batched``
        variant scoring against the whole lineage; ``W`` (the latest
        promoted readout) is untouched — the learning plane keeps using it
        to rescore label candidates.  Same zero-loss semantics as
        :meth:`hot_swap`."""
        snaps = to_host(snaps)
        omega = to_host(omega)
        targets = self._swap_targets(stream)
        inflight = sum(1 for s in targets if s.busy)
        for s in targets:
            s.set_ensemble(snaps, omega)
        self.monitor.incr("hot_swaps")
        self.monitor.log_event("hot_swap", t=t if t is not None else 0.0,
                               version=version, inflight=inflight,
                               stream=stream, kind="ensemble",
                               snapshots=int(snaps.shape[0]))
        return inflight

    # ------------------------------------------------------------------
    def throughput_report(self) -> Dict[str, float]:
        """Wall-clock + simulated throughput of the detect stage, batch
        stats, replica pool size, and SLO attainment (when SLOs are set)."""
        d = dict(self.detect_stats)
        d["frames_per_s"] = (d["frames"] / d["wall_s"] if d["wall_s"] > 0
                             else 0.0)
        d.update({f"batch_{k}": v for k, v in self.batcher.stats.items()})
        d["replicas"] = len(self.router.replicas)
        d["healthy_replicas"] = self.router.healthy_count()
        d["hot_path"] = self.hot_path
        hps = self.hot_path_stats
        d.update({f"hot_{k}": v for k, v in hps.items()})
        if hps["flushes"]:
            d["host_syncs_per_flush"] = hps["host_syncs"] / hps["flushes"]
        if hps["crops_budget"]:
            # fraction of full-budget fog-classify FLOPs the compacted
            # (bucketed) gather avoided this run
            d["classify_flops_saved_frac"] = (
                1.0 - hps["crops_classified"] / hps["crops_budget"])
        d["w_uploads"] = sum(s.w_uploads for s in self.streams.values())
        d["e_uploads"] = sum(s.e_uploads for s in self.streams.values())
        ss = self.sched_stats
        d.update({f"sched_{k}": v for k, v in ss.items()})
        if ss["finalizes"]:
            # event-loop wall net of payload assembly + model dispatch,
            # amortized per finalized chunk: the fleet-scale flatness metric
            d["sched_overhead_per_chunk_s"] = (
                max(0.0, ss["step_wall_s"] - ss["model_wall_s"])
                / ss["finalizes"])
        if self.store is not None:
            d["store"] = self.store.report()
            # capacity-pressure evictions, surfaced at top level so the
            # regression gate (and the CostModel's spill charge) see them
            d["store_spills"] = self.store.stats["spills"]
        if self.tenant_stats["flushes"]:
            d.update({f"tenant_{k}": v for k, v in self.tenant_stats.items()})
        if self.cost_model is not None:
            store_stats = (self.store.report() if self.store is not None
                           else None)
            d["cost"] = self.cost_model.cost_report(store_stats)
            d["tenants"] = self._tenant_report()
        # per-field lazy-result ledger: which result fields were actually
        # downloaded (a HITL-off run must never pay for fog_features)
        d["field_downloads"] = dict(self.field_downloads)
        # chaos plane: emitted unconditionally (zeros on fault-free runs)
        # so plain and idle-injector reports stay key-for-key identical
        d.update({f"chaos_{k}": v for k, v in self.chaos_stats.items()})
        d["chaos_route_timeouts"] = self.router.timeouts
        # warm-pool plane: same unconditional-zeros discipline as chaos_*
        d.update({f"warm_{k}": v for k, v in self.warm_stats.items()})
        # simulated detect-stage makespan across the replica pool: with R
        # replicas the sub-batches overlap, so frames/span is the serving
        # plane's *capacity*, unlike frames/wall_s (one-device wall time)
        if self._detect_windows:
            t_lo = min(s for s, _ in self._detect_windows)
            t_hi = max(s + dur for s, dur in self._detect_windows)
            span = t_hi - t_lo
            d["detect_span_s"] = span
            d["sim_frames_per_s"] = (d["frames"] / span if span > 0 else 0.0)
            # detect-device occupancy: busy fraction of the replica pool
            # over the detect span (a starved accelerator reads low here);
            # computed from _detect_windows because retired replicas take
            # their ExecutionRecords with them.  The shared fog-batch
            # executor never retires, so it reports via busy_fraction.
            busy = sum(dur for _, dur in self._detect_windows)
            pool = max(1, len(self.router.replicas))
            d["detect_occupancy"] = (min(1.0, busy / (span * pool))
                                     if span > 0 else 0.0)
            d["fog_batch_occupancy"] = self.fog_batch_exec.busy_fraction(
                t_lo, t_hi)
        att = self.monitor.values("slo_attained")
        if att:
            d["slo_attainment"] = float(np.mean(att))
        if self.autoscaler is not None and self.autoscaler.history:
            s = self.autoscaler.summary()
            d["peak_devices"] = s["peak_devices"]
            d["peak_queue"] = s["peak_queue"]
        return d

    def _tenant_report(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant latency percentiles + SLO attainment, enumerated from
        the monitor's tagged series (sharded-safe: shards share the
        monitor, so every shard reports the same complete view)."""
        out: Dict[str, Dict[str, float]] = {}
        for tag in self.monitor.tags("latency"):
            att = self.monitor.values(f"slo_attained:{tag}")
            out[tag] = {
                "chunks": len(self.monitor.values(f"latency:{tag}")),
                "p50_latency_s": self.monitor.percentile(f"latency:{tag}",
                                                         50),
                "p99_latency_s": self.monitor.percentile(f"latency:{tag}",
                                                         99),
                "slo_attainment": float(np.mean(att)) if att else 1.0,
            }
        return out
