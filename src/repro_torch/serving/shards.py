"""Sharded scheduling: K per-shard event loops over disjoint stream sets;
PyTorch port of ``repro.serving.shards``.

The single :class:`~repro_torch.serving.graph.GraphScheduler` carries an O(Q)
cost per flush event inside :class:`CrossStreamBatcher` (``_arrived`` /
``take`` / ``next_deadline`` all scan the whole queue), and Q grows with
the number of concurrent streams — flat per-stream overhead at ~1000
streams needs that scan bounded.  :class:`ShardedScheduler` partitions the
streams across K ordinary ``GraphScheduler`` instances, each with its own
event heap and batcher (Q ≈ streams/K), and interleaves their ``step()``
loops on ONE merged simulated timeline: every iteration picks the shard
whose next event key ``(t, seq)`` is globally smallest.  Shards share a
single event-sequence counter, so same-time events across shard heaps pop
in exactly the order a single heap would have popped them — with one shard
the merged loop degenerates to ``run_until_idle`` and is bitwise-identical
to today's scheduler.

Shared across shards:

* the detector **replica pool** (one
  :class:`~repro_torch.serving.router.Router`, power-of-two-choices pick
  by default — O(1)-ish routing state instead of an O(R) scan per
  dispatch),
* the claim-check :class:`~repro_torch.serving.ingest.ArtifactStore`
  (streams on any shard dedup against the same content-addressed
  payloads),
* the :class:`~repro_torch.serving.monitor.Monitor` (series from all
  shards land in one place — the "merged monitor" is shared, not
  reconciled later),
* the event-sequence counter (global deterministic tie-break),
* the warm-pool policy (one
  :class:`~repro_torch.serving.autoscaler.WarmPoolPolicy` instance passed to
  every shard: arrival observations from all shards feed one forecast,
  and its at-most-one-outstanding-check dedup is therefore global — the
  shared pool is prewarmed once, not once per shard).  Its ``warm_*``
  report counters sum across shards like any other counter.

**Work stealing:** before stepping a shard that is about to flush, the
merged loop checks whether more requests are due there than one flush can
take (``> max_chunks``); the WFQ-ordered overflow moves atomically to an
idle shard's batcher (``steal_due`` / ``adopt`` — arrival, vft, seq, and
requeue gates travel with each request) and the thief gets a flush event
at the same simulated time.  A stolen chunk is dispatched and finalized by
the thief exactly once; a replica failure mid-service requeues it into the
*thief's* batcher (still exactly once), and the stream's next ingest is
routed back to its owner shard via ``StreamState.owner``.

``throughput_report`` merges the per-shard reports: counters sum, peaks
take the max (so multi-shard peak byte figures are an upper bound on the
true simultaneous peak), derived rates are recomputed from the merged
sums, and the shared router/store report once.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.protocol import to_host
from repro_torch.serving.batching import CrossStreamBatcher
from repro_torch.serving.graph import (GraphScheduler, StreamState,
                                       VideoFunctionGraph)
from repro_torch.serving.ingest import ArtifactStore

__all__ = ["ShardedScheduler"]

# report keys merged as max() rather than summed: largest-batch-seen and
# pool-level gauges, where summing across shards would double-count shared
# state.  Per-shard resource peaks (inflight futures, retained bundles /
# bundle bytes) are deliberately NOT here: those buffers are disjoint per
# shard, so their sum is the fleet-wide residency bound.
_MAX_KEYS = frozenset((
    "batch_max_batch_chunks", "fog_batch_occupancy", "replicas",
    "healthy_replicas", "peak_devices", "peak_queue"))
# keys identical on every shard (shared objects / config): the store,
# cost model, and monitor are shared, so their rollups ("store_spills",
# "cost", "tenants") must not be summed K times.  The router is shared
# too, so its timeout counter reports once; per-shard chaos_* counters
# (hedges, probes, requeues, repairs) sum through the default branch.
_FIRST_KEYS = frozenset(("hot_path", "replicas", "healthy_replicas",
                         "peak_devices", "peak_queue", "store_spills",
                         "cost", "tenants", "chaos_route_timeouts"))


class ShardedScheduler:
    """K :class:`GraphScheduler` shards on one merged simulated timeline."""

    def __init__(self, graph: VideoFunctionGraph, *,
                 num_shards: int = 1,
                 batcher_factory: Optional[
                     Callable[[int], CrossStreamBatcher]] = None,
                 store: Optional[ArtifactStore] = None,
                 use_store: bool = True,
                 pick_policy: str = "p2c",
                 steal: bool = True,
                 **sched_kw: Any):
        assert num_shards >= 1
        if batcher_factory is None:
            def batcher_factory(i: int) -> CrossStreamBatcher:
                return CrossStreamBatcher(max_chunks=1, window=0.0)
        if store is None and use_store:
            store = ArtifactStore()
        self.graph = graph
        self.store = store
        self.steal = steal
        self.steals = 0
        # shard 0 builds the shared substrate (router + monitor); the rest
        # plug into it and share the event-sequence counter
        first = GraphScheduler(graph, batcher=batcher_factory(0),
                               store=store, pick_policy=pick_policy,
                               **sched_kw)
        self.shards: List[GraphScheduler] = [first]
        shared_kw = dict(sched_kw)
        for drop in ("monitor", "cloud_replicas", "cloud_devices",
                     "autoscaler", "scale_unit", "cold_start_s"):
            shared_kw.pop(drop, None)
        for i in range(1, num_shards):
            self.shards.append(GraphScheduler(
                graph, batcher=batcher_factory(i), store=store,
                router=first.router, seq_counter=first._seq,
                monitor=first.monitor, **shared_kw))
        self.router = first.router
        self.monitor = first.monitor
        self.streams: Dict[str, StreamState] = {}
        self._shard_of: Dict[str, GraphScheduler] = {}
        self._rr = 0

    # -- plane hook: plane.attach(...) assigns scheduler.plane -----------
    @property
    def plane(self):
        return self.shards[0].plane

    @plane.setter
    def plane(self, plane) -> None:
        for sh in self.shards:
            sh.plane = plane

    @property
    def batcher(self) -> CrossStreamBatcher:
        # convenience for single-shard introspection (tests, tools)
        return self.shards[0].batcher

    # -- stream management ------------------------------------------------
    def add_stream(self, name: str, *, shard: Optional[int] = None,
                   **kw: Any) -> StreamState:
        """Register a stream on a shard (round-robin unless pinned)."""
        if shard is None:
            shard = self._rr % len(self.shards)
            self._rr += 1
        sh = self.shards[shard]
        st = sh.add_stream(name, **kw)
        st.owner = sh
        self.streams[name] = st
        self._shard_of[name] = sh
        return st

    def submit(self, stream: StreamState, chunk, *, learn: bool = True
               ) -> None:
        owner = stream.owner if stream.owner is not None else self.shards[0]
        owner.submit(stream, chunk, learn=learn)

    # -- merged event loop -------------------------------------------------
    def _next_shard(self) -> Optional[GraphScheduler]:
        best, best_key = None, None
        for si, sh in enumerate(self.shards):
            key = sh._peek_key()
            if key is None:
                continue
            # shard index breaks exact (t, seq) ties (only the safety-net
            # sentinel can tie — real events share one seq counter)
            key = (key[0], key[1], si)
            if best_key is None or key < best_key:
                best, best_key = sh, key
        return best

    def _maybe_steal(self, sh: GraphScheduler) -> None:
        """If ``sh`` is about to flush more than one batch's worth of due
        requests, move the WFQ overflow to an idle shard."""
        if not sh._events or sh._events[0][2] != "flush":
            return
        t = sh._events[0][0]
        due = len(sh.batcher._arrived(t))
        if due <= sh.batcher.max_chunks:
            return
        thief = None
        for other in self.shards:
            if other is sh or len(other.batcher):
                continue
            key = other._peek_key()
            if key is None or key[0] > t:
                thief = other
                break
        if thief is None:
            return
        moved = sh.batcher.steal_due(t, keep=sh.batcher.max_chunks)
        if not moved:
            return
        thief.batcher.adopt(moved)
        thief._push(t, "flush", {})
        self.steals += len(moved)

    def step(self) -> bool:
        sh = self._next_shard()
        if sh is None:
            return False
        if self.steal and len(self.shards) > 1:
            self._maybe_steal(sh)
            # stealing may have handed the globally-next event to the thief
            sh = self._next_shard()
            if sh is None:
                return False
        return sh.step()

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def drain(self) -> None:
        """Run the merged loop to idle and assert the shared claim-check
        store leaked nothing (same contract as ``GraphScheduler.drain``)."""
        self.run_until_idle()
        if self.store is not None:
            leaked = self.store.live_refs()
            if leaked:
                raise AssertionError(
                    f"claim-check leak: {len(leaked)} artifact(s) still "
                    f"referenced at drain: {leaked}")

    # -- delegated control-plane operations -------------------------------
    def set_stream_thresholds(self, stream: str, **kw: Any) -> None:
        self._shard_of[stream].set_stream_thresholds(stream, **kw)

    def hot_swap(self, W, *, version=None, t: Optional[float] = None,
                 stream: Optional[str] = None) -> int:
        if stream is not None:
            return self._shard_of[stream].hot_swap(
                W, version=version, t=t, stream=stream)
        W = to_host(W)
        targets = list(self.streams.values())
        inflight = sum(1 for s in targets if s.busy)
        for s in targets:
            s.W = W.copy()
            s.clear_ensemble()
        self.monitor.incr("hot_swaps")
        self.monitor.log_event("hot_swap", t=t if t is not None else 0.0,
                               version=version, inflight=inflight,
                               stream=None)
        return inflight

    def hot_swap_ensemble(self, snaps, omega, *, version=None,
                          t: Optional[float] = None,
                          stream: Optional[str] = None) -> int:
        if stream is not None:
            return self._shard_of[stream].hot_swap_ensemble(
                snaps, omega, version=version, t=t, stream=stream)
        snaps = to_host(snaps)
        omega = to_host(omega)
        targets = list(self.streams.values())
        inflight = sum(1 for s in targets if s.busy)
        for s in targets:
            s.set_ensemble(snaps, omega)
        self.monitor.incr("hot_swaps")
        self.monitor.log_event("hot_swap", t=t if t is not None else 0.0,
                               version=version, inflight=inflight,
                               stream=None, kind="ensemble",
                               snapshots=int(snaps.shape[0]))
        return inflight

    # -- merged reporting --------------------------------------------------
    def throughput_report(self) -> Dict[str, float]:
        """Per-shard reports merged into one fleet view.

        With one shard this IS that shard's report.  With K shards,
        counters sum, peak gauges take the max across shards, and the
        rate/ratio fields are recomputed from the merged sums."""
        reports = [sh.throughput_report() for sh in self.shards]
        if len(reports) == 1:
            d = dict(reports[0])
            d["shards"] = 1
            d["steals"] = self.steals
            return d
        d: Dict[str, Any] = {}
        for key in reports[0]:
            vals = [r[key] for r in reports if key in r]
            if key in _FIRST_KEYS:
                d[key] = vals[0]
            elif key in _MAX_KEYS:
                d[key] = max(vals)
            elif key == "field_downloads":
                merged: Dict[str, int] = {}
                for v in vals:
                    for f, n in v.items():
                        merged[f] = merged.get(f, 0) + n
                d[key] = merged
            elif isinstance(vals[0], (int, float, np.integer, np.floating)):
                d[key] = sum(vals)
            else:
                d[key] = vals[0]
        # recompute derived rates/ratios from the merged sums
        d["frames_per_s"] = (d["frames"] / d["wall_s"]
                             if d.get("wall_s") else 0.0)
        flushes = d.get("hot_flushes", 0)
        if flushes:
            d["host_syncs_per_flush"] = d["hot_host_syncs"] / flushes
        if d.get("hot_crops_budget"):
            d["classify_flops_saved_frac"] = (
                1.0 - d["hot_crops_classified"] / d["hot_crops_budget"])
        if d.get("sched_finalizes"):
            d["sched_overhead_per_chunk_s"] = (
                max(0.0, d["sched_step_wall_s"] - d["sched_model_wall_s"])
                / d["sched_finalizes"])
        windows = [w for sh in self.shards for w in sh._detect_windows]
        if windows:
            t_lo = min(s for s, _ in windows)
            t_hi = max(s + dur for s, dur in windows)
            span = t_hi - t_lo
            d["detect_span_s"] = span
            d["sim_frames_per_s"] = (d["frames"] / span if span > 0 else 0.0)
            busy = sum(dur for _, dur in windows)
            pool = max(1, len(self.router.replicas))
            d["detect_occupancy"] = (min(1.0, busy / (span * pool))
                                     if span > 0 else 0.0)
        att = self.monitor.values("slo_attained")
        if att:
            d["slo_attainment"] = float(np.mean(att))
        if self.store is not None:
            d["store"] = self.store.report()
        d["shards"] = len(self.shards)
        d["steals"] = self.steals
        d["batch_stolen"] = sum(sh.batcher.stats["stolen"]
                                for sh in self.shards)
        d["batch_adopted"] = sum(sh.batcher.stats["adopted"]
                                 for sh in self.shards)
        return d

    def results(self):
        return {name: st.results for name, st in self.streams.items()}
