"""Dynamic batching (Clipper-style, §IV.B last paragraph).

Requests accumulate until ``max_batch`` or ``max_delay`` elapses (simulated
clock).  Used by the fog classifier (variable region counts per chunk) and
by the LLM serving loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class QueuedRequest:
    payload: Any
    arrival: float
    request_id: int


@dataclass
class DynamicBatcher:
    max_batch: int = 16
    max_delay: float = 0.02           # seconds (simulated)
    pad_to_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)

    _queue: List[QueuedRequest] = field(default_factory=list)
    _next_id: int = 0
    stats: Dict[str, float] = field(default_factory=lambda: {
        "batches": 0, "requests": 0, "padded": 0})

    def submit(self, payload: Any, now: float) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append(QueuedRequest(payload, now, rid))
        return rid

    def ready(self, now: float) -> bool:
        if not self._queue:
            return False
        return (len(self._queue) >= self.max_batch
                or now - self._queue[0].arrival >= self.max_delay)

    def bucket(self, n: int) -> int:
        for b in self.pad_to_buckets:
            if n <= b:
                return b
        # beyond the largest bucket the batch runs at its exact size: padding
        # down to the last bucket would truncate, and counting it made the
        # `padded` stat go negative
        return n

    def take_batch(self, now: float) -> List[QueuedRequest]:
        batch = self._queue[: self.max_batch]
        self._queue = self._queue[self.max_batch:]
        b = self.bucket(len(batch))
        self.stats["batches"] += 1
        self.stats["requests"] += len(batch)
        self.stats["padded"] += max(0, b - len(batch))
        return batch

    def __len__(self) -> int:
        return len(self._queue)


# ---------------------------------------------------------------------------
# Cross-stream frame batching (cloud detector stage)
# ---------------------------------------------------------------------------
@dataclass(eq=False)           # identity equality: payloads are arrays
class DetectRequest:
    """One chunk's detector invocation, queued for cross-stream batching.

    ``deadline`` is the absolute simulated time by which the *detector* stage
    should complete for this chunk's end-to-end SLO to remain attainable
    (the scheduler derives it from the stream's SLO minus the estimated
    downstream classify/transfer time).  ``weight`` is the stream's fair-
    queueing weight; ``not_before`` gates re-queued requests (a replica
    failure is only *detected* at the failure time, so the retry must not be
    dispatched earlier on the simulated clock).  All hedge/requeue state
    (``deadline``, ``not_before``, ``retries``) lives on the request object
    itself, so a flush stolen or adopted across scheduler shards carries it
    along untouched."""
    frames: Any                  # (F, H, W, 3) low-quality frames
    arrival: float               # simulated arrival time at the cloud
    stream: Any = None           # opaque owner handle (scheduler state)
    meta: Dict[str, Any] = field(default_factory=dict)
    deadline: Optional[float] = None   # absolute detect-complete deadline
    weight: float = 1.0                # WFQ weight (higher = more service)
    not_before: Optional[float] = None # earliest dispatch (requeue gate)
    retries: int = 0                   # replica-failure requeue count
    vft: Optional[float] = None        # WFQ virtual finish time (set once)
    seq: int = -1                      # submit order (deterministic ties)


@dataclass
class CrossStreamBatcher:
    """Accumulates detector requests from concurrent chunk streams and packs
    their frames into one padded batch for a single detector call
    (Tangram-style SLO-aware batching of serverless video invocations).

    Flush policy:

    * a full batch (``max_chunks`` arrived requests) always flushes;
    * requests without a deadline flush when the oldest has waited
      ``window`` seconds (the fixed-window policy);
    * requests carrying a ``deadline`` flush **deadline-driven**: the batch
      is held open only while the tightest pending deadline can still be
      met given the estimated batch service time (``service_model``), i.e.
      it flushes at ``min(deadline) - est_service(pending_frames)``.

    Batch-assembly order is weighted fair queueing: each request gets a
    virtual finish time ``vft = max(vclock, last_vft(stream)) + frames/weight``
    at submit, and ``take`` drains in vft order — so when the batch is full,
    a high-weight camera's chunks preempt backlog from bulk streams.

    ``window=0`` with no deadlines degenerates to immediate per-chunk
    dispatch — the bit-identical sequential single-stream path."""
    max_chunks: int = 8
    window: float = 0.0
    pad_buckets: Tuple[int, ...] = (2, 4, 8, 16, 32, 64)
    # frames -> estimated detector service seconds (e.g. profile.detect_time)
    service_model: Optional[Callable[[int], float]] = None

    _queue: List[DetectRequest] = field(default_factory=list)
    _vclock: float = 0.0
    _vft: Dict[int, float] = field(default_factory=dict)
    _seq: int = 0
    stats: Dict[str, float] = field(default_factory=lambda: {
        "batches": 0, "chunks": 0, "frames": 0, "padded_frames": 0,
        "max_batch_chunks": 0, "deadline_flushes": 0, "requeued": 0,
        "stolen": 0, "adopted": 0})

    def submit(self, req: DetectRequest) -> None:
        if req.seq < 0:
            req.seq = self._seq
            self._seq += 1
        if req.vft is None:
            # WFQ virtual finish time; keyed per stream so a stream's own
            # requests stay FIFO while streams interleave by weight
            key = id(req.stream) if req.stream is not None else -req.seq
            w = max(float(req.weight), 1e-6)
            start = max(self._vclock, self._vft.get(key, 0.0))
            req.vft = start + req.frames.shape[0] / w
            self._vft[key] = req.vft
        else:
            # requeue after a replica failure: keep the original arrival and
            # fair-queueing position, just count it
            self.stats["requeued"] += 1
        self._queue.append(req)

    def _arrived(self, now: float) -> List[DetectRequest]:
        # only requests whose (simulated) upload has completed — and whose
        # requeue gate has passed — are eligible
        return [r for r in self._queue if r.arrival <= now + 1e-12
                and (r.not_before is None or r.not_before <= now + 1e-12)]

    @staticmethod
    def _order(r: DetectRequest) -> Tuple[float, float, int]:
        return (r.vft if r.vft is not None else 0.0, r.arrival, r.seq)

    def _est_service(self, reqs: List[DetectRequest]) -> float:
        if self.service_model is None:
            return 0.0
        head = sorted(reqs, key=self._order)[: self.max_chunks]
        return self.service_model(sum(r.frames.shape[0] for r in head))

    def _flush_by(self, r: DetectRequest, est: float) -> float:
        """Latest simulated time this request allows the batch to stay open."""
        earliest = max(r.arrival, r.not_before or r.arrival)
        if r.deadline is None:
            return earliest + self.window
        return max(earliest, r.deadline - est)

    def ready(self, now: float) -> bool:
        arrived = self._arrived(now)
        if not arrived:
            return False
        if len(arrived) >= self.max_chunks:
            return True
        est = self._est_service(arrived)
        # small tolerance: the flush event fires at exactly the flush-by
        # time, and float summation must not leave the batch stranded
        return now >= min(self._flush_by(r, est) for r in arrived) - 1e-9

    def next_deadline(self) -> Optional[float]:
        """Earliest time any queued request forces a flush (event horizon)."""
        if not self._queue:
            return None
        est = self._est_service(self._queue)
        return min(self._flush_by(r, est) for r in self._queue)

    def take(self, now: float) -> List[DetectRequest]:
        batch = sorted(self._arrived(now), key=self._order)[: self.max_chunks]
        for r in batch:
            self._queue.remove(r)
        if batch:
            self._vclock = max(self._vclock,
                               min(r.vft for r in batch if r.vft is not None))
        self.stats["batches"] += 1
        self.stats["chunks"] += len(batch)
        self.stats["frames"] += sum(r.frames.shape[0] for r in batch)
        self.stats["max_batch_chunks"] = max(self.stats["max_batch_chunks"],
                                             len(batch))
        if any(r.deadline is not None for r in batch):
            self.stats["deadline_flushes"] += 1
        return batch

    def steal_due(self, now: float, keep: int) -> List[DetectRequest]:
        """Remove due requests beyond the ``keep`` this shard will flush.

        Work-stealing support (ShardedScheduler): when more requests are
        due at ``now`` than one flush can take, the overflow — in WFQ
        order, so the keep-set is exactly what ``take(now)`` would pick —
        moves atomically to an idle shard's batcher via :meth:`adopt`.
        Each request's arrival/vft/seq travel with it, so fair-queueing
        position and requeue gates are preserved wherever it lands."""
        arrived = sorted(self._arrived(now), key=self._order)
        if len(arrived) <= keep:
            return []
        out = arrived[keep:]
        for r in out:
            self._queue.remove(r)
        self.stats["stolen"] += len(out)
        return out

    def adopt(self, reqs: List[DetectRequest]) -> None:
        """Accept requests stolen from another shard's batcher as-is
        (no re-submit bookkeeping: vft/seq/arrival are already set)."""
        self._queue.extend(reqs)
        self.stats["adopted"] += len(reqs)

    @property
    def pending_frames(self) -> int:
        return sum(r.frames.shape[0] for r in self._queue)

    def __len__(self) -> int:
        return len(self._queue)


def pack_frames(frame_arrays: List[np.ndarray],
                buckets: Tuple[int, ...] = (2, 4, 8, 16, 32, 64)
                ) -> Tuple[np.ndarray, List[slice], int]:
    """Concatenate per-chunk frame arrays into one batch along axis 0.

    Multi-chunk batches are zero-padded up to the next bucket size so the
    detector sees few distinct shapes; a single request passes through
    exactly as-is (no padding), keeping the sequential path bit-identical.
    Returns (batch, per-request slices, padded_frames)."""
    assert frame_arrays, "pack_frames needs at least one request"
    slices, off = [], 0
    for a in frame_arrays:
        slices.append(slice(off, off + a.shape[0]))
        off += a.shape[0]
    batch = np.concatenate([np.asarray(a) for a in frame_arrays], axis=0)
    pad = 0
    if len(frame_arrays) > 1:
        size = next((b for b in buckets if off <= b), None)
        size = off if size is None else size
        pad = size - off
        if pad:
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)], 0)
    return batch, slices, pad


def pack_frames_device(frame_arrays: List[Any],
                       buckets: Tuple[int, ...] = (2, 4, 8, 16, 32, 64)
                       ) -> Tuple[Any, List[slice], int]:
    """Device-side twin of :func:`pack_frames`: concat + zero-pad as torch
    ops on the frames' device, so per-chunk frames already device-resident
    (the
    ``encode_low`` output) are packed without a device->host->device round
    trip.  Same bucket/slice semantics; a single request passes through
    exactly as-is (the bit-identical sequential path — the array object
    itself, so not even a copy is queued).  Returns
    (batch, per-request slices, padded_frames)."""
    assert frame_arrays, "pack_frames_device needs at least one request"
    slices, off = [], 0
    for a in frame_arrays:
        slices.append(slice(off, off + a.shape[0]))
        off += a.shape[0]
    if len(frame_arrays) == 1:
        return frame_arrays[0], slices, 0
    batch = torch.cat([torch.as_tensor(a) for a in frame_arrays], dim=0)
    size = next((b for b in buckets if off <= b), off)
    pad = size - off
    if pad:
        batch = torch.cat([batch, batch.new_zeros((pad,) + batch.shape[1:])],
                          dim=0)
    return batch, slices, pad


def batch_crops(crops: np.ndarray, valid: np.ndarray,
                buckets: Tuple[int, ...] = (4, 8, 16, 32, 64)
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack the valid crops of one chunk into a padded batch.

    Returns (batch, index_map, padded_size); index_map recovers the original
    (frame, region) position of each batch row."""
    idx = np.argwhere(valid)
    n = len(idx)
    size = next((b for b in buckets if n <= b), buckets[-1])
    if n == 0:
        return (np.zeros((buckets[0],) + crops.shape[2:], crops.dtype),
                np.zeros((0, 2), np.int64), buckets[0])
    take = idx[:size]
    batch = crops[take[:, 0], take[:, 1]]
    if len(batch) < size:
        pad = np.zeros((size - len(batch),) + batch.shape[1:], batch.dtype)
        batch = np.concatenate([batch, pad])
    return batch, take, size
