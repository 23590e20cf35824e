"""Claim-check ingestion plane: a simulated content-addressed artifact store.

At fleet scale the scheduler's event heap must stay cheap: a heap entry that
drags a multi-megabyte frame tensor around is a per-stream memory tax and a
copy hazard every time an event is requeued, stolen, or replayed.  The
claim-check pattern (FAVE; Kinesis->Lambda->S3 pipelines) splits the two
planes: streams *publish* their encoded chunk once into an artifact store,
and every scheduler event — batcher queue entries, flush events, replica
requeues, cross-shard steals — carries only a :class:`ClaimCheck` reference.
The payload is resolved exactly once per dispatch, at flush-assembly time,
which preserves the fused hot path's one-upload-per-flush property (the
single-request fast path still hands the *stored array object* to
``pack_frames_device``, so the pass-through identity shortcut survives).

The store is content-addressed: the key is a digest of the source chunk's
host bytes plus the encode parameters, so a stream (or several streams fed
from a shared chunk pool) that re-publishes an identical chunk dedups to one
stored payload with a bumped ref-count.  Encoding is deterministic, so the
dedup is bitwise-safe.  Byte accounting tracks both the *physical* store
footprint (unique payloads) and the *logical* footprint (sum over
outstanding claims) — the latter is what the event heap would be holding
without the store, and the gap between the two is the claim-check win
reported by ``bench_shard_scale``.

Eviction is ref-count + TTL: a payload becomes a candidate only once every
claim against it has been released, and is swept after ``ttl`` simulated
seconds of sitting unreferenced (so a re-publish of a pooled chunk inside
the TTL window is a dedup hit, not a re-upload).  A referenced payload is
never evicted, regardless of age — `tests/test_shards.py` pins that down.
Sweeping is O(1) amortised via an expiry deque rather than a full scan, so
the store never re-introduces the O(#streams) per-event cost that sharding
removes from the batcher.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["ClaimCheck", "ArtifactStore", "ArtifactCorrupted",
           "content_key"]


class ArtifactCorrupted(RuntimeError):
    """A stored payload no longer matches its content checksum.

    Raised by :meth:`ArtifactStore.get` when ``integrity=True`` and the
    payload bytes were flipped after publish (bit rot, a bad replica
    write, or an injected chaos fault).  The caller owns recovery: the
    graph scheduler re-derives the payload from the source chunk and
    calls :meth:`ArtifactStore.repair` — garbage is never served."""

    def __init__(self, key: str):
        super().__init__(f"artifact {key!r} failed its integrity check")
        self.key = key


def content_key(host_bytes: Any, salt: str = "") -> str:
    """Digest of a host-side buffer (bytes or ndarray) plus a salt.

    The salt discriminates payload *derivations* of the same source bytes
    (e.g. different encode parameters).  Device arrays must be converted by
    the caller — hashing one here would force a hidden device->host sync.
    """
    if isinstance(host_bytes, np.ndarray):
        host_bytes = np.ascontiguousarray(host_bytes).tobytes()
    h = hashlib.blake2b(digest_size=16)
    h.update(host_bytes)
    if salt:
        h.update(salt.encode())
    return h.hexdigest()


@dataclass(frozen=True)
class ClaimCheck:
    """Lightweight reference to a stored payload.

    Carries the shape/dtype/nbytes metadata the scheduler needs for batch
    planning (frame counts, pad buckets, WAN accounting) so no event handler
    has to touch the payload — or the store — before flush assembly.
    """
    key: str
    shape: Tuple[int, ...]
    dtype: Any
    nbytes: int


def _payload_checksum(payload: Any) -> str:
    """Content digest of a payload's host bytes (a device tensor is copied
    to the host: a sync, paid in integrity mode only)."""
    if isinstance(payload, torch.Tensor):
        return content_key(payload.detach().cpu().numpy())
    return content_key(np.asarray(payload))


@dataclass
class _Entry:
    payload: Any
    nbytes: int
    refs: int = 0
    # stamp of the release that made refs hit 0; an expiry-deque record is
    # only honoured when its stamp still matches (a re-acquire in between
    # invalidates the old record)
    idle_since: float = 0.0
    idle_stamp: int = 0
    # payload content digest at publish time (integrity mode only)
    checksum: Optional[str] = None


@dataclass
class ArtifactStore:
    """Simulated content-addressed artifact store with ref-count+TTL GC."""

    ttl: float = 30.0
    # physical-footprint bound; None = unbounded (the behaviour before capacity bounds).
    # Publishing over capacity force-evicts idle payloads before their TTL
    # — each such early eviction is a *spill*: the payload must be re-fetched
    # from cold storage if re-published, so the CostModel charges
    # ``spill_bytes`` at the spill rate.  Referenced payloads are never
    # evicted; a fully-referenced over-capacity store tolerates the overflow.
    capacity_bytes: Optional[float] = None
    # integrity mode: checksum payload bytes at publish and verify them at
    # every resolve.  Opt-in because the digest forces a device->host read
    # of the payload on the put/get path; with it on, a flipped byte
    # surfaces as ArtifactCorrupted at flush assembly instead of garbage
    # detections downstream.
    integrity: bool = False

    _entries: Dict[str, _Entry] = field(default_factory=dict)
    # (expire_t, key, idle_stamp) records; lazily validated on sweep
    _expiry: Deque[Tuple[float, str, int]] = field(default_factory=deque)
    stats: Dict[str, float] = field(default_factory=lambda: {
        "puts": 0,            # claims issued
        "unique_puts": 0,     # payloads physically stored
        "dedup_hits": 0,      # claims satisfied by an existing payload
        "gets": 0,            # payload resolutions (flush assembly)
        "releases": 0,
        "evictions": 0,
        "spills": 0,          # capacity-pressure evictions (pre-TTL)
        "spill_bytes": 0.0,
        "bytes_current": 0.0,         # physical: unique payload bytes
        "bytes_peak": 0.0,
        "logical_bytes_current": 0.0,  # what the event heap would hold
        "logical_bytes_peak": 0.0,
        "corruptions_injected": 0,    # bytes flipped (chaos injection)
        "corruptions_detected": 0,    # checksum mismatches caught at get
        "corruptions_repaired": 0,    # payloads re-derived via repair()
    })

    # -- publish ---------------------------------------------------------
    def put(self, payload: Any, *, key: str, nbytes: Optional[int] = None,
            now: float = 0.0) -> ClaimCheck:
        """Publish ``payload`` under ``key``; returns a claim against it.

        A second put of the same key is a dedup hit: the new payload object
        is dropped and the existing one gains a reference (safe because keys
        are content digests of a deterministic encode).  ``nbytes`` defaults
        to the payload's buffer size computed from shape/dtype — never from
        the device buffer itself.
        """
        shape = tuple(getattr(payload, "shape", ()))
        dtype = getattr(payload, "dtype", None)
        if nbytes is None:
            if isinstance(payload, torch.Tensor):
                itemsize = payload.element_size()
            elif dtype is not None:
                itemsize = np.dtype(dtype).itemsize
            else:
                itemsize = 1
            nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize if shape \
                else int(itemsize)
        ent = self._entries.get(key)
        if ent is None:
            ent = _Entry(payload=payload, nbytes=int(nbytes))
            if self.integrity:
                ent.checksum = _payload_checksum(payload)
            self._entries[key] = ent
            self.stats["unique_puts"] += 1
            self.stats["bytes_current"] += ent.nbytes
            self.stats["bytes_peak"] = max(self.stats["bytes_peak"],
                                           self.stats["bytes_current"])
        else:
            self.stats["dedup_hits"] += 1
        ent.refs += 1
        ent.idle_stamp += 1  # invalidate any pending expiry record
        self.stats["puts"] += 1
        self.stats["logical_bytes_current"] += int(nbytes)
        self.stats["logical_bytes_peak"] = max(
            self.stats["logical_bytes_peak"],
            self.stats["logical_bytes_current"])
        if self.capacity_bytes is not None:
            self._enforce_capacity()
        return ClaimCheck(key=key, shape=shape, dtype=dtype,
                          nbytes=int(nbytes))

    def _enforce_capacity(self) -> None:
        """Spill idle payloads (oldest pending expiry first) until the
        physical footprint fits ``capacity_bytes``."""
        while (self.stats["bytes_current"] > self.capacity_bytes
               and self._expiry):
            _, key, stamp = self._expiry.popleft()
            ent = self._entries.get(key)
            if ent is None or ent.refs != 0 or ent.idle_stamp != stamp:
                continue  # stale record — the payload was re-acquired
            del self._entries[key]
            self.stats["evictions"] += 1
            self.stats["spills"] += 1
            self.stats["spill_bytes"] += ent.nbytes
            self.stats["bytes_current"] -= ent.nbytes

    # -- resolve ---------------------------------------------------------
    def get(self, ref: ClaimCheck) -> Any:
        """Resolve a claim to the stored payload object (no copy).

        In integrity mode the payload is re-digested and compared to the
        publish-time checksum first; a mismatch raises
        :class:`ArtifactCorrupted` so the caller can re-derive the bytes
        from the source instead of serving garbage."""
        ent = self._entries.get(ref.key)
        if ent is None:
            raise KeyError(f"artifact {ref.key!r} not in store "
                           "(evicted while referenced?)")
        if (self.integrity and ent.checksum is not None
                and _payload_checksum(ent.payload) != ent.checksum):
            self.stats["corruptions_detected"] += 1
            raise ArtifactCorrupted(ref.key)
        self.stats["gets"] += 1
        return ent.payload

    # -- integrity / chaos -----------------------------------------------
    def corrupt(self, key: str) -> None:
        """Replace the stored payload by a copy with its first 8 bytes
        flipped, on the payload's own device and in its own dtype (chaos
        injection); a bundle still in flight keeps the old bytes.

        Models bit rot / a bad storage-tier write: the claim metadata and
        refcounts are untouched, only the payload bytes change, so the
        fault is invisible until an integrity-checked ``get``."""
        ent = self._entries.get(key)
        if ent is None:
            raise KeyError(f"corrupt of absent artifact {key!r}")
        if isinstance(ent.payload, torch.Tensor):
            # a copy on the payload's own device: an in-flight bundle that
            # still holds the old tensor keeps its bytes
            arr = ent.payload.detach().clone().contiguous()
            flat = arr.reshape(-1).view(torch.uint8)
            flat[: min(8, flat.numel())] ^= 0xFF
        else:
            arr = np.asarray(ent.payload).copy()
            flat = arr.reshape(-1).view(np.uint8)
            flat[: min(8, flat.size)] ^= 0xFF
        ent.payload = arr
        self.stats["corruptions_injected"] += 1

    def repair(self, key: str, payload: Any) -> None:
        """Replace a corrupted payload with a re-derived copy.

        The caller re-derives the bytes from the source chunk (encoding
        is deterministic, so the repaired payload is bitwise the
        original); refcounts and expiry state carry over unchanged."""
        ent = self._entries.get(key)
        if ent is None:
            raise KeyError(f"repair of absent artifact {key!r}")
        ent.payload = payload
        if self.integrity:
            ent.checksum = _payload_checksum(payload)
        self.stats["corruptions_repaired"] += 1

    def release(self, ref: ClaimCheck, now: float = 0.0) -> None:
        """Drop one claim; the payload becomes evictable once refs hit 0."""
        ent = self._entries.get(ref.key)
        if ent is None or ent.refs <= 0:
            raise KeyError(f"release of unheld artifact {ref.key!r}")
        ent.refs -= 1
        self.stats["releases"] += 1
        self.stats["logical_bytes_current"] -= ref.nbytes
        if ent.refs == 0:
            ent.idle_since = now
            ent.idle_stamp += 1
            self._expiry.append((now + self.ttl, ref.key, ent.idle_stamp))

    # -- GC --------------------------------------------------------------
    def sweep(self, now: float) -> int:
        """Evict payloads unreferenced for >= ttl; O(1) amortised."""
        evicted = 0
        while self._expiry and self._expiry[0][0] <= now:
            _, key, stamp = self._expiry.popleft()
            ent = self._entries.get(key)
            # honour the record only if the entry is still idle *from the
            # same release*: a referenced payload is never evicted
            if ent is not None and ent.refs == 0 and ent.idle_stamp == stamp:
                del self._entries[key]
                self.stats["evictions"] += 1
                self.stats["bytes_current"] -= ent.nbytes
                evicted += 1
        return evicted

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def refs(self, key: str) -> int:
        ent = self._entries.get(key)
        return ent.refs if ent is not None else 0

    def live_refs(self) -> Dict[str, int]:
        """Keys still holding claims — must be empty at ``drain()``."""
        return {k: e.refs for k, e in self._entries.items() if e.refs > 0}

    def report(self) -> Dict[str, float]:
        out = dict(self.stats)
        out["entries"] = float(len(self._entries))
        out["bytes_saved_peak"] = (out["logical_bytes_peak"]
                                   - out["bytes_peak"])
        return out
