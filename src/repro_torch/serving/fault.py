"""Fault tolerance and chaos injection for the cloud-fog serving plane.

The original Fig. 15 reproduction modelled two failure domains (a binary
WAN outage detected by heartbeats, and a replica dying permanently
mid-run).  Real cloud-fog deployments fail mostly through *degraded*
states, so :class:`FaultInjector` generalizes the schedule to six domains,
all on the simulated clock:

* **WAN outage** (the original Fig. 15 path): the whole cloud link drops;
  heartbeats detect it and chunks run on the fog fallback detector.
* **Permanent replica outage**: one detector replica in the cloud pool
  dies mid-run and never returns.  The graph scheduler consults
  ``replica_down`` / ``fail_time_in`` before and during each sub-batch
  dispatch; a failed replica's sub-batch is re-queued to surviving
  replicas (or the fog fallback when none survive) with no chunk lost.
* **Transient replica flaps** (``flap_replica``): down-then-up windows.
  A flapped replica is detected like a dead one, but the scheduler
  schedules health probes with exponential backoff and *re-admits* the
  replica (load stats reset) once a probe finds it up.
* **Stragglers** (``add_straggler``): per-replica service-time
  multipliers over a window.  The replica stays healthy but slow; the
  scheduler's hedged dispatch covers the tail.
* **Link brownouts** (``inject_brownout``): bandwidth/RTT degradation
  factors pushed onto :class:`~repro_torch.core.bandwidth.NetworkModel` —
  transfers get slower without the link going down.
* **Artifact corruption** (``inject_corruption``): a stored payload's
  bytes are flipped at a scheduled time; the content-hash check in
  :meth:`~repro_torch.serving.ingest.ArtifactStore.get` detects it at flush
  assembly and the scheduler re-derives the payload from the source
  chunk (a forced re-put) instead of serving garbage.

The base :class:`FaultTolerantCoordinator` keeps the original two-domain
behaviour and API; the scheduler calls the generalized queries
(``fail_time_in``, ``service_multiplier``) which degrade to the old
semantics on the base class, so existing runs stay bitwise-identical.

Every replica-level domain is keyed by the router's *stable uid*, so
warm-pool prewarmed replicas (spun up ahead of forecast demand with
``ready_at`` in the future) are first-class fault-injection targets: a
flap scheduled on a prewarmed uid interrupts its spin-up, and
``Router.readmit`` resumes the *remaining* spin-up on recovery rather
than granting a free warm start."""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.bandwidth import NetworkModel


@dataclass
class FaultTolerantCoordinator:
    network: NetworkModel
    heartbeat_interval: float = 1.0
    failure_threshold: int = 2      # missed heartbeats before failover

    missed: int = 0
    mode: str = "cloud"             # "cloud" | "fog-fallback"
    events: List[dict] = field(default_factory=list)
    # replica uid -> simulated time at which it permanently fails.  Keyed
    # by the router's *stable* replica uid (initial replicas: uid == pool
    # index), never by pool position — autoscaling shifts positions, and a
    # scheduled outage must not migrate onto a later replica
    replica_fail_at: Dict[int, float] = field(default_factory=dict)

    # -- replica failure domain ------------------------------------------
    def fail_replica(self, uid: int, at: float = 0.0) -> None:
        """Schedule the replica with ``uid`` to die at simulated ``at``."""
        self.replica_fail_at[uid] = at

    def replica_fail_time(self, uid: int) -> Optional[float]:
        return self.replica_fail_at.get(uid)

    def replica_down(self, uid: int, now: float) -> bool:
        t = self.replica_fail_at.get(uid)
        return t is not None and now >= t

    def fail_time_in(self, uid: int, start: float, end: float
                     ) -> Optional[float]:
        """Earliest failure onset that interrupts a service occupying
        ``[start, end)`` on replica ``uid``, or ``None``.

        Base semantics match the original mid-service check: a permanent
        failure interrupts the service iff it fires before the service
        completes (a failure at/before dispatch time is caught earlier by
        ``replica_down``)."""
        t0 = self.replica_fail_at.get(uid)
        return t0 if (t0 is not None and t0 < end) else None

    def service_multiplier(self, uid: int, t: float) -> float:
        """Straggler factor for replica ``uid`` at ``t`` (base: none)."""
        return 1.0

    def note_replica_failure(self, uid: int, now: float,
                             requeued: int = 0) -> None:
        """Record a detected replica outage (called by the scheduler)."""
        self.events.append({"t": now, "event": "replica_failover",
                            "replica": uid, "requeued_chunks": requeued})

    def heartbeat(self, now: float) -> str:
        """Poll the cloud link; returns the current serving mode."""
        if self.network.up:
            if self.mode != "cloud":
                self.events.append({"t": now, "event": "recovered"})
            self.missed = 0
            self.mode = "cloud"
        else:
            self.missed += 1
            if self.missed >= self.failure_threshold and self.mode == "cloud":
                self.mode = "fog-fallback"
                self.events.append({"t": now, "event": "failover"})
        return self.mode

    def route(self, now: float, cloud_fn: Callable, fog_fn: Callable):
        """Run the chunk through whichever tier is healthy."""
        mode = self.heartbeat(now)
        return (cloud_fn() if mode == "cloud" else fog_fn()), mode


@dataclass
class FaultInjector(FaultTolerantCoordinator):
    """Multi-domain chaos schedule on the simulated clock.

    An injector with *nothing scheduled* behaves exactly like the base
    coordinator: every query degrades to the base semantics, so a
    scheduler with an idle injector attached stays bitwise-identical to
    the plain scheduler (``bench_chaos`` gates this)."""

    # uid -> sorted [(down, up)] windows during which the replica is down
    # but will recover (vs replica_fail_at's permanent death)
    flap_windows: Dict[int, List[Tuple[float, float]]] = field(
        default_factory=dict)
    # uid -> [(t0, t1, factor)] service-time multiplier windows
    straggler_windows: Dict[int, List[Tuple[float, float, float]]] = field(
        default_factory=dict)
    # sorted fire times of pending artifact corruptions
    _corruptions: List[float] = field(default_factory=list)
    corruptions_injected: int = 0

    # -- schedule construction -------------------------------------------
    def flap_replica(self, uid: int, down: float, up: float) -> None:
        """Replica ``uid`` is down during ``[down, up)`` then recovers."""
        assert up > down
        wins = self.flap_windows.setdefault(uid, [])
        bisect.insort(wins, (down, up))

    def add_straggler(self, uid: int, t0: float, t1: float,
                      factor: float) -> None:
        """Replica ``uid`` serves ``factor`` x slower during ``[t0, t1)``."""
        assert factor > 0 and t1 > t0
        self.straggler_windows.setdefault(uid, []).append((t0, t1, factor))

    def inject_brownout(self, t0: float, t1: float, *,
                        bw_factor: float = 1.0,
                        rtt_factor: float = 1.0) -> None:
        """Degrade the WAN link during ``[t0, t1)`` (bandwidth scaled by
        ``bw_factor``, RTT by ``rtt_factor``)."""
        self.network.brownouts.append((t0, t1, bw_factor, rtt_factor))
        self.events.append({"t": t0, "event": "brownout", "until": t1,
                            "bw_factor": bw_factor,
                            "rtt_factor": rtt_factor})

    def inject_corruption(self, at: float, count: int = 1) -> None:
        """Flip a stored payload's bytes at simulated ``at`` (``count``
        distinct payloads).  Applied by the scheduler at the first flush
        assembly at/after ``at``; the store's content-hash check must
        detect each one and force a re-derivation."""
        for _ in range(count):
            bisect.insort(self._corruptions, at)

    # -- scheduler-facing queries ----------------------------------------
    def due_corruptions(self, now: float,
                        limit: Optional[int] = None) -> int:
        """Pop and return the number of corruption faults due by ``now``.

        ``limit`` caps the pop at how many distinct stored payloads the
        caller can actually corrupt in this flush; the remainder stays
        queued for the next one, so ``corruptions_injected`` only ever
        counts faults that were really applied (the bench gate compares
        it against detected-and-repaired)."""
        n = bisect.bisect_right(self._corruptions, now)
        if limit is not None:
            n = min(n, limit)
        if n:
            del self._corruptions[:n]
            self.corruptions_injected += n
        return n

    def replica_down(self, uid: int, now: float) -> bool:
        if super().replica_down(uid, now):
            return True
        for down, up in self.flap_windows.get(uid, ()):
            if down <= now < up:
                return True
        return False

    def fail_time_in(self, uid: int, start: float, end: float
                     ) -> Optional[float]:
        onsets = []
        base = super().fail_time_in(uid, start, end)
        if base is not None:
            onsets.append(base)
        for down, up in self.flap_windows.get(uid, ()):
            # a flap interrupts the service iff its down-window overlaps
            # [start, end): onset before completion, recovery after start
            if down < end and up > start:
                onsets.append(down)
        return min(onsets) if onsets else None

    def down_until(self, uid: int, now: float) -> Optional[float]:
        """End of the flap window covering ``now`` for ``uid``, or ``None``
        if the replica is up (or permanently dead — no recovery time)."""
        for down, up in self.flap_windows.get(uid, ()):
            if down <= now < up:
                return up
        return None

    def transient(self, uid: int, now: float) -> bool:
        """True when the outage observed at ``now`` will recover (a flap
        rather than a permanent death) — the scheduler only spends probe
        events on replicas that can come back."""
        if super().replica_down(uid, now):
            return False
        return any(down <= now < up
                   for down, up in self.flap_windows.get(uid, ()))

    def service_multiplier(self, uid: int, t: float) -> float:
        m = 1.0
        for t0, t1, factor in self.straggler_windows.get(uid, ()):
            if t0 <= t < t1:
                m *= factor
        return m
