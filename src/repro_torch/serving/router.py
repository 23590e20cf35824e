"""Request router / load balancer (the cloud ML server's load balancer in
Fig. 3): routes requests across executor replicas with health checks and
least-loaded selection; integrates with the autoscaler.

Scaling has two units: ``scale_unit="devices"`` grows the picked replica's
simulated device pool in place (the pre-SLO behaviour), while
``scale_unit="replicas"`` adds/removes whole executor replicas through
``replica_factory`` — the cloud ML server's autoscaled replica pool, which
the graph scheduler shards batches across.

Two pick policies: ``"least"`` scans every healthy replica for the lowest
(inflight, earliest-free-device) load — exact, but O(R) of *coordinated*
state per dispatch, which is the contended read when many scheduler shards
share one pool.  ``"p2c"`` is power-of-two-choices: sample two distinct
healthy replicas and take the less loaded, which keeps max load within
O(log log R) of optimal while touching only two replicas' state.  The
sample stream is seeded and deterministic, so sharded runs stay
reproducible; with a single replica both policies degenerate to it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.autoscaler import Autoscaler
from repro_torch.serving.executor import Executor
from repro_torch.serving.monitor import Monitor


@dataclass
class Replica:
    executor: Executor
    uid: int = 0          # stable identity: pool positions shift on scaling
    healthy: bool = True
    inflight: int = 0
    served: int = 0
    # serverless spin-up state: a replica is COLD (spinning up) until the
    # simulated clock reaches ready_at, WARM after.  Initial replicas are
    # warm from t=0; scale-up/prewarm sets ready_at = now + cold_start_s.
    # A spinning replica is healthy and routable — its devices are just
    # busy until ready_at — so it participates in hedging and fault
    # handling like any other pool member.
    ready_at: float = 0.0
    # EWMA of observed per-frame service time; the scheduler's hedge
    # decision compares it against the nominal profile rate to spot a
    # straggling replica.  None until the first dispatch completes, and
    # reset on re-admission — stale pre-outage load stats must not starve
    # (or mis-hedge) a recovered replica.
    rate_ewma: Optional[float] = None


class Router:
    """Least-loaded routing with health checks over executor replicas."""

    def __init__(self, replicas: List[Executor],
                 monitor: Optional[Monitor] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 scale_unit: str = "devices",
                 replica_factory: Optional[Callable[[int], Executor]] = None,
                 cold_start_s: float = 0.0,
                 pick_policy: str = "least", pick_seed: int = 0):
        assert scale_unit in ("devices", "replicas")
        assert pick_policy in ("least", "p2c")
        self.pick_policy = pick_policy
        self._pick_rng = np.random.default_rng(pick_seed)
        self.replicas = [Replica(e, uid=i) for i, e in enumerate(replicas)]
        self._next_uid = len(self.replicas)
        self.monitor = monitor or Monitor()
        self.autoscaler = autoscaler
        self.scale_unit = scale_unit
        self.replica_factory = replica_factory
        # serverless container spin-up: a replica added at simulated time t
        # serves its first request no earlier than t + cold_start_s (its
        # devices start busy, not free-at-t=0)
        self.cold_start_s = cold_start_s
        # optional tenancy CostModel: when set, every pool-size change is
        # observed as a (t, healthy) point so provisioned replica-seconds
        # (keep-alive spend) can be integrated at report time
        self.cost_model = None
        self._queue: List[Tuple[str, tuple, dict, float]] = []
        self.clock = 0.0
        self.timeouts = 0     # dispatches that exceeded their SLO timeout

    # ------------------------------------------------------------------
    def mark_unhealthy(self, idx: int, now: Optional[float] = None) -> None:
        """Fail a replica.  Passing ``now`` closes the keep-alive billing
        interval at the failure time — a dead replica stops accruing
        provisioned replica-seconds immediately, not at the next
        ``scale_replicas`` sweep."""
        self.replicas[idx].healthy = False
        self.monitor.incr("health_check_failures")
        if now is not None and self.cost_model is not None:
            self.cost_model.observe_pool(now, self.healthy_count())

    def mark_healthy(self, idx: int) -> None:
        self.replicas[idx].healthy = True

    def readmit(self, idx: int, now: float) -> bool:
        """Bring a flapped replica back into rotation at simulated ``now``.

        Load state accumulated before the outage is stale — inflight
        counts, the service-rate EWMA, and device busy horizons all
        describe a replica that no longer exists — so everything resets;
        its devices come up free at ``now``.  Returns False if the
        replica was already healthy (duplicate probe chains no-op)."""
        rep = self.replicas[idx]
        if rep.healthy:
            return False
        rep.healthy = True
        rep.inflight = 0
        rep.rate_ewma = None
        ex = rep.executor
        # a replica flapped *mid-spin-up* was never warm: re-admission
        # resumes the remaining spin-up (devices free at ready_at), it
        # does not skip it.  Warm replicas (ready_at <= now) come up free
        # at `now` exactly as before.
        ex.busy_until = [max(now, rep.ready_at)] * len(ex.busy_until)
        ex.clock = max(ex.clock, now)
        self.monitor.incr("replica_readmits")
        if self.cost_model is not None:
            self.cost_model.observe_pool(now, self.healthy_count())
        return True

    def healthy_count(self) -> int:
        return sum(r.healthy for r in self.replicas)

    def warm_count(self, now: float) -> int:
        """Healthy replicas whose spin-up has completed at ``now``."""
        return sum(r.healthy and r.ready_at <= now + 1e-12
                   for r in self.replicas)

    def spinning_count(self, now: float) -> int:
        """Healthy replicas still inside their spin-up window at ``now``
        (spin-up-in-progress — provisioned, billed, but not warm yet)."""
        return sum(r.healthy and r.ready_at > now + 1e-12
                   for r in self.replicas)

    def pick(self) -> Optional[int]:
        healthy = [i for i, r in enumerate(self.replicas) if r.healthy]
        if not healthy:
            return None
        if self.pick_policy == "p2c" and len(healthy) > 2:
            # power-of-two-choices on queue depth: two deterministic
            # samples, pick the less loaded of the pair
            a, b = self._pick_rng.choice(len(healthy), size=2,
                                         replace=False)
            healthy = [healthy[int(a)], healthy[int(b)]]
        # least-loaded: fewest inflight, then earliest-free device
        load = [(self.replicas[i].inflight,
                 min(self.replicas[i].executor.busy_until), i)
                for i in healthy]
        return min(load)[2]

    # ------------------------------------------------------------------
    def scale_replicas(self, target: int,
                       now: Optional[float] = None,
                       prewarm: bool = False) -> None:
        """Grow/shrink the pool to ``target`` *healthy* replicas
        (``scale_unit="replicas"``): dead replicas hold no capacity, so
        they are swept out first and never counted toward the target.

        A replica added at simulated ``now`` models serverless container
        spin-up: its devices come up busy until ``now + cold_start_s``
        instead of free-at-t=0.  ``prewarm=True`` tags the additions as
        warm-pool prewarms (the :class:`WarmPoolPolicy` spinning replicas
        up *ahead* of forecast demand, so they are warm when it lands) —
        the mechanics are identical, only the monitoring differs."""
        target = max(1, target)
        now = self.clock if now is None else now
        for i in range(len(self.replicas) - 1, 0, -1):
            if (not self.replicas[i].healthy
                    and self.replicas[i].inflight == 0):
                self.replicas.pop(i)
                self.monitor.incr("replicas_removed")
        while (self.healthy_count() < target
               and self.replica_factory is not None):
            uid = self._next_uid
            self._next_uid += 1
            ex = self.replica_factory(uid)
            ready_at = now + self.cold_start_s
            ex.clock = max(ex.clock, now)
            ex.busy_until = [ready_at] * len(ex.busy_until)
            self.replicas.append(Replica(ex, uid=uid, ready_at=ready_at))
            self.monitor.incr("replicas_added")
            if prewarm:
                self.monitor.incr("replicas_prewarmed")
                self.monitor.record("replica_prewarm", self.cold_start_s,
                                    now)
            if self.cold_start_s > 0:
                self.monitor.record("replica_cold_start", self.cold_start_s,
                                    now)
        while self.healthy_count() > target:
            # retire idle healthy replicas from the tail; replica 0 is the
            # primary and always survives (schedulers hold a reference)
            idx = next((i for i in range(len(self.replicas) - 1, 0, -1)
                        if self.replicas[i].inflight == 0
                        and self.replicas[i].healthy), None)
            if idx is None:
                break
            self.replicas.pop(idx)
            self.monitor.incr("replicas_removed")
        if self.cost_model is not None:
            self.cost_model.observe_pool(now, self.healthy_count())

    # ------------------------------------------------------------------
    def route(self, fn_name: str, *args, now: Optional[float] = None,
              model_time: Optional[float] = None,
              queue_depth: Optional[int] = None,
              replica: Optional[int] = None,
              timeout: Optional[float] = None, **kw):
        """Dispatch one request; returns (result, completion_time, replica).

        ``queue_depth`` lets callers that maintain a real request queue
        (e.g. the cross-stream graph scheduler) feed the autoscaler the
        actual backlog instead of the per-replica busy-time heuristic.
        ``replica`` pins the request to a specific replica (the scheduler
        uses this after its own pick + fault check).  ``timeout`` is the
        flush's SLO slack: a dispatch whose completion exceeds
        ``now + timeout`` is counted (the scheduler's hedging layer is
        what actually covers the miss)."""
        now = self.clock if now is None else now
        self.clock = max(self.clock, now)
        idx = self.pick() if replica is None else replica
        if idx is None:
            raise RuntimeError("no healthy replicas")
        rep = self.replicas[idx]
        rep.inflight += 1
        try:
            result, done = rep.executor.run(fn_name, *args, now=now,
                                            model_time=model_time, **kw)
        finally:
            rep.inflight -= 1
        rep.served += 1
        if timeout is not None and done - now > timeout + 1e-12:
            self.timeouts += 1
            self.monitor.incr("route_timeouts")
        self.monitor.record("route_latency", done - now, now)
        self.monitor.incr(f"served_replica_{idx}")
        if self.autoscaler is not None:
            if queue_depth is None:
                # queue pressure = backlog seconds ahead of `now`, in units
                # of this request's service time
                backlog = max(0.0, min(rep.executor.busy_until) - now)
                unit = model_time if model_time else max(done - now, 1e-9)
                queue = int(backlog / max(unit, 1e-9))
            else:
                queue = queue_depth
            if self.scale_unit == "replicas":
                # capacity = healthy replicas: a dead one still in the pool
                # must not be counted as provisioned capacity
                current = self.healthy_count()
                target = self.autoscaler.decide(done, queue, current)
                if target != current:
                    self.scale_replicas(target, now=done)
            else:
                target = self.autoscaler.decide(done, queue,
                                                rep.executor.num_devices)
                if target != rep.executor.num_devices:
                    rep.executor.scale_to(target)
        return result, done, idx

    def hedge(self, idx: int, now: float, model_time: float
              ) -> Tuple[float, float]:
        """Book a speculative duplicate of an already-routed dispatch on
        replica ``idx``: occupies real device time and counts as served
        (a hedge is a real invocation) but does not re-run the function —
        the primary's result is bitwise-reused, only the completion time
        race differs.  Returns ``(start, done)``."""
        rep = self.replicas[idx]
        rep.served += 1
        start, done = rep.executor.occupy("hedge", now=now,
                                          model_time=model_time)
        self.monitor.incr(f"served_replica_{idx}")
        return start, done

    def load_report(self) -> Dict[str, float]:
        total = sum(r.served for r in self.replicas) or 1
        shares = [r.served / total for r in self.replicas]
        # Jain's fairness index: 1.0 = perfectly balanced
        fairness = (sum(shares) ** 2 /
                    (len(shares) * sum(s ** 2 for s in shares))
                    if any(shares) else 1.0)
        return {"served": total, "fairness": fairness,
                "replicas": len(self.replicas),
                "healthy": sum(r.healthy for r in self.replicas)}
