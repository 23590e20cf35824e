"""Provisioner / autoscaler (Fig. 16): scale the cloud GPU pool with load.

The decision is unit-agnostic: ``decide`` maps (queue backlog, current
capacity) -> new capacity.  The ``Router`` applies it either to a replica's
simulated *device* pool (``scale_unit="devices"``) or to the number of
whole executor *replicas* in its pool (``scale_unit="replicas"`` — the
cloud ML server's autoscaled replica pool that batches are sharded
across).  ``unit`` only labels the trace for monitoring."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Autoscaler:
    min_devices: int = 1
    max_devices: int = 8
    target_queue_per_device: float = 2.0
    scale_down_queue: float = 0.5
    cooldown_s: float = 2.0
    unit: str = "devices"         # "devices" | "replicas" (trace label)

    _last_change: float = -1e9
    history: List[Dict[str, float]] = field(default_factory=list)

    def decide(self, now: float, queue_len: int, devices: int) -> int:
        """Returns the new device count."""
        new = devices
        per_dev = queue_len / max(devices, 1)
        if per_dev > self.target_queue_per_device:
            new = min(self.max_devices, devices + 1 + int(
                per_dev // (2 * self.target_queue_per_device)))
        elif per_dev < self.scale_down_queue and devices > self.min_devices:
            new = devices - 1
        if new != devices and now - self._last_change < self.cooldown_s:
            new = devices
        if new != devices:
            self._last_change = now
        self.history.append({"t": now, "queue": queue_len,
                             "devices": devices, "new_devices": new})
        return new

    def summary(self) -> Dict[str, float]:
        """Aggregate view of the scaling trace (for benchmarks/monitoring)."""
        if not self.history:
            return {"decisions": 0, "peak_queue": 0, "peak_devices": 0,
                    "scale_ups": 0, "scale_downs": 0, "unit": self.unit}
        return {
            "unit": self.unit,
            "decisions": len(self.history),
            "peak_queue": max(h["queue"] for h in self.history),
            "peak_devices": max(h["new_devices"] for h in self.history),
            "scale_ups": sum(h["new_devices"] > h["devices"]
                             for h in self.history),
            "scale_downs": sum(h["new_devices"] < h["devices"]
                               for h in self.history),
        }


class DiurnalForecaster:
    """Per-tenant arrival-rate forecaster on the simulated clock.

    Arrivals are accumulated into fixed ``bin_s`` buckets.  Two estimators
    run over the bin series:

    * an **EWMA rate** — the reactive fallback, always available;
    * a **diurnal profile** — once ≥2 periods of history exist, a
      normalized autocorrelation scan over candidate lags detects the
      dominant period (smallest lag within 95% of the best correlation,
      so harmonics at 2L/3L never shadow the fundamental).  The per-phase
      mean of the bins then forecasts the rate at any *future* simulated
      time, which is what lets the warm pool spin replicas up *before* a
      burst instead of reacting to its backlog.

    Everything is pure python over a few hundred bins — deterministic and
    cheap enough to re-run per arrival (results are memoized on the
    observation count)."""

    def __init__(self, bin_s: float = 0.25, ewma_alpha: float = 0.3,
                 min_corr: float = 0.5, burst_frac: float = 0.5,
                 max_period_bins: int = 512):
        self.bin_s = bin_s
        self.ewma_alpha = ewma_alpha
        self.min_corr = min_corr
        self.burst_frac = burst_frac
        self.max_period_bins = max_period_bins
        self._bins: List[float] = []
        self.observations = 0
        self._cache_key: Tuple[int, int] = (-1, -1)
        self._cache: Tuple[Optional[int], Optional[List[float]]] = (None,
                                                                    None)

    def observe(self, t: float, frames: float) -> None:
        idx = max(0, int(t / self.bin_s))
        while len(self._bins) <= idx:
            self._bins.append(0.0)
        self._bins[idx] += float(frames)
        self.observations += 1

    # -- estimators ------------------------------------------------------
    def ewma_rate(self) -> float:
        """EWMA arrival rate (frames/s) over the whole bin history — empty
        bins decay it, so a quiet stretch reads as a low rate."""
        e = 0.0
        for v in self._bins:
            e += self.ewma_alpha * (v - e)
        return e / self.bin_s

    def _analyze(self) -> Tuple[Optional[int], Optional[List[float]]]:
        """(period_bins, per-phase mean profile), memoized; (None, None)
        until a period is detectable."""
        key = (len(self._bins), self.observations)
        if key == self._cache_key:
            return self._cache
        x, n = self._bins, len(self._bins)
        best_lag: Optional[int] = None
        if n >= 8:
            mu = sum(x) / n
            var = sum((v - mu) ** 2 for v in x) / n
            if var > 1e-12:
                max_lag = min(n // 2, self.max_period_bins)
                corr: Dict[int, float] = {}
                best_r = 0.0
                for lag in range(2, max_lag + 1):
                    m = n - lag
                    # biased ACF estimator (divide by n, not m): overlap
                    # shrinkage damps long lags, so a harmonic at 2L can
                    # never outscore the fundamental on sparse history
                    c = sum((x[i] - mu) * (x[i + lag] - mu)
                            for i in range(m)) / (n * var)
                    corr[lag] = c
                    if c > best_r:
                        best_r, best_lag = c, lag
                if best_lag is None or best_r < self.min_corr:
                    best_lag = None
                else:
                    for lag in sorted(corr):
                        if corr[lag] >= 0.95 * best_r:
                            best_lag = lag
                            break
        profile: Optional[List[float]] = None
        if best_lag:
            length = best_lag
            periods = n // length
            profile = [
                sum(x[p * length + i] for p in range(periods)) / periods
                for i in range(length)]
        self._cache_key = key
        self._cache = (best_lag, profile)
        return self._cache

    @property
    def period_s(self) -> Optional[float]:
        lag, _ = self._analyze()
        return lag * self.bin_s if lag else None

    def rate_at(self, t: float) -> float:
        """Forecast arrival rate (frames/s) at simulated ``t`` — the
        diurnal profile when detected, the EWMA fallback otherwise."""
        lag, profile = self._analyze()
        if lag:
            return profile[int(t / self.bin_s) % lag] / self.bin_s
        return self.ewma_rate()

    def volume_in_window(self, t0: float, t1: float) -> float:
        """Forecast frames arriving in ``[t0, t1)``."""
        if t1 <= t0:
            return 0.0
        lag, profile = self._analyze()
        if not lag:
            return self.ewma_rate() * (t1 - t0)
        b0, b1 = int(t0 / self.bin_s), int(math.ceil(t1 / self.bin_s))
        return sum(profile[k % lag] for k in range(b0, b1))

    def _thr(self, profile: List[float]) -> float:
        return self.burst_frac * max(profile)

    def next_burst_after(self, t: float) -> Optional[float]:
        """Predicted start of the next burst strictly after ``t`` (rising
        edge of the profile through ``burst_frac * peak``), or ``None``
        while no period is detected."""
        lag, profile = self._analyze()
        if not lag or max(profile) <= 0:
            return None
        thr = self._thr(profile)
        k0 = int(t / self.bin_s)
        for k in range(k0 + 1, k0 + 2 * lag + 1):
            if profile[k % lag] >= thr and profile[(k - 1) % lag] < thr:
                return k * self.bin_s
        return None

    def burst_end_after(self, t: float) -> Optional[float]:
        """Predicted end of the burst active at/after ``t`` (falling
        edge), or ``None`` while no period is detected."""
        lag, profile = self._analyze()
        if not lag or max(profile) <= 0:
            return None
        thr = self._thr(profile)
        k0 = int(t / self.bin_s)
        for k in range(k0 + 1, k0 + 2 * lag + 1):
            if profile[k % lag] < thr and profile[(k - 1) % lag] >= thr:
                return k * self.bin_s
        return None


@dataclass
class WarmPoolPolicy:
    """Predictive warm-pool management: prewarm ahead of forecast bursts,
    keep-alive sized by the break-even $ tradeoff.

    Two decisions, both driven by per-tenant :class:`DiurnalForecaster`
    state fed from the scheduler's arrival events:

    * **Prewarm-ahead**: when the forecast sees the next burst, the
      scheduler fires a warm check ``cold_start_s + prewarm_margin_s``
      *before* its predicted start, so spin-up completes off the critical
      path and the burst lands on warm replicas.
    * **Keep-alive vs cold start**: holding a replica warm costs
      ``replica_rate_usd_s`` $/s; letting it go cold risks one SLO miss
      worth ``miss_value_usd`` when demand returns.  The break-even
      horizon is ``miss_value_usd / replica_rate_usd_s`` seconds: a pool
      is kept warm through gaps shorter than that, and shed to
      ``min_replicas`` across longer gaps (the prewarm-ahead check
      restores it in time, so the cold start still stays off the
      critical path).

    ``enabled=False`` (or simply not attaching a policy) disables every
    decision — the serving plane then stays bitwise-identical to the
    policy-free scheduler; ``bench_coldstart`` gates this at 1 and K
    shards.  One policy instance is shared across scheduler shards, like
    the router it steers."""
    cold_start_s: float = 0.0
    replica_rate_usd_s: float = 0.004   # keep-alive $/replica-s (CostModel)
    miss_value_usd: float = 0.004       # $ value of one cold-start SLO miss
    frame_service_s: float = 1.0 / 75.0
    slo_slack_s: float = 0.5            # drain budget for a forecast burst
    min_replicas: int = 1
    max_replicas: int = 8
    prewarm_margin_s: float = 0.05      # spin-up must land before the burst
    drain_margin_s: float = 0.5         # shed check delay after a burst end
    bin_s: float = 0.25
    enabled: bool = True
    # forecast checks allowed per observation epoch: one shed (after the
    # current burst drains) + one prewarm (ahead of the next burst); the
    # cap is what makes the check chain terminate when traffic stops
    max_checks_per_obs: int = 2

    forecasters: Dict[str, DiurnalForecaster] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=lambda: {
        "observations": 0, "checks": 0})
    _pending: Optional[float] = None
    _fires_since_obs: int = 0

    # -- economics -------------------------------------------------------
    @property
    def keep_warm_horizon_s(self) -> float:
        """Break-even idle gap: keep-alive for longer than this costs more
        than the cold start it avoids."""
        return self.miss_value_usd / max(self.replica_rate_usd_s, 1e-9)

    def _clamp(self, n: int) -> int:
        return min(self.max_replicas, max(self.min_replicas, n))

    # -- forecast feed ---------------------------------------------------
    def observe(self, t: float, frames: float,
                tenant: str = "default") -> None:
        fc = self.forecasters.get(tenant)
        if fc is None:
            fc = self.forecasters[tenant] = DiurnalForecaster(
                bin_s=self.bin_s)
        fc.observe(t, frames)
        self.stats["observations"] += 1
        self._fires_since_obs = 0

    def rate_at(self, t: float) -> float:
        return sum(fc.rate_at(t) for fc in self.forecasters.values())

    def volume_in_window(self, t0: float, t1: float) -> float:
        return sum(fc.volume_in_window(t0, t1)
                   for fc in self.forecasters.values())

    def next_burst_after(self, t: float) -> Optional[float]:
        ts = [fc.next_burst_after(t) for fc in self.forecasters.values()]
        ts = [x for x in ts if x is not None]
        return min(ts) if ts else None

    def burst_end_after(self, t: float) -> Optional[float]:
        ts = [fc.burst_end_after(t) for fc in self.forecasters.values()]
        ts = [x for x in ts if x is not None]
        return min(ts) if ts else None

    # -- pool sizing -----------------------------------------------------
    def target_replicas(self, now: float) -> int:
        """Warm replicas the pool should hold at ``now``.

        Imminent forecast demand (arrivals inside the spin-up lookahead
        plus the drain budget) sizes the pool to drain that volume within
        ``slo_slack_s``.  With nothing imminent, the break-even rule
        applies: hold the next burst's pool through a gap shorter than
        ``keep_warm_horizon_s``, shed to ``min_replicas`` otherwise."""
        if not self.enabled:
            return self.min_replicas
        look = self.cold_start_s + self.prewarm_margin_s + max(
            self.slo_slack_s, self.bin_s)
        vol = self.volume_in_window(now, now + look)
        if vol > 0:
            return self._clamp(int(math.ceil(
                vol * self.frame_service_s / max(self.slo_slack_s, 1e-6))))
        nb = self.next_burst_after(now)
        if nb is not None and nb - now <= self.keep_warm_horizon_s:
            vol = self.volume_in_window(nb, nb + max(self.slo_slack_s,
                                                     self.bin_s))
            return self._clamp(int(math.ceil(
                vol * self.frame_service_s / max(self.slo_slack_s, 1e-6))))
        return self.min_replicas

    # -- check scheduling (the scheduler turns these into events) --------
    def next_check(self, now: float) -> Optional[float]:
        """Simulated time of the next warm-pool check, or ``None``.

        At most one check is outstanding at a time, and at most
        ``max_checks_per_obs`` fire per observation epoch (shed after the
        current burst drains, prewarm ahead of the next one) — new
        arrivals reset the budget, so the chain is self-sustaining under
        live traffic and self-terminating when traffic stops."""
        if not self.enabled or self._pending is not None \
                or self._fires_since_obs >= self.max_checks_per_obs:
            return None
        cands = []
        be = self.burst_end_after(now)
        if be is not None:
            cands.append(be + self.drain_margin_s)
        nb = self.next_burst_after(now)
        if nb is not None:
            cands.append(nb - self.cold_start_s - self.prewarm_margin_s)
        if self._fires_since_obs > 0:
            # a check just fired at `now`: only strictly-future candidates
            # may chain, so a late prewarm can't re-fire in place and burn
            # the epoch's remaining slot
            cands = [c for c in cands if c > now + 1e-9]
        if not cands:
            return None
        t = max(now, min(cands))
        self._pending = t
        self.stats["checks"] += 1
        return t

    def fired(self) -> None:
        """A scheduled check fired (scheduler callback)."""
        self._pending = None
        self._fires_since_obs += 1


@dataclass
class CostAwareAutoscaler(Autoscaler):
    """Scale the replica pool to minimise $ subject to SLO attainment.

    Replaces the queue-depth heuristic with an explicit economic objective:

    * **Upward** pressure is SLO-driven.  The pool needed to drain the
      (EWMA-smoothed) backlog within the per-chunk SLO slack is
      ``ceil(demand * frame_service_s / (slo_slack_s - cold_start_s))`` —
      the cold-start term discounts the slack because a replica spun up
      *now* contributes nothing for ``cold_start_s`` simulated seconds
      (``Router(cold_start_s=)``).  When that exceeds the current pool we
      scale up immediately: an SLO miss is priced at ``miss_value_usd``
      per chunk, which dominates keep-alive for any sane price book.
    * **Downward** pressure is keep-alive cost.  Retiring one replica
      saves ``replica_rate_usd_s`` $/s, but if demand returns we pay the
      cold-start latency (valued at ``miss_value_usd``).  The break-even
      idle horizon is ``miss_value_usd / replica_rate_usd_s`` seconds —
      we shed a replica only after demand has stayed below the smaller
      pool's capacity for that long, one replica at a time.

    With a :class:`WarmPoolPolicy` attached (``warm_pool=``), the upward
    demand signal comes from the policy's *forecast* instead of only the
    observed backlog: ``needed`` is floored at the forecast pool target,
    so the pool is already sized for a predicted burst before its queue
    materializes, and the break-even scale-down never undercuts the warm
    floor the policy wants held ahead of the next burst.  A ``None`` (or
    disabled) policy leaves every decision bitwise-identical to the
    backlog-reactive behaviour.

    History rows keep the base-class keys so ``summary()`` and the
    schedulers' ``peak_devices``/``peak_queue`` reporting work unchanged.
    """
    replica_rate_usd_s: float = 0.004   # keep-alive $ per replica-second
    frame_service_s: float = 1.0 / 75.0  # service time per queued frame
    slo_slack_s: float = 1.0            # per-chunk latency budget to drain
    cold_start_s: float = 0.0           # mirror of Router(cold_start_s=)
    miss_value_usd: float = 0.004       # $ value assigned to one SLO miss
    ewma_alpha: float = 0.4
    warm_pool: Optional[WarmPoolPolicy] = None

    _ewma_queue: float = 0.0
    _low_since: Optional[float] = None

    def decide(self, now: float, queue_len: int, devices: int) -> int:
        self._ewma_queue += self.ewma_alpha * (queue_len - self._ewma_queue)
        demand = max(float(queue_len), self._ewma_queue)
        headroom = max(self.slo_slack_s - self.cold_start_s, 1e-6)
        needed = math.ceil(demand * self.frame_service_s / headroom)
        if self.warm_pool is not None and self.warm_pool.enabled:
            needed = max(needed, self.warm_pool.target_replicas(now))
        needed = min(self.max_devices, max(self.min_devices, needed))
        new = devices
        if needed > devices:
            new = needed
            self._low_since = None
        elif needed < devices:
            grace = self.miss_value_usd / max(self.replica_rate_usd_s, 1e-9)
            if self._low_since is None:
                self._low_since = now
            if now - self._low_since >= grace and devices > self.min_devices:
                new = devices - 1
                self._low_since = now
        else:
            self._low_since = None
        self.history.append({"t": now, "queue": queue_len,
                             "devices": devices, "new_devices": new,
                             "needed": needed,
                             "ewma_queue": self._ewma_queue})
        return new
