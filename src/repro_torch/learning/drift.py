"""Online drift detection over per-stream cascade statistics.

The fog classifier's confidence is the cascade's health signal: §V data
drift (object appearances change) leaves the cloud detector's localization
intact but collapses the one-vs-all readout, so the mean fog confidence on
uncertain regions — and the fog/cloud agreement rate — drop well before
accuracy numbers are available.  The detector keeps, per stream,

  * a **baseline** established over the first ``warmup`` chunks (and
    re-anchored by ``rebaseline`` after a successful model promotion),
  * an **EWMA** of the observed statistic,

and raises a :class:`DriftEvent` when the EWMA stays below
``baseline * (1 - threshold)`` for ``patience`` consecutive observations.
Events are **debounced**: after an event fires, no new event can fire for
``cooldown`` observations on that stream, so a noisy-but-drifted stream
raises one event per drift episode instead of one per chunk.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class DriftConfig:
    window: int = 8          # EWMA span (alpha = 2 / (window + 1))
    warmup: int = 4          # observations used to fix the baseline
    threshold: float = 0.15  # relative drop vs baseline that counts as drift
    patience: int = 2        # consecutive below-threshold obs before firing
    cooldown: int = 6        # observations an event suppresses further events
    # recovery bar as a fraction of baseline (None = halfway back inside
    # the drift threshold).  Decoupled from ``threshold`` because the two
    # pull opposite ways: a *detection* trip-wire must sit well below the
    # noise floor of the sentinel statistic, while an *episode-close* bar
    # (per-site adaptation stops drawing budget at recovery) can demand
    # nearly full restoration
    recover_frac: Optional[float] = None

    @property
    def alpha(self) -> float:
        return 2.0 / (self.window + 1.0)


@dataclass
class DriftEvent:
    stream: str
    t: float                 # simulated time of the triggering observation
    stat: float              # EWMA at trigger
    baseline: float
    severity: float          # relative drop (1 - stat / baseline)
    onset_t: float = 0.0     # first below-threshold observation this episode


@dataclass
class _StreamDrift:
    count: int = 0
    baseline_sum: float = 0.0
    baseline: Optional[float] = None
    ewma: Optional[float] = None
    below: int = 0           # consecutive below-threshold observations
    below_since: float = 0.0
    cooldown_left: int = 0


@dataclass
class _StreamHealth:
    a: float = 1.0               # Beta pseudo-count: correct verdicts
    b: float = 1.0               # Beta pseudo-count: wrong verdicts


class HealthPosterior:
    """Per-stream Beta posterior over sentinel-verdict correctness.

    The active sentinel scheduler spends oracle spot-checks where it is
    *least certain* about a stream's health, and the posterior standard
    deviation is that certainty: a stream with many consistent verdicts
    concentrates (low std, few checks buy little information); a stream
    with mixed verdicts — or one not checked for a while — stays or drifts
    back toward the flat prior (high std).  ``decay`` shrinks the
    pseudo-counts toward Beta(1, 1) once per observed chunk, so certainty
    is perishable and no stream is starved of checks forever."""

    def __init__(self, decay: float = 0.97):
        self.decay = decay
        self._streams: Dict[str, _StreamHealth] = {}

    def _state(self, stream: str) -> _StreamHealth:
        return self._streams.setdefault(stream, _StreamHealth())

    def observe_chunk(self, stream: str) -> None:
        """One chunk elapsed on ``stream``: age its pseudo-counts."""
        st = self._state(stream)
        st.a = 1.0 + (st.a - 1.0) * self.decay
        st.b = 1.0 + (st.b - 1.0) * self.decay

    def update(self, stream: str, correct: bool) -> None:
        st = self._state(stream)
        if correct:
            st.a += 1.0
        else:
            st.b += 1.0

    def mean(self, stream: str) -> float:
        st = self._state(stream)
        return st.a / (st.a + st.b)

    def std(self, stream: str) -> float:
        """Posterior standard deviation (unseen streams: the flat prior's
        maximum, so new streams are checked first)."""
        st = self._state(stream)
        n = st.a + st.b
        return float(np.sqrt(st.a * st.b / (n * n * (n + 1.0))))

    def streams(self) -> List[str]:
        return list(self._streams)


class DriftDetector:
    """Per-stream EWMA drift detector with debouncing."""

    def __init__(self, cfg: DriftConfig = DriftConfig()):
        self.cfg = cfg
        self._streams: Dict[str, _StreamDrift] = {}
        self.events: List[DriftEvent] = []

    def _state(self, stream: str) -> _StreamDrift:
        return self._streams.setdefault(stream, _StreamDrift())

    def baseline(self, stream: str) -> Optional[float]:
        return self._state(stream).baseline

    def ewma(self, stream: str) -> Optional[float]:
        return self._state(stream).ewma

    def rebaseline(self, stream: str) -> None:
        """Re-anchor the baseline to the current EWMA (after recovery a new
        drift episode must be judged against the *recovered* level)."""
        st = self._state(stream)
        if st.ewma is not None:
            st.baseline = st.ewma
        st.below = 0
        st.cooldown_left = 0

    def recovered(self, stream: str) -> bool:
        """EWMA back above the recovery bar (default: half the drift
        threshold below baseline)."""
        st = self._state(stream)
        if st.baseline is None or st.ewma is None:
            return False
        frac = (self.cfg.recover_frac if self.cfg.recover_frac is not None
                else 1.0 - 0.5 * self.cfg.threshold)
        return st.ewma >= st.baseline * frac

    def observe(self, stream: str, stat: float, t: float = 0.0
                ) -> Optional[DriftEvent]:
        """Feed one per-chunk statistic; returns an event when drift fires."""
        cfg = self.cfg
        st = self._state(stream)
        st.count += 1
        st.ewma = (stat if st.ewma is None
                   else (1 - cfg.alpha) * st.ewma + cfg.alpha * stat)
        if st.count <= cfg.warmup:
            st.baseline_sum += stat
            st.baseline = st.baseline_sum / st.count
            return None
        if st.cooldown_left > 0:
            st.cooldown_left -= 1
            return None
        assert st.baseline is not None
        if st.ewma < st.baseline * (1.0 - cfg.threshold):
            if st.below == 0:
                st.below_since = t
            st.below += 1
        else:
            st.below = 0
        if st.below < cfg.patience:
            return None
        st.below = 0
        st.cooldown_left = cfg.cooldown
        ev = DriftEvent(stream=stream, t=t, stat=st.ewma,
                        baseline=st.baseline,
                        severity=1.0 - st.ewma / max(st.baseline, 1e-9),
                        onset_t=st.below_since)
        self.events.append(ev)
        return ev
