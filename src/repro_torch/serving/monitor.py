"""Global monitor: runtime performance collection (global control plane)."""
from __future__ import annotations

import statistics
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Monitor:
    series: Dict[str, List[tuple]] = field(
        default_factory=lambda: defaultdict(list))
    counters: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    # discrete control-plane events (drift, promotion, rollback, hot_swap)
    events: List[dict] = field(default_factory=list)

    def record(self, name: str, value: float, t: float = 0.0) -> None:
        self.series[name].append((t, float(value)))

    def incr(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def log_event(self, name: str, t: float = 0.0, **fields) -> None:
        self.events.append({"event": name, "t": t, **fields})

    def events_of(self, name: str) -> List[dict]:
        return [e for e in self.events if e["event"] == name]

    def event_count(self, name: str) -> int:
        """Occurrences of a control-plane event (chaos gates count
        failovers/readmits/repairs with this)."""
        return len(self.events_of(name))

    def values(self, name: str) -> List[float]:
        return [v for _, v in self.series[name]]

    def tags(self, prefix: str) -> List[str]:
        """Tag suffixes of series named ``{prefix}:{tag}`` (e.g. per-tenant
        ``latency:gold-vision`` series) — sorted, without the prefix."""
        p = prefix + ":"
        return sorted(n[len(p):] for n in self.series
                      if n.startswith(p) and self.series[n])

    def percentile(self, name: str, p: float) -> float:
        vals = sorted(self.values(name))
        if not vals:
            return 0.0
        k = min(len(vals) - 1, max(0, int(round(p / 100 * (len(vals) - 1)))))
        return vals[k]

    def mean(self, name: str) -> float:
        vals = self.values(name)
        return statistics.fmean(vals) if vals else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in self.series:
            out[name] = {"mean": self.mean(name),
                         "p50": self.percentile(name, 50),
                         "p95": self.percentile(name, 95),
                         "n": len(self.series[name])}
        return out
