"""Function executor over a (simulated) accelerator pool.

Runs registered functions; wall-time per call comes either from real CPU
measurement (``measure=True``) or from the device profile model (TPU/GPU
targets).  This is the stateless-server execution layer of Fig. 3.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.bandwidth import DeviceProfile
from repro_torch.serving.registry import FunctionRegistry


@dataclass
class ExecutionRecord:
    fn_name: str
    start: float
    duration: float
    device: str
    ok: bool = True


@dataclass
class Executor:
    """One node's executor (cloud or fog)."""
    name: str
    registry: FunctionRegistry
    profile: DeviceProfile
    num_devices: int = 1
    measure: bool = False          # True: wall-clock; False: profile model

    clock: float = 0.0
    busy_until: List[float] = None
    # background-lane horizon: HITL/maintenance work queues here and never
    # blocks the serving lane (fixes the fog head-of-line hazard where a
    # busy node's own high-priority chunk sat behind collect work)
    bg_busy_until: float = 0.0
    records: List[ExecutionRecord] = field(default_factory=list)

    def __post_init__(self):
        if self.busy_until is None:
            self.busy_until = [0.0] * self.num_devices

    # -- device pool -------------------------------------------------------
    def scale_to(self, n: int) -> None:
        n = max(1, n)
        if n > len(self.busy_until):
            self.busy_until += [self.clock] * (n - len(self.busy_until))
        else:
            self.busy_until = self.busy_until[:n]
        self.num_devices = n

    def _acquire(self, now: float) -> Tuple[int, float]:
        i = min(range(len(self.busy_until)), key=lambda j: self.busy_until[j])
        return i, max(now, self.busy_until[i])

    # -- execution ----------------------------------------------------------
    def run(self, fn_name: str, *args, now: Optional[float] = None,
            model_time: Optional[float] = None, priority: str = "serve",
            **kw) -> Tuple[Any, float]:
        """Execute; returns (result, completion_time).

        ``priority="serve"`` (default) occupies a pool device.
        ``priority="background"`` runs on the deferrable lane: it starts no
        earlier than the pool's next free instant but reserves *no* device
        time — later serve-lane calls are never queued behind it (WFQ/
        priority ordering on a shared fog node).
        """
        now = self.clock if now is None else now
        fn = self.registry.get(fn_name)
        if priority == "background":
            start = max(now, min(self.busy_until), self.bg_busy_until)
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            wall = time.perf_counter() - t0
            dur = wall if self.measure else (
                model_time if model_time is not None else wall)
            done = start + dur
            self.bg_busy_until = done
            self.clock = max(self.clock, done)
            self.records.append(ExecutionRecord(fn_name, start, dur,
                                                f"{self.name}/bg"))
            return result, done
        dev, start = self._acquire(now)
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        wall = time.perf_counter() - t0
        dur = wall if self.measure else (
            model_time if model_time is not None else wall)
        done = start + dur
        self.busy_until[dev] = done
        self.clock = max(self.clock, done)
        self.records.append(ExecutionRecord(fn_name, start, dur,
                                            f"{self.name}/dev{dev}"))
        return result, done

    def occupy(self, fn_name: str, *, now: float,
               model_time: float) -> Tuple[float, float]:
        """Reserve device time without running a function.

        Hedged dispatch books the speculative duplicate with this: the
        duplicate occupies a real device (it shows up in utilization and
        billing) but the primary's result is reused bitwise, so there is
        nothing to execute.  Returns ``(start, completion_time)``."""
        dev, start = self._acquire(now)
        done = start + model_time
        self.busy_until[dev] = done
        self.clock = max(self.clock, done)
        self.records.append(ExecutionRecord(fn_name, start, model_time,
                                            f"{self.name}/dev{dev}"))
        return start, done

    def utilization(self, horizon: float) -> float:
        if horizon <= 0:
            return 0.0
        busy = sum(r.duration for r in self.records
                   if r.start >= self.clock - horizon)
        return min(1.0, busy / (horizon * max(self.num_devices, 1)))

    def busy_fraction(self, t0: float, t1: float) -> float:
        """Fraction of the simulated window [t0, t1] this executor's device
        pool spent in service (`GraphScheduler.throughput_report` scores
        the shared fog-batch executor with this over the detect span — a
        starved accelerator shows up here before it shows up in
        frames/sec)."""
        if t1 <= t0:
            return 0.0
        busy = sum(max(0.0, min(r.start + r.duration, t1) - max(r.start, t0))
                   for r in self.records)
        return min(1.0, busy / ((t1 - t0) * max(self.num_devices, 1)))
