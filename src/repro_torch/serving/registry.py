"""Function manager + model zoo (stateful backend, §III.D).

The serverless surface: users register video/ML functions and models; the
dispatcher deploys them to cloud or fog nodes.  The model zoo persists
checkpoints through ``repro_torch.weights.save_npz`` (the MongoDB role) and
records profiler results per device (the model profiler of the global
control plane).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch import weights


@dataclass
class FunctionEntry:
    name: str
    fn: Callable
    kind: str = "generic"        # decode | preprocess | inference | postprocess
    version: int = 1
    metadata: Dict[str, Any] = field(default_factory=dict)


class FunctionRegistry:
    """Fine-grained housekeeping for video-processing functions (Fig 2)."""

    def __init__(self):
        self._functions: Dict[str, FunctionEntry] = {}

    def register(self, name: str, fn: Callable, *, kind: str = "generic",
                 **metadata) -> FunctionEntry:
        version = (self._functions[name].version + 1
                   if name in self._functions else 1)
        entry = FunctionEntry(name, fn, kind, version, metadata)
        self._functions[name] = entry
        return entry

    def get(self, name: str) -> Callable:
        return self._functions[name].fn

    def entry(self, name: str) -> FunctionEntry:
        return self._functions[name]

    def list(self, kind: Optional[str] = None) -> List[str]:
        return sorted(n for n, e in self._functions.items()
                      if kind is None or e.kind == kind)

    def __contains__(self, name: str) -> bool:
        return name in self._functions


@dataclass
class ModelRecord:
    name: str
    params: Any
    config: Any
    profile: Dict[str, float] = field(default_factory=dict)
    registered_at: float = field(default_factory=time.time)
    version: int = 1
    # continual-learning lineage: parent version this candidate was trained
    # from, the training-data span it consumed, and its shadow-eval score
    lineage: Dict[str, Any] = field(default_factory=dict)


class ModelZoo:
    """Versioned model registry with optional on-disk persistence.

    Every registration keeps its full :class:`ModelRecord` (params included)
    under the model's version history, so the continual-learning plane can
    promote a candidate into the **live** slot, and later roll back to the
    previous live version *bit-identically*.  ``register`` (the serving-path
    API) registers *and* promotes in one step — the pre-versioning
    behaviour; ``register_version`` adds a candidate without touching the
    live pointer."""

    def __init__(self, root: Optional[str] = None,
                 keep_candidates: int = 64):
        self._models: Dict[str, ModelRecord] = {}            # live pointer
        self._versions: Dict[str, Dict[int, ModelRecord]] = {}
        self._promoted: Dict[str, List[int]] = {}            # promotion log
        # in-memory retention cap for never-promoted candidate versions
        # (a long-running trainer registers one per round; only versions
        # on the promotion log are needed for rollback)
        self.keep_candidates = keep_candidates
        self._root = root

    # -- registration ----------------------------------------------------
    def _next_version(self, name: str) -> int:
        return max(self._versions.get(name, {}), default=0) + 1

    def register_version(self, name: str, params, config=None,
                         profile: Optional[Dict[str, float]] = None,
                         lineage: Optional[Dict[str, Any]] = None
                         ) -> ModelRecord:
        """Add a candidate version; the live pointer does NOT move (unless
        this is the model's very first version)."""
        version = self._next_version(name)
        rec = ModelRecord(name, params, config, profile or {},
                          version=version, lineage=dict(lineage or {}))
        self._versions.setdefault(name, {})[version] = rec
        if self._root is not None:
            weights.save_npz(f"{self._root}/{name}@v{version}", params,
                            {"name": name, "version": version,
                             "lineage": rec.lineage})
        if name not in self._models:
            self._models[name] = rec
            self._promoted[name] = [version]
        self._prune(name)
        return rec

    def _prune(self, name: str) -> None:
        """Evict the oldest never-promoted candidates past the cap; the
        live version and everything on the promotion log always stay."""
        keep = set(self._promoted.get(name, []))
        keep.add(self._models[name].version)
        candidates = [v for v in sorted(self._versions[name])
                      if v not in keep]
        for v in candidates[: max(0, len(candidates)
                                  - self.keep_candidates)]:
            del self._versions[name][v]

    def register(self, name: str, params, config=None,
                 profile: Optional[Dict[str, float]] = None,
                 lineage: Optional[Dict[str, Any]] = None) -> ModelRecord:
        """Register a new version and promote it immediately."""
        rec = self.register_version(name, params, config, profile, lineage)
        if self._models[name].version != rec.version:
            self.promote(name, rec.version)
        if self._root is not None:
            weights.save_npz(f"{self._root}/{name}", params,
                            {"name": name, "version": rec.version})
        return rec

    # -- promotion / rollback --------------------------------------------
    def promote(self, name: str, version: int) -> ModelRecord:
        """Move the live pointer to ``version`` (must be registered)."""
        rec = self._versions[name][version]
        self._models[name] = rec
        self._promoted.setdefault(name, []).append(version)
        return rec

    def rollback(self, name: str) -> ModelRecord:
        """Revert the live pointer to the previously promoted version.

        Restores that version's exact stored params (bit-identical: the zoo
        never mutates a registered record)."""
        log = self._promoted.get(name, [])
        if len(log) < 2:
            raise ValueError(f"{name!r} has no prior promotion to roll back "
                             "to")
        log.pop()                                 # discard the current live
        rec = self._versions[name][log[-1]]
        self._models[name] = rec
        return rec

    # -- lookup ----------------------------------------------------------
    def get(self, name: str) -> ModelRecord:
        """The live (promoted) record."""
        return self._models[name]

    def get_version(self, name: str, version: int) -> ModelRecord:
        return self._versions[name][version]

    def versions(self, name: str) -> List[int]:
        return sorted(self._versions.get(name, {}))

    def promotion_log(self, name: str) -> List[int]:
        return list(self._promoted.get(name, []))

    def set_profile(self, name: str, device: str, fps: float) -> None:
        self._models[name].profile[device] = fps

    def list(self) -> List[str]:
        return sorted(self._models)

    def __contains__(self, name: str) -> bool:
        return name in self._models


@dataclass
class Dispatcher:
    """Deploys registered functions/models to cloud and fog nodes (§III.D)."""
    registry: FunctionRegistry
    zoo: ModelZoo
    deployments: Dict[str, List[str]] = field(default_factory=dict)

    def dispatch(self, target: str, name: str) -> None:
        if name not in self.registry and name not in self.zoo:
            raise KeyError(f"{name!r} is not registered")
        self.deployments.setdefault(target, [])
        if name not in self.deployments[target]:
            self.deployments[target].append(name)

    def deployed(self, target: str) -> List[str]:
        return list(self.deployments.get(target, []))
