"""KV-cache slot management for continuous-batching LLM serving (port of
``repro.serving.kv_cache``).

A fixed pool of batch slots, each holding one request's cache region; frees
and reuses slots as requests finish.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


@dataclass
class SlotState:
    request_id: Optional[int] = None
    length: int = 0               # tokens currently in the cache
    done: bool = True


@dataclass
class CachePool:
    cfg: ModelConfig
    num_slots: int
    max_seq: int
    device: object = "cuda"

    cache: object = None
    slots: List[SlotState] = field(default_factory=list)

    def __post_init__(self):
        self.cache = tfm.init_cache(self.cfg, self.num_slots, self.max_seq,
                                    self.device)
        self.slots = [SlotState() for _ in range(self.num_slots)]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.done]

    def allocate(self, request_id: int) -> Optional[int]:
        free = self.free_slots()
        if not free:
            return None
        i = free[0]
        self.slots[i] = SlotState(request_id, 0, False)
        return i

    def release(self, slot: int) -> None:
        self.slots[slot] = SlotState()

    def lengths(self) -> np.ndarray:
        return np.asarray([s.length for s in self.slots], np.int32)

    def write_prefill(self, slot: int, new_cache, length: int) -> None:
        """Copy one request's prefilled cache row into the pool.  ``blocks``
        caches are stacked (num_blocks, batch, ...); prefix / suffix caches
        have batch first."""
        for part, layers in self.cache.items():
            for key, leaves in layers.items():
                for name, pool_leaf in leaves.items():
                    new_leaf = new_cache[part][key][name]
                    if part == "blocks":
                        pool_leaf[:, slot].copy_(new_leaf[:, 0])
                    else:
                        pool_leaf[slot].copy_(new_leaf[0])
        self.slots[slot].length = length

