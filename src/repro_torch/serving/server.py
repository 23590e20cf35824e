"""LLM serving loop: continuous batching over a slot-based cache pool (port
of ``repro.serving.server``).

Requests are admitted into free slots and prefilled one by one, then
decoded together in lockstep with per-slot cache indices.  Decoding is
greedy: each token is the argmax of the logits, with the softmax
confidence as in the reference.  The engine runs on the device its
parameters live on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.kv_cache import CachePool
from repro_torch.serving.monitor import Monitor


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int = 16
    arrival: float = 0.0

    # filled by the server
    output: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    confidence: float = 1.0


class LLMServer:
    """Single-model serving engine (one tier of the cascade)."""

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int = 4,
                 max_seq: int = 256, eos_token: int = 1,
                 monitor: Optional[Monitor] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["embedding"].device
        self.pool = CachePool(cfg, num_slots, max_seq, self.device)
        self.eos = eos_token
        self.monitor = monitor or Monitor()
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}     # slot -> request
        self.finished: List[Request] = []
        self.clock = 0.0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrival = self.clock
        self.waiting.append(req)

    def _admit(self) -> None:
        while self.waiting and self.pool.free_slots():
            req = self.waiting.pop(0)
            slot = self.pool.allocate(req.request_id)
            # prefill this request alone into a single-row cache, then copy
            one = tfm.init_cache(self.cfg, 1, self.pool.max_seq, self.device)
            toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                   device=self.device)[None]
            logits, one = tfm.prefill(self.cfg, self.params, toks, one)
            self.pool.write_prefill(slot, one, len(req.prompt))
            req.output.append(int(torch.argmax(logits[0])))
            req.confidence = float(torch.softmax(logits[0], -1).max())
            req.first_token_time = self.clock
            req.slot = slot
            self.active[slot] = req
            self.pool.slots[slot].length = len(req.prompt)

    # ------------------------------------------------------------------
    def step(self, dt: float = 0.0) -> int:
        """One serving iteration: admit + one lockstep decode step.

        Returns the number of active requests after the step."""
        self.clock += dt
        self._admit()
        if not self.active:
            return 0

        last = np.zeros((self.pool.num_slots, 1), np.int64)
        for slot, req in self.active.items():
            last[slot, 0] = req.output[-1]
        # slot length tracks the prompt; the n-th decode step writes its KV at
        # prompt_len + n_generated - 1 (the first generated token came from
        # prefill and is the decode input, not yet in the cache)
        lengths = self.pool.lengths()
        for slot, req in self.active.items():
            lengths[slot] = self.pool.slots[slot].length + len(req.output) - 1

        logits, self.pool.cache = tfm.decode_step(
            self.cfg, self.params, torch.as_tensor(last, device=self.device),
            self.pool.cache, torch.as_tensor(lengths, device=self.device))
        probs = torch.softmax(logits[:, 0], dim=-1)
        toks = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        confs = probs.amax(dim=-1).cpu().numpy()

        done_slots = []
        for slot, req in self.active.items():
            tok = int(toks[slot])
            req.output.append(tok)
            req.confidence = min(req.confidence, float(confs[slot]))
            if tok == self.eos or len(req.output) >= req.max_new_tokens:
                req.finish_time = self.clock
                done_slots.append(slot)
        for slot in done_slots:
            self.finished.append(self.active.pop(slot))
            self.pool.release(slot)
            self.monitor.incr("requests_finished")
        self.monitor.record("active_requests", len(self.active), self.clock)
        return len(self.active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.waiting or self.active) and steps < max_steps:
            self.step(dt=0.01)
            steps += 1
        return self.finished
