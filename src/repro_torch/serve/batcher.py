"""Continuous batching (`repro.serve.batcher`): a slot scheduler over
per-sequence decode.

When one sequence finishes, the next request is admitted into its slot
at once instead of waiting for the whole batch.  New prompts stream
through the same decode step one token per tick (decode-only admission):
slots still in their prompt feed prompt tokens and drop the samples,
slots past it feed back their last sample.  Every slot decodes at its own
position (``index`` is a (B,) vector).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.params import ParamSpec, init_params


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    eos_id: Optional[int] = None


@dataclasses.dataclass
class _Slot:
    req: Request
    pos: int = 0                      # next cache position to write
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.req.prompt)

    @property
    def next_token(self) -> int:
        if self.prefilling:
            return self.req.prompt[self.pos]
        return self.out[-1]

    @property
    def done(self) -> bool:
        if len(self.out) >= self.req.max_new:
            return True
        return (self.req.eos_id is not None and bool(self.out)
                and self.out[-1] == self.req.eos_id)


class ContinuousBatcher:
    """Greedy continuous-batching engine over ``model.decode_step``.

    Runs on ``device`` (the card unless the CPU is named), which must be
    the model's.  The KV cache is updated in place tick after tick.
    """

    def __init__(self, model, cfg: ModelConfig, *, n_slots: int,
                 cache_len: int, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, batcher on {self.device}")
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.queue: deque = deque()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.finished: Dict[int, List[int]] = {}
        self.ticks = 0
        self.busy_slot_ticks = 0
        self._cache_specs = model.cache_specs(n_slots, cache_len)
        self.cache = init_params(self._cache_specs, None, device=self.device)  # zeros

    # ------------------------------------------------------------ state ----
    def _reset_slot_cache(self, slot: int) -> None:
        """Zero one slot's slice in every cache leaf.  The batch axis is
        found from the leaf's ParamSpec (stacked block caches are
        (layers, B, ...): batch is not dim 0)."""
        def reset(tree, specs):
            if isinstance(specs, ParamSpec):
                idx = (slice(None),) * specs.axes.index("batch") + (slot,)
                tree[idx].zero_()
                return
            for k in specs:
                reset(tree[k], specs[k])

        reset(self.cache, self._cache_specs)

    # -------------------------------------------------------------- api ----
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.cache_len:
            raise ValueError(f"request {req.rid} exceeds cache_len")
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = _Slot(self.queue.popleft())
                self._reset_slot_cache(i)

    def tick(self) -> None:
        """One engine step: every busy slot advances one position."""
        self._admit()
        busy = [i for i, s in enumerate(self.slots) if s is not None]
        if not busy:
            return
        self.ticks += 1
        self.busy_slot_ticks += len(busy)
        tokens = np.zeros((self.n_slots, 1), np.int32)
        index = np.zeros((self.n_slots,), np.int32)
        for i in busy:
            tokens[i, 0] = self.slots[i].next_token
            index[i] = self.slots[i].pos
        logits, self.cache = self.model.decode_step(
            self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(index).to(self.device))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i in busy:
            s = self.slots[i]
            s.pos += 1
            if not s.prefilling:       # a sample counts once past the prompt
                s.out.append(int(nxt[i]))
            if s.done:
                self.finished[s.req.rid] = s.out
                self.slots[i] = None

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: generated tokens}."""
        while self.queue or any(s is not None for s in self.slots):
            self.tick()
        return self.finished

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots busy per tick."""
        if self.ticks == 0:
            return 0.0
        return self.busy_slot_ticks / (self.ticks * self.n_slots)
