"""Continuous batcher in front of the port's Engine (paper §3.3 semantics,
real datapath): collects requests into fixed-shape batches (pad to the
bucket), launches when full or when the head-of-line request has waited
the batch-formation timeout, early-drops per the deadline rule.  A copy of
``repro.serving.batcher`` with the same semantics: prompts are left-padded
with token 0 and no mask.  Under its engine's tracer each batch is one
``batcher.pump`` span, from the batch's formation to its tokens, with its
counts as args: ``B``, ``S``, ``prompt_tokens``, ``pad_tokens`` and the
requests ``dropped`` by this call.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import Engine


@dataclass
class ServeRequest:
    req_id: int
    prompt: np.ndarray            # [S] int32
    deadline_s: float
    submitted_s: float
    result: Optional[np.ndarray] = None
    dropped: bool = False


@dataclass
class Batcher:
    engine: Engine
    timeout_ms: float = 50.0
    max_new: int = 16
    clock: Callable[[], float] = time.monotonic
    queue: List[ServeRequest] = field(default_factory=list)
    served: int = 0
    dropped: int = 0

    def submit(self, req: ServeRequest):
        self.queue.append(req)

    # ------------------------------------------------------------------
    def pump(self) -> List[ServeRequest]:
        """Run at most one batch; returns completed requests."""
        now = self.clock()
        dropped = self.dropped
        keep, batch = [], []
        for r in self.queue:
            if now > r.deadline_s:
                r.dropped = True
                self.dropped += 1
            elif len(batch) < self.engine.cfg.max_batch:
                batch.append(r)
            else:
                keep.append(r)
        self.queue = keep
        if not batch or not self._ready(batch, now):
            self.queue = batch + self.queue
            return []
        tr = self.engine.tracer
        if tr is None:
            return self._run(batch)
        S = max(len(r.prompt) for r in batch)
        prompt = sum(len(r.prompt) for r in batch)
        with tr.span("batcher.pump", "batcher",
                     app=self.engine.model.arch.name, B=len(batch), S=S,
                     prompt_tokens=prompt, pad_tokens=len(batch) * S - prompt,
                     dropped=self.dropped - dropped):
            return self._run(batch)

    def _run(self, batch: List[ServeRequest]) -> List[ServeRequest]:
        S = max(len(r.prompt) for r in batch)
        toks = np.zeros((len(batch), S), np.int32)
        for i, r in enumerate(batch):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad
        out = self.engine.generate(toks, max_new=self.max_new)
        for i, r in enumerate(batch):
            r.result = out[i]
            self.served += 1
        return batch

    def _ready(self, batch, now) -> bool:
        if len(batch) >= self.engine.cfg.max_batch:
            return True
        wait_ms = (now - batch[0].submitted_s) * 1e3
        return wait_ms >= self.timeout_ms
