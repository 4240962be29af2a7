"""In-process serving engine of the port: one prefill, then greedy decode.

PyTorch counterpart of ``repro.serving.engine``.  The cache is padded to
``max_seq`` at prefill and updated in place by every decode step;
``cache_len`` is a host int, so no step waits on the device to learn where
to write.  Without an ``eos_id`` the generated tokens stay on the device
until the last step and cross to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 512


class Engine:
    """Batched greedy serving engine for one model instance; it runs on
    the model's device."""

    def __init__(self, model: Model, cfg: EngineConfig):
        self.model = model
        self.cfg = cfg

    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Batched greedy decode. prompts: [B, S] int32 (right-aligned,
        same length -- the batcher pads).  Returns [B, max_new] int32."""
        B, S = prompts.shape
        if B > self.cfg.max_batch or S >= self.cfg.max_seq:
            raise ValueError(f"prompts {prompts.shape} exceed max_batch "
                             f"{self.cfg.max_batch} / max_seq "
                             f"{self.cfg.max_seq}")
        model = self.model
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=model.device)
        logits, cache = model.prefill(tokens, max_seq=self.cfg.max_seq)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out = np.zeros((B, max_new), np.int32)
        done = np.zeros((B,), bool)
        steps: List[torch.Tensor] = []
        for i in range(max_new):
            if eos_id is not None:
                t = tok[:, 0].cpu().numpy()
                out[:, i] = np.where(done, eos_id, t)
                done |= t == eos_id
                if done.all():
                    break
            else:
                steps.append(tok)
            if i == max_new - 1:
                break
            logits, cache = model.decode_step(cache, S + i, tok)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        if steps:
            out[:, :len(steps)] = torch.cat(steps, dim=1).cpu().numpy()
        return out
