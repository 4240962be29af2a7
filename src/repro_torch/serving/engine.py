"""In-process serving engine of the port: one prefill, then greedy decode.

PyTorch counterpart of ``repro.serving.engine``.  ``cache_len`` is a host
int, so no step waits on the device to learn where to write.  Without an
``eos_id`` the generated tokens stay on the device until the last step and
cross to the host once.

On a card, a dense-family model decodes through
``models.graphed.GraphedDecode``: the stretches of a step between its
attention calls replay as CUDA graphs (the counterpart of the reference's
jitted step), captured for every batch size up to ``max_batch`` on the
first call, and the prefill's cache is copied into the graphs' static
cache.  Elsewhere (the CPU, the SSM and hybrid families) the cache is
padded to ``max_seq`` at prefill and every decode step runs eagerly,
updating it in place.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import kvcache
from repro_torch.models.graphed import GraphedDecode
from repro_torch.models.model import DENSE_FAMILIES, Model


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
        self._graphed: Optional[GraphedDecode] = None

    def _decoder(self) -> Optional[GraphedDecode]:
        """The graphed decode of a dense model on a card (captured for
        every batch size on first use); None elsewhere."""
        m = self.model
        if (self._graphed is None and m.device.type == "cuda"
                and m.arch.family in DENSE_FAMILIES):
            self._graphed = GraphedDecode(m, self.cfg.max_batch,
                                          self.cfg.max_seq)
            self._graphed.capture_all()
        return self._graphed

    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """tokens [B, S] -> (last-token logits [B, 1, V], the cache the
        decode steps of this batch run against)."""
        dec = self._decoder()
        if dec is None:
            return self.model.prefill(tokens, max_seq=self.cfg.max_seq)
        logits, cache = self.model.prefill(tokens)
        return logits, dec.load(cache, tokens.shape[1])

    def decode_step(self, cache: kvcache.Cache, cache_len: int,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """One greedy step of a batch that :meth:`prefill` started ->
        (logits [B, 1, V], cache).  On the graphed path the logits are a
        buffer that the next step overwrites."""
        dec = self._decoder()
        if dec is None:
            return self.model.decode_step(cache, cache_len, tokens)
        return dec.step(cache_len, tokens), cache

    def generate(self, prompts: np.ndarray, max_new: int = 16,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Batched greedy decode. prompts: [B, S] int32 (right-aligned,
        same length -- the batcher pads).  Returns [B, max_new] int32."""
        B, S = prompts.shape
        if B > self.cfg.max_batch or S >= self.cfg.max_seq:
            raise ValueError(f"prompts {prompts.shape} exceed max_batch "
                             f"{self.cfg.max_batch} / max_seq "
                             f"{self.cfg.max_seq}")
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.model.device)
        logits, cache = self.prefill(tokens)
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
            logits, cache = self.decode_step(cache, S + i, tok)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        if steps:
            out[:, :len(steps)] = torch.cat(steps, dim=1).cpu().numpy()
        return out
