"""In-process serving engine of the port: one prefill, then greedy decode.

PyTorch counterpart of ``repro.serving.engine``.  ``cache_len`` is a host
int, so no step waits on the device to learn where to write.  Without an
``eos_id`` the generated tokens stay on the device until the last step and
cross to the host once.

On a card, a dense-family or ``hybrid_moe`` model decodes through
``models.graphed.GraphedDecode``: the stretches of a step between its
attention calls replay as CUDA graphs (the counterpart of the reference's
jitted step), captured for ``max_batch`` on the first call and for each
other batch size when it first comes (``GraphedDecode.capture_max_batch``),
and the prefill writes its KV prefix (and a ``hybrid_moe`` model's Mamba2
states) into the graphs' static caches in place.  Elsewhere (the CPU, the SSM, hybrid and MoE families) the cache is
padded to ``max_seq`` at prefill and every decode step runs eagerly,
updating it in place.

Under a sharding policy with a mesh (the model's ``policy``) the engine
places the model's parameters per ``param_specs`` (``Model.distribute``),
as the reference's engine jits its prefill with those shardings, and
decodes eagerly: ``GraphedDecode``'s captured segments and static buffers
hold plain tensors, not DTensors.  ``decode_mode`` says which ran.  The
greedy tokens are gathered to every rank (``full_tensor``) each step.

Given a ``tracer`` (``obs.Tracer``), the engine records its own spans, the
model its own (the Mamba2 and MoE layers': the engine sets
``Model.tracer`` to its own, or None, before each eager call), and
``GraphedDecode`` its own: ``engine.generate`` around a batch, with
``engine.prefill`` (its arg ``head``: the route of ``layers.logits``
that served the prefill's head, ``bf16`` or ``upcast``), one
``engine.decode_step`` a step (the step, its ``argmax`` and ``cpu_s``,
the thread's CPU seconds over the span) and ``engine.to_host`` inside
it.  ``engine.generate``'s args carry
``first_token_ms`` (entry to the first token's ``argmax``) and
``token_gaps_ms`` (between consecutive tokens' ``argmax``): on a card from
CUDA events read after the batch's own final copy, so tracing adds no
synchronisation; elsewhere from the host clock, the device being the
host.  A decode step's body is written once: without a tracer its spans
are null contexts (``Engine._span``), so the traced step runs the same
lines as the untraced one, and no event is created.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import kvcache, layers
from repro_torch.models import graphed
from repro_torch.models.graphed import GraphedDecode
from repro_torch.models.model import Model
from repro_torch.sharding.policy import whole

if TYPE_CHECKING:
    from repro_torch.obs.tracing import Tracer


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 512


class Engine:
    """Batched greedy serving engine for one model instance; it runs on
    the model's device."""

    def __init__(self, model: Model, cfg: EngineConfig,
                 tracer: Optional[Tracer] = None):
        self.model = model.distribute()
        self.cfg = cfg
        self.tracer = tracer
        self._graphed: Optional[GraphedDecode] = None

    @property
    def decode_mode(self) -> str:
        """``"graphed"`` where a dense or ``hybrid_moe`` model on a card
        decodes through ``GraphedDecode``, ``"eager (mesh)"`` where it
        would but its policy has a mesh, ``"eager"`` elsewhere."""
        m = self.model
        if m.device.type != "cuda" or m.arch.family not in graphed.FAMILIES:
            return "eager"
        return "eager (mesh)" if m.sharded else "graphed"

    def _decoder(self) -> Optional[GraphedDecode]:
        """The graphed decode of a dense or ``hybrid_moe`` model on a card
        (``max_batch`` captured on first use, each other size when it
        first comes); None elsewhere."""
        m = self.model
        if self._graphed is None and self.decode_mode == "graphed":
            self._graphed = GraphedDecode(m, self.cfg.max_batch,
                                          self.cfg.max_seq, self.tracer)
            self._graphed.capture_max_batch()
        return self._graphed

    def _span(self, name: str, **args):
        """A span of the engine's tracer, or nothing."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, "engine", **args)

    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """tokens [B, S] -> (last-token logits [B, 1, V], the cache the
        decode steps of this batch run against)."""
        if self.tracer is None:
            return self._prefill(tokens)
        with self.tracer.span("engine.prefill", "engine", B=tokens.shape[0],
                              S=tokens.shape[1]) as span:
            before = dict(layers.logit_routes)
            out = self._prefill(tokens)
            span.args["head"] = "+".join(
                r for r, n in layers.logit_routes.items() if n > before[r])
            return out

    def _prefill(self, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, kvcache.Cache]:
        dec = self._decoder()
        self.model.tracer = self.tracer
        if dec is None:
            return self.model.prefill(tokens, max_seq=self.cfg.max_seq)
        if tokens.shape[1] >= self.cfg.max_seq:
            raise ValueError(f"{tokens.shape[1]} positions leave no room in "
                             f"max_seq {self.cfg.max_seq}")
        return self.model.prefill(tokens, into=dec.rows(tokens.shape[0]))

    def decode_step(self, cache: kvcache.Cache, cache_len: int,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """One greedy step of a batch that :meth:`prefill` started ->
        (logits [B, 1, V], cache).  On the graphed path the logits are a
        buffer that the next step overwrites."""
        dec = self._decoder()
        if dec is None:
            self.model.tracer = self.tracer
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
        if self.tracer is None:
            return self._generate(prompts, max_new, eos_id, None)
        with self.tracer.span("engine.generate", "engine",
                              app=self.model.arch.name, B=B, S=S,
                              max_new=max_new) as span:
            marks = _TokenMarks(self.model.device)
            out = self._generate(prompts, max_new, eos_id, marks)
            span.args.update(marks.read())
        return out

    def _generate(self, prompts: np.ndarray, max_new: int,
                  eos_id: Optional[int],
                  marks: Optional["_TokenMarks"]) -> np.ndarray:
        B, S = prompts.shape
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.model.device)
        logits, cache = self.prefill(tokens)
        tok = whole(logits[:, -1].argmax(-1, keepdim=True))
        if marks is not None:
            marks.mark()
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
            with self._span("engine.decode_step", step=i) as span:
                cpu0 = time.thread_time_ns()
                logits, cache = self.decode_step(cache, S + i, tok)
                tok = whole(logits[:, -1].argmax(-1, keepdim=True))
                if marks is not None:
                    marks.mark()
                    span.args["cpu_s"] = (time.thread_time_ns() - cpu0) * 1e-9
        if steps:
            with self._span("engine.to_host"):
                out[:, :len(steps)] = torch.cat(steps, dim=1).cpu().numpy()
        return out


class _TokenMarks:
    """A mark at ``generate``'s entry and after each token's ``argmax``:
    CUDA events on a card, host seconds elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if self.cuda else None
        self.marks: list = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def read(self) -> dict:
        """``first_token_ms`` and ``token_gaps_ms`` (one fewer than the
        tokens); on a card, once the last event has completed (the batch's
        own copy to the host has waited for it already)."""
        m = self.marks
        if self.cuda:
            m[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(m, m[1:])]
        return {"first_token_ms": ms[0], "token_gaps_ms": ms[1:]}
