"""Execution backends of the port: HOW a dispatched batch gets served.

The :class:`~repro_torch.runtime.cluster.ClusterRuntime` owns queues,
batching, early drop and the event clock; a backend only answers "how long
does THIS server take to serve THIS batch?" (:class:`ExecutionBackend`).
Both backends below serve the port's own ``ClusterRuntime``, and they
still fit the JAX package's ``ExecutionBackend`` protocol (same method
names and arguments, no import), so its runtime can drive them too:

* :class:`SimBackend` -- the profiled-latency lognormal model, draw for
  draw the reference's.
* :class:`EngineBackend` -- drives real :class:`repro_torch.serving.engine.Engine`
  instances and uses the measured wall-clock generation time as the
  service time.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Any, Dict, List, Mapping, Optional,
                    Protocol, Sequence, runtime_checkable)

import numpy as np
import torch

if TYPE_CHECKING:   # pragma: no cover — typing only
    from repro_torch.core.milp import PlanConfig
    from repro_torch.core.taskgraph import TaskGraph
    from repro_torch.runtime.metrics import Server


@runtime_checkable
class ExecutionBackend(Protocol):
    """Data-plane contract consumed by :class:`ClusterRuntime`.

    ``bind`` is called once per served app before the event loop starts
    — a single-app runtime calls it once with that app's graph/config, a
    multi-app runtime (``ClusterRuntime.multi``) once per co-located
    app.  Backends that key state by graph should store it under
    ``Server.app`` (every ``service_s`` call carries the owning app on
    its server); see :class:`EngineBackend` for the pattern.
    """

    def bind(self, graph: "TaskGraph", config: "PlanConfig",
             app: str = "") -> None:
        """Called once per app before serving starts (build engines,
        caches...).  ``app`` is the co-located app's tag ("" single-app)."""
        ...

    def service_s(self, server: "Server", batch: Sequence[Any],
                  now_s: float, rng: np.random.Generator) -> float:
        """Service time (seconds) for ``server`` executing ``batch``."""
        ...

    def on_capacity_change(self, servers: List["Server"]) -> None:
        """Called after failure-injection / elasticity changed the fleet."""
        ...


@dataclass
class SimBackend:
    """Profiled-latency model: lognormal jitter around the profiled p95."""
    jitter_sigma: float = 0.08
    mu: float = -0.15

    def bind(self, graph, config, app=""):
        pass

    def service_s(self, server, batch, now_s, rng):
        return (server.tup.latency_ms / 1e3
                * float(rng.lognormal(self.mu, self.jitter_sigma)))

    def on_capacity_change(self, servers):
        pass


@dataclass
class EngineBackend:
    """Serve batches on the port's ``Engine`` instances.

    One engine is built per distinct model arch on first use; a warm-up
    generate (which also builds the CUDA kernels, and under graphed decode
    one per batch size, which captures its graphs) stays outside the timed
    service.  Service time is the wall clock of the batched greedy decode,
    read after ``torch.cuda.synchronize()`` on a card.

    ``reduced`` (the default, as the reference always does) serves the
    archs' reduced variants in fp32; ``reduced=False`` serves the full
    widths in bf16, which needs the card.  Weights are random, seeded per
    arch from its name.

    The measured wall is scaled by ``time_scale`` (sim-seconds per
    wall-second).  ``pool_time_scale`` maps a ClusterSpec pool name to ITS
    scale, so a plan over several pools reflects their relative device
    speeds: a server's pool picks its own scale, pools absent from the map
    fall back to ``time_scale``."""
    max_batch: int = 4
    max_seq: int = 64
    prompt_len: int = 8
    max_new: int = 4
    time_scale: float = 1.0
    pool_time_scale: Optional[Mapping[str, float]] = None
    device: str = "cuda"
    reduced: bool = True
    _engines: Dict[str, Any] = field(default_factory=dict, repr=False)
    _graphs: Dict[str, Any] = field(default_factory=dict, repr=False)

    def bind(self, graph, config, app=""):
        self._graphs[app] = graph

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def _engine_for(self, arch_name: str):
        eng = self._engines.get(arch_name)
        if eng is None:
            from repro_torch.configs import ARCHS
            from repro_torch.models import Model
            from repro_torch.serving.engine import Engine, EngineConfig

            arch = ARCHS[arch_name]
            arch = arch.reduced() if self.reduced else arch
            dtype = torch.float32 if self.reduced else torch.bfloat16
            model = Model(arch, device=self.device, dtype=dtype)
            # stable per-arch seed (str hash is salted per process)
            gen = torch.Generator(device=model.device)
            gen.manual_seed(zlib.crc32(arch_name.encode()) & 0x7FFFFFFF)
            model.init(gen)
            eng = Engine(model, EngineConfig(max_batch=self.max_batch,
                                             max_seq=self.max_seq))
            # warm-up: kernel build, first launches and (graphed decode)
            # each batch size's capture outside timed serving
            sizes = (range(1, self.max_batch + 1)
                     if eng.decode_mode == "graphed" else (1,))
            for b in sizes:
                eng.generate(np.zeros((b, self.prompt_len), np.int32),
                             max_new=2)
            self._sync()
            self._engines[arch_name] = eng
        return eng

    def scale_for(self, pool: str) -> float:
        """The time scale of one pool (``time_scale`` if unmapped)."""
        if self.pool_time_scale is not None and pool in self.pool_time_scale:
            return float(self.pool_time_scale[pool])
        return self.time_scale

    def service_s(self, server, batch: Sequence[Any], now_s: float,
                  rng: np.random.Generator) -> float:
        graph = self._graphs[getattr(server, "app", "")]
        task = graph.tasks[server.tup.task]
        arch_name = task.variant(server.tup.variant).arch
        eng = self._engine_for(arch_name)
        vocab = eng.model.arch.vocab_size
        b = min(max(len(batch), 1), eng.cfg.max_batch)
        prompts = np.asarray(
            rng.integers(0, vocab, size=(b, self.prompt_len)), np.int32)
        self._sync()
        t0 = time.monotonic()
        eng.generate(prompts, max_new=self.max_new)
        self._sync()
        wall = time.monotonic() - t0
        # a fixed-shape engine may need several launches for a big batch
        launches = -(-len(batch) // eng.cfg.max_batch)
        return wall * launches * self.scale_for(server.tup.pool)

    def on_capacity_change(self, servers):
        pass
