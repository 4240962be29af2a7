"""Compatibility shim: the legacy discrete-event ``Simulator`` API.

The event loop, task-level batching, early drop and failure handling now
live in :class:`repro_torch.runtime.cluster.ClusterRuntime`; the profiled-
latency lognormal service model is :class:`repro_torch.runtime.backend.
SimBackend`.  ``Simulator(graph, cfg).run(rps)`` is preserved verbatim —
it wraps ``ClusterRuntime(SimBackend())`` with a Poisson
:class:`~repro_torch.runtime.scenario.Scenario` and is draw-for-draw identical
to the pre-refactor implementation (seed-deterministic traces).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.runtime.metrics import Server, SimMetrics

__all__ = ["Server", "SimMetrics", "Simulator"]


class Simulator:
    """Thin wrapper over ``ClusterRuntime(SimBackend())``."""

    def __init__(self, graph, config, *, seed: int = 0,
                 staleness_ms: float = 20.0, jitter_sigma: float = 0.08):
        # deferred: repro_torch.core and repro_torch.runtime import each other's
        # leaves, so the heavy modules load lazily on first use
        from repro_torch.runtime.backend import SimBackend
        from repro_torch.runtime.cluster import ClusterRuntime

        self.graph = graph
        self.config = config
        self._rt = ClusterRuntime(
            graph, config, SimBackend(jitter_sigma=jitter_sigma),
            seed=seed, staleness_ms=staleness_ms)

    # -- legacy surface, delegated to the runtime -----------------------
    @property
    def servers(self) -> List[Server]:
        return self._rt.servers

    @property
    def by_task(self) -> Dict[str, List[Server]]:
        return self._rt.by_task

    @property
    def queues(self):
        return self._rt.queues

    @property
    def rng(self):
        return self._rt.rng

    def fail_instances(self, indices: Sequence[int]):
        self._rt.fail_instances(indices)

    def run(self, demand_rps: float, duration_s: float = 20.0,
            warmup_s: float = 2.0) -> SimMetrics:
        from repro_torch.runtime.scenario import Scenario
        return self._rt.run(Scenario.poisson(demand_rps, duration_s,
                                             warmup_s))
