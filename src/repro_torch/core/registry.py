"""Registration handler (paper §3.1).

Registering a compound inference system = listing tasks, providing the
variant set (arch + quantization + registered accuracy) per task, the DAG
edges, multiplicative factors, and the end-to-end latency/accuracy SLOs.
Validation happens here: the graph must be a DAG with a single entry, all
variant archs must exist in the model zoo, and accuracy metadata must be
sane.  Returns a :class:`Registration` that owns the profiler.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs import ARCHS
from repro_torch.core.profiler import Profiler
from repro_torch.core.taskgraph import TaskGraph


class RegistrationError(ValueError):
    pass


@dataclass
class Registration:
    graph: TaskGraph
    profiler: Profiler

    @property
    def name(self) -> str:
        return self.graph.name


def register(graph: TaskGraph, *, profile: bool = True,
             segments=None) -> Registration:
    """Validate and register a compound inference system."""
    for tname, task in graph.tasks.items():
        if not task.variants:
            raise RegistrationError(f"task {tname!r} has no variants")
        for v in task.variants:
            if v.arch not in ARCHS:
                raise RegistrationError(
                    f"task {tname!r} variant {v.name!r}: unknown arch "
                    f"{v.arch!r} (known: {sorted(ARCHS)})")
        names = [v.name for v in task.variants]
        if len(set(names)) != len(names):
            raise RegistrationError(f"task {tname!r}: duplicate variant "
                                    "names")
    for (t, v, t2) in graph.mult:
        if t not in graph.tasks or t2 not in graph.tasks:
            raise RegistrationError(f"mult factor ({t},{v},{t2}) references "
                                    "unknown task")
        if (t, t2) not in [(a, b) for (a, b) in graph.edges]:
            raise RegistrationError(f"mult factor ({t},{v},{t2}) has no "
                                    "matching edge")
    if graph.slo_latency_ms <= 0:
        raise RegistrationError("latency SLO must be positive")
    if not (0.0 < graph.slo_accuracy <= 1.0):
        raise RegistrationError("accuracy SLO must be in (0, 1]")

    kw = {"segments": segments} if segments is not None else {}
    profiler = Profiler(graph, **kw) if profile else Profiler(
        graph, table={(None,): None})  # type: ignore[arg-type]
    return Registration(graph=graph, profiler=profiler)
