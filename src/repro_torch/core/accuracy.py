"""Exact evaluator for the paper's accuracy model (Eq. 9-12).

The MILP uses a conservative linearization (DESIGN.md §5); every returned
configuration is re-checked HERE against the exact nonlinear definition —
the bound is one-sided, so Eq. 13 can never be violated by a config the
planner emits.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

from repro_torch.core.taskgraph import TaskGraph

# (task, variant, segment, batch) -> instance count
ConfigMap = Mapping[Tuple[str, str, str, int], int]


def effective_task_accuracy(graph: TaskGraph, task: str, config: ConfigMap,
                            throughput: Mapping, ) -> float:
    """Â(t) — throughput-weighted mean variant accuracy (Eq. 9-10)."""
    num = den = 0.0
    for key, m in config.items():
        t, v, s, b = key
        if t != task or m <= 0:
            continue
        h = throughput[key] * m                      # Ĥ(t,v,s,b), Eq. 9
        num += h * graph.tasks[t].variant(v).accuracy
        den += h
    if den == 0.0:
        return 0.0
    return num / den


def path_accuracy(graph: TaskGraph, path: Tuple[str, ...], config: ConfigMap,
                  throughput: Mapping) -> float:
    """A_p — product of task accuracies along the path (Eq. 11, PAS)."""
    acc = 1.0
    for t in path:
        acc *= effective_task_accuracy(graph, t, config, throughput)
    return acc


def a_obj(graph: TaskGraph, config: ConfigMap, throughput: Mapping) -> float:
    """A_obj — path-weighted accuracy normalized to A_max (Eq. 12)."""
    weighted = sum(graph.path_fractions[p]
                   * path_accuracy(graph, p, config, throughput)
                   for p in graph.paths)
    return weighted / a_max(graph)


def a_max(graph: TaskGraph) -> float:
    """Maximum achievable system accuracy — most accurate variant
    everywhere (paper: A_max computed as A_obj restricted to the most
    accurate variants)."""
    return sum(graph.path_fractions[p]
               * _prod(graph.tasks[t].max_accuracy for t in p)
               for p in graph.paths)


def a_obj_lower_bound(graph: TaskGraph, task_floor: Mapping[str, float]
                      ) -> float:
    """The MILP's Weierstrass linearization of Eq. 12:
    Π a_t ≥ 1 − Σ (1 − a_t) for a_t ∈ [0,1]."""
    weighted = 0.0
    for p in graph.paths:
        lb = 1.0 - sum(1.0 - task_floor[t] for t in p)
        weighted += graph.path_fractions[p] * lb
    return weighted / a_max(graph)


def _prod(it) -> float:
    out = 1.0
    for x in it:
        out *= x
    return out
