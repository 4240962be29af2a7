"""The plan types of the controller's MILP (paper §3.2): one admissible
(task, variant, segment, batch) tuple with its profiled constants, and a
concrete deployment of instance counts over such tuples.

A copy of ``Key``, ``TupleVar`` and ``PlanConfig`` of the JAX package's
``core/milp.py``, which is what the runtime consumes.  The planner itself
(the MILP, its solver and the profiler that feeds it) comes to the port in
a later slice; until then plans are built by hand or handed over.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import accuracy as acc_mod
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.hwspec import DEFAULT_POOL

Key = Tuple[str, str, str, int]


@dataclass(frozen=True)
class TupleVar:
    """One admissible (t, v, s, b) with its profiled constants.

    ``pool`` names the ClusterSpec pool whose capacity row the tuple's
    cost charges; ``streams`` is the slice's MPS-style multiplicity (the
    runtime spawns that many execution streams per instance without
    needing the partition catalogue)."""
    task: str
    variant: str
    segment: str
    batch: int
    latency_ms: float
    throughput: float
    cost: int
    accuracy: float
    pool: str = DEFAULT_POOL
    streams: int = 1

    @property
    def key(self) -> Key:
        return (self.task, self.variant, self.segment, self.batch)


@dataclass
class PlanConfig:
    """A concrete deployment: M(t,v,s,b) counts + derived metrics."""
    graph: TaskGraph
    counts: Dict[Key, int]
    tuples: Dict[Key, TupleVar]
    demand: Dict[str, float]
    # per-pool capacity the plan was solved against (None = legacy scalar)
    pool_budgets: Optional[Dict[str, int]] = None

    # ------------------------------------------------------------------
    @property
    def slices(self) -> int:
        return sum(self.tuples[k].cost * m for k, m in self.counts.items()
                   if m > 0)

    def pool_slices(self) -> Dict[str, int]:
        """Capacity units used per pool."""
        out: Dict[str, int] = {}
        for k, m in self.counts.items():
            if m > 0:
                j = self.tuples[k]
                out[j.pool] = out.get(j.pool, 0) + j.cost * m
        return out

    def lhat(self, task: str) -> float:
        """L̂(t): latency of the slowest ACTIVE instance (Eq. 2)."""
        ls = [self.tuples[k].latency_ms for k, m in self.counts.items()
              if m > 0 and k[0] == task]
        return max(ls) if ls else 0.0

    def path_latency(self, path: Tuple[str, ...]) -> float:
        """Σ 2·L̂ along the path (Eq. 3's LHS — 2x for queuing delay)."""
        return sum(2.0 * self.lhat(t) for t in path)

    def worst_path_latency(self) -> float:
        return max(self.path_latency(p) for p in self.graph.paths)

    def task_throughput(self, task: str) -> float:
        return sum(self.tuples[k].throughput * m
                   for k, m in self.counts.items()
                   if m > 0 and k[0] == task)

    def throughput_map(self) -> Dict[Key, float]:
        return {k: self.tuples[k].throughput for k in self.counts}

    def exact_a_obj(self) -> float:
        return acc_mod.a_obj(self.graph, self.counts, self.throughput_map())

    def task_effective_accuracy(self, task: str) -> float:
        return acc_mod.effective_task_accuracy(
            self.graph, task, self.counts, self.throughput_map())

    def feasible(self, slo_l: float, slo_a: float, s_avail: int,
                 tol: float = 1e-6) -> bool:
        if self.slices > s_avail:
            return False
        if self.pool_budgets is not None:
            for p, used in self.pool_slices().items():
                if used > self.pool_budgets.get(p, 0):
                    return False
        for t, r in self.demand.items():
            if self.task_throughput(t) < r - tol:
                return False
        if self.worst_path_latency() > slo_l + tol:
            return False
        return self.exact_a_obj() >= slo_a - tol

    def instances(self) -> List[Tuple[TupleVar, int]]:
        return [(self.tuples[k], m) for k, m in sorted(self.counts.items())
                if m > 0]
