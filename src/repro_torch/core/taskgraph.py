"""Compound-inference task graphs (paper §2, §3.1).

A :class:`TaskGraph` is a DAG of tasks; each task has multiple *model
variants* (accuracy ↔ latency ↔ cost).  Edges carry per-variant
*multiplicative factors* ``F(t, v, t')`` — e.g. a detector triggers one
downstream inference per detection (paper Eq. 4-5).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Path = Tuple[str, ...]

# Multi-app namespacing (DESIGN.md §11): when several compound apps are
# planned in one joint MILP or served by one runtime, task names are
# qualified "app::task" so per-app variables, queues and metrics never
# collide.  The empty app name ("") is the single-app legacy namespace
# and qualifies to the bare task name.
APP_SEP = "::"


def qualify(app: str, task: str) -> str:
    """Namespace ``task`` under ``app`` ("" → the bare task name)."""
    return f"{app}{APP_SEP}{task}" if app else task


def split_qualified(qtask: str) -> Tuple[str, str]:
    """Inverse of :func:`qualify`: ``"app::task" → (app, task)``;
    an unqualified name maps to the legacy ("", task) namespace."""
    app, sep, task = qtask.partition(APP_SEP)
    return (app, task) if sep else ("", qtask)


@dataclass(frozen=True)
class Variant:
    """One model variant of a task (paper §2 'Model variants')."""
    name: str
    arch: str                    # key into repro_torch.configs.ARCHS
    accuracy: float              # registered metric (model-card style)
    quant: str = "bf16"          # "bf16" | "int8" — int8 = quantized variant
    seq_len: int = 256           # tokens processed per request by this task
    gen_len: int = 32            # tokens generated per request (0 = encode-only)

    def __post_init__(self):
        if not (0.0 < self.accuracy <= 1.0):
            raise ValueError(f"{self.name}: accuracy must be in (0, 1]")
        if self.quant not in ("bf16", "int8"):
            raise ValueError(f"{self.name}: unknown quant {self.quant!r}")


@dataclass(frozen=True)
class Task:
    name: str
    variants: Tuple[Variant, ...]

    def variant(self, name: str) -> Variant:
        for v in self.variants:
            if v.name == name:
                return v
        raise KeyError(f"task {self.name}: no variant {name!r}")

    @property
    def max_accuracy(self) -> float:
        return max(v.accuracy for v in self.variants)

    @property
    def most_accurate(self) -> Variant:
        return max(self.variants, key=lambda v: v.accuracy)


@dataclass
class TaskGraph:
    """The registered compound inference system."""
    name: str
    tasks: Dict[str, Task]
    edges: List[Tuple[str, str]]
    # F(t, v, t'): expected downstream requests per upstream request when
    # task t runs variant v.  Missing entries default to 1.0.
    mult: Dict[Tuple[str, str, str], float] = field(default_factory=dict)
    slo_latency_ms: float = 1000.0
    # acceptable fraction of the maximum achievable accuracy (paper: 0.9)
    slo_accuracy: float = 0.9
    # fraction of requests taking each path; filled by finalize() if absent
    path_fractions: Dict[Path, float] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def __post_init__(self):
        self._validate()
        self._paths = self._enumerate_paths()
        if not self.path_fractions:
            frac = 1.0 / len(self._paths)
            self.path_fractions = {p: frac for p in self._paths}
        total = sum(self.path_fractions.values())
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"path fractions sum to {total}, expected 1")

    def _validate(self):
        names = set(self.tasks)
        for (a, b) in self.edges:
            if a not in names or b not in names:
                raise ValueError(f"edge ({a},{b}) references unknown task")
        # DAG check (Kahn)
        indeg = {t: 0 for t in names}
        for (_, b) in self.edges:
            indeg[b] += 1
        queue = [t for t, d in indeg.items() if d == 0]
        seen = 0
        while queue:
            t = queue.pop()
            seen += 1
            for (a, b) in self.edges:
                if a == t:
                    indeg[b] -= 1
                    if indeg[b] == 0:
                        queue.append(b)
        if seen != len(names):
            raise ValueError("task graph has a cycle")
        roots = [t for t in names
                 if not any(b == t for (_, b) in self.edges)]
        if len(roots) != 1:
            raise ValueError(f"expected exactly one entry task, got {roots}")
        self._entry = roots[0]

    # ------------------------------------------------------------------
    @property
    def entry(self) -> str:
        return self._entry

    def successors(self, t: str) -> List[str]:
        return [b for (a, b) in self.edges if a == t]

    def predecessors(self, t: str) -> List[str]:
        return [a for (a, b) in self.edges if b == t]

    def _enumerate_paths(self) -> List[Path]:
        paths: List[Path] = []

        def walk(t: str, acc: Tuple[str, ...]):
            nxt = self.successors(t)
            if not nxt:
                paths.append(acc + (t,))
                return
            for n in nxt:
                walk(n, acc + (t,))

        walk(self._entry, ())
        return paths

    @property
    def paths(self) -> List[Path]:
        return list(self._paths)

    @property
    def depth(self) -> int:
        return max(len(p) for p in self._paths) - 1

    def factor(self, t: str, v: str, t2: str) -> float:
        return self.mult.get((t, v, t2), 1.0)

    def topo_order(self) -> List[str]:
        order, seen = [], set()

        def visit(t):
            if t in seen:
                return
            for p in self.predecessors(t):
                visit(p)
            seen.add(t)
            order.append(t)

        for t in self.tasks:
            visit(t)
        return order

    # ------------------------------------------------------------------
    def demand_at_tasks(self, R: float,
                        fbar: Optional[Dict[Tuple[str, str], float]] = None
                        ) -> Dict[str, float]:
        """Eq. 5: propagate demand through the DAG.

        ``fbar[(t, t')]`` is the *observed average* multiplicative factor
        (paper §3.2 — an input that can change across MILP runs); defaults
        to the factor of each task's most accurate variant."""
        def f(t, t2):
            if fbar is not None and (t, t2) in fbar:
                return fbar[(t, t2)]
            return self.factor(t, self.tasks[t].most_accurate.name, t2)

        demand = {t: 0.0 for t in self.tasks}
        demand[self.entry] = R
        for t in self.topo_order():
            for t2 in self.successors(t):
                demand[t2] += demand[t] * f(t, t2)
        return demand
