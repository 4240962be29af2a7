"""Leaf module: serving metrics + server state shared by every backend.

Deliberately imports nothing from ``repro_torch.core`` at module level so it can
be loaded from either side of the runtime/core boundary without cycles.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:   # pragma: no cover — typing only
    from repro_torch.core.milp import TupleVar
    from repro_torch.core.taskgraph import TaskGraph


@dataclass
class SimMetrics:
    """Serving outcome of one run.

    The top-level counters aggregate the whole run.  A multi-app run
    (``ClusterRuntime.multi``) additionally files each app's outcome
    under ``by_app`` — per-app sub-metrics use the app's PLAIN task
    names in ``traffic`` so ``realized_a_obj(app_graph)`` works
    unchanged, while the aggregate keys traffic by the qualified
    ``app::task`` name.  Single-app runs leave ``by_app`` empty.

    Runs that execute a live reconfiguration additionally file the
    outcome of requests ARRIVING inside a transition window under
    ``window`` (its own ledger, warmup-independent — the switching cost
    must stay visible even during warm-up), with ``transition_window_s``
    the summed window span; atomic legacy runs leave both untouched.

    Chaos runs (DESIGN.md §13) add three degradation ledgers.
    ``drop_reasons`` attributes every fan-weighted drop to its cause —
    ``"failed_capacity"`` (the task had lost servers to kills or
    preemption when the drop happened), ``"deadline"`` / ``"stale"``
    (genuine SLO misses), ``"admission"`` / ``"shed"`` (the degradation
    ladder's deliberate load shedding) — so experiments can tell shed
    load from real violations.  ``admission_dropped`` counts the ladder's
    entry-gate drops, ``degraded_served`` the sub-requests served by an
    accuracy-downshifted server.  ``by_domain`` files the outcome of
    requests arriving AFTER a domain failure under that domain's name
    (per-domain attainment: what the blast radius cost)."""
    completions: int = 0           # leaf sub-requests serviced
    missed: int = 0                # serviced but past the deadline
    dropped: int = 0               # early-drops, fan-out weighted (§4.5)
    latencies_ms: List[float] = field(default_factory=list)
    traffic: Dict[Tuple[str, str], int] = field(default_factory=dict)
    by_app: Dict[str, "SimMetrics"] = field(default_factory=dict)
    # transition-window attainment (DESIGN.md §12)
    window: Optional["SimMetrics"] = None
    transition_window_s: float = 0.0
    # chaos / degradation accounting (DESIGN.md §13)
    drop_reasons: Dict[str, int] = field(default_factory=dict)
    admission_dropped: int = 0     # ladder entry-gate drops (fan-weighted)
    degraded_served: int = 0       # sub-requests served on downshifted tuples
    by_domain: Dict[str, "SimMetrics"] = field(default_factory=dict)

    def app(self, name: str) -> "SimMetrics":
        """This app's sub-metrics (created on first use)."""
        sub = self.by_app.get(name)
        if sub is None:
            sub = self.by_app[name] = SimMetrics()
        return sub

    def domain(self, name: str) -> "SimMetrics":
        """Attainment ledger of one failed domain (created on first use):
        the outcome of requests arriving after its failure."""
        sub = self.by_domain.get(name)
        if sub is None:
            sub = self.by_domain[name] = SimMetrics()
        return sub

    def count_drop(self, n: int, reason: str) -> None:
        """File ``n`` fan-weighted drops under ``reason`` (and the
        aggregate ``dropped`` counter)."""
        self.dropped += n
        self.drop_reasons[reason] = self.drop_reasons.get(reason, 0) + n
        if reason == "admission":
            self.admission_dropped += n

    @property
    def violations(self) -> int:
        return self.missed + self.dropped

    @property
    def total_requests(self) -> int:
        return self.completions + self.dropped

    @property
    def violation_rate(self) -> float:
        return self.violations / max(self.total_requests, 1)

    @property
    def p99_ms(self) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(self.latencies_ms, 99))

    def realized_task_accuracy(self, graph: "TaskGraph", task: str) -> float:
        num = den = 0.0
        for (t, v), n in self.traffic.items():
            if t == task:
                num += n * graph.tasks[t].variant(v).accuracy
                den += n
        return num / den if den else 1.0

    def realized_a_obj(self, graph: "TaskGraph") -> float:
        from repro_torch.core import accuracy as acc
        weighted = 0.0
        for p in graph.paths:
            a = 1.0
            for t in p:
                a *= self.realized_task_accuracy(graph, t)
            weighted += graph.path_fractions[p] * a
        return weighted / acc.a_max(graph)


def diff_metrics(a: Any, b: Any, path: str = "metrics") -> List[str]:
    """Recursive exact-equality diff of two :class:`SimMetrics`.

    Returns the list of diverging field paths (empty == field-exact
    identical — floats compared with ``==``; "close" is already a
    determinism bug).  Dataclass-valued fields and dicts of dataclasses
    (``by_app`` / ``by_domain``) recurse; dict comparison is
    key-set-based (insertion order is not part of the contract), list
    comparison is order-sensitive and names the first diverging index.

    This is the shared differential oracle: the determinism sanitizer
    (``tools.analyze.sanitize_determinism``) uses it to compare seeded
    replays, and the runtime parity suite (``tests/test_runtime_parity``)
    uses it to compare the vectorized event loop against the legacy one.
    """
    out: List[str] = []
    if a is None or b is None:
        if (a is None) != (b is None):
            out.append(f"{path}: {a!r} != {b!r}")
        return out
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        p = f"{path}.{f.name}"
        if dataclasses.is_dataclass(va) or dataclasses.is_dataclass(vb):
            out.extend(diff_metrics(va, vb, p))
        elif isinstance(va, dict):
            if set(va) != set(vb):
                out.append(f"{p}: key sets differ "
                           f"({sorted(set(va) ^ set(vb))!r})")
                continue
            for k in va:
                if dataclasses.is_dataclass(va[k]):
                    out.extend(diff_metrics(va[k], vb[k], f"{p}[{k!r}]"))
                elif va[k] != vb[k]:
                    out.append(f"{p}[{k!r}]: {va[k]!r} != {vb[k]!r}")
        elif isinstance(va, list):
            if len(va) != len(vb):
                out.append(f"{p}: length {len(va)} != {len(vb)}")
            elif va != vb:
                i = next(i for i, (x, y) in enumerate(zip(va, vb))
                         if x != y)
                out.append(f"{p}[{i}]: {va[i]!r} != {vb[i]!r}")
        elif va != vb:
            out.append(f"{p}: {va!r} != {vb!r}")
    return out


@dataclass
class Server:
    """One execution stream of one deployed instance.

    ``app`` tags the co-located application the stream belongs to (""
    in single-app runtimes): batches are formed per (app, task) queue,
    so a server only ever serves its own app's requests.

    ``retire_at`` implements transition draining (DESIGN.md §12): past
    it the stream accepts no new batches (in-flight work still
    completes, then the runtime removes the server).  An incoming
    stream's warm-up is expressed through ``busy_until`` — it exists
    from the start but only becomes dispatchable once ready.

    ``degraded`` marks a stream the degradation ladder downshifted to a
    cheaper variant (DESIGN.md §13) — requests it serves are counted
    under ``SimMetrics.degraded_served``."""
    tup: "TupleVar"
    idx: int
    busy_until: float = 0.0
    served: int = 0
    app: str = ""
    retire_at: float = math.inf
    degraded: bool = False
