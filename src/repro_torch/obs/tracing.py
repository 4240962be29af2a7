"""Per-request tracing across the task graph (DESIGN.md §14).

A :class:`Tracer` records spans — queue wait, service, and the covering
per-hop span — for sampled requests as they move through the
:class:`~repro_torch.runtime.cluster.ClusterRuntime` event loop or the live
gateway.  Export is Chrome-trace / Perfetto JSON (the ``traceEvents``
array of ``ph: "X"`` complete events): load the file at
``chrome://tracing`` or https://ui.perfetto.dev and each app renders as
a process, each request as a track (tid = root id), each task-graph hop
as one span with queue/service sub-phases.

Span timestamps are the runtime's *simulated* seconds (wall seconds for
the live gateway, which runs its clock in sim units scaled by
``time_scale``), converted to the microseconds Chrome-trace expects.

The tracer is bounded: ``max_events`` caps memory, ``sample_every``
traces one in N roots so instrumentation stays off the hot path at high
request rates (the overhead pin in ``BENCH_gateway.json`` is measured
with sampling on).

A copy of the JAX package's ``obs/tracing.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "validate_chrome_trace"]


@dataclass
class Span:
    """One complete ("X") trace event."""
    name: str
    cat: str
    start_s: float
    end_s: float
    app: str
    root_id: int
    args: Optional[dict] = None

    def to_event(self, pid: int) -> dict:
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self.start_s * 1e6,
              "dur": max(self.end_s - self.start_s, 0.0) * 1e6,
              "pid": pid, "tid": self.root_id}
        if self.args:
            ev["args"] = self.args
        return ev


@dataclass
class Tracer:
    """Bounded span recorder with 1-in-N root sampling."""

    max_events: int = 100_000
    sample_every: int = 1
    spans: List[Span] = field(default_factory=list)
    dropped: int = 0

    def enabled_for(self, root_id: int) -> bool:
        if self.sample_every <= 1:
            return True
        return root_id % self.sample_every == 0

    def record(self, name: str, cat: str, start_s: float, end_s: float,
               app: str, root_id: int,
               args: Optional[dict] = None) -> None:
        if len(self.spans) >= self.max_events:
            self.dropped += 1
            return
        self.spans.append(Span(name, cat, start_s, end_s, app, root_id,
                               args))

    def spans_for_root(self, root_id: int,
                       cat: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans
                if s.root_id == root_id and (cat is None or s.cat == cat)]

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0

    # -- export --------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The Chrome-trace JSON object: one process per app (metadata-
        named), one ``ph: "X"`` event per span."""
        pids: Dict[str, int] = {}
        events: List[dict] = []
        for s in self.spans:
            pid = pids.setdefault(s.app, len(pids) + 1)
            events.append(s.to_event(pid))
        for app, pid in pids.items():
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0,
                           "args": {"name": app or "app"}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def validate_chrome_trace(obj: dict) -> List[dict]:
    """Assert ``obj`` is a loadable Chrome-trace JSON object; returns the
    complete ("X") events.  Raises ``ValueError`` on malformed traces —
    used by tests and the gateway smoke job."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("chrome trace must be an object with traceEvents")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    complete: List[dict] = []
    for ev in events:
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"trace event missing {k!r}: {ev}")
        if ev["ph"] == "X":
            if "ts" not in ev or "dur" not in ev:
                raise ValueError(f"complete event missing ts/dur: {ev}")
            if ev["dur"] < 0:
                raise ValueError(f"negative span duration: {ev}")
            complete.append(ev)
    return complete
