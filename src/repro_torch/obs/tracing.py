"""Per-request tracing across the task graph and inside the serving engine
(DESIGN.md §14).

A :class:`Tracer` records spans — queue wait, service, and the covering
per-hop span — for sampled requests as they move through the
:class:`~repro_torch.runtime.cluster.ClusterRuntime` event loop or the live
gateway, and the engine's own work: ``Batcher.pump``, ``Engine.generate``
with its prefill, decode steps and final copy, and ``GraphedDecode``'s
captures, cache loads, input writes and attention calls.  Export is
Chrome-trace / Perfetto JSON (the ``traceEvents`` array of ``ph: "X"``
complete events): load the file at ``chrome://tracing`` or
https://ui.perfetto.dev and each app renders as a process, each request
or batch as a track (tid = root id), each span as one bar.

Two ways to record.  :meth:`Tracer.record` takes explicit times: the
runtime's *simulated* seconds, or the live gateway's wall seconds scaled
by ``time_scale``.  :meth:`Tracer.span` stamps the tracer's own ``clock``
— wall seconds from ``time.time_ns()`` unless given another, the clock
that ``torch.profiler``'s (kineto's) timestamps use, so a gap on the
device timeline can be named by the span open on the host — and links
each span to the span open around it (``Span.parent``).  Spans nest per
tracer: one thread records into one tracer.  :meth:`Tracer.trace_gc`
adds one ``gc`` span per collection of the interpreter's collector.

The tracer is bounded: ``max_events`` caps memory, ``sample_every``
traces one in N roots so instrumentation stays off the hot path at high
request rates (the overhead pin in ``BENCH_gateway.json`` is measured
with sampling on).
"""
from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "validate_chrome_trace"]


def wall_s() -> float:
    """Wall seconds from ``time.time_ns()``: the clock of kineto's
    timestamps."""
    return time.time_ns() * 1e-9


@dataclass(slots=True)
class Span:
    """One complete ("X") trace event; ``parent`` is the index in
    ``Tracer.spans`` of the span open around it, if any."""
    name: str
    cat: str
    start_s: float
    end_s: float
    app: str
    root_id: int
    args: Optional[dict] = None
    parent: Optional[int] = None

    def to_event(self, pid: int) -> dict:
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self.start_s * 1e6,
              "dur": max(self.end_s - self.start_s, 0.0) * 1e6,
              "pid": pid, "tid": self.root_id}
        if self.args:
            ev["args"] = self.args
        return ev


class _Open:
    """The scope of one span from :meth:`Tracer.span`: yields the span (its
    ``args`` open to additions) and stamps its end on exit."""
    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer, self.span = tracer, span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> bool:
        t = self.tracer
        self.span.end_s = t.clock()
        t._open.pop()
        return False


@dataclass
class Tracer:
    """Bounded span recorder with 1-in-N root sampling."""

    max_events: int = 100_000
    sample_every: int = 1
    spans: List[Span] = field(default_factory=list)
    dropped: int = 0
    clock: Callable[[], float] = wall_s
    # the spans open now, innermost last, each with its index in ``spans``
    # (None where the span was dropped); the last root id :meth:`span` made
    _open: List[tuple] = field(default_factory=list, init=False, repr=False)
    _roots: int = field(default=0, init=False, repr=False)
    _gc_start: float = field(default=0.0, init=False, repr=False)
    _gc_hooked: bool = field(default=False, init=False, repr=False)

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

    def _add(self, span: Span) -> Optional[int]:
        if len(self.spans) >= self.max_events:
            self.dropped += 1
            return None
        self.spans.append(span)
        return len(self.spans) - 1

    def span(self, name: str, cat: str, root_id: Optional[int] = None,
             app: Optional[str] = None, **args) -> _Open:
        """``with tracer.span(...) as s:`` records one span on ``clock``
        around the block; ``s.args`` (the keyword arguments) may gain
        entries before it closes.  ``root_id`` and ``app`` default to the
        enclosing span's, or a new root and ``""`` outside any."""
        up = self._open[-1] if self._open else None
        if root_id is None and up is not None:
            root_id = up[1].root_id
        elif root_id is None:
            self._roots += 1
            root_id = self._roots
        if app is None:
            app = up[1].app if up is not None else ""
        s = Span(name, cat, 0.0, 0.0, app, root_id, args,
                 up[0] if up is not None else None)
        self._open.append((self._add(s), s))
        s.start_s = self.clock()
        return _Open(self, s)

    # -- the interpreter's collector ----------------------------------
    def trace_gc(self) -> None:
        """Record one ``gc`` span (args ``generation``, ``collected``) per
        collection from now until :meth:`close`, under the span open
        when it ran."""
        if not self._gc_hooked:
            gc.callbacks.append(self._on_gc)
            self._gc_hooked = True

    def close(self) -> None:
        if self._gc_hooked:
            gc.callbacks.remove(self._on_gc)
            self._gc_hooked = False

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = self.clock()
            return
        end = self.clock()
        up = self._open[-1] if self._open else None
        self._add(Span("gc", "gc", self._gc_start, end,
                       up[1].app if up is not None else "",
                       up[1].root_id if up is not None else -1,
                       {"generation": info["generation"],
                        "collected": info["collected"]},
                       up[0] if up is not None else None))

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
