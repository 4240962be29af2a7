"""Prometheus-style metrics primitives (DESIGN.md §14).

A tiny, dependency-free subset of the Prometheus client model: a
:class:`MetricsRegistry` holding :class:`Counter` / :class:`Gauge` /
:class:`Histogram` families, rendered in the text exposition format
(``text/plain; version=0.0.4``) that any Prometheus-compatible scraper
ingests.  Label values are positional against the family's declared
``labelnames`` — the hot path (runtime event loop) does tuple-keyed dict
updates, no string formatting until scrape time.

Counter semantics mirror :class:`~repro_torch.runtime.metrics.SimMetrics`
exactly where the two overlap (completions, missed, fan-weighted drops
by reason) so a mid-run scrape sums to the final SimMetrics totals —
tested in ``tests/test_obs.py``.

``parse_exposition`` is the inverse used by tests and the gateway smoke
job; it parses the subset this module emits (one flat sample per line,
``name{label="v"} value``).

A copy of the JAX package's ``obs/metrics.py``.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Sample",
           "parse_exposition"]

# flat structured sample: (name, kind, ((label, value), ...), value) —
# what MetricsRegistry.snapshot() yields and the push exporter ships
Sample = Tuple[str, str, Tuple[Tuple[str, str], ...], float]

_DEF_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    f = float(value)
    return repr(int(f)) if f == int(f) else repr(f)


class _Family:
    """One metric family: a name, help text, declared label names, and a
    dict of label-value-tuple -> sample state."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._samples: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Sequence[str]) -> Tuple[str, ...]:
        # hot path: label values must already be strings (the runtime
        # event loop calls this per event; per-element str() was 30% of
        # the instrumentation overhead budget)
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(labels)} label values for "
                f"labelnames {self.labelnames}")
        return tuple(labels)

    def value(self, *labels: str) -> float:
        return self._samples.get(self._key(labels), 0.0)

    def samples(self) -> Dict[Tuple[str, ...], float]:
        return dict(self._samples)

    # -- exposition ----------------------------------------------------
    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [f'{n}="{_escape(v)}"'
                 for n, v in list(zip(self.labelnames, key)) + list(extra)]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._samples):
            lines.append(f"{self.name}{self._label_str(key)} "
                         f"{_fmt(self._samples[key])}")
        return lines


class Counter(_Family):
    """Monotonically increasing sample per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        k = self._key(labels)
        self._samples[k] = self._samples.get(k, 0.0) + amount


class Gauge(_Family):
    """Set-to-current-value sample per label set."""

    kind = "gauge"

    def set(self, value: float, *labels: str) -> None:
        self._samples[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        k = self._key(labels)
        self._samples[k] = self._samples.get(k, 0.0) + amount


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus semantics: bucket counts
    are cumulative, ``+Inf`` bucket == ``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = _DEF_BUCKETS) -> None:
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label-set: [bucket counts..., +Inf count], sum
        self._hist: Dict[Tuple[str, ...], List[float]] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, *labels: str) -> None:
        k = self._key(labels)
        row = self._hist.get(k)
        if row is None:
            row = self._hist[k] = [0.0] * (len(self.buckets) + 1)
            self._sum[k] = 0.0
        # non-cumulative per-bucket counts internally; cumulated at
        # render (bisect: buckets are sorted, value <= buckets[i] iff
        # i == bisect_left; past-the-end lands in the +Inf slot)
        row[bisect.bisect_left(self.buckets, value)] += 1
        self._sum[k] += value
        self._samples[k] = self._samples.get(k, 0.0) + 1   # _count

    def value(self, *labels: str) -> float:
        """Observation count for the label set (matches ``_count``)."""
        return self._samples.get(self._key(labels), 0.0)

    def sum(self, *labels: str) -> float:
        return self._sum.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._hist):
            cum = 0.0
            for b, n in zip(self.buckets, self._hist[key]):
                cum += n
                lines.append(
                    f"{self.name}_bucket"
                    f"{self._label_str(key, (('le', _fmt(b)),))} "
                    f"{_fmt(cum)}")
            cum += self._hist[key][-1]
            lines.append(f"{self.name}_bucket"
                         f"{self._label_str(key, (('le', '+Inf'),))} "
                         f"{_fmt(cum)}")
            lines.append(f"{self.name}_sum{self._label_str(key)} "
                         f"{_fmt(self._sum[key])}")
            lines.append(f"{self.name}_count{self._label_str(key)} "
                         f"{_fmt(cum)}")
        return lines


class MetricsRegistry:
    """Get-or-create registry of metric families.

    Creation is idempotent per (name, kind); re-registering a name with a
    different kind or label set fails loud — two subsystems silently
    sharing a name is a bug.  ``render()`` emits the full exposition
    text; a lock makes scrape-during-serve safe from the gateway's
    asyncio handlers (the simulated runtime is single-threaded and never
    contends)."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a callable run at the START of every ``render()`` —
        for gauges derived from cheaper running state (e.g. attainment),
        so the hot path pays nothing until someone scrapes."""
        self._collectors.append(fn)

    def _get(self, cls: type, name: str, help: str,
             labelnames: Sequence[str], **kw: Any) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = _DEF_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def render(self) -> str:
        for fn in self._collectors:
            fn()
        with self._lock:
            lines: List[str] = []
            for name in sorted(self._families):
                lines.extend(self._families[name].render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> List[Sample]:
        """Structured twin of :meth:`render` for the push exporter:
        collectors run first, so the snapshot equals what a scrape at
        the same instant would expose.  Histograms flatten to their
        ``_count`` / ``_sum`` series (the statsd/OTLP sinks have no
        native bucket shape)."""
        for fn in self._collectors:
            fn()
        out: List[Sample] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                for key in sorted(fam._samples):
                    lbl = tuple(zip(fam.labelnames, key))
                    if isinstance(fam, Histogram):
                        out.append((f"{name}_count", "counter", lbl,
                                    fam._samples[key]))
                        out.append((f"{name}_sum", "counter", lbl,
                                    fam._sum[key]))
                    else:
                        out.append((name, fam.kind, lbl,
                                    fam._samples[key]))
        return out


def parse_exposition(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                                  float]]:
    """Parse the exposition text this module renders back into
    ``{metric_name: {((label, value), ...): sample}}`` — the test /
    smoke-job inverse of :meth:`MetricsRegistry.render`."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labelpart, value = rest.rsplit("} ", 1)
            labels: List[Tuple[str, str]] = []
            for item in _split_labels(labelpart):
                k, v = item.split("=", 1)
                v = v.strip('"').replace(r'\"', '"') \
                    .replace(r"\n", "\n").replace(r"\\", "\\")
                labels.append((k, v))
            key = tuple(labels)
        else:
            name, value = line.rsplit(" ", 1)
            key = ()
        out.setdefault(name, {})[key] = (
            math.inf if value == "+Inf" else float(value))
    return out


def _split_labels(s: str) -> Iterable[str]:
    """Split ``a="x",b="y,z"`` on commas outside quotes."""
    item: List[str] = []
    in_q, prev = False, ""
    for ch in s:
        if ch == '"' and prev != "\\":
            in_q = not in_q
        if ch == "," and not in_q:
            yield "".join(item)
            item = []
        else:
            item.append(ch)
        prev = ch
    if item:
        yield "".join(item)
