"""Push-based telemetry export (DESIGN.md §17).

The pull scrape (``GET /metrics``) is the source of truth; the
:class:`PushExporter` is the *push* twin for fleets where a collector
can't reach every process: it snapshots the SAME
:class:`~repro_torch.obs.metrics.MetricsRegistry` (collectors run, so the
snapshot equals what a scrape would see), batches the samples, and
hands them to a sink — statsd line protocol or an OTLP-JSON-shaped
payload, both stdlib-only over a pluggable transport callable.

Delivery guarantees (tested):

* the hot path is NEVER blocked — :meth:`PushExporter.scrape` enqueues
  into a bounded deque and returns; when the queue is full the OLDEST
  batch is dropped and counted (freshest-data-wins);
* a failing sink is retried ``max_retries`` times with exponential
  backoff (injectable ``sleep`` keeps tests deterministic), then the
  batch is dropped and counted;
* every batch is accounted exactly once:
  ``enqueued == delivered + dropped_overflow + dropped_failed +
  pending`` (:meth:`PushExporter.stats`).

Wall-clock time and threads are legal here: ``repro_torch.obs`` is outside
the deterministic-sim packages (jigsaw-lint determinism pass, DESIGN.md
§15).

A copy of the JAX package's ``obs/export.py``.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Tuple

from repro_torch.obs.metrics import MetricsRegistry, Sample

__all__ = ["ListTransport", "MetricBatch", "OtlpJsonSink", "PushExporter",
           "StatsdSink"]

Transport = Callable[[str], None]


class ListTransport:
    """In-process transport: collects payload strings (tests / smoke)."""

    def __init__(self) -> None:
        self.payloads: List[str] = []

    def __call__(self, payload: str) -> None:
        self.payloads.append(payload)


@dataclass(frozen=True)
class MetricBatch:
    """One registry snapshot queued for delivery."""
    seq: int
    t_s: float
    samples: Tuple[Sample, ...]


class Sink(Protocol):
    def emit(self, batch: MetricBatch) -> None:
        """Deliver one batch; raise on failure (the exporter retries)."""


class StatsdSink:
    """Render a batch as dogstatsd lines: ``name:value|type|#k:v,...``
    (counters as ``|c``, everything else as gauges ``|g``)."""

    def __init__(self, transport: Transport) -> None:
        self.transport = transport

    def emit(self, batch: MetricBatch) -> None:
        lines: List[str] = []
        for name, kind, labels, value in batch.samples:
            t = "c" if kind == "counter" else "g"
            line = f"{name}:{value:g}|{t}"
            if labels:
                line += "|#" + ",".join(f"{k}:{v}" for k, v in labels)
            lines.append(line)
        self.transport("\n".join(lines))


class OtlpJsonSink:
    """Render a batch in the OTLP/HTTP JSON *shape* (resourceMetrics ->
    scopeMetrics -> metrics with gauge/sum datapoints) — close enough
    for an OTLP-JSON ingester, built with nothing but ``json``."""

    def __init__(self, transport: Transport,
                 service_name: str = "jigsaw-gateway") -> None:
        self.transport = transport
        self.service_name = service_name

    def emit(self, batch: MetricBatch) -> None:
        t_ns = int(batch.t_s * 1e9)
        metrics = []
        for name, kind, labels, value in batch.samples:
            point = {
                "timeUnixNano": str(t_ns),
                "asDouble": value,
                "attributes": [{"key": k, "value": {"stringValue": v}}
                               for k, v in labels],
            }
            body: dict = {"name": name}
            if kind == "counter":
                body["sum"] = {"isMonotonic": True,
                               "aggregationTemporality": 2,
                               "dataPoints": [point]}
            else:
                body["gauge"] = {"dataPoints": [point]}
            metrics.append(body)
        payload = {"resourceMetrics": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": self.service_name}}]},
            # the reference's scope name: both packages send the same bytes
            "scopeMetrics": [{"scope": {"name": "repro.obs"},
                              "metrics": metrics}],
        }]}
        self.transport(json.dumps(payload, sort_keys=True))


# ---------------------------------------------------------------------------
class PushExporter:
    """Batching push pump from a registry to a sink.

    Drive it manually (``scrape()`` + ``pump()`` — deterministic, used
    in tests and benches) or start the background thread (``start()`` /
    ``stop()``) which scrapes every ``interval_s`` wall seconds.
    """

    def __init__(self, registry: MetricsRegistry, sink: Sink, *,
                 interval_s: float = 1.0, queue_max: int = 8,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 backoff_mult: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if queue_max <= 0:
            raise ValueError("queue_max must be positive")
        self.registry = registry
        self.sink = sink
        self.interval_s = float(interval_s)
        self.queue_max = int(queue_max)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self._sleep = sleep
        self._queue: List[MetricBatch] = []
        self._lock = threading.Lock()
        self._seq = 0
        self.enqueued = 0
        self.delivered = 0
        self.dropped_overflow = 0
        self.dropped_failed = 0
        self.retries = 0
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer side (never blocks) -----------------------------------
    def scrape(self, now: Optional[float] = None) -> MetricBatch:
        """Snapshot the registry and enqueue one batch.  O(samples);
        drops the OLDEST queued batch when the queue is full."""
        t = time.time() if now is None else float(now)
        batch = MetricBatch(self._seq, t,
                            tuple(self.registry.snapshot()))
        self._seq += 1
        with self._lock:
            if len(self._queue) >= self.queue_max:
                self._queue.pop(0)
                self.dropped_overflow += 1
            self._queue.append(batch)
            self.enqueued += 1
        return batch

    # -- consumer side ---------------------------------------------------
    def pump(self) -> int:
        """Deliver every queued batch, retrying each with exponential
        backoff; returns the number delivered.  Runs on the exporter
        thread, or call it directly for deterministic tests."""
        delivered = 0
        while True:
            with self._lock:
                if not self._queue:
                    return delivered
                batch = self._queue.pop(0)
            delay = self.backoff_s
            for attempt in range(self.max_retries + 1):
                try:
                    self.sink.emit(batch)
                    self.delivered += 1
                    delivered += 1
                    break
                except Exception:   # noqa: BLE001 — sink failure IS the case
                    if attempt == self.max_retries:
                        self.dropped_failed += 1
                        break
                    self.retries += 1
                    self._sleep(delay)
                    delay *= self.backoff_mult

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        """Batch accounting: enqueued == delivered + dropped_overflow +
        dropped_failed + pending (the delivery invariant)."""
        with self._lock:
            pending = len(self._queue)
        return {"enqueued": self.enqueued, "delivered": self.delivered,
                "dropped_overflow": self.dropped_overflow,
                "dropped_failed": self.dropped_failed,
                "retries": self.retries, "pending": pending}

    # -- background pump -------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_ev.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="push-exporter", daemon=True)
        self._thread.start()

    def stop(self, *, flush: bool = True) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_ev.set()
        t.join(timeout=30.0)
        self._thread = None
        if flush:
            self.scrape()
            self.pump()

    def _loop(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            self.scrape()
            self.pump()
