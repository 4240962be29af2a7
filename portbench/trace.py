"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a stretch
of the window, reduced to device busy time, device time by operation and
idle gaps by what the host was doing.

On a card the profiler records the device's activity only: recording
every host operation as well slows the host-bound serving loop enough to
change what it measures.  What the host was doing comes from the
harness's own spans around its calls into the program (:meth:`span`),
stamped with the wall clock that the profiler's timestamps also use.  The
raw kineto events are read directly (no ``key_averages`` tree), so a
trace of a few hundred thousand kernels reduces in seconds.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def idle_pct(run) -> Optional[float]:
    """Share of the run's traced stretch in which no operation ran on the
    device; no reading without a device trace."""
    tr = run.device_trace
    if tr is None or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def span(trace: Optional["DeviceTrace"], name: str):
    """``trace.span(name)``, or nothing without a trace."""
    return contextlib.nullcontext() if trace is None else trace.span(name)


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Start and stop a profiler around part of the window; after
    :meth:`stop`, ``busy_s``, ``window_s``, ``ops`` (device seconds and
    count by operation name) and ``gaps`` (idle seconds by host range)."""

    def __init__(self, on_cuda: bool):
        self.on_cuda = on_cuda
        self._prof = None
        self._host: List[Tuple[int, int, str]] = []
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.ops: Dict[str, List[float]] = {}
        self.gaps: Dict[str, float] = {}

    def prime(self) -> None:
        """Start and stop once in set-up: the first start of a process
        initialises CUPTI, which takes seconds, and must not fall in the
        window."""
        self.start()
        if self.on_cuda:
            torch.ones(1, device="cuda").add_(1)
        self.stop()
        self.busy_s = self.window_s = None
        self.ops, self.gaps = {}, {}

    @contextlib.contextmanager
    def span(self, name: str):
        """A host range that idle gaps inside it are named by; recorded
        only while the profiler runs."""
        if self._prof is None:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self._host.append((a, time.time_ns(), name))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        if self.on_cuda:
            torch.cuda.synchronize()
        self._host = []
        self._prof = profile(activities=[ProfilerActivity.CUDA if self.on_cuda
                                         else ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        if self._prof is None:
            return
        if self.on_cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        self._reduce(events, self._t0, t1)

    def _reduce(self, events, t0: int, t1: int) -> None:
        dev, host = [], self._host
        ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for e in events:
            # user annotations mirrored on the device timeline are ranges,
            # not operations
            if e.device_type() == torch.autograd.DeviceType.CUDA and \
                    not e.is_user_annotation():
                a, b = e.start_ns(), e.end_ns()
                dev.append((a, b))
                o = ops[e.name()]
                o[0] += (b - a) / 1e9
                o[1] += 1
        busy = _union([(max(a, t0), min(b, t1)) for a, b in dev
                       if b > t0 and a < t1])
        self.window_s = (t1 - t0) / 1e9
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        self.ops = dict(ops)
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        # name each gap by the innermost host span open at its middle: a
        # sweep over the spans' starts and ends as the gaps advance
        host = [h for h in host if h[1] > h[0]]
        marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(host)]
                       + [(b, 0, i) for i, (_, b, _) in enumerate(host)])
        open_spans: Dict[int, Tuple[int, str]] = {}
        j = 0
        gaps: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while j < len(marks) and marks[j][0] <= mid:
                _, starts, i = marks[j]
                if starts:
                    open_spans[i] = (host[i][0], host[i][2])
                else:
                    open_spans.pop(i, None)
                j += 1
            label = (max(open_spans.values())[1] if open_spans
                     else "outside the harness's spans")
            gaps[label] += (b - a) / 1e9
        self.gaps = dict(gaps)

    def device_seconds(self, names) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        one of ``names``."""
        s, n = 0.0, 0
        for op, (t, c) in self.ops.items():
            if any(x in op for x in names):
                s += t
                n += c
        return s, n

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v[0]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
