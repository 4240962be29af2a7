"""Frontend (paper §3.1): request intake, deadline stamping, demand
tracking, and controller triggering.

The Frontend is the :class:`repro_torch.runtime.cluster.ClusterRuntime`'s
intake and the control plane's single source of truth: it stamps request
ids + deadlines, bins arrivals into demand timestamps, accumulates the
per-bin violation count the runtime reports back, and owns the ONE
re-plan trigger (:meth:`should_replan`) the controller consumes — there
is deliberately no second drift/violation check anywhere else.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.taskgraph import TaskGraph


@dataclass
class RequestMeta:
    """Stamped intake metadata: the id/deadline pair the runtime attaches
    to every root request, tagged with the owning app ("" single-app)."""
    req_id: int
    arrival_s: float
    deadline_s: float
    app: str = ""


@dataclass
class Frontend:
    """One app's intake.  A multi-app deployment runs one Frontend per
    co-located app (the ``app`` tag rides on every stamped
    :class:`RequestMeta`), each owning that app's demand bins, violation
    window and re-plan trigger — the controller re-plans JOINTLY when any
    of them fires (the JAX package's ``MultiAppController``; the port has no
    controller yet)."""
    graph: TaskGraph
    bin_seconds: float = 300.0
    comm_hop_ms: float = 10.0     # paper §4.4: per-hop communication latency
    app: str = ""                 # owning app tag (multi-app deployments)

    def __post_init__(self):
        self._ids = itertools.count()
        self._bin_counts: List[int] = [0]
        self._bin_idx = 0
        self.violations_this_bin = 0
        self.requests_this_bin = 0

    # ------------------------------------------------------------------
    @property
    def effective_slo_ms(self) -> float:
        """End-to-end SLO plus per-hop communication allowance
        (paper §4.4: +~10 ms per hop by application depth)."""
        return (self.graph.slo_latency_ms
                + self.comm_hop_ms * self.graph.depth)

    def submit(self, now_s: float) -> RequestMeta:
        """Stamp metadata (request id + deadline) and count demand.

        Feeds the demand bins only; the violation-trigger window counts
        datapath outcomes reported via ``record_bin_outcome`` (requests
        and violations together), keeping its rate on the same
        fan-weighted leaf-level basis as ``SimMetrics.violation_rate``."""
        b = int(now_s // self.bin_seconds)
        while b >= len(self._bin_counts):
            self._bin_counts.append(0)
        self._bin_counts[b] += 1
        return RequestMeta(next(self._ids), now_s,
                           now_s + self.effective_slo_ms / 1e3, self.app)

    def record_bin_outcome(self, requests: int, violations: int):
        """Fold a bin's datapath outcome into the trigger state — always
        requests and violations TOGETHER, so the violation rate keeps a
        denominator (the runtime reports each run's SimMetrics totals)."""
        self.requests_this_bin += requests
        self.violations_this_bin += violations

    def reset_bin(self):
        """Start a fresh violation-tracking window (one controller bin)."""
        self.violations_this_bin = 0
        self.requests_this_bin = 0

    def extrapolate_bin(self, bin_idx: int, observed_window_s: float):
        """The runtime observed only ``observed_window_s`` of bin
        ``bin_idx`` (e.g. a short simulated slice of a 300 s bin) —
        extrapolate the count so ``observed_demand`` reports a true rate."""
        if not (0 <= bin_idx < len(self._bin_counts)):
            return
        if 0.0 < observed_window_s < self.bin_seconds:
            scale = self.bin_seconds / observed_window_s
            self._bin_counts[bin_idx] = int(
                round(self._bin_counts[bin_idx] * scale))

    # ------------------------------------------------------------------
    def observed_demand(self) -> List[float]:
        """Demand (rps) per completed bin — the predictor's history."""
        return [c / self.bin_seconds for c in self._bin_counts]

    def should_replan(self, planned_for_rps: float,
                      threshold: float = 0.10,
                      violation_trigger: float = 0.05,
                      demand_rps: Optional[float] = None,
                      requests: Optional[int] = None,
                      violations: Optional[int] = None) -> bool:
        """THE re-plan trigger (single implementation, paper §3.1): demand
        drifted from the planned-for rate, or the last window's violation
        rate spiked.  ``demand_rps`` defaults to the last observed bin; the
        controller passes its *predicted* demand instead.

        ``requests``/``violations`` (always together) override the bin
        counters with an explicit observation window — the chaos
        engine's mid-bin monitor checks short intervals against the same
        trigger instead of growing a second implementation (DESIGN.md
        §13)."""
        if (requests is None) != (violations is None):
            raise ValueError("pass requests= and violations= together")
        if demand_rps is None:
            hist = self.observed_demand()
            if not hist:
                return False
            demand_rps = hist[-1]
        drift = abs(demand_rps - planned_for_rps) > threshold * max(
            planned_for_rps, 1e-9)
        if requests is None:
            requests = self.requests_this_bin
            violations = self.violations_this_bin
        vrate = violations / max(requests, 1)
        return drift or vrate > violation_trigger
