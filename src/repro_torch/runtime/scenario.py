"""Scenario API: WHAT the cluster is asked to serve.

A :class:`Scenario` bundles an arrival process (Poisson, trace replay,
burst, diurnal), a failure-injection schedule, a capacity-change schedule
and an SLO scale into one declarative object that the
:class:`~repro_torch.runtime.cluster.ClusterRuntime` executes against any
:class:`~repro_torch.runtime.backend.ExecutionBackend`.  The same scenario runs
unmodified against the profiled-latency simulation backend and the real
``serving.Engine`` backend — that parity is what makes multi-backend
evaluation (and the paper's empirical claims) reproducible.

Multi-app scenarios (:meth:`Scenario.multi`) carry one independent
:class:`ArrivalProcess` per co-located app instead of a single stream;
``ClusterRuntime.multi`` interleaves them on one event clock.  Failure
and capacity events gain an ``app`` scope in that setting, while
index-based failures stay global (a host dying under several apps).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (Any, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, Union, runtime_checkable)

import numpy as np

from repro_torch.core.trace import DemandTrace, burst_trace, diurnal_trace


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------
@runtime_checkable
class ArrivalProcess(Protocol):
    """Generates the root-request arrival times of one run."""

    def times(self, rng: np.random.Generator,
              duration_s: float) -> List[float]:
        ...


@dataclass(frozen=True)
class PoissonArrivals:
    """Homogeneous Poisson stream at ``rate_rps``.

    Draw-for-draw identical to the legacy ``Simulator.run`` arrival loop so
    the compatibility shim reproduces seed-exact traces."""
    rate_rps: float

    def times(self, rng: np.random.Generator,
              duration_s: float) -> List[float]:
        out: List[float] = []
        t = 0.0
        while t < duration_s:
            t += rng.exponential(1.0 / max(self.rate_rps, 1e-9))
            out.append(t)
        return out


@dataclass(frozen=True)
class TraceArrivals:
    """Piecewise-Poisson replay of a :class:`DemandTrace`.

    The trace's bins are stretched/compressed to span ``duration_s``; the
    instantaneous rate at time ``t`` is the bin ``t`` falls in.  A draw
    that overshoots its bin boundary restarts from the boundary at the
    next bin's rate — exact for piecewise-constant rates (memorylessness),
    so idle (zero-rate) bins don't swallow later bins' arrivals."""
    trace: DemandTrace

    def times(self, rng: np.random.Generator,
              duration_s: float) -> List[float]:
        rps = np.asarray(self.trace.rps, float)
        n = len(rps)
        bin_s = duration_s / n
        out: List[float] = []
        t, b = 0.0, 0
        while t < duration_s:
            while b < n - 1 and t >= (b + 1) * bin_s:
                b += 1             # catch up to the bin containing t
            nxt = t + rng.exponential(1.0 / max(float(rps[b]), 1e-9))
            bin_end = (b + 1) * bin_s
            if b < n - 1 and nxt > bin_end:
                # no arrival left in this bin — resample from the boundary
                # (the explicit index advance guarantees progress even
                # when float rounding puts bin_end back inside bin b)
                t, b = bin_end, b + 1
                continue
            t = nxt
            out.append(t)
        return out


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FailureEvent:
    """Kill servers at ``at_s``: explicit ``indices``, or ``count`` servers
    of ``task`` (``task=None`` → the task with the most servers).

    ``indices`` are global server ids, so an index-based failure models a
    HOST dying: in a multi-app runtime it can take out streams of several
    co-located apps at once (shared-capacity failure).  ``app`` scopes a
    task-based kill to one app's servers (multi-app runtimes; ignored
    when ``indices`` is given).  ``pool`` restricts a task-based kill to
    servers deployed in that ClusterSpec pool — the runtime then
    attributes the dead capacity to the pool automatically
    (``ClusterRuntime.dead_units``), closing the loop the controller's
    manual ``dead_units=`` dict used to hand-feed."""
    at_s: float
    indices: Optional[Tuple[int, ...]] = None
    count: int = 1
    task: Optional[str] = None
    app: str = ""
    pool: Optional[str] = None


@dataclass(frozen=True)
class DomainFailureEvent:
    """A correlated infrastructure failure: at ``at_s`` the named
    failure domain (rack / power group — see ``Pool.domains``) dies,
    killing the domain's capacity units in EVERY member pool at once.
    The runtime resolves the blast radius via its ``ClusterSpec``
    (``cluster=`` must be attached) and records the lost physical units
    per pool for a failure detector."""
    at_s: float
    domain: str


@dataclass(frozen=True)
class PreemptionEvent:
    """Spot capacity reclaim: at ``at_s`` the provider serves notice
    that ``fraction`` of pool ``pool`` disappears after ``notice_s``.

    The notice window becomes a drain hand-over (DESIGN.md §12): every
    affected server gets ``retire_at = at_s + notice_s`` stamped, so
    in-flight and notice-window work still completes on the doomed
    capacity but nothing new is dispatched past the hand-over.  The
    reclaimed physical units are recorded as dead capacity (the pool's
    ``slice_price`` is what made the planner buy the cheap spot units
    in the first place — the detector makes it re-plan without them)."""
    at_s: float
    pool: str
    notice_s: float = 2.0
    fraction: float = 1.0


@dataclass(frozen=True)
class CapacityEvent:
    """Elasticity: at ``at_s`` add (``delta > 0``) or retire (``delta < 0``)
    ``|delta|`` execution streams of ``task``, cloning an existing tuple.

    ``pool`` restricts the event to instances deployed in that
    ClusterSpec pool (None = any pool) — capacity joins/retires are
    per-pool events in a heterogeneous cluster.  ``app`` scopes the
    event to one co-located app's servers (multi-app runtimes)."""
    at_s: float
    task: str
    delta: int
    pool: Optional[str] = None
    app: str = ""


@dataclass(frozen=True)
class TransitionEvent:
    """Live reconfiguration: at ``at_s`` the runtime starts executing
    ``plan`` (a transition plan, duck-typed, diffing the
    CURRENTLY deployed config against its target).  Outgoing instances
    drain, incoming instances warm up, and the run's
    ``SimMetrics.window`` ledger records attainment inside the
    transition window — see DESIGN.md §12."""
    at_s: float
    plan: Any                       # a transition plan, duck-typed


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AppArrivals:
    """One co-located app's independent arrival process (multi-app
    scenarios — see :meth:`Scenario.multi`)."""
    app: str
    arrivals: ArrivalProcess


@dataclass(frozen=True)
class Scenario:
    """One declarative serving experiment.

    Single-app scenarios set ``arrivals``; multi-app scenarios set
    ``apps`` instead — one independent :class:`ArrivalProcess` per
    co-located app, interleaved on one event clock by
    ``ClusterRuntime.multi``.  Exactly one of the two must be given.
    """
    arrivals: Optional[ArrivalProcess] = None
    duration_s: float = 20.0
    warmup_s: float = 2.0
    failures: Tuple[FailureEvent, ...] = ()
    capacity: Tuple[CapacityEvent, ...] = ()
    slo_scale: float = 1.0            # deadline = arrival + SLO * slo_scale
    name: str = "scenario"
    apps: Tuple[AppArrivals, ...] = ()
    transitions: Tuple[TransitionEvent, ...] = ()
    # chaos schedules (DESIGN.md §13): correlated domain deaths and spot
    # preemption notices, expanded by the runtime against its ClusterSpec
    domain_failures: Tuple[DomainFailureEvent, ...] = ()
    preemptions: Tuple[PreemptionEvent, ...] = ()

    def __post_init__(self) -> None:
        if (self.arrivals is None) == (not self.apps):
            raise ValueError("set exactly one of arrivals= (single-app) "
                             "or apps= (multi-app)")
        seen = [a.app for a in self.apps]
        if len(set(seen)) != len(seen):
            raise ValueError(f"duplicate app workloads: {seen}")

    # -- constructors ---------------------------------------------------
    @classmethod
    def poisson(cls, rate_rps: float, duration_s: float = 20.0,
                warmup_s: float = 2.0, **kw: Any) -> "Scenario":
        return cls(PoissonArrivals(rate_rps), duration_s, warmup_s,
                   name=f"poisson@{rate_rps:g}rps", **kw)

    @classmethod
    def replay(cls, trace: DemandTrace, duration_s: float = 20.0,
               warmup_s: float = 2.0, **kw: Any) -> "Scenario":
        return cls(TraceArrivals(trace), duration_s, warmup_s,
                   name="trace-replay", **kw)

    @classmethod
    def diurnal(cls, peak_rps: float, duration_s: float = 20.0,
                warmup_s: float = 2.0, *, seed: int = 0, bins: int = 48,
                **kw: Any) -> "Scenario":
        tr = diurnal_trace(seed=seed, bins=bins).scaled_to_max(peak_rps)
        return cls(TraceArrivals(tr), duration_s, warmup_s,
                   name=f"diurnal@{peak_rps:g}rps", **kw)

    @classmethod
    def burst(cls, base_rps: float, burst_rps: float,
              duration_s: float = 20.0, warmup_s: float = 2.0, *,
              bins: int = 40, period_bins: int = 10, duty: float = 0.3,
              **kw: Any) -> "Scenario":
        tr = burst_trace(base_rps, burst_rps, bins=bins,
                         period_bins=period_bins, duty=duty)
        return cls(TraceArrivals(tr), duration_s, warmup_s,
                   name=f"burst@{base_rps:g}/{burst_rps:g}rps", **kw)

    @classmethod
    def step_change(cls, rate0_rps: float, rate1_rps: float,
                    duration_s: float = 20.0, warmup_s: float = 2.0, *,
                    switch_frac: float = 0.5, **kw: Any) -> "Scenario":
        """Demand steps from ``rate0`` to ``rate1`` at ``switch_frac`` of
        the run — the canonical reconfiguration workload (the plan for
        rate0 must transition to the plan for rate1 mid-traffic)."""
        if not 0.0 < switch_frac < 1.0:
            raise ValueError("switch_frac must be in (0, 1)")
        bins = 20
        cut = max(1, min(bins - 1, int(round(bins * switch_frac))))
        tr = DemandTrace(np.array([float(rate0_rps)] * cut
                                  + [float(rate1_rps)] * (bins - cut)))
        return cls(TraceArrivals(tr), duration_s, warmup_s,
                   name=f"step@{rate0_rps:g}->{rate1_rps:g}rps", **kw)

    @classmethod
    def multi(cls, workloads: "Mapping[str, ArrivalProcess]",
              duration_s: float = 20.0, warmup_s: float = 2.0,
              **kw: Any) -> "Scenario":
        """Multi-app scenario: ``workloads`` maps app name → that app's
        independent arrival process, e.g.::

            Scenario.multi({"social": PoissonArrivals(40.0),
                            "traffic": PoissonArrivals(15.0)},
                           duration_s=30.0)
        """
        return cls(None, duration_s, warmup_s,
                   apps=tuple(AppArrivals(a, p)
                              for a, p in workloads.items()),
                   name="multi:" + "+".join(workloads), **kw)

    # -- derived scenarios ----------------------------------------------
    def with_failures(self, *events: FailureEvent) -> "Scenario":
        return dataclasses.replace(
            self, failures=self.failures + tuple(events))

    def with_capacity(self, *events: CapacityEvent) -> "Scenario":
        return dataclasses.replace(
            self, capacity=self.capacity + tuple(events))

    def with_transitions(self, *events: TransitionEvent) -> "Scenario":
        return dataclasses.replace(
            self, transitions=self.transitions + tuple(events))

    def with_chaos(self, *events: Union[DomainFailureEvent,
                                    PreemptionEvent]) -> "Scenario":
        """Add correlated-failure / preemption events (any mix of
        :class:`DomainFailureEvent` and :class:`PreemptionEvent`)."""
        dom = tuple(e for e in events if isinstance(e, DomainFailureEvent))
        pre = tuple(e for e in events if isinstance(e, PreemptionEvent))
        if len(dom) + len(pre) != len(events):
            bad = [e for e in events
                   if not isinstance(e, (DomainFailureEvent,
                                         PreemptionEvent))]
            raise TypeError(f"with_chaos takes DomainFailureEvent / "
                            f"PreemptionEvent, got {bad!r}")
        return dataclasses.replace(
            self, domain_failures=self.domain_failures + dom,
            preemptions=self.preemptions + pre)

    def slo_sweep(self, scales: Sequence[float]) -> List["Scenario"]:
        """SLO sensitivity sweep: the same workload under tighter/looser
        deadlines (paper §4.4-style sensitivity analysis)."""
        return [dataclasses.replace(self, slo_scale=float(s),
                                    name=f"{self.name}|slo x{s:g}")
                for s in scales]
