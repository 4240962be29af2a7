"""The controller (paper §3.1-3.2): demand prediction → MILP → placement →
reconfiguration, driven per demand-timestamp bin.

Also the fault-tolerance / elasticity brain: on capacity change (failed
chips or added pods) it re-solves with the adjusted ``S_avail`` and the
placer routes around dead hosts.

The controller is pure control plane: each bin it builds (or receives) a
:class:`~repro_torch.runtime.scenario.Scenario` and executes it on a
:class:`~repro_torch.runtime.cluster.ClusterRuntime` over a pluggable
:class:`~repro_torch.runtime.backend.ExecutionBackend` — it never touches a
concrete datapath directly.  The re-plan trigger is the
:class:`~repro_torch.core.frontend.Frontend`'s single implementation.

:class:`MultiAppController` is the multi-app variant (DESIGN.md §11):
one JOINT plan per bin across all co-located apps (shared pools, per-app
SLOs), re-planned as soon as ANY app's frontend trigger fires, served on
one shared ``ClusterRuntime.multi`` event loop.

A copy of the JAX package's ``core/controller.py``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.core.frontend import Frontend
from repro_torch.core.milp import (AppSpec, FeatureSet, JointPlan, PlanConfig,
                             Planner, JointPlanner)
from repro_torch.core.placement import Placement, Placer, make_placer
from repro_torch.core.profiler import Profiler
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.core.trace import DemandTrace, predict_demand
from repro_torch.hwspec import ClusterSpec

if TYPE_CHECKING:   # pragma: no cover — repro_torch.runtime loads lazily to
    # keep the core/runtime leaf imports cycle-free
    from repro_torch.chaos.degrade import DegradationLadder
    from repro_torch.chaos.detector import FailureDetector
    from repro_torch.chaos.emergency import EmergencyReplanner
    from repro_torch.reconfig.transition import TransitionPlan, TransitionPlanner
    from repro_torch.runtime.backend import ExecutionBackend
    from repro_torch.runtime.cluster import ClusterRuntime
    from repro_torch.runtime.scenario import Scenario


def _observe_fbar(graph: TaskGraph, mm, fbar: Dict[Tuple[str, str], float],
                  ewma: float) -> None:
    """Fold one bin's OBSERVED multiplicative factors into ``fbar``
    in place (paper §3.2: F̂ is a runtime-refined input, not a
    constant).  The observation is the served-traffic ratio along each
    single-predecessor edge — multi-predecessor joins cannot attribute
    their traffic to one upstream task, so their edges keep the
    registered factors.  Bins with early drops are skipped: dropped
    children deflate the served ratio, and feeding that back would
    under-provision the bottleneck task further (a negative feedback
    ratchet) — only near-loss-free bins observe F̂."""
    if mm.dropped > 0.01 * max(mm.total_requests, 1):
        return
    served: Dict[str, int] = {}
    for (t, _v), c in mm.traffic.items():
        served[t] = served.get(t, 0) + c
    for (t, t2) in graph.edges:
        if len(graph.predecessors(t2)) != 1:
            continue
        if served.get(t, 0) <= 0:
            continue
        obs = served.get(t2, 0) / served[t]
        prev = fbar.get((t, t2))
        fbar[(t, t2)] = obs if prev is None else \
            (1 - ewma) * prev + ewma * obs


def _merge_dead_units(detector: Optional["FailureDetector"],
                      manual: Optional[Mapping[str, int]]
                      ) -> Dict[str, int]:
    """Detector-derived dead capacity merged with the manual
    ``step(dead_units=...)`` override (DESIGN.md §13).  A pool named by
    BOTH with different values is a conflict — the operator's claim
    contradicts the observed loss — and fails loud instead of silently
    preferring either."""
    derived = detector.dead_units() if detector is not None else {}
    manual = dict(manual or {})
    for p in set(derived) & set(manual):
        if manual[p] != derived[p]:
            raise ValueError(
                f"dead_units conflict on pool {p!r}: the detector "
                f"observed {derived[p]} dead units but step() was "
                f"passed {manual[p]} — drop the manual override or "
                "FailureDetector.forget() the pool")
    return {**derived, **manual}


@dataclass
class BinReport:
    bin_idx: int
    demand_actual: float
    demand_predicted: float
    slices_used: int
    replanned: bool
    milp_ms: float
    violation_rate: float
    accuracy_drop_pct: float      # vs A_max, in percent
    completions: int
    p99_ms: float
    warm_replan: bool = False     # re-plan reused the previous bin's basis
    milp_nodes: int = 0           # B&B nodes spent in this bin's re-plan
    # live-reconfiguration accounting (DESIGN.md §12; zero when the
    # controller runs the legacy instantaneous-swap model)
    transition_s: float = 0.0     # warm-up makespan charged this bin
    transition_actions: int = 0   # drain + load actions executed
    window_violation_rate: float = 0.0   # attainment INSIDE the window


@dataclass
class Controller:
    graph: TaskGraph
    profiler: Profiler
    s_avail: int
    features: FeatureSet = field(default_factory=FeatureSet)
    slack: float = 0.05                   # paper §4.4
    replan_threshold: float = 0.10        # re-plan when prediction moves 10%
    violation_trigger: float = 0.05       # or the SLO violation rate spikes
    staleness_ms: float = 20.0
    num_pods: int = 2
    planner_kwargs: dict = field(default_factory=dict)
    # hardware model (defaults to the profiler's ClusterSpec)
    cluster: Optional[ClusterSpec] = None
    # control-plane intake + pluggable data plane
    frontend: Optional[Frontend] = None
    backend_factory: Optional[Callable[[], "ExecutionBackend"]] = None
    # live reconfiguration (DESIGN.md §12): a TransitionPlanner makes
    # plan changes time-consuming staged processes executed on the
    # runtime; None keeps the legacy instantaneous atomic swap.  Pair
    # with planner_kwargs=dict(stickiness=...) to make the MILP prefer
    # cheaply-reachable plans.
    reconfig: Optional["TransitionPlanner"] = None
    # chaos engine (DESIGN.md §13): a FailureDetector closes the failure
    # loop — each bin's runtime observations accumulate into the derived
    # per-pool dead capacity the planner subtracts, replacing the manual
    # ``step(dead_units=...)`` dict (which stays as a fail-loud
    # override).  ``monitor``/``ladder`` ride on every bin's runtime:
    # mid-bin emergency re-planning and graceful load-shedding.
    detector: Optional["FailureDetector"] = None
    monitor: Optional["EmergencyReplanner"] = None
    ladder: Optional["DegradationLadder"] = None
    # runtime profile refinement (paper §3.2): EWMA-blend the OBSERVED
    # multiplicative factors back into every subsequent solve (ported
    # from MultiAppController, ROADMAP carried-over item)
    fbar_refine: bool = True
    fbar_ewma: float = 0.3
    # observability (DESIGN.md §14): a repro_torch.obs.Instrumentation shared
    # with every bin's runtime; the controller adds re-plan latency
    hooks: Optional[object] = None
    # SLO error-budget feedback (DESIGN.md §17): when True, a firing
    # page-severity burn-rate alert on the hooks' SloPlane forces a
    # re-plan even if the frontend's drift/violation trigger is quiet
    slo_replan: bool = False

    def __post_init__(self):
        if self.cluster is None:
            self.cluster = getattr(self.profiler, "cluster", None)
            # legacy knob: num_pods sizes a single-pool rectangle
            # deployment's packing capacity (pre-hwspec, place() was
            # Placer(num_pods)).  Applied only to a profiler-synthesized
            # (implicit) single-pool torus-style cluster — any cluster a
            # user passed, here or to the Profiler, is authoritative
            from repro_torch.hwspec import MigScheme
            if (self.cluster is not None
                    and getattr(self.profiler, "cluster_implicit", False)
                    and len(self.cluster.pools) == 1
                    and not isinstance(self.cluster.pools[0].scheme,
                                       MigScheme)):
                pool = self.cluster.pools[0]
                shape = getattr(pool.scheme, "pod_shape", (16, 16))
                want = self.num_pods * shape[0] * shape[1]
                if pool.count != want:
                    self.cluster = ClusterSpec(pools=(
                        dataclasses.replace(pool, count=want),))
        self.planner = Planner(self.graph, self.profiler, self.s_avail,
                               features=self.features, cluster=self.cluster,
                               **self.planner_kwargs)
        if self.frontend is None:
            self.frontend = Frontend(self.graph)
        if self.backend_factory is None:
            from repro_torch.runtime.backend import SimBackend
            self.backend_factory = SimBackend
        self._backend: Optional["ExecutionBackend"] = None
        self._config: Optional[PlanConfig] = None
        self._planned_for: float = -1.0
        self._history: List[float] = []
        self._fbar: Dict[Tuple[str, str], float] = {}
        self.milp_times_ms: List[float] = []

    # ------------------------------------------------------------------
    @property
    def backend(self) -> "ExecutionBackend":
        """The data plane, built once — an EngineBackend keeps its built
        engines (and captured decode graphs) across bins instead of
        rebuilding them every step."""
        if self._backend is None:
            self._backend = self.backend_factory()
        return self._backend

    def make_runtime(self, *, seed: int = 0, time_base_s: float = 0.0,
                     transition: Optional["TransitionPlan"] = None
                     ) -> "ClusterRuntime":
        """Deploy the current config on a fresh runtime (frontend-intaked)."""
        from repro_torch.runtime.cluster import ClusterRuntime
        if self._config is None:
            raise RuntimeError("no plan deployed — call step() first")
        return ClusterRuntime(self.graph, self._config, self.backend,
                              seed=seed, staleness_ms=self.staleness_ms,
                              frontend=self.frontend,
                              time_base_s=time_base_s,
                              transition=transition,
                              cluster=self.cluster,
                              monitor=self.monitor, ladder=self.ladder,
                              hooks=self.hooks)

    def _slo_paging(self) -> bool:
        """True when the hooks' SLO plane has a page-severity alert firing
        for this controller's app (any app if the frontend is unnamed)."""
        slo = getattr(self.hooks, "slo", None) if self.hooks is not None \
            else None
        if slo is None:
            return False
        app = getattr(self.frontend, "app", "") or None
        return bool(slo.paging(app))

    # ------------------------------------------------------------------
    def step(self, bin_idx: int, demand_actual: float, *,
             sim_seconds: float = 12.0, seed: int = 0,
             dead_chips: int = 0,
             dead_units: Optional[Mapping[str, int]] = None,
             scenario: Optional[Scenario] = None) -> BinReport:
        """One demand-timestamp bin: predict → (re)plan → execute.

        ``dead_units`` attributes failed capacity to its pool (units per
        pool name) so the planner shrinks the RIGHT pool's Eq. 8 budget;
        the scalar ``dead_chips`` remains the unattributed fallback
        (shrinks the largest pool).  With ``reconfig`` set, a plan
        change is executed as a staged live transition: the previous
        bin's instances drain while the new plan's instances warm up,
        and the bin report carries the transition window's attainment."""
        predicted = predict_demand(self._history + [demand_actual],
                                   self.slack) if self._history else \
            demand_actual * (1 + self.slack)
        self._history.append(demand_actual)

        replanned = False
        milp_ms = 0.0
        warm_replan = False
        milp_nodes = 0
        # the frontend owns the ONE drift/violation re-plan trigger; the
        # controller feeds it the predicted demand and last bin's outcome
        frontend_fired = (self._config is not None
                          and self.frontend.should_replan(
                              self._planned_for,
                              threshold=self.replan_threshold,
                              violation_trigger=self.violation_trigger,
                              demand_rps=predicted))
        # opt-in extra trigger: a firing page-severity burn-rate alert
        # (SloPlane on the shared hooks) forces a re-plan mid-incident
        # even when the bin-boundary drift/violation signals are quiet
        alert_fired = (not frontend_fired and self._config is not None
                       and self.slo_replan and self._slo_paging())
        need = self._config is None or frontend_fired or alert_fired
        trigger = ("cold" if self._config is None
                   else "frontend" if frontend_fired
                   else "slo_alert" if alert_fired else "")
        self.frontend.reset_bin()   # the runtime records this bin's outcome
        # dead_units shrinks each named pool's budget inside the planner
        # (Planner.pool_budgets); only the unattributed dead_chips path
        # still shrinks the scalar total (largest pool first)
        s_now = self.s_avail - dead_chips
        # detector-derived dead capacity (chaos loop), manual override
        # checked for conflicts — both reach the planner as ONE dict
        dead_merged = _merge_dead_units(self.detector, dead_units)
        incumbent = self._config
        if need:
            t0 = time.monotonic()
            # steady-state bins re-plan from the previous bin's incumbent
            # and root basis (Planner carries the warm state per context)
            warm0 = self.planner.stats.warm_basis_hits
            nodes0 = self.planner.stats.nodes
            self.planner.s_avail = s_now
            self.planner.dead_units = dict(dead_merged)
            cfg = self.planner.plan(predicted, self._fbar or None,
                                    incumbent=incumbent)
            if cfg is not None:
                self._config = cfg
                self._planned_for = predicted
                replanned = True
            elif self._config is None:
                # fall back to the highest plannable demand (paper §5:
                # "uses the configuration that can serve the highest demand")
                cfg = self._plan_max(s_now, charge=False)
                if cfg is None:
                    raise RuntimeError("no feasible config at any demand")
                self._config = cfg
                self._planned_for = predicted
                replanned = True
            # one charge per bin, fallback search included
            milp_ms = (time.monotonic() - t0) * 1e3
            warm_replan = self.planner.stats.warm_basis_hits > warm0
            milp_nodes = self.planner.stats.nodes - nodes0
            self.milp_times_ms.append(milp_ms)
            if self.hooks is not None:
                self.hooks.on_replan(
                    milp_ms / 1e3, warm_replan,
                    now=bin_idx * self.frontend.bin_seconds,
                    app=getattr(self.frontend, "app", ""),
                    trigger=trigger, demand_rps=predicted)

        # live reconfiguration: diff the incumbent against the new plan
        # and charge the staged transition to this bin's serving window
        transition: Optional["TransitionPlan"] = None
        if (self.reconfig is not None and replanned
                and incumbent is not None
                and self._config is not incumbent):
            transition = self.reconfig.plan(incumbent, self._config,
                                            dead_units=dead_merged)
            if transition.is_empty:
                transition = None

        if scenario is None:
            from repro_torch.runtime.scenario import Scenario
            scenario = Scenario.poisson(
                demand_actual, duration_s=sim_seconds,
                warmup_s=min(3.0, sim_seconds / 4))
        if self.monitor is not None:
            # the mid-bin monitor judges THIS bin's plan and already-
            # observed dead capacity (chaos loop, DESIGN.md §13)
            self.monitor.planned_for_rps = self._planned_for
            self.monitor.base_dead_units = dict(dead_merged)
        runtime = self.make_runtime(
            seed=seed, time_base_s=bin_idx * self.frontend.bin_seconds,
            transition=transition)
        metrics = runtime.run(scenario)
        if self.detector is not None:
            # close the loop: this bin's observed kills/preemptions feed
            # the NEXT bin's planner budgets
            self.detector.observe(runtime)
        if self.fbar_refine:
            # observed F̂ feeds every subsequent solve via the fbar
            # argument to planner.plan() above (paper §3.2)
            _observe_fbar(self.graph, metrics, self._fbar, self.fbar_ewma)
        # two demand views coexist on purpose: _history holds the ground-
        # truth bin demand the predictor consumes (the paper's demand
        # timestamps); the frontend's bins hold DATAPATH-observed demand —
        # extrapolated to a full-bin rate here since the runtime only
        # sampled scenario.duration_s of the bin
        self.frontend.extrapolate_bin(bin_idx, scenario.duration_s)
        # runtime profile refinement (paper §3.1): EWMA of realized latency
        acc_drop = (1.0 - metrics.realized_a_obj(self.graph)) * 100.0
        return BinReport(
            bin_idx=bin_idx,
            demand_actual=demand_actual,
            demand_predicted=predicted,
            slices_used=self._config.slices,
            replanned=replanned,
            milp_ms=milp_ms,
            violation_rate=metrics.violation_rate,
            accuracy_drop_pct=acc_drop,
            completions=metrics.completions,
            p99_ms=metrics.p99_ms,
            warm_replan=warm_replan,
            milp_nodes=milp_nodes,
            transition_s=transition.makespan_s if transition else 0.0,
            transition_actions=(transition.n_actions if transition
                                else 0),
            window_violation_rate=(metrics.window.violation_rate
                                   if metrics.window is not None else 0.0),
        )

    # ------------------------------------------------------------------
    def _search_max_demand(self, hi_cap: float = 1e6
                           ) -> Tuple[Optional[PlanConfig], float]:
        """Geometric doubling to bracket the largest feasible demand, then
        bisection DOWN into the bracket — also reaches sub-1 rps demands
        when even plan(1.0) is infeasible.  Returns (config, demand)."""
        lo, hi = 0.0, 1.0
        best: Optional[PlanConfig] = None
        while hi <= hi_cap:
            cfg = self.planner.plan(hi)
            if cfg is None:
                break
            best, lo = cfg, hi
            hi *= 2
        for _ in range(6):
            mid = (lo + hi) / 2
            cfg = self.planner.plan(mid)
            if cfg is not None:
                best, lo = cfg, mid
            else:
                hi = mid
        return best, lo

    def _plan_max(self, s_now: int, *, charge: bool = True
                  ) -> Optional[PlanConfig]:
        """Max-demand fallback (paper §5: 'uses the configuration that can
        serve the highest demand').  Charges its solve time to
        ``milp_times_ms`` unless the caller (``step``) already times the
        whole planning pass."""
        t0 = time.monotonic()
        self.planner.s_avail = s_now
        best, _ = self._search_max_demand()
        if charge:
            self.milp_times_ms.append((time.monotonic() - t0) * 1e3)
        return best

    # ------------------------------------------------------------------
    def place(self, dead_hosts: Optional[Mapping[str, Sequence]] = None
              ) -> Optional[List[Placement]]:
        """Pack the current config's slices onto their pools' devices.

        One packer per pool (rectangle packer for torus pools, MIG slice
        packer for MIG pools); returns the concatenated placements, or
        None if ANY pool refuses its mix.  Without a multi-pool cluster
        this is the legacy single-pool rectangle pack.  ``dead_hosts``
        maps pool name → that pool's packer dead-host list ((pod, row,
        col) chips for a torus pool, device indices for a MIG pool) so
        each pool routes around ITS OWN failures."""
        if self._config is None:
            return None
        by_pool: Dict[str, List[str]] = {}
        for tup, m in self._config.instances():
            by_pool.setdefault(tup.pool, []).extend([tup.segment] * m)
        return _pack_pools(self.cluster, by_pool, self.num_pods,
                           dead_hosts)

    def max_serviceable_demand(self, hi_cap: float = 1e6) -> float:
        """Binary-search the largest plannable demand (Fig. 3 metric)."""
        _, demand = self._search_max_demand(hi_cap)
        return demand


# ---------------------------------------------------------------------------
def _pack_pools(cluster: Optional[ClusterSpec],
                by_pool: Dict[str, List[str]], num_pods: int,
                dead_hosts: Optional[Mapping[str, Sequence]] = None
                ) -> Optional[List[Placement]]:
    """Pack segments pool by pool with each pool's own packer, offsetting
    instance ids so they stay unique across the concatenated list; the
    no-cluster legacy path is a single ``num_pods``-pod rectangle pack.
    ``dead_hosts`` maps pool name → that pool's dead-host list, handed to
    the pool's own packer.  Returns None if ANY pool refuses its mix."""
    dead_hosts = dead_hosts or {}
    from repro_torch.hwspec import DEFAULT_POOL, validate_pool_names
    validate_pool_names(cluster, dead_hosts, "dead_hosts")
    if cluster is None:
        segs = [s for pool_segs in by_pool.values() for s in pool_segs]
        return Placer(num_pods, dead_hosts.get(DEFAULT_POOL)).pack(segs)
    out: List[Placement] = []
    base = 0
    for pool in cluster.pools:
        segs = by_pool.get(pool.name)
        if not segs:
            continue
        pls = make_placer(pool, dead_hosts.get(pool.name)).pack(segs)
        if pls is None:
            return None
        out.extend(dataclasses.replace(pl, instance_id=pl.instance_id + base)
                   for pl in pls)
        base += len(segs)
    return out


# ---------------------------------------------------------------------------
# Multi-app co-location (DESIGN.md §11)
# ---------------------------------------------------------------------------
@dataclass
class AppBinReport:
    """One app's share of a multi-app bin (see :class:`MultiBinReport`)."""
    app: str
    demand_actual: float
    demand_predicted: float
    slices_used: int
    violation_rate: float
    accuracy_drop_pct: float      # vs this app's A_max, in percent
    completions: int
    p99_ms: float


@dataclass
class MultiBinReport:
    """Outcome of one multi-app controller bin: joint-plan stats plus a
    separately-attributed :class:`AppBinReport` per co-located app."""
    bin_idx: int
    replanned: bool
    milp_ms: float
    slices_used: int              # total across apps (shared cluster)
    warm_replan: bool
    milp_nodes: int
    per_app: Dict[str, AppBinReport]
    # live-reconfiguration accounting (DESIGN.md §12)
    transition_s: float = 0.0
    transition_actions: int = 0
    window_violation_rate: float = 0.0


@dataclass
class MultiAppController:
    """The controller loop for several co-located apps on ONE cluster.

    Mirrors :class:`Controller` bin-by-bin, but plans ALL apps in one
    :class:`~repro_torch.core.milp.JointPlanner` solve (shared per-pool Eq. 8
    capacity rows, per-app SLO rows) and serves them on one
    ``ClusterRuntime.multi`` event loop with per-app arrival processes.
    Each app keeps its own :class:`Frontend` (demand bins, violation
    window, deadline stamping with its own SLO); a bin re-plans JOINTLY
    as soon as ANY app's ``should_replan`` fires — capacity freed by a
    cooling app is immediately re-offered to the others.

    ``graphs`` and ``profilers`` map the app name to its task graph and
    to a profiler built on the SHARED :class:`ClusterSpec`.
    """
    graphs: Dict[str, TaskGraph]
    profilers: Dict[str, Profiler]
    s_avail: int
    features: FeatureSet = field(default_factory=FeatureSet)
    slack: float = 0.05                   # paper §4.4
    replan_threshold: float = 0.10
    violation_trigger: float = 0.05
    staleness_ms: float = 20.0
    num_pods: int = 2             # legacy no-cluster placement knob
    planner_kwargs: dict = field(default_factory=dict)
    cluster: Optional[ClusterSpec] = None
    backend_factory: Optional[Callable[[], "ExecutionBackend"]] = None
    # live reconfiguration across the co-located apps (DESIGN.md §12)
    reconfig: Optional["TransitionPlanner"] = None
    # chaos loop (DESIGN.md §13): derived per-pool dead capacity, with
    # the manual step(dead_units=) dict as a fail-loud override
    detector: Optional["FailureDetector"] = None
    # runtime profile refinement (paper §3.2): EWMA-blend each app's
    # OBSERVED multiplicative factors back into the next joint solve
    fbar_refine: bool = True
    fbar_ewma: float = 0.3
    # observability (DESIGN.md §14), shared with every bin's runtime
    hooks: Optional[object] = None
    # SLO error-budget feedback (DESIGN.md §17): firing page-severity
    # burn-rate alerts force a JOINT re-plan (mirrors Controller)
    slo_replan: bool = False

    def __post_init__(self):
        if set(self.graphs) != set(self.profilers):
            raise ValueError("graphs and profilers must name the same apps")
        if self.cluster is None:
            self.cluster = getattr(next(iter(self.profilers.values())),
                                   "cluster", None)
        self.planner = JointPlanner(
            [AppSpec(n, g, self.profilers[n])
             for n, g in self.graphs.items()],
            self.s_avail, features=self.features, cluster=self.cluster,
            **self.planner_kwargs)
        self.frontends: Dict[str, Frontend] = {
            n: Frontend(g, app=n) for n, g in self.graphs.items()}
        if self.backend_factory is None:
            from repro_torch.runtime.backend import SimBackend
            self.backend_factory = SimBackend
        self._backend: Optional["ExecutionBackend"] = None
        self._plan: Optional[JointPlan] = None
        self._planned_for: Dict[str, float] = {}
        self._history: Dict[str, List[float]] = {n: [] for n in self.graphs}
        # app -> {(task, succ): observed multiplicative factor} (EWMA)
        self._fbar: Dict[str, Dict[Tuple[str, str], float]] = {
            n: {} for n in self.graphs}
        self.milp_times_ms: List[float] = []

    # ------------------------------------------------------------------
    @property
    def backend(self) -> "ExecutionBackend":
        """The shared data plane, built once across bins."""
        if self._backend is None:
            self._backend = self.backend_factory()
        return self._backend

    @property
    def joint_plan(self) -> Optional[JointPlan]:
        return self._plan

    # ------------------------------------------------------------------
    def step(self, bin_idx: int, demands: Dict[str, float], *,
             sim_seconds: float = 12.0, seed: int = 0,
             dead_chips: int = 0,
             dead_units: Optional[Mapping[str, int]] = None,
             scenario: Optional["Scenario"] = None) -> MultiBinReport:
        """One demand bin: per-app predict → ONE joint (re)plan → serve.

        ``demands`` maps app name → this bin's actual entry demand (rps).
        ``scenario`` defaults to independent Poisson arrivals per app at
        the actual demands.  ``dead_units`` attributes failed capacity
        per pool (see :meth:`Controller.step`); with ``reconfig`` set,
        a joint re-plan executes as a staged live transition across all
        apps' deployments."""
        predicted: Dict[str, float] = {}
        for n in self.graphs:
            d = float(demands[n])
            hist = self._history[n]
            predicted[n] = (predict_demand(hist + [d], self.slack)
                            if hist else d * (1 + self.slack))
            hist.append(d)

        # ANY app's trigger forces a JOINT re-plan: the solve re-divides
        # the shared pools across all apps, not just the one that fired
        frontend_fired = (self._plan is not None
                          and any(self.frontends[n].should_replan(
                              self._planned_for.get(n, -1.0),
                              threshold=self.replan_threshold,
                              violation_trigger=self.violation_trigger,
                              demand_rps=predicted[n])
                              for n in self.graphs))
        slo = getattr(self.hooks, "slo", None) if self.hooks is not None \
            else None
        alert_fired = (not frontend_fired and self._plan is not None
                       and self.slo_replan and slo is not None
                       and any(slo.paging(n) for n in self.graphs))
        need = self._plan is None or frontend_fired or alert_fired
        trigger = ("cold" if self._plan is None
                   else "frontend" if frontend_fired
                   else "slo_alert" if alert_fired else "")
        for fe in self.frontends.values():
            fe.reset_bin()
        replanned = False
        milp_ms = 0.0
        warm_replan = False
        milp_nodes = 0
        s_now = self.s_avail - dead_chips   # dead_units shrinks budgets
        dead_merged = _merge_dead_units(self.detector, dead_units)
        incumbent = self._plan
        if need:
            t0 = time.monotonic()
            warm0 = self.planner.stats.warm_basis_hits
            nodes0 = self.planner.stats.nodes
            self.planner.s_avail = s_now
            self.planner.dead_units = dict(dead_merged)
            fbar = ({n: fb for n, fb in self._fbar.items() if fb}
                    if self.fbar_refine else {})
            plan = self.planner.plan_joint(predicted, fbar or None,
                                           incumbent=incumbent)
            if plan is not None:
                self._plan = plan
                self._planned_for = dict(predicted)
                replanned = True
            elif self._plan is None:
                # fall back to the largest jointly-plannable scale of the
                # SAME demand mix (paper §5's highest-demand config,
                # generalized to the multi-app simplex direction)
                plan, _ = self.planner.max_total_scale(
                    {n: max(r, 1e-9) for n, r in predicted.items()})
                if plan is None:
                    raise RuntimeError(
                        "no feasible joint config at any demand")
                self._plan = plan
                self._planned_for = dict(predicted)
                replanned = True
            milp_ms = (time.monotonic() - t0) * 1e3
            warm_replan = self.planner.stats.warm_basis_hits > warm0
            milp_nodes = self.planner.stats.nodes - nodes0
            self.milp_times_ms.append(milp_ms)
            if self.hooks is not None:
                bin_seconds = next(
                    iter(self.frontends.values())).bin_seconds
                self.hooks.on_replan(
                    milp_ms / 1e3, warm_replan,
                    now=bin_idx * bin_seconds,
                    app=",".join(sorted(self.graphs)),
                    trigger=trigger,
                    demand_rps=sum(predicted.values()))

        transition: Optional["TransitionPlan"] = None
        if (self.reconfig is not None and replanned
                and incumbent is not None and self._plan is not incumbent):
            transition = self.reconfig.plan_joint(incumbent, self._plan,
                                                  dead_units=dead_merged)
            if transition.is_empty:
                transition = None

        if scenario is None:
            from repro_torch.runtime.scenario import PoissonArrivals, Scenario
            scenario = Scenario.multi(
                {n: PoissonArrivals(float(demands[n]))
                 for n in self.graphs},
                duration_s=sim_seconds,
                warmup_s=min(3.0, sim_seconds / 4))
        from repro_torch.runtime.cluster import ClusterRuntime
        bin_seconds = next(iter(self.frontends.values())).bin_seconds
        runtime = ClusterRuntime.multi(
            {n: (g, self._plan.plans[n]) for n, g in self.graphs.items()},
            self.backend, seed=seed, staleness_ms=self.staleness_ms,
            frontends=self.frontends,
            time_base_s=bin_idx * bin_seconds,
            transition=transition, cluster=self.cluster,
            hooks=self.hooks)
        metrics = runtime.run(scenario)
        if self.detector is not None:
            self.detector.observe(runtime)
        if self.fbar_refine:
            self._refine_fbar(metrics)
        per_app: Dict[str, AppBinReport] = {}
        for n, g in self.graphs.items():
            self.frontends[n].extrapolate_bin(bin_idx, scenario.duration_s)
            mm = metrics.app(n)
            per_app[n] = AppBinReport(
                app=n,
                demand_actual=float(demands[n]),
                demand_predicted=predicted[n],
                slices_used=self._plan.plans[n].slices,
                violation_rate=mm.violation_rate,
                accuracy_drop_pct=(1.0 - mm.realized_a_obj(g)) * 100.0,
                completions=mm.completions,
                p99_ms=mm.p99_ms,
            )
        return MultiBinReport(
            bin_idx=bin_idx,
            replanned=replanned,
            milp_ms=milp_ms,
            slices_used=self._plan.slices,
            warm_replan=warm_replan,
            milp_nodes=milp_nodes,
            per_app=per_app,
            transition_s=transition.makespan_s if transition else 0.0,
            transition_actions=(transition.n_actions if transition
                                else 0),
            window_violation_rate=(metrics.window.violation_rate
                                   if metrics.window is not None else 0.0),
        )

    # ------------------------------------------------------------------
    def _refine_fbar(self, metrics) -> None:
        """Fold each app's observed factors into its fbar dict (shared
        :func:`_observe_fbar` single-app logic, per app)."""
        for n, g in self.graphs.items():
            _observe_fbar(g, metrics.app(n), self._fbar[n],
                          self.fbar_ewma)

    # ------------------------------------------------------------------
    def place(self, dead_hosts: Optional[Mapping[str, Sequence]] = None
              ) -> Optional[List[Placement]]:
        """Pack ALL apps' slices onto the shared pools' devices — the
        apps' instances are interleaved per pool exactly as they compete
        in the MILP.  ``dead_hosts`` maps pool name → that pool's packer
        dead-host list.  Returns None if any pool refuses its mix."""
        if self._plan is None:
            return None
        by_pool: Dict[str, List[str]] = {}
        for cfg in self._plan.plans.values():
            for tup, m in cfg.instances():
                by_pool.setdefault(tup.pool, []).extend([tup.segment] * m)
        return _pack_pools(self.cluster, by_pool, self.num_pods,
                           dead_hosts)
