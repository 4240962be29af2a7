"""The controller's MILP (paper §3.2, Eq. 1-14) + feature-ablated variants.

Decision variable M(t,v,s,b) — instances of variant v of task t on segment
type s with max batch b.  The formulation follows the paper exactly where
it is linear (latency Eq. 2-3, throughput Eq. 4-6 with F̂ as a runtime
input, resources Eq. 7-8, objective Eq. 14) and uses a documented
*conservative* linearization for the accuracy constraint Eq. 9-13
(accuracy-grid floors + Weierstrass path bound — see DESIGN.md §5); every
solution is re-validated against the exact evaluator in
``repro_torch.core.accuracy``.

Feature flags (paper Table 1 / §4.3):

* ``accuracy_scaling``    (A) — off: only the most accurate variant.
* ``spatial``             (S) — off: whole-accelerator segments only.
* ``task_graph_informed`` (T) — off: static per-task latency & resource
  budgets per the paper's Appendix B, solved as independent per-task MILPs.

Hardware model (DESIGN.md §10): the planner is cluster-aware.  Each
(t,v,s,b) tuple carries the pool its slice belongs to; Eq. 8 becomes one
capacity row PER POOL (Σ cost·x ≤ pool budget) and the objective prices
each slice by its pool's ``slice_price``.  A single-pool cluster (the
default) collapses to the legacy scalar ``s_avail`` formulation
bit-for-bit, so pre-hwspec plans are reproduced exactly.

Multi-app co-location (DESIGN.md §11): :class:`JointPlanner` plans
SEVERAL compound apps in one solve.  Task variables are namespaced
``app::task``; latency (Eq. 3) and accuracy (Eq. 9-13) rows stay per
app, the per-pool Eq. 8 capacity rows are shared, and the result is a
:class:`JointPlan` holding one ordinary :class:`PlanConfig` per app.

A copy of the JAX package's ``core/milp.py``: the same operation order,
tolerances and dtypes, so the same profile gives the same plan.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import accuracy as acc_mod
from repro_torch.core.profiler import ProfileEntry, Profiler
from repro_torch.core.solver.branch_bound import MILPResult, solve_milp
from repro_torch.core.solver.simplex import BasisState, BoundedSimplex
from repro_torch.core.taskgraph import TaskGraph, qualify, split_qualified
from repro_torch.hwspec import (ClusterSpec, DEFAULT_POOL, ExplicitScheme,
                          TorusScheme, validate_pool_names)

Key = Tuple[str, str, str, int]
Path = Tuple[str, ...]

# geometric grid for instance-cap quantization: caps (and with them the
# whole constraint matrix) stay identical while demand moves within one
# band, so re-plans hit the matrix cache and warm-start from the previous
# bin's basis.  Quantizing UP only enlarges the feasible space.
CAP_QUANT = 1.25


def _quantize_up(d: float) -> float:
    if d <= 0.0:
        return 0.0
    k = math.ceil(math.log(d) / math.log(CAP_QUANT) - 1e-9)
    return CAP_QUANT ** k


@dataclass
class PlannerStats:
    """Solve-stats counters (cumulative over a Planner's lifetime)."""
    milp_solves: int = 0
    nodes: int = 0
    lp_warm: int = 0              # node LPs warm-started from a basis
    lp_cold: int = 0              # node LPs solved from scratch
    matrix_cache_hits: int = 0
    matrix_cache_misses: int = 0
    warm_basis_hits: int = 0      # root LP seeded from a previous solve
    warm_incumbent_hits: int = 0


@dataclass
class _Assembled:
    """Demand-independent MILP matrices (cached across ``plan()`` calls)."""
    c: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray              # template; throughput rows patched per call
    A_eq: np.ndarray
    b_eq: np.ndarray
    ub: np.ndarray
    int_mask: np.ndarray
    solver: BoundedSimplex        # factorized-basis solver bound to A
    tput_rows: Dict[str, int]     # task -> row index of its Eq.6 row
    grid: Dict[str, List[float]]
    caps: np.ndarray
    ix_x: np.ndarray
    ix_y: np.ndarray
    ix_L: Dict[str, int]
    ix_z: Dict[Tuple[str, int], int]
    nvar: int


@dataclass
class _AppBlock:
    """Per-app constraint block of one (possibly joint) solve.

    A solve takes a LIST of blocks: the single-app planner passes one,
    the :class:`JointPlanner` one per co-located app.  Task names inside
    ``paths``/``w`` are qualified (``app::task`` — see
    ``taskgraph.qualify``); capacity rows are NOT in the block because
    pools are shared across apps (DESIGN.md §11)."""
    app: str                       # "" = the legacy single-app namespace
    paths: Tuple[Path, ...]        # request paths over qualified tasks
    slo_l: float                   # this app's latency SLO (Eq. 3 rhs)
    slo_a: float                   # this app's accuracy SLO (Eq. 13 rhs)
    amax: float                    # this app's A_max normalizer
    w: Dict[str, float]            # qualified task -> path weight (Eq. 12)

    @property
    def sig(self) -> tuple:
        """Hashable identity for the matrix-cache key (paths/w/amax are
        functions of the app's graph, fixed for a planner's lifetime)."""
        return (self.app, round(self.slo_l, 9), round(self.slo_a, 12))


@dataclass(frozen=True)
class FeatureSet:
    accuracy_scaling: bool = True     # A
    spatial: bool = True              # S
    task_graph_informed: bool = True  # T

    @property
    def label(self) -> str:
        if self.accuracy_scaling and self.spatial and self.task_graph_informed:
            return "A+S+T (JigsawServe)"
        parts = [f for f, on in (("A", self.accuracy_scaling),
                                 ("S", self.spatial),
                                 ("T", self.task_graph_informed)) if on]
        return "+".join(parts) if parts else "Unopt"


@dataclass(frozen=True)
class TupleVar:
    """One admissible (t, v, s, b) with its profiled constants.

    ``pool`` names the ClusterSpec pool whose capacity row the tuple's
    cost charges; ``streams`` is the slice's MPS-style multiplicity (the
    runtime spawns that many execution streams per instance without
    needing the partition catalogue)."""
    task: str
    variant: str
    segment: str
    batch: int
    latency_ms: float
    throughput: float
    cost: int
    accuracy: float
    pool: str = DEFAULT_POOL
    streams: int = 1

    @property
    def key(self) -> Key:
        return (self.task, self.variant, self.segment, self.batch)


@dataclass
class PlanConfig:
    """A concrete deployment: M(t,v,s,b) counts + derived metrics."""
    graph: TaskGraph
    counts: Dict[Key, int]
    tuples: Dict[Key, TupleVar]
    demand: Dict[str, float]
    # per-pool capacity the plan was solved against (None = legacy scalar)
    pool_budgets: Optional[Dict[str, int]] = None

    # ------------------------------------------------------------------
    @property
    def slices(self) -> int:
        return sum(self.tuples[k].cost * m for k, m in self.counts.items()
                   if m > 0)

    def pool_slices(self) -> Dict[str, int]:
        """Capacity units used per pool."""
        out: Dict[str, int] = {}
        for k, m in self.counts.items():
            if m > 0:
                j = self.tuples[k]
                out[j.pool] = out.get(j.pool, 0) + j.cost * m
        return out

    def lhat(self, task: str) -> float:
        """L̂(t): latency of the slowest ACTIVE instance (Eq. 2)."""
        ls = [self.tuples[k].latency_ms for k, m in self.counts.items()
              if m > 0 and k[0] == task]
        return max(ls) if ls else 0.0

    def path_latency(self, path: Tuple[str, ...]) -> float:
        """Σ 2·L̂ along the path (Eq. 3's LHS — 2x for queuing delay)."""
        return sum(2.0 * self.lhat(t) for t in path)

    def worst_path_latency(self) -> float:
        return max(self.path_latency(p) for p in self.graph.paths)

    def task_throughput(self, task: str) -> float:
        return sum(self.tuples[k].throughput * m
                   for k, m in self.counts.items()
                   if m > 0 and k[0] == task)

    def throughput_map(self) -> Dict[Key, float]:
        return {k: self.tuples[k].throughput for k in self.counts}

    def exact_a_obj(self) -> float:
        return acc_mod.a_obj(self.graph, self.counts, self.throughput_map())

    def task_effective_accuracy(self, task: str) -> float:
        return acc_mod.effective_task_accuracy(
            self.graph, task, self.counts, self.throughput_map())

    def feasible(self, slo_l: float, slo_a: float, s_avail: int,
                 tol: float = 1e-6) -> bool:
        if self.slices > s_avail:
            return False
        if self.pool_budgets is not None:
            for p, used in self.pool_slices().items():
                if used > self.pool_budgets.get(p, 0):
                    return False
        for t, r in self.demand.items():
            if self.task_throughput(t) < r - tol:
                return False
        if self.worst_path_latency() > slo_l + tol:
            return False
        return self.exact_a_obj() >= slo_a - tol

    def instances(self) -> List[Tuple[TupleVar, int]]:
        return [(self.tuples[k], m) for k, m in sorted(self.counts.items())
                if m > 0]


# ---------------------------------------------------------------------------
_UNOPT_CHIPS_DEFAULT = 8


@dataclass
class Planner:
    graph: TaskGraph
    profiler: Profiler
    s_avail: int                          # TOTAL capacity units (all pools)
    features: FeatureSet = field(default_factory=FeatureSet)
    alpha: float = 1.0
    beta: Optional[float] = None          # None → alpha / s_avail (paper §4.4)
    unopt_chips: int = _UNOPT_CHIPS_DEFAULT   # the 'whole accelerator' unit
    max_tuples_per_task: int = 120
    bb_nodes: int = 60
    bb_time_s: float = 10.0
    # plan at <= headroom utilization so steady-state queueing stays inside
    # the paper's 2x latency allowance (Eq. 3)
    headroom: float = 0.8
    prune_dominated: bool = True      # drop dominated (t,v,s,b) pre-assembly
    matrix_cache_size: int = 8        # LRU entries of cached MILP matrices
    # hardware model: defaults to the profiler's cluster.  Single-pool →
    # legacy scalar-s_avail semantics; multi-pool → per-pool capacity rows
    # with budgets from the cluster (s_avail caps the total, shrinking the
    # largest pool first — the dead-capacity path).
    cluster: Optional[ClusterSpec] = None
    # switching-cost awareness (DESIGN.md §12): with an incumbent plan,
    # activating a tuple TYPE absent from it costs an extra
    # stickiness × cost × price in the objective (per y variable) — the
    # solver prefers plans reachable without new weight loads /
    # repartitions.  0.0 (default) reproduces the history-free objective
    # bit-for-bit.
    stickiness: float = 0.0
    # per-pool dead capacity (failed hosts), subtracted from that pool's
    # Eq. 8 budget; the scalar s_avail dead-chip path (shrink the largest
    # pool) remains the fallback when the caller has no pool attribution
    dead_units: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if self.beta is None:
            self.beta = self.alpha / max(self.s_avail, 1)
        if self.cluster is None:
            self.cluster = getattr(self.profiler, "cluster", None)
        # every profiled tuple's pool must have a capacity row: a planner
        # cluster whose pool names miss the profiler's would give those
        # tuples unlimited LP capacity while the repair sees budget 0 —
        # fail loud at construction instead
        prof_cl = getattr(self.profiler, "cluster", None)
        if self.cluster is not None and prof_cl is not None:
            missing = ({p.name for p in prof_cl.pools}
                       - {p.name for p in self.cluster.pools})
            if missing:
                raise ValueError(
                    f"planner cluster lacks pools {sorted(missing)} that "
                    "the profiler's tables were built on — pass a cluster "
                    "covering the profiler's pools (or none to inherit)")
        self.stats = PlannerStats()
        self._admissible_cache: Dict[str, List[TupleVar]] = {}
        self._matrix_cache: Dict[tuple, _Assembled] = {}
        self._ready_s_cache: Dict[Key, float] = {}
        # per-context warm state: last solve's root basis + incumbent
        self._warm: Dict[Optional[str],
                         Tuple[tuple, Optional[BasisState],
                               Optional[np.ndarray]]] = {}

    # ------------------------------------------------------------------
    # hardware model helpers
    # ------------------------------------------------------------------
    def pool_budgets(self) -> Dict[str, int]:
        """Per-pool capacity (Eq. 8 rhs), re-derived on every plan() so a
        controller mutating ``s_avail`` (dead chips) or ``dead_units``
        (pool-attributed failures) stays effective."""
        cl = self.cluster
        dead = self.dead_units
        if dead:
            # a typo'd pool name would silently model the failure as
            # zero — fail as loud as the runtime's pool-scoped hooks
            validate_pool_names(cl, dead, "dead_units")
        if cl is None or len(cl.pools) == 1:
            name = cl.pools[0].name if cl is not None else DEFAULT_POOL
            # dead capacity shrinks the pool's budget HERE (not via a
            # caller-side s_avail adjustment), so direct Planner users
            # and the controller see the same contract
            budget = int(self.s_avail) - dead.get(name, 0)
            # a user-described (explicit) cluster states PHYSICAL capacity
            # — cap so plan() never promises slices place() cannot realize.
            # Profiler-synthesized legacy clusters keep the uncapped
            # scalar-s_avail semantics (pre-hwspec pinned behavior).
            if cl is not None and not getattr(self.profiler,
                                              "cluster_implicit", True):
                budget = min(budget,
                             cl.pools[0].capacity_units - dead.get(name, 0))
            return {name: max(budget, 0) if dead else budget}
        budgets = {n: max(0, b - dead.get(n, 0))
                   for n, b in cl.budgets().items()}
        # the scalar cap is net of the pool-attributed dead units, so an
        # ADDITIONAL unattributed dead_chips shrink (s_avail already
        # reduced by the caller) still bites on top of dead_units
        deficit = sum(budgets.values()) - max(
            int(self.s_avail) - sum(dead.values()), 0)
        while deficit > 0:
            p = max(budgets, key=lambda n: budgets[n])
            cut = min(deficit, budgets[p])
            if cut <= 0:        # every pool already at 0 (s_avail <= 0)
                break
            budgets[p] -= cut
            deficit -= cut
        return budgets

    def _price(self, pool: str) -> float:
        if self.cluster is None:
            return 1.0
        try:
            return self.cluster.pool(pool).slice_price
        except KeyError:
            return 1.0

    def _graph_for_task(self, task: str) -> Optional[TaskGraph]:
        """Graph owning ``task`` (tuple task names are plain here; the
        JointPlanner's are app-qualified and override this)."""
        return self.graph if task in self.graph.tasks else None

    def _tuple_ready_s(self, tup: TupleVar) -> float:
        """Actual activation delay (seconds) of a NEW tuple type: weight
        staging over the slice devices' staging bandwidth plus the pool
        scheme's repartition delay — the same physics
        ``TransitionPlanner.weight_load_s`` charges when the transition
        executes (DESIGN.md §13).  Falls back to the legacy ``cost``
        proxy when the cluster / slice / architecture can't resolve
        (profiler-synthesized clusters, exotic variant names)."""
        cached = self._ready_s_cache.get(tup.key)
        if cached is not None:
            return cached
        val: Optional[float] = None
        graph = self._graph_for_task(tup.task)
        if self.cluster is not None and graph is not None:
            try:
                from repro_torch.configs import ARCHS
                _, plain = split_qualified(tup.task)
                pool, sl = self.cluster.find_slice(tup.segment)
                v = graph.tasks[plain].variant(tup.variant)
                n_total, _ = ARCHS[v.arch].param_count()
                wb = float(n_total) * pool.device.param_bytes(v.quant)
                per_dev = wb / max(sl.devices, 1)
                val = (pool.device.weight_load_s(per_dev,
                                                 sl.memory_fraction)
                       + pool.scheme.repartition_delay_s)
            except (KeyError, AttributeError):
                val = None
        if val is None:
            val = float(tup.cost)
        self._ready_s_cache[tup.key] = val
        return val

    def _activation_cost(self, tup: TupleVar) -> float:
        """Objective units (×stickiness) for activating a tuple type
        outside the incumbent: price-weighted ACTUAL readiness delay —
        a type whose weights stage in 0.5 s is cheap to adopt, an 8 s
        MIG repartition + 70B load is not.  The pre-§13 flat
        ``cost × price`` penalty falls out as the no-cluster fallback
        (``_tuple_ready_s`` → ``cost``)."""
        return self._tuple_ready_s(tup) * self._price(tup.pool)

    def _unopt_cost(self, pool: str) -> int:
        """'Whole accelerator' unit size for spatial=False, per pool.
        Torus pools keep the legacy ``unopt_chips`` knob — and so do
        ExplicitScheme pools when the knob was explicitly set (the
        legacy ``Profiler(segments=...)`` path wraps segments in an
        ExplicitScheme the caller never sees); otherwise the scheme
        defines its own whole unit (e.g. the 7g MIG slice)."""
        if self.cluster is not None:
            try:
                scheme = self.cluster.pool(pool).scheme
            except KeyError:
                return self.unopt_chips
            if isinstance(scheme, TorusScheme):
                return self.unopt_chips
            if (isinstance(scheme, ExplicitScheme)
                    and self.unopt_chips != _UNOPT_CHIPS_DEFAULT):
                return self.unopt_chips
            return scheme.unopt_cost
        return self.unopt_chips

    # ------------------------------------------------------------------
    # admissible tuples
    # ------------------------------------------------------------------
    def invalidate_caches(self) -> None:
        """Drop cached admissible tuples / matrices / warm state (call after
        profiler entries or graph SLOs change)."""
        self._admissible_cache.clear()
        self._matrix_cache.clear()
        self._ready_s_cache.clear()
        self._warm.clear()

    def _admissible(self, task: str) -> List[TupleVar]:
        # profiler entries and SLOs are fixed for a Planner's lifetime
        # (see invalidate_caches), so the pareto-pruned tuple set is too
        cached = self._admissible_cache.get(task)
        if cached is not None:
            return cached
        t = self.graph.tasks[task]
        variants = (t.variants if self.features.accuracy_scaling
                    else (t.most_accurate,))
        out = []
        for (tn, vn, sn, b), e in self.profiler.entries_for_task(task).items():
            if all(v.name != vn for v in variants):
                continue
            if not self.features.spatial:
                if e.chips != self._unopt_cost(e.pool) or e.streams != 1:
                    continue
            if 2.0 * e.latency_ms > self.graph.slo_latency_ms:
                continue  # can never satisfy Eq. 3 even alone
            v = t.variant(vn)
            out.append(TupleVar(task, vn, sn, b, e.latency_ms,
                                e.throughput_rps, e.chips, v.accuracy,
                                e.pool, e.streams))
        out = _pareto_prune(out)
        if len(out) > self.max_tuples_per_task:
            # round-robin across (variant, pool, segment-size) groups so
            # pruning never wipes out a whole size class or pool (small
            # segments must stay available when S_avail is tight, and a
            # pool must stay reachable when its peer fills up)
            groups: Dict[Tuple[str, str, int], List[TupleVar]] = {}
            for j in out:
                groups.setdefault((j.variant, j.pool, j.cost), []).append(j)
            for grp in groups.values():
                grp.sort(key=lambda j: -j.throughput / j.cost)
            picked: List[TupleVar] = []
            while len(picked) < self.max_tuples_per_task and groups:
                for key in list(groups):
                    if groups[key]:
                        picked.append(groups[key].pop(0))
                        if len(picked) >= self.max_tuples_per_task:
                            break
                    else:
                        del groups[key]
            out = picked
        self._admissible_cache[task] = out
        return out

    # ------------------------------------------------------------------
    # public entry
    # ------------------------------------------------------------------
    def plan(self, demand_rps: float,
             fbar: Optional[Mapping[Tuple[str, str], float]] = None,
             incumbent: Optional[PlanConfig] = None
             ) -> Optional[PlanConfig]:
        """Solve for configuration at entry-task demand R (Eq. 14).

        ``incumbent`` is the currently-deployed plan; with a non-zero
        ``stickiness`` the objective penalizes activating tuple types
        it does not already run (switching-cost awareness, DESIGN.md
        §12).  With ``stickiness == 0`` the incumbent is ignored and the
        solve is bit-identical to the history-free formulation."""
        sticky = self._sticky_keys(incumbent)
        if self.features.task_graph_informed:
            cfg = self._plan_joint(demand_rps, fbar, sticky)
            # The T search space is a strict superset of the static split —
            # if the joint heuristics miss, the static solution is still a
            # member of the space, so fall back (and keep the cheaper one,
            # where 'cheaper' includes the switching cost when an
            # incumbent is sticky: a smaller-by-slices static plan built
            # from all-new tuple types must not override a joint plan
            # that reuses the running fleet).
            static = self._plan_static_budgets(demand_rps, fbar, sticky)
            if cfg is None:
                return static
            if static is not None and \
                    (static.slices + self._switch_cost(static, sticky)
                     < cfg.slices + self._switch_cost(cfg, sticky)):
                return static
            return cfg
        return self._plan_static_budgets(demand_rps, fbar, sticky)

    def _sticky_keys(self, incumbent: Optional[PlanConfig]
                     ) -> Optional[frozenset]:
        if incumbent is None or self.stickiness <= 0.0:
            return None
        return frozenset(k for k, mm in incumbent.counts.items() if mm > 0)

    def _switch_cost(self, cfg: PlanConfig,
                     sticky: Optional[frozenset]) -> float:
        """The objective's switching penalty of a plan (0 history-free):
        stickiness × price × ready_s per ACTIVE tuple type outside the
        incumbent — the same term `_assemble` puts on the y variables."""
        if sticky is None:
            return 0.0
        return self.stickiness * sum(
            self._activation_cost(j)
            for k, j in cfg.tuples.items()
            if cfg.counts.get(k, 0) > 0 and k not in sticky)

    # ------------------------------------------------------------------
    def _plan_joint(self, R: float, fbar,
                    sticky: Optional[frozenset] = None
                    ) -> Optional[PlanConfig]:
        g = self.graph
        demand = {t: r / self.headroom
                  for t, r in g.demand_at_tasks(R, fbar).items()}
        tasks = list(g.tasks)
        tuples: List[TupleVar] = []
        task_tuples: Dict[str, List[int]] = {t: [] for t in tasks}
        for t in tasks:
            adm = self._admissible(t)
            if not adm:
                return None
            for j in adm:
                task_tuples[t].append(len(tuples))
                tuples.append(j)
        w, paths, amax = self._weights(tasks, None)
        block = _AppBlock("", tuple(paths), g.slo_latency_ms,
                          g.slo_accuracy, amax, w)
        return self._solve(tuples, task_tuples, demand, blocks=[block],
                           budgets=self.pool_budgets(), sticky=sticky)

    # ------------------------------------------------------------------
    def _plan_static_budgets(self, R: float, fbar,
                             sticky: Optional[frozenset] = None
                             ) -> Optional[PlanConfig]:
        """Appendix B: static per-task latency & resource budgets, then
        independent per-task solves."""
        g = self.graph
        demand = {t: r / self.headroom
                  for t, r in g.demand_at_tasks(R, fbar).items()}
        # expected resources per task (most accurate variant, best tuple)
        exp_res: Dict[str, float] = {}
        lmax: Dict[str, float] = {}
        for t in g.tasks:
            v_acc = g.tasks[t].most_accurate
            entries = [(k, e) for k, e in
                       self.profiler.entries_for_task(t).items()
                       if k[1] == v_acc.name
                       and (self.features.spatial
                            or (e.chips == self._unopt_cost(e.pool)
                                and e.streams == 1))]
            if not entries:
                return None
            best = max(entries, key=lambda ke: ke[1].throughput_rps
                       / ke[1].chips)
            exp_res[t] = demand[t] / best[1].throughput_rps * best[1].chips
            lat_ok = [e.latency_ms for _, e in entries
                      if 2 * e.latency_ms <= g.slo_latency_ms]
            if not lat_ok:
                # no admissible tuple of the most accurate variant meets
                # Eq. 3 even alone — the static split is infeasible
                return None
            lmax[t] = max(lat_ok)
        total_res = sum(exp_res.values())
        if total_res <= 0.0:
            # zero demand everywhere: no meaningful static split exists
            # (the joint path handles R=0 as an empty deployment)
            return None
        # per-path latency split in ratio of lmax; task gets min across paths
        lat_budget = {t: math.inf for t in g.tasks}
        for p in g.paths:
            denom = sum(lmax[t] for t in p)
            for t in p:
                lat_budget[t] = min(lat_budget[t],
                                    g.slo_latency_ms * lmax[t] / denom)
        # uninformed accuracy split: geometric floor over the longest path
        acc_floor = {}
        for t in g.tasks:
            plen = max(len(p) for p in g.paths if t in p)
            acc_floor[t] = g.slo_accuracy ** (1.0 / plen)

        full_budgets = self.pool_budgets()
        counts: Dict[Key, int] = {}
        tuples: Dict[Key, TupleVar] = {}
        for t in g.tasks:
            adm = [j for j in self._admissible(t)
                   if 2.0 * j.latency_ms <= lat_budget[t]]
            if not adm:
                return None
            # each task gets its demand share of EVERY pool's budget (the
            # single-pool case reduces to the legacy int(res_budget[t]))
            sub_budgets = {p: int(b * exp_res[t] / total_res)
                           for p, b in full_budgets.items()}
            w1, paths1, amax1 = self._weights([t], t)
            block = _AppBlock("", tuple(paths1), 2.0 * lat_budget[t],
                              acc_floor[t], amax1, w1)
            sub = self._solve(
                adm, {t: list(range(len(adm)))}, {t: demand[t]},
                blocks=[block], budgets=sub_budgets, single_task=t,
                sticky=sticky)
            if sub is None:
                return None
            counts.update(sub.counts)
            tuples.update(sub.tuples)
        cfg = PlanConfig(g, counts, tuples, demand,
                         pool_budgets=dict(full_budgets))
        if not cfg.feasible(g.slo_latency_ms, g.slo_accuracy, self.s_avail):
            return None
        return cfg

    # ------------------------------------------------------------------
    # MILP assembly
    # ------------------------------------------------------------------
    def _assemble(self, tuples: List[TupleVar],
                  task_tuples: Dict[str, List[int]], caps: np.ndarray,
                  *, blocks: Sequence[_AppBlock], budgets: Dict[str, int],
                  single_task: Optional[str]) -> _Assembled:
        """Build the demand-independent MILP matrices (throughput rhs is a
        template patched per solve).

        ``blocks`` carries the per-app rows: latency paths (Eq. 3),
        accuracy bound (Eq. 12-13) and objective accuracy weights are
        emitted per block, while the Eq. 8 capacity rows are shared —
        that sharing is what makes a multi-block solve a JOINT plan.
        The assembled objective is history-free: the sticky switching
        cost (which follows the live incumbent) is applied per solve in
        ``_solve`` via the solver's per-solve ``c`` override, so
        incumbent churn never invalidates these matrices or the warm
        basis."""
        tasks = list(task_tuples)
        # per-task app attribution (tasks are disjoint across blocks)
        blk_of: Dict[str, _AppBlock] = {t: b for b in blocks for t in b.w}
        nj = len(tuples)
        # accuracy grid per task: distinct variant accuracies (floors)
        grid = {t: sorted({j.accuracy for i in task_tuples[t]
                           for j in [tuples[i]]}) for t in tasks}
        nz = {t: len(grid[t]) for t in tasks}

        # variable layout: [x (nj) | y (nj) | Lhat (T) | z (Σ nz)]
        ix_x = np.arange(nj)
        ix_y = nj + np.arange(nj)
        ix_L = {t: 2 * nj + i for i, t in enumerate(tasks)}
        z_off = 2 * nj + len(tasks)
        ix_z: Dict[Tuple[str, int], int] = {}
        for t in tasks:
            for k in range(nz[t]):
                ix_z[(t, k)] = z_off
                z_off += 1
        nvar = z_off

        rows, rhs = [], []

        def add(row: Dict[int, float], b: float):
            rows.append(row)
            rhs.append(b)

        # Eq.1 linking: x - cap*y <= 0 ; y - x <= 0
        for i in range(nj):
            add({ix_x[i]: 1.0, ix_y[i]: -caps[i]}, 0.0)
            add({ix_y[i]: 1.0, ix_x[i]: -1.0}, 0.0)
        # Eq.2: L_j*y_j - Lhat_t <= 0
        for t in tasks:
            for i in task_tuples[t]:
                add({ix_y[i]: tuples[i].latency_ms, ix_L[t]: -1.0}, 0.0)
        # Eq.3 per app per path: Σ 2*Lhat <= that app's SLO_l
        for blk in blocks:
            for p in blk.paths:
                add({ix_L[t]: 2.0 for t in p if t in ix_L}, blk.slo_l)
        # Eq.6 throughput: -Σ x*H <= -R̂(t)  (rhs patched with live demand)
        tput_rows = {}
        for t in tasks:
            tput_rows[t] = len(rows)
            add({ix_x[i]: -tuples[i].throughput for i in task_tuples[t]},
                0.0)
        # Eq.8 resources: one capacity row per pool (slices charge their
        # pool's budget; a single-pool cluster yields the legacy one row)
        for pname, bud in budgets.items():
            idxs = [i for i in range(nj) if tuples[i].pool == pname]
            if not idxs and len(budgets) > 1:
                continue    # no admissible tuples in this pool
            add({ix_x[i]: float(tuples[i].cost) for i in idxs},
                float(bud))
        # accuracy grid: z selects a floor g_k ⇒ Σ x H (A_j - g_k) >= -M(1-z)
        bigM_a = {t: sum(caps[i] * tuples[i].throughput
                         for i in task_tuples[t]) for t in tasks}
        for t in tasks:
            for k, gk in enumerate(grid[t]):
                row = {ix_x[i]: -(tuples[i].accuracy - gk)
                       * tuples[i].throughput for i in task_tuples[t]}
                row[ix_z[(t, k)]] = bigM_a[t]
                add(row, bigM_a[t])
        # Weierstrass path bound (Eq.12-13 linearized), one row PER APP:
        # Σ_t w_t Σ_k g_tk z_tk >= slo_a*amax - 1 + Σ w_t
        for blk in blocks:
            row = {ix_z[(t, k)]: -blk.w[t] * grid[t][k]
                   for t in tasks if blk_of[t] is blk
                   for k in range(nz[t])}
            add(row, 1.0 - sum(blk.w.values()) - blk.slo_a * blk.amax)

        # equalities: Σ_k z_tk = 1
        eq_rows, eq_rhs = [], []
        for t in tasks:
            eq_rows.append({ix_z[(t, k)]: 1.0 for k in range(nz[t])})
            eq_rhs.append(1.0)

        # objective (min): β Σ price·x − Σ_apps (α/amax) Σ w_t g_tk z_tk,
        # price = cost × the pool's slice_price (1.0 → legacy β Σ cost x)
        c = np.zeros(nvar)
        for i in range(nj):
            c[ix_x[i]] = (self.beta * tuples[i].cost
                          * self._price(tuples[i].pool))
        for t in tasks:
            blk = blk_of[t]
            for k in range(nz[t]):
                c[ix_z[(t, k)]] = (-self.alpha * blk.w[t] * grid[t][k]
                                   / blk.amax)

        ub = np.full(nvar, np.inf)
        ub[ix_x] = caps
        ub[ix_y] = 1.0
        for t in tasks:
            ub[ix_L[t]] = blk_of[t].slo_l / 2.0
            for k in range(nz[t]):
                ub[ix_z[(t, k)]] = 1.0

        int_mask = np.zeros(nvar, bool)
        int_mask[ix_x] = True
        int_mask[ix_y] = True
        for key, col in ix_z.items():
            int_mask[col] = True

        A_ub = _densify(rows, nvar)
        b_ub = np.array(rhs)
        A_eq = _densify(eq_rows, nvar)
        b_eq = np.array(eq_rhs)
        solver = BoundedSimplex(c, A_ub, b_ub, A_eq, b_eq)
        return _Assembled(c, A_ub, b_ub, A_eq, b_eq, ub, int_mask, solver,
                          tput_rows, grid, caps, ix_x, ix_y, ix_L, ix_z,
                          nvar)

    def _weights(self, tasks, single_task):
        """Path weights w_t = Σ_{p∋t} f_p (for the linearized Eq. 12)."""
        g = self.graph
        if single_task is None:
            w = {t: sum(f for p, f in g.path_fractions.items() if t in p)
                 for t in tasks}
            paths = g.paths
            amax = acc_mod.a_max(g)
        else:
            w = {single_task: 1.0}
            paths = [(single_task,)]
            amax = g.tasks[single_task].max_accuracy
        return w, paths, amax

    def _solve(self, tuples: List[TupleVar],
               task_tuples: Dict[str, List[int]],
               demand: Dict[str, float], *, blocks: Sequence[_AppBlock],
               budgets: Dict[str, int], single_task: Optional[str] = None,
               sticky: Optional[frozenset] = None
               ) -> Optional["PlanConfig"]:
        if self.prune_dominated:
            tuples, task_tuples = _prune_dominated(tuples, task_tuples)
        tasks = list(task_tuples)
        nj = len(tuples)

        # instance caps from demand quantized UP onto a geometric grid so
        # the matrices (and the warm-start basis) survive small demand moves
        qd = {t: _quantize_up(demand[t]) for t in tasks}
        caps = np.array([max(1.0, math.ceil(qd[j.task]
                                            / max(j.throughput, 1e-9))) + 1
                         for j in tuples])

        # the sticky objective is NOT part of the matrix identity: the
        # switching-cost term is patched into a per-solve c below (like
        # the demand rhs), so incumbent changes reuse the cached matrix
        # AND its warm basis — the dual-simplex warm path restores dual
        # feasibility against the new objective in a few bound flips
        cache_key = (single_task, tuple(tuples),
                     tuple(int(cp) for cp in caps),
                     tuple(b.sig for b in blocks),
                     tuple(sorted(budgets.items())))
        asm = self._matrix_cache.pop(cache_key, None)
        if asm is None:
            self.stats.matrix_cache_misses += 1
            asm = self._assemble(tuples, task_tuples, caps,
                                 blocks=blocks, budgets=budgets,
                                 single_task=single_task)
        else:
            self.stats.matrix_cache_hits += 1
        self._matrix_cache[cache_key] = asm       # LRU: re-insert as newest
        while len(self._matrix_cache) > self.matrix_cache_size:
            self._matrix_cache.pop(next(iter(self._matrix_cache)))

        # patch the live demand into the throughput rows
        b_ub = asm.b_ub.copy()
        for t in tasks:
            b_ub[asm.tput_rows[t]] = -demand[t]

        # patch the switching cost into the objective: a tuple type NOT
        # in the incumbent needs a weight load (and possibly a
        # repartition) to activate — its y variable carries the penalty,
        # weighted by the type's ACTUAL readiness delay (weight staging
        # + repartition), so any count of an already running type stays
        # free while the first instance of a new type pays once, in
        # proportion to how long its activation would really take
        c = asm.c
        if sticky is not None:
            c = asm.c.copy()
            for i in range(len(tuples)):
                if tuples[i].key not in sticky:
                    c[asm.ix_y[i]] += (self.stickiness
                                       * self._activation_cost(tuples[i]))

        grid = asm.grid
        ix_x, ix_y, ix_L, ix_z = asm.ix_x, asm.ix_y, asm.ix_L, asm.ix_z
        nvar = asm.nvar

        def repair(xfrac: np.ndarray) -> Optional[np.ndarray]:
            counts = self._repair(xfrac[ix_x], tuples, task_tuples, demand,
                                  blocks, budgets, grid)
            if counts is None:
                return None
            return self._lift(counts, tuples, task_tuples, grid, nvar,
                              ix_x, ix_y, ix_L, ix_z, tasks)

        # warm start: previous solve of the same matrices in this context
        ctx = single_task
        wkey, wbasis, wx = self._warm.get(ctx, (None, None, None))
        warm_basis = wbasis if wkey == cache_key else None
        warm_x = wx if wkey == cache_key else None
        if warm_x is not None:
            self.stats.warm_incumbent_hits += 1

        res = solve_milp(c, asm.A_ub, b_ub, asm.A_eq, asm.b_eq,
                         asm.ub, asm.int_mask,
                         repair=repair, max_nodes=self.bb_nodes,
                         time_limit_s=self.bb_time_s, solver=asm.solver,
                         warm_basis=warm_basis, warm_incumbent=warm_x)
        self.stats.milp_solves += 1
        self.stats.nodes += res.nodes
        self.stats.lp_warm += res.lp_warm
        self.stats.lp_cold += res.lp_cold
        if res.root_warm:
            self.stats.warm_basis_hits += 1
        self._warm[ctx] = (cache_key, res.root_basis,
                           res.x.copy() if res.x is not None else None)
        if res.x is None:
            return None
        counts = {tuples[i].key: int(round(res.x[ix_x[i]]))
                  for i in range(nj) if res.x[ix_x[i]] > 0.5}
        return self._package(counts, tuples, demand, budgets, blocks,
                             single_task)

    # ------------------------------------------------------------------
    def _package(self, counts: Dict[Key, int], tuples: List[TupleVar],
                 demand: Dict[str, float], budgets: Dict[str, int],
                 blocks: Sequence[_AppBlock],
                 single_task: Optional[str]) -> Optional["PlanConfig"]:
        """Integer solution → validated result (JointPlanner overrides
        this to split the namespaced counts into per-app plans)."""
        cfg = PlanConfig(self.graph, counts, {j.key: j for j in tuples},
                         dict(demand), pool_budgets=dict(budgets))
        # exact re-validation (one-sided bound ⇒ should always pass)
        if single_task is None and not cfg.feasible(
                blocks[0].slo_l, blocks[0].slo_a, self.s_avail):
            return None
        return cfg

    # ------------------------------------------------------------------
    def _repair(self, x: np.ndarray, tuples, task_tuples, demand,
                blocks: Sequence[_AppBlock], budgets, grid
                ) -> Optional[Dict[Key, int]]:
        """LP point → integer-feasible counts (exact-semantics greedy).

        Strategy: seed with the floored LP point, fill throughput deficits
        latency-budget-aware (each task only uses tuples that fit the slack
        the OTHER tasks leave on its tightest path), then fix the accuracy
        floor, then trim.  If LP-guided fill fails, rebuild from scratch
        with a delete-worst latency loop.  Capacity is tracked per pool
        (``budgets``) so the greedy never overfills one pool while its
        peer has room; latency and accuracy targets are tracked per app
        block (a task only competes on its own app's paths and SLOs)."""
        tasks = list(task_tuples)
        blk_of: Dict[str, _AppBlock] = {t: b for b in blocks for t in b.w}

        def attempt(seed: Dict[int, int]) -> Optional[Dict[int, int]]:
            counts = dict(seed)
            # per-pool capacity used, maintained incrementally: every
            # counts mutation goes through bump() (the greedy's hot loops
            # must not re-aggregate counts per iteration)
            used: Dict[str, int] = {}
            for i, m in counts.items():
                p = tuples[i].pool
                used[p] = used.get(p, 0) + tuples[i].cost * m

            def bump(i: int, d: int):
                counts[i] = counts.get(i, 0) + d
                p = tuples[i].pool
                used[p] = used.get(p, 0) + tuples[i].cost * d
                if counts[i] == 0:
                    del counts[i]

            def room(p: str) -> int:
                return budgets.get(p, 0) - used.get(p, 0)

            def tput(t):
                return sum(tuples[i].throughput * m
                           for i, m in counts.items()
                           if tuples[i].task == t)

            def lhat(t):
                ls = [tuples[i].latency_ms for i, m in counts.items()
                      if m > 0 and tuples[i].task == t]
                return max(ls) if ls else 0.0

            def path_ok():
                return all(sum(2.0 * lhat(t) for t in p) <= blk.slo_l + 1e-9
                           for blk in blocks for p in blk.paths)

            def budget(t):
                """Max 2·L a new tuple of task t may have, given others."""
                blk = blk_of[t]
                b = math.inf
                for p in blk.paths:
                    if t not in p:
                        continue
                    used = sum(2.0 * lhat(t2) for t2 in p if t2 != t)
                    b = min(b, blk.slo_l - used)
                return max(b, 2.0 * lhat(t))  # existing lhat already charged

            def floor_acc(t):
                num = sum(tuples[i].throughput * m * tuples[i].accuracy
                          for i, m in counts.items() if tuples[i].task == t)
                den = sum(tuples[i].throughput * m
                          for i, m in counts.items() if tuples[i].task == t)
                if den <= 0:
                    return 0.0
                a = num / den
                lv = [gk for gk in grid[t] if gk <= a + 1e-9]
                return lv[-1] if lv else 0.0

            def acc_block_ok(blk):
                tot = sum(blk.w[t] * floor_acc(t) for t in blk.w)
                return (tot >= blk.slo_a * blk.amax - 1.0
                        + sum(blk.w.values()) - 1e-9)

            def failing_block():
                for blk in blocks:
                    if not acc_block_ok(blk):
                        return blk
                return None

            def acc_lb_ok():
                return failing_block() is None

            def reshape_mates(worst: str) -> bool:
                """Free latency budget for ``worst``'s accuracy swap by
                speeding up its slowest path mate: replace that task's
                deployment with a faster tuple type of >= its current
                accuracy floor.  The one coupled move the greedy needs —
                without it, a slow-but-cheap mate deployment can make the
                only affordable top-accuracy tuples of ``worst`` look
                latency-infeasible forever."""
                blk = blk_of[worst]
                mates = {t2 for p in blk.paths if worst in p
                         for t2 in p if t2 != worst and lhat(t2) > 0.0}
                for t2 in sorted(mates, key=lambda t2: -lhat(t2)):
                    cur = [i for i, mm in counts.items()
                           if mm > 0 and tuples[i].task == t2]
                    freed: Dict[str, int] = {}
                    for i in cur:
                        freed[tuples[i].pool] = (freed.get(tuples[i].pool,
                                                           0)
                                                 + tuples[i].cost
                                                 * counts[i])
                    floor_now = floor_acc(t2)
                    best = None
                    for j in task_tuples[t2]:
                        jt = tuples[j]
                        if (jt.latency_ms >= lhat(t2) - 1e-9
                                or jt.accuracy < floor_now - 1e-12):
                            continue
                        n = max(1, math.ceil(demand[t2]
                                             / max(jt.throughput, 1e-9)))
                        if n * jt.cost > (room(jt.pool)
                                          + freed.get(jt.pool, 0)):
                            continue
                        rank = (n * jt.cost, jt.latency_ms)
                        if best is None or rank < best[0]:
                            best = (rank, j, n)
                    if best is None:
                        continue
                    _, j, n = best
                    for i in cur:
                        bump(i, -counts[i])
                    bump(j, n)
                    return True
                return False

            def shed_low_acc() -> bool:
                """Drop low-accuracy instances that throughput no longer
                needs (LP-node seeds can arrive bloated): monotone — only
                frees pool room and can only raise accuracy floors."""
                freed = False
                for i in sorted(list(counts), key=lambda i: -tuples[i].cost):
                    t = tuples[i].task
                    if tuples[i].accuracy >= grid[t][-1] - 1e-12:
                        continue
                    while counts.get(i, 0) > 0:
                        bump(i, -1)
                        if tput(t) >= demand[t] - 1e-9:
                            freed = True
                            continue
                        bump(i, 1)
                        break
                return freed

            if not path_ok():
                return None

            # 1. fill throughput deficits, cheapest-per-rps within budget
            for t in tasks:
                guard = 0
                while tput(t) < demand[t] - 1e-9 and guard < 100000:
                    guard += 1
                    bud = budget(t)
                    cand = [i for i in task_tuples[t]
                            if 2.0 * tuples[i].latency_ms <= bud + 1e-9
                            and tuples[i].cost <= room(tuples[i].pool)]
                    if not cand:
                        return None
                    # close the whole deficit with the single best type
                    deficit = demand[t] - tput(t)
                    best = min(cand, key=lambda i: (
                        tuples[i].cost * math.ceil(
                            deficit / tuples[i].throughput),
                        tuples[i].cost))
                    n_add = max(1, int(deficit // tuples[best].throughput))
                    n_add = min(n_add, max(1, room(tuples[best].pool)
                                           // tuples[best].cost))
                    bump(best, n_add)
                if tput(t) < demand[t] - 1e-9:
                    return None

            # 2. fix the accuracy lower bound (per failing app block)
            guard = 0
            while (blk := failing_block()) is not None and guard < 500:
                guard += 1
                worst, gain = None, 0.0
                for t in blk.w:
                    gp = (grid[t][-1] - floor_acc(t)) * blk.w[t]
                    if gp > gain:
                        worst, gain = t, gp
                if worst is None:
                    return None
                bud = budget(worst)
                # room may transiently borrow the cost of the low-accuracy
                # instance we are about to drop IN THE SAME POOL (the final
                # per-pool capacity check guards)
                drop_by_pool: Dict[str, int] = {}
                for i, mm in counts.items():
                    if (mm > 0 and tuples[i].task == worst
                            and tuples[i].accuracy
                            < grid[worst][-1] - 1e-12):
                        p = tuples[i].pool
                        drop_by_pool[p] = max(drop_by_pool.get(p, 0),
                                              tuples[i].cost)
                cand = [i for i in task_tuples[worst]
                        if tuples[i].accuracy >= grid[worst][-1] - 1e-12
                        and 2.0 * tuples[i].latency_ms <= bud + 1e-9
                        and tuples[i].cost <= (room(tuples[i].pool)
                                               + drop_by_pool.get(
                                                   tuples[i].pool, 0))]
                if not cand:
                    # no top-accuracy tuple fits the latency budget or the
                    # pool room — free latency budget (reshape a path
                    # mate) or pool room (shed bloated low-accuracy
                    # excess) and retry, bounded by the loop guard
                    if reshape_mates(worst) or shed_low_acc():
                        continue
                    return None
                best = min(cand, key=lambda i: (tuples[i].cost
                           / max(tuples[i].throughput, 1e-9),
                           tuples[i].cost))
                bump(best, 1)
                # drop low-accuracy instances while throughput allows
                low = sorted([i for i, m in counts.items() if m > 0
                              and tuples[i].task == worst
                              and tuples[i].accuracy
                              < grid[worst][-1] - 1e-12],
                             key=lambda i: tuples[i].accuracy)
                for i in low:
                    bump(i, -1)
                    if tput(worst) >= demand[worst] - 1e-9:
                        break
                    bump(i, 1)
            if not acc_lb_ok():
                return None

            # 3. trim expensive instances while feasible
            order = sorted([i for i in counts],
                           key=lambda i: -tuples[i].cost)
            for i in order:
                while counts.get(i, 0) > 0:
                    bump(i, -1)
                    t = tuples[i].task
                    if (tput(t) >= demand[t] - 1e-9 and path_ok()
                            and acc_lb_ok()):
                        continue
                    bump(i, 1)
                    break

            for p, u in used.items():
                if u > budgets.get(p, 0):
                    return None
            return counts

        def attempt_restricted(keep: Dict[str, List[int]]
                               ) -> Optional[Dict[int, int]]:
            saved = dict(task_tuples)
            try:
                for t in tasks:
                    task_tuples[t] = keep[t]
                return attempt({})
            finally:
                for t in tasks:
                    task_tuples[t] = saved[t]

        # try LP-guided seed first
        seed = {i: int(math.floor(x[i] + 1e-6)) for i in range(len(tuples))
                if x[i] > 1e-6}
        counts = attempt(seed)
        if counts is None and seed:
            counts = attempt({})
        if counts is None:
            # accuracy-first: restrict every task to its top-accuracy
            # variants, making the fill accuracy-feasible by construction
            # and free to spill across pools.  (The step-2 accuracy swap
            # can strand itself when co-located tasks have already filled
            # the only pool whose top-accuracy tuples fit the latency
            # budget — a joint-plan load pattern.)
            counts = attempt_restricted({
                t: ([i for i in task_tuples[t]
                     if tuples[i].accuracy >= grid[t][-1] - 1e-12]
                    or task_tuples[t])
                for t in tasks})
        if counts is None:
            # delete-worst: start empty, but pre-restrict each task to its
            # fastest half of tuples and retry (handles tight joint SLOs)
            counts = attempt_restricted({
                t: sorted(task_tuples[t],
                          key=lambda i: tuples[i].latency_ms
                          )[: max(1, len(task_tuples[t]) // 2)]
                for t in tasks})
        if counts is None:
            if len(blocks) > 1:
                return self._repair_sequential(x, tuples, task_tuples,
                                               demand, blocks, budgets,
                                               grid)
            return None
        return {tuples[i].key: m for i, m in counts.items() if m > 0}

    def _repair_sequential(self, x, tuples, task_tuples, demand,
                           blocks: Sequence[_AppBlock], budgets, grid
                           ) -> Optional[Dict[Key, int]]:
        """Joint-repair fallback: repair each app ALONE against a slice
        of the pool budgets, trying both app orders.  Valid because apps
        share no constraint rows except the Eq. 8 capacity rows — per-app
        feasible configs that together fit the budgets are jointly
        feasible.  The simultaneous greedy can strand a capacity-hungry
        app when a cheaper co-located app grabbed its latency-critical
        pool first; sequencing the full single-app ladder per app
        sidesteps that interaction.

        Each non-final app is first capped at its LP-proportional pool
        share (root LP usage + an even split of the LP slack) so an
        early app's cost-greedy cannot exhaust a shared hot pool the
        later apps need; if the capped pass fails, the uncapped residual
        pass is tried as well."""
        by_key = {j.key: j for j in tuples}
        napp = len(blocks)
        # per-app fractional pool usage at the LP point
        lp_use: Dict[str, Dict[str, float]] = {b.app: {} for b in blocks}
        for blk in blocks:
            for t in blk.w:
                for i in task_tuples.get(t, ()):
                    if x[i] > 1e-9:
                        d = lp_use[blk.app]
                        p = tuples[i].pool
                        d[p] = d.get(p, 0.0) + x[i] * tuples[i].cost
        slack = {p: budgets[p] - sum(lp_use[b.app].get(p, 0.0)
                                     for b in blocks) for p in budgets}

        def run(order: Tuple[_AppBlock, ...], capped: bool
                ) -> Optional[Dict[Key, int]]:
            remaining = dict(budgets)
            merged: Dict[Key, int] = {}
            for k, blk in enumerate(order):
                if capped and k < napp - 1:
                    eff = {p: min(remaining[p],
                                  math.ceil(lp_use[blk.app].get(p, 0.0)
                                            - 1e-9)
                                  + max(0, int(slack.get(p, 0.0) // napp)))
                           for p in remaining}
                else:
                    eff = dict(remaining)
                sub_tt = {t: task_tuples[t] for t in blk.w
                          if t in task_tuples}
                # zero the LP seed outside this app so the sub-repair
                # neither charges nor deploys other apps' tuples
                xm = np.zeros_like(x)
                for idxs in sub_tt.values():
                    xm[idxs] = x[idxs]
                sub = self._repair(xm, tuples, sub_tt, demand, [blk],
                                   eff, grid)
                if sub is None:
                    return None
                for key, m in sub.items():
                    j = by_key[key]
                    remaining[j.pool] = remaining.get(j.pool, 0) \
                        - j.cost * m
                merged.update(sub)
            return merged

        for capped in (True, False):
            for order in (tuple(blocks), tuple(reversed(blocks))):
                merged = run(order, capped)
                if merged is not None:
                    return merged
        return None

    # ------------------------------------------------------------------
    def _lift(self, counts: Dict[Key, int], tuples, task_tuples, grid,
              nvar, ix_x, ix_y, ix_L, ix_z, tasks) -> np.ndarray:
        """Counts → full MILP variable vector (for the B&B incumbent)."""
        xv = np.zeros(nvar)
        by_key = {tuples[i].key: i for i in range(len(tuples))}
        for key, m in counts.items():
            i = by_key[key]
            xv[ix_x[i]] = m
            xv[ix_y[i]] = 1.0
        for t in tasks:
            ls = [tuples[i].latency_ms for i in task_tuples[t]
                  if xv[ix_y[i]] > 0.5]
            xv[ix_L[t]] = max(ls) if ls else 0.0
            # pick the grid floor below the exact weighted accuracy
            num = sum(tuples[i].throughput * xv[ix_x[i]] * tuples[i].accuracy
                      for i in task_tuples[t])
            den = sum(tuples[i].throughput * xv[ix_x[i]]
                      for i in task_tuples[t])
            a = num / den if den > 0 else 0.0
            ks = [k for k, gk in enumerate(grid[t]) if gk <= a + 1e-9]
            xv[ix_z[(t, ks[-1] if ks else 0)]] = 1.0
        return xv


# ---------------------------------------------------------------------------
# Multi-app co-location (DESIGN.md §11)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AppSpec:
    """One co-located application: its task graph plus a profiler whose
    tables were built on the SHARED :class:`ClusterSpec` all the
    co-located apps compete for."""
    name: str
    graph: TaskGraph
    profiler: Profiler


@dataclass
class JointPlan:
    """Result of one joint multi-app solve: per-app deployments that were
    optimized TOGETHER against shared per-pool capacity rows.

    ``plans[app]`` is an ordinary single-app :class:`PlanConfig` (plain
    task names — runtime and placement consume it unchanged); the joint
    coupling lives only in how the counts were chosen."""
    plans: Dict[str, PlanConfig]       # app name -> per-app deployment
    pool_budgets: Dict[str, int]       # the shared Eq. 8 rhs of the solve
    demand: Dict[str, float]           # entry-task demand (rps) per app

    @property
    def slices(self) -> int:
        return sum(cfg.slices for cfg in self.plans.values())

    def pool_slices(self) -> Dict[str, int]:
        """COMBINED capacity units used per pool, across all apps."""
        out: Dict[str, int] = {}
        for cfg in self.plans.values():
            for p, u in cfg.pool_slices().items():
                out[p] = out.get(p, 0) + u
        return out

    def app(self, name: str) -> PlanConfig:
        return self.plans[name]


class JointPlanner(Planner):
    """Joint configuration MILP over several co-located apps on ONE
    cluster (DESIGN.md §11).

    Variables are namespaced per app (``app::task``); Eq. 3 latency
    paths, the Eq. 9-13 accuracy rows and the objective's accuracy terms
    are emitted PER APP, while the Eq. 8 capacity rows are SHARED so the
    apps compete for the same pool slices in a single solve.  Matrix
    caching and warm starts (DESIGN.md §7) work exactly as in the
    single-app planner: while every app's quantized demand stays inside
    its cap band, re-plans hit the cached matrices and warm-start from
    the previous solve's basis and incumbent.

    Construction takes a sequence of :class:`AppSpec` whose profilers
    must share one cluster; ``s_avail`` caps the TOTAL capacity across
    pools exactly as for :class:`Planner`.  Per-solve knobs
    (``max_tuples_per_task``, ``bb_nodes``, ...) pass through
    ``planner_kwargs`` to both the joint solve and the per-app
    admissibility filters.
    """

    def __init__(self, apps: Sequence[AppSpec], s_avail: int, *,
                 features: Optional[FeatureSet] = None, alpha: float = 1.0,
                 beta: Optional[float] = None,
                 cluster: Optional[ClusterSpec] = None, **planner_kwargs):
        if not apps:
            raise ValueError("JointPlanner needs at least one app")
        names = [a.name for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate app names: {names}")
        if any(not a.name for a in apps):
            raise ValueError("app names must be non-empty")
        ref = apps[0].profiler.cluster
        for a in apps[1:]:
            if a.profiler.cluster != ref:
                raise ValueError(
                    f"app {a.name!r} was profiled on a different cluster "
                    "— all co-located apps must share one ClusterSpec")
        features = features if features is not None else FeatureSet()
        self.apps = tuple(apps)
        # per-app sub-planners own the admissible-tuple caches (each app
        # filters against its own latency SLO and variant set)
        self._subs = {a.name: Planner(a.graph, a.profiler, s_avail,
                                      features=features, cluster=cluster,
                                      **planner_kwargs)
                      for a in apps}
        super().__init__(apps[0].graph, apps[0].profiler, s_avail,
                         features=features, alpha=alpha, beta=beta,
                         cluster=cluster, **planner_kwargs)

    # ------------------------------------------------------------------
    def invalidate_caches(self) -> None:
        super().invalidate_caches()
        for sub in self._subs.values():
            sub.invalidate_caches()

    def plan(self, demand_rps, fbar=None, incumbent=None):
        raise TypeError("JointPlanner plans several apps at once — call "
                        "plan_joint({app: rps, ...}) instead of plan()")

    def _graph_for_task(self, task: str) -> Optional[TaskGraph]:
        """Joint tuples carry ``app::task`` names — resolve the owning
        app's graph for the ready_s sticky weighting."""
        app, plain = split_qualified(task)
        for a in self.apps:
            if a.name == app and plain in a.graph.tasks:
                return a.graph
        return super()._graph_for_task(task)

    # ------------------------------------------------------------------
    def plan_joint(self, demands: Mapping[str, float],
                   fbar: Optional[Mapping[str, Mapping]] = None,
                   incumbent: Optional[JointPlan] = None
                   ) -> Optional[JointPlan]:
        """Solve ONE joint configuration MILP at per-app entry demands.

        ``demands`` maps app name → entry-task rps (apps absent from the
        mapping get zero demand and an empty deployment); ``fbar``
        optionally maps app name → that app's observed multiplicative
        factors (paper §3.2).  ``incumbent`` is the currently-deployed
        joint plan — with ``stickiness > 0`` the objective penalizes
        activating tuple types no app currently runs (see
        :meth:`Planner.plan`).  Returns a :class:`JointPlan`, or None
        when no configuration serves every app's demand and SLOs inside
        the shared pool budgets."""
        sticky: Optional[frozenset] = None
        if incumbent is not None and self.stickiness > 0.0:
            sticky = frozenset(
                (qualify(app, k[0]),) + k[1:]
                for app, cfg in incumbent.plans.items()
                for k, m in cfg.counts.items() if m > 0)
        tuples: List[TupleVar] = []
        task_tuples: Dict[str, List[int]] = {}
        demand: Dict[str, float] = {}
        blocks: List[_AppBlock] = []
        for a in self.apps:
            g = a.graph
            sub = self._subs[a.name]
            fb = (fbar or {}).get(a.name)
            d = {t: r / self.headroom
                 for t, r in g.demand_at_tasks(
                     float(demands.get(a.name, 0.0)), fb).items()}
            for t in g.tasks:
                adm = sub._admissible(t)
                if not adm:
                    return None
                qt = qualify(a.name, t)
                demand[qt] = d[t]
                task_tuples[qt] = []
                for j in adm:
                    task_tuples[qt].append(len(tuples))
                    tuples.append(dataclasses.replace(j, task=qt))
            w = {qualify(a.name, t):
                 sum(f for p, f in g.path_fractions.items() if t in p)
                 for t in g.tasks}
            paths = tuple(tuple(qualify(a.name, t) for t in p)
                          for p in g.paths)
            blocks.append(_AppBlock(a.name, paths, g.slo_latency_ms,
                                    g.slo_accuracy, acc_mod.a_max(g), w))
        return self._solve(tuples, task_tuples, demand, blocks=blocks,
                           budgets=self.pool_budgets(), sticky=sticky)

    # ------------------------------------------------------------------
    def max_total_scale(self, mix: Mapping[str, float], hi_cap: float = 1e6
                        ) -> Tuple[Optional[JointPlan], float]:
        """Largest λ such that demands ``λ·mix`` are jointly plannable
        (geometric doubling then bisection — the joint analogue of
        ``Controller._search_max_demand``).  Returns (plan, λ)."""
        def at(lam: float) -> Optional[JointPlan]:
            return self.plan_joint({a: lam * r for a, r in mix.items()})

        lo, hi = 0.0, 1.0
        best: Optional[JointPlan] = None
        while hi <= hi_cap:
            p = at(hi)
            if p is None:
                break
            best, lo = p, hi
            hi *= 2
        for _ in range(6):
            mid = (lo + hi) / 2
            p = at(mid)
            if p is not None:
                best, lo = p, mid
            else:
                hi = mid
        return best, lo

    # ------------------------------------------------------------------
    def _package(self, counts, tuples, demand, budgets, blocks,
                 single_task) -> Optional[JointPlan]:
        """Namespaced integer solution → per-app validated JointPlan."""
        per_counts: Dict[str, Dict[Key, int]] = {a.name: {}
                                                 for a in self.apps}
        per_tuples: Dict[str, Dict[Key, TupleVar]] = {a.name: {}
                                                      for a in self.apps}
        by_key = {j.key: j for j in tuples}
        for key, m in counts.items():
            app, t = split_qualified(key[0])
            pkey = (t,) + key[1:]
            per_counts[app][pkey] = m
            per_tuples[app][pkey] = dataclasses.replace(by_key[key], task=t)
        plans: Dict[str, PlanConfig] = {}
        entry_demand: Dict[str, float] = {}
        for a in self.apps:
            g = a.graph
            app_demand = {t: demand[qualify(a.name, t)] for t in g.tasks}
            cfg = PlanConfig(g, per_counts[a.name], per_tuples[a.name],
                             app_demand, pool_budgets=dict(budgets))
            # exact per-app re-validation: latency, throughput and the
            # exact accuracy evaluator against THIS app's SLOs (an empty
            # deployment is only acceptable at zero demand)
            if cfg.counts:
                if not cfg.feasible(g.slo_latency_ms, g.slo_accuracy,
                                    self.s_avail):
                    return None
            elif any(r > 1e-9 for r in app_demand.values()):
                return None
            plans[a.name] = cfg
            entry_demand[a.name] = (app_demand.get(g.entry, 0.0)
                                    * self.headroom)
        # shared capacity: the COMBINED per-pool usage must fit the
        # budgets the solve shared across apps
        used: Dict[str, int] = {}
        for cfg in plans.values():
            for p, u in cfg.pool_slices().items():
                used[p] = used.get(p, 0) + u
        if sum(used.values()) > self.s_avail:
            return None
        for p, u in used.items():
            if u > budgets.get(p, 0):
                return None
        return JointPlan(plans, dict(budgets), entry_demand)


# ---------------------------------------------------------------------------
def _prune_dominated(tuples: List[TupleVar],
                     task_tuples: Dict[str, List[int]]
                     ) -> Tuple[List[TupleVar], Dict[str, List[int]]]:
    """Drop tuples dominated within their task (≥ cost, ≥ latency,
    ≤ throughput, ≤ accuracy than some other tuple, strict somewhere)
    before matrix assembly, re-indexing ``task_tuples``.  Removing a
    dominated column never changes the MILP optimum: any solution using it
    maps to one at least as good on the dominator."""
    new_tuples: List[TupleVar] = []
    new_tt: Dict[str, List[int]] = {}
    for t, idxs in task_tuples.items():
        group = [tuples[i] for i in idxs]
        keep = _nondominated_mask(group)
        new_tt[t] = []
        for j, k in zip(group, keep):
            if k:
                new_tt[t].append(len(new_tuples))
                new_tuples.append(j)
    return new_tuples, new_tt


def _nondominated_mask(group: List[TupleVar]) -> List[bool]:
    keep = [True] * len(group)
    for a, j in enumerate(group):
        for b, i in enumerate(group):
            if a == b or not keep[b]:
                continue
            if (i.pool == j.pool
                    and i.accuracy >= j.accuracy
                    and i.latency_ms <= j.latency_ms
                    and i.throughput >= j.throughput
                    and i.cost <= j.cost
                    and (i.latency_ms < j.latency_ms
                         or i.throughput > j.throughput
                         or i.cost < j.cost or i.accuracy > j.accuracy
                         or b < a)):     # tie-break exact duplicates
                keep[a] = False
                break
    return keep


def _pareto_prune(tuples: List[TupleVar]) -> List[TupleVar]:
    """Drop (t,v,s,b) tuples dominated on (latency, throughput, cost).

    Domination is only meaningful WITHIN a pool: costs are pool-local
    capacity units, and a cross-pool 'dominated' tuple may still be the
    only way to use its pool once the dominator's pool fills up."""
    out = []
    for j in tuples:
        dominated = False
        for i in tuples:
            if i is j:
                continue
            if (i.pool == j.pool
                    and i.accuracy >= j.accuracy
                    and i.latency_ms <= j.latency_ms
                    and i.throughput >= j.throughput
                    and i.cost <= j.cost
                    and (i.latency_ms < j.latency_ms
                         or i.throughput > j.throughput
                         or i.cost < j.cost or i.accuracy > j.accuracy)):
                dominated = True
                break
        if not dominated:
            out.append(j)
    return out


def _densify(rows: List[Dict[int, float]], nvar: int) -> np.ndarray:
    A = np.zeros((len(rows), nvar))
    for r, row in enumerate(rows):
        for col, val in row.items():
            A[r, col] = val
    return A
