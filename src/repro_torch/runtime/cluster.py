"""ClusterRuntime: the single shared serving event loop.

Control plane (queues, task-level batching per paper §3.3, early drop,
failure/elasticity bookkeeping, metrics) lives here; the data plane is a
pluggable :class:`~repro_torch.runtime.backend.ExecutionBackend` that only turns
(server, batch) into a service time.  Workloads arrive as declarative
:class:`~repro_torch.runtime.scenario.Scenario` objects.  The legacy
``Simulator`` of the JAX package is a thin shim over
``ClusterRuntime(SimBackend())`` and stays seed-deterministic; this copy
gives field-exact the same ``SimMetrics``.  Transition plans, cluster
specs, monitors, ladders and hooks are duck-typed arguments: the port has
no planner, hardware catalogue or chaos plane yet.

When a :class:`~repro_torch.core.frontend.Frontend` is attached it is the
runtime's intake: it stamps request ids and deadlines (effective SLO incl.
per-hop allowance), accumulates demand bins, and receives violation
reports — the single source of truth the controller's re-plan trigger
reads.

Multi-app co-location (DESIGN.md §11): :meth:`ClusterRuntime.multi`
serves SEVERAL apps on one event loop.  Queues, servers and batch
formation are keyed per ``app::task`` (``taskgraph.qualify``), so a batch
is only ever formed from one app's requests on that app's own planned
instances — apps share the cluster, never a batch.  Each app keeps its
own Frontend (deadlines from its own SLO), and ``SimMetrics.by_app``
reports SLO attainment separately per app.  The single-app constructor
is the one-app special case under the empty app name, bit-identical to
the pre-multi-app behavior.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dispatch import (QueuedRequest, batch_ready, early_drop,
                                 next_poll_time)
from repro_torch.core.milp import PlanConfig
from repro_torch.core.taskgraph import TaskGraph, qualify, split_qualified
from repro_torch.runtime.backend import ExecutionBackend, SimBackend
from repro_torch.runtime.metrics import Server, SimMetrics
from repro_torch.runtime.scenario import (CapacityEvent, DomainFailureEvent,
                                    FailureEvent, PreemptionEvent, Scenario)

# queue sweep cadence while chaos events are in play: dead-task queues
# get no poll events, so without a periodic scan their requests would
# never be counted as dropped (accounting hole, not a serving change)
_CHAOS_SCAN_S = 0.5

__all__ = ["ClusterRuntime", "Server", "SimMetrics"]


@dataclass
class _AppState:
    """One co-located app's static serving state."""
    name: str
    graph: TaskGraph
    config: PlanConfig
    frontend: object = None       # Optional[Frontend]


class ClusterRuntime:
    """The shared event loop serving one or several co-located apps.

    Single-app (legacy): ``ClusterRuntime(graph, config, backend, ...)``.
    Multi-app: ``ClusterRuntime.multi({app: (graph, config)}, ...)``.
    All queue/served-state dictionaries are keyed by the qualified task
    name (plain name for the single-app runtime), so external capacity
    hooks address tasks as ``"app::task"`` in multi-app runtimes.
    """

    def __init__(self, graph: TaskGraph, config: PlanConfig,
                 backend: Optional[ExecutionBackend] = None, *,
                 seed: int = 0, staleness_ms: float = 20.0,
                 frontend=None, time_base_s: float = 0.0,
                 transition: Optional[Any] = None,
                 cluster: Optional[Any] = None,
                 monitor=None, ladder=None, hooks=None,
                 fast: bool = True):
        self._setup({"": _AppState("", graph, config, frontend)},
                    backend, seed=seed, staleness_ms=staleness_ms,
                    time_base_s=time_base_s, transition=transition,
                    cluster=cluster, monitor=monitor, ladder=ladder,
                    hooks=hooks, fast=fast)

    @classmethod
    def multi(cls, apps: Mapping[str, Tuple[TaskGraph, PlanConfig]],
              backend: Optional[ExecutionBackend] = None, *,
              seed: int = 0, staleness_ms: float = 20.0,
              frontends: Optional[Mapping[str, object]] = None,
              time_base_s: float = 0.0,
              transition: Optional[Any] = None,
              cluster: Optional[Any] = None,
              monitor=None, ladder=None, hooks=None,
              fast: bool = True) -> "ClusterRuntime":
        """Serve several co-located apps on one event loop.

        ``apps`` maps the (non-empty) app name to that app's graph and
        per-app :class:`PlanConfig` — e.g. the ``plans`` of a
        joint plan; ``frontends`` optionally
        maps app name to its :class:`~repro_torch.core.frontend.Frontend`."""
        if not apps:
            raise ValueError("need at least one app")
        if any(not name for name in apps):
            raise ValueError("multi-app names must be non-empty")
        rt = cls.__new__(cls)
        fes = frontends or {}
        rt._setup({name: _AppState(name, g, cfg, fes.get(name))
                   for name, (g, cfg) in apps.items()},
                  backend, seed=seed, staleness_ms=staleness_ms,
                  time_base_s=time_base_s, transition=transition,
                  cluster=cluster, monitor=monitor, ladder=ladder,
                  hooks=hooks, fast=fast)
        return rt

    # ------------------------------------------------------------------
    def _setup(self, apps: Dict[str, _AppState],
               backend: Optional[ExecutionBackend], *, seed: int,
               staleness_ms: float, time_base_s: float,
               transition: Optional[Any] = None,
               cluster: Optional[Any] = None,
               monitor=None, ladder=None, hooks=None, fast: bool = True):
        self._apps = apps
        # event-loop selection (DESIGN.md §16): the vectorized calendar
        # loop (repro_torch.runtime.fastloop) is the default; ``fast=False``
        # keeps the incumbent per-event loop as the differential oracle
        self.fast = fast
        # bumped on EVERY fleet mutation (kills, elasticity, transitions,
        # retire sweeps, ladder downshifts via refresh_capacity) so the
        # fast loop's per-queue server mirrors know to rebuild
        self._fleet_epoch = 0
        self._single = apps.get("") if list(apps) == [""] else None
        self.backend = backend if backend is not None else SimBackend()
        self.rng = np.random.default_rng(seed)
        self.staleness_ms = staleness_ms
        self.time_base_s = time_base_s
        self._transition = transition
        # chaos wiring (DESIGN.md §13): the hardware model that resolves
        # domain/preemption blast radii, the mid-bin monitor (e.g. an
        # EmergencyReplanner) and the degradation ladder
        self.cluster = cluster
        self._monitor = monitor
        self._ladder = ladder
        # observability (DESIGN.md §14): an optional
        # instrumentation object whose on_* methods feed the metrics
        # registry + tracer; every call site is None-guarded so the
        # uninstrumented hot loop pays one pointer test per event
        self.hooks = hooks
        # closed-loop failure accounting: physical capacity units lost
        # per pool (fractional until ceil'd by dead_units()) and the
        # qualified tasks that lost streams — read by the
        # FailureDetector and the drop-reason attribution
        self._dead_unit_frac: Dict[str, float] = {}
        self.lost_capacity: set = set()
        self.servers: List[Server] = []
        if transition is None:
            for name, st in apps.items():
                for tup, m in st.config.instances():
                    # the tuple carries its slice's stream multiplicity, so
                    # the runtime needs no partition-catalogue lookup
                    for _ in range(m * tup.streams):
                        self.servers.append(
                            Server(tup, len(self.servers), app=name))
        else:
            self._build_transition_fleet(transition)
        self._next_idx = len(self.servers)
        self.by_task: Dict[str, List[Server]] = {}
        for s in self.servers:
            self.by_task.setdefault(qualify(s.app, s.tup.task),
                                    []).append(s)
        self.queues: Dict[str, List[QueuedRequest]] = {
            qualify(name, t): []
            for name, st in apps.items() for t in st.graph.tasks}
        # root_id -> root arrival time; ids and the map are instance-level
        # so a re-run on a runtime with leftover queued requests still
        # resolves their roots (and never reuses their ids)
        self._ids = itertools.count()
        self._root_t: Dict[int, float] = {}
        self._fastest = self._fastest_remaining()
        self._timeout = {qualify(name, t): st.config.lhat(t)
                         for name, st in apps.items()
                         for t in st.graph.tasks}
        if self._single is not None:
            self.backend.bind(self._single.graph, self._single.config)
        else:
            for name, st in apps.items():
                self.backend.bind(st.graph, st.config, app=name)

    # ------------------------------------------------------------------
    def _build_transition_fleet(self, plan: Any):
        """Deploy a mid-transition fleet (DESIGN.md §12): the target
        config's instances split into warm keeps and loading instances
        (dispatchable only from ``ready_s``), plus the OUTGOING config's
        draining instances (serving until ``retire_s``).  Fails loud if
        the plan's keep+load bookkeeping does not reproduce the deployed
        config exactly — a transition for the wrong target is a bug."""
        keep: Dict[Tuple[str, tuple], int] = {}
        for a in plan.keeps:
            k = (a.app, a.tup.key)
            keep[k] = keep.get(k, 0) + a.count
        loads: Dict[Tuple[str, tuple], List] = {}
        for a in plan.loads:
            loads.setdefault((a.app, a.tup.key), []).append(a)
        for name, st in self._apps.items():
            for tup, m in st.config.instances():
                kc = keep.pop((name, tup.key), 0)
                lds = loads.pop((name, tup.key), [])
                if kc + sum(a.count for a in lds) != m:
                    raise ValueError(
                        f"transition fleet mismatch for app {name!r} "
                        f"tuple {tup.key}: keep {kc} + load "
                        f"{sum(a.count for a in lds)} != planned {m}")
                for _ in range(kc * tup.streams):
                    self.servers.append(
                        Server(tup, len(self.servers), app=name))
                for a in lds:
                    for _ in range(a.count * tup.streams):
                        self.servers.append(
                            Server(tup, len(self.servers),
                                   busy_until=a.ready_s, app=name))
        stray = [k for k, c in keep.items() if c] + list(loads)
        if stray:
            raise ValueError(
                f"transition names tuples absent from the deployed "
                f"config: {sorted(stray)}")
        for a in plan.drains:
            if a.app not in self._apps:
                raise ValueError(
                    f"transition drains unknown app {a.app!r}")
            for _ in range(a.count * a.tup.streams):
                self.servers.append(
                    Server(a.tup, len(self.servers), app=a.app,
                           retire_at=a.retire_s))

    # -- single-app compatibility surface ------------------------------
    @property
    def graph(self) -> Optional[TaskGraph]:
        return self._single.graph if self._single is not None else None

    @property
    def config(self) -> Optional[PlanConfig]:
        return self._single.config if self._single is not None else None

    @property
    def frontend(self):
        return self._single.frontend if self._single is not None else None

    def effective_config(self, app: str = "") -> PlanConfig:
        """The LIVE deployment as a :class:`PlanConfig`: whole instances
        whose streams are neither killed nor draining.  After a chaos
        kill this is what an emergency re-plan must diff against — the
        planned config still counts capacity that no longer exists."""
        st = self._apps[app]
        streams: Dict[tuple, int] = {}
        tups: Dict[tuple, object] = {}
        for s in self.servers:
            if s.app != app or s.retire_at != math.inf:
                continue
            k = s.tup.key
            streams[k] = streams.get(k, 0) + 1
            tups[k] = s.tup
        counts = {k: n // max(tups[k].streams, 1)
                  for k, n in streams.items()}
        counts = {k: c for k, c in counts.items() if c > 0}
        return PlanConfig(st.graph, counts,
                          {k: tups[k] for k in counts},
                          dict(st.config.demand),
                          pool_budgets=st.config.pool_budgets)

    # ------------------------------------------------------------------
    def _fastest_remaining(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, st in self._apps.items():
            fastest_inst = {
                t: min(s.tup.latency_ms
                       for s in self.by_task[qualify(name, t)])
                for t in st.graph.tasks
                if self.by_task.get(qualify(name, t))}

            def rec(t: str) -> float:
                qt = qualify(name, t)
                if qt in out:
                    return out[qt]
                tail = max((rec(n) for n in st.graph.successors(t)),
                           default=0.0)
                out[qt] = fastest_inst.get(t, 0.0) + tail
                return out[qt]

            for t in st.graph.tasks:
                rec(t)
        return out

    # ------------------------------------------------------------------
    # capacity hooks (failure injection + elasticity)
    # ------------------------------------------------------------------
    def fail_instances(self, indices: Sequence[int], *,
                       record: bool = True, allow_empty: bool = False):
        """Kill servers (node failure).  Indices are global, so one event
        can model a host dying under SEVERAL co-located apps.  Shared
        per-app queues mean survivors simply absorb the load; raises if
        any app's task loses all capacity unless ``allow_empty`` (chaos
        storms degrade instead of crash — the emergency re-plan is the
        recovery path).

        ``record`` attributes the killed streams' capacity to their
        pools (``dead_units``) and marks their tasks as capacity-lossy
        (drop-reason attribution).  Intentional elasticity (the
        CapacityEvent retire path) passes ``record=False`` so planned
        shrinks never masquerade as failures."""
        dead = set(indices)
        gone = [s for s in self.servers if s.idx in dead]
        if record:
            for s in gone:
                # one stream is 1/streams of its instance's slice
                self._dead_unit_frac[s.tup.pool] = (
                    self._dead_unit_frac.get(s.tup.pool, 0.0)
                    + s.tup.cost / max(s.tup.streams, 1))
                self.lost_capacity.add(qualify(s.app, s.tup.task))
        self.servers = [s for s in self.servers if s.idx not in dead]
        self._fleet_epoch += 1
        self.by_task = {}
        for s in self.servers:
            self.by_task.setdefault(qualify(s.app, s.tup.task),
                                    []).append(s)
        if not allow_empty:
            for name, st in self._apps.items():
                for t in st.graph.tasks:
                    if not self.by_task.get(qualify(name, t)):
                        raise RuntimeError(
                            f"task {qualify(name, t)!r} lost all instances "
                            "— controller must re-plan with reduced "
                            "S_avail")
        self._fastest = self._fastest_remaining()
        self.backend.on_capacity_change(self.servers)
        if record and self.hooks is not None:
            self.hooks.on_dead_units(self.dead_units())

    # -- closed-loop failure accounting (DESIGN.md §13) -----------------
    def record_dead_units(self, pool: str, units: float):
        """Attribute ``units`` of physical capacity loss to ``pool`` —
        used by domain failures and preemptions, whose blast radius is
        physical hardware (which may exceed what was deployed on it)."""
        self._dead_unit_frac[pool] = (self._dead_unit_frac.get(pool, 0.0)
                                      + float(units))
        if self.hooks is not None:
            self.hooks.on_dead_units(self.dead_units())

    def dead_units(self) -> Dict[str, int]:
        """Per-pool dead capacity units observed by THIS runtime (killed
        or preempted servers, domain blast radii), ceil'd to the integer
        units the planner's Eq. 8 budgets subtract and clamped to the
        pool's physical capacity when the cluster is attached."""
        out: Dict[str, int] = {}
        for pool, frac in self._dead_unit_frac.items():
            units = int(math.ceil(frac - 1e-9))
            if self.cluster is not None:
                try:
                    units = min(units, self.cluster.pool(pool).capacity_units)
                except KeyError:
                    pass
            if units > 0:
                out[pool] = units
        return out

    def refresh_capacity(self):
        """Recompute the latency model + notify the backend after an
        external actor (the degradation ladder) mutated server tuples."""
        self._fleet_epoch += 1
        self._fastest = self._fastest_remaining()
        self.backend.on_capacity_change(self.servers)

    def add_instances(self, task: str, count: int, now: float = 0.0,
                      pool: Optional[str] = None):
        """Elasticity: clone ``count`` extra streams of ``task``'s first
        deployed tuple (a pod joined / capacity was restored).  ``task``
        is the qualified ``app::task`` name in multi-app runtimes;
        ``pool`` restricts the clone template to instances of that
        cluster pool."""
        servers = self.by_task.get(task) or []
        if pool is not None:
            servers = [s for s in servers if s.tup.pool == pool]
        if not servers:
            where = f" in pool {pool!r}" if pool is not None else ""
            raise RuntimeError(
                f"task {task!r} has no live instance{where} to clone")
        for _ in range(count):
            s = Server(servers[0].tup, self._next_idx, busy_until=now,
                       app=servers[0].app)
            self._next_idx += 1
            self.servers.append(s)
            self.by_task[task].append(s)
        self._fleet_epoch += 1
        self._fastest = self._fastest_remaining()
        self.backend.on_capacity_change(self.servers)

    def _apply_failure(self, ev: FailureEvent):
        if ev.indices is not None:
            self.fail_instances(ev.indices)
            return
        if ev.task is not None:
            qt = qualify(ev.app, ev.task)
        else:
            keys = [k for k in self.by_task
                    if not ev.app or split_qualified(k)[0] == ev.app]
            if ev.pool is not None:
                keys = [k for k in keys
                        if any(s.tup.pool == ev.pool
                               for s in self.by_task[k])]
            if not keys:
                # fail as loud as the other capacity hooks — an
                # app-scoped kill matching nothing is a scenario bug
                raise RuntimeError(
                    f"FailureEvent app {ev.app!r} pool {ev.pool!r} has no "
                    f"live servers (runtime serves {sorted(self._apps)})")
            qt = max(keys, key=lambda k: len(self.by_task[k]))
        cand = self.by_task.get(qt, [])
        if ev.pool is not None:
            cand = [s for s in cand if s.tup.pool == ev.pool]
            if not cand:
                raise RuntimeError(
                    f"FailureEvent task {qt!r} has no live servers in "
                    f"pool {ev.pool!r}")
        victims = [s.idx for s in cand[:ev.count]]
        if victims:
            self.fail_instances(victims)

    def _apply_domain_failure(self, ev: DomainFailureEvent):
        """Correlated kill: the named failure domain dies, taking its
        capacity units in EVERY member pool at once.  Which DEPLOYED
        streams die follows the cluster's implied placement — instances
        pack the pool's devices in deployment order, and a device
        belongs to ``domains[i % len(domains)]`` (see
        ``Pool.domain_units``) — so a plan spread across two racks
        loses roughly its per-rack share, not everything.  The PHYSICAL
        blast radius is recorded as dead capacity even where the
        incumbent plan deployed less, because the hardware is gone
        either way."""
        if self.cluster is None:
            raise RuntimeError(
                "DomainFailureEvent needs the runtime's cluster= — "
                "domains are resolved against the ClusterSpec")
        from repro_torch.hwspec import validate_domain_names
        validate_domain_names(self.cluster, [ev.domain],
                              "DomainFailureEvent")
        radius = self.cluster.domain_units().get(ev.domain, {})
        victims: List[int] = []
        for pool, units in radius.items():
            self.record_dead_units(pool, units)
            spec = self.cluster.pool(pool)
            per_dev = max(spec.scheme.units_per_device, 1)
            offset = 0.0    # running unit offset = packed device position
            for s in self.servers:
                if s.tup.pool != pool:
                    continue
                dev = int(offset // per_dev) % max(spec.count, 1)
                offset += s.tup.cost / max(s.tup.streams, 1)
                if spec.domains[dev % len(spec.domains)] != ev.domain:
                    continue
                victims.append(s.idx)
                self.lost_capacity.add(qualify(s.app, s.tup.task))
        if victims:
            # physical units were recorded above — don't double count
            self.fail_instances(victims, record=False, allow_empty=True)

    def _apply_preemption(self, ev: PreemptionEvent, now: float, push):
        """Spot reclaim notice: stamp ``retire_at`` on the affected
        streams (the notice window is a drain hand-over — in-flight and
        notice-window work completes, nothing new past it) and record
        the reclaimed physical units as dead capacity IMMEDIATELY, so a
        mid-bin emergency re-plan already excludes the doomed pool
        while it is still serving."""
        handover = now + max(ev.notice_s, 0.0)
        pool_servers = [s for s in self.servers if s.tup.pool == ev.pool]
        if self.cluster is not None:
            from repro_torch.hwspec import validate_pool_names
            validate_pool_names(self.cluster, [ev.pool], "PreemptionEvent")
            total = self.cluster.pool(ev.pool).capacity_units
        else:
            total = sum(s.tup.cost / max(s.tup.streams, 1)
                        for s in pool_servers)
        reclaim = float(total) * min(max(ev.fraction, 0.0), 1.0)
        if reclaim <= 0.0:
            return
        self.record_dead_units(ev.pool, reclaim)
        covered = 0.0
        stamped = False
        for s in pool_servers:
            if ev.fraction < 1.0 and covered >= reclaim - 1e-9:
                break
            s.retire_at = min(s.retire_at, handover)
            self.lost_capacity.add(qualify(s.app, s.tup.task))
            covered += s.tup.cost / max(s.tup.streams, 1)
            stamped = True
        if stamped:
            # retire_at stamps change dispatchability immediately
            self._fleet_epoch += 1
            # idle preempted streams get no 'done' event to retire them
            push(handover, "retire_sweep", None)

    def apply_transition(self, plan: Any, now: float):
        """Execute a reconfiguration LIVE on the running fleet: the
        current servers must be the plan's incumbent deployment.  Drained
        instances get their ``retire_at`` stamped (they finish in-flight
        work and stop accepting batches), incoming instances are created
        with their warm-up as ``busy_until``, and each app's config /
        batching timeouts switch to the transition's target."""
        for a in plan.drains:
            qt = qualify(a.app, a.tup.task)
            cand = [s for s in self.by_task.get(qt, [])
                    if s.tup.key == a.tup.key and s.app == a.app
                    and s.retire_at == math.inf]
            need = a.count * a.tup.streams
            if len(cand) < need:
                raise RuntimeError(
                    f"transition drains {need} streams of {a.tup.key} "
                    f"(app {a.app!r}) but only {len(cand)} are live")
            for s in cand[:need]:
                s.retire_at = now + a.retire_s
        for a in plan.loads:
            qt = qualify(a.app, a.tup.task)
            for _ in range(a.count * a.tup.streams):
                s = Server(a.tup, self._next_idx, app=a.app,
                           busy_until=now + a.ready_s)
                self._next_idx += 1
                self.servers.append(s)
                self.by_task.setdefault(qt, []).append(s)
        for app, cfg in plan.target.items():
            st = self._apps.get(app)
            if st is None:
                raise RuntimeError(
                    f"transition targets unknown app {app!r} "
                    f"(runtime serves {sorted(self._apps)})")
            st.config = cfg
            for t in st.graph.tasks:
                self._timeout[qualify(app, t)] = cfg.lhat(t)
        self._fleet_epoch += 1
        self._fastest = self._fastest_remaining()
        self.backend.on_capacity_change(self.servers)

    def _sweep_retired(self, now: float):
        """Remove drained servers that are IDLE past their retire_at —
        they can never serve again, and leaving them in ``by_task``
        would fool the lost-all-instances guard, the fastest-remaining
        map and clone-template lookups.  Runs on the scheduled retire
        sweeps AND after a retired stream's last batch completes, so
        early-drop estimates and the backend always see the true fleet
        in one batched pass."""
        gone = [s for s in self.servers
                if s.retire_at <= now + 1e-12
                and s.busy_until <= now + 1e-12]
        if not gone:
            return
        dead = set(id(s) for s in gone)
        self.servers = [s for s in self.servers if id(s) not in dead]
        for qt, peers in self.by_task.items():
            self.by_task[qt] = [s for s in peers if id(s) not in dead]
        self._fleet_epoch += 1
        self._fastest = self._fastest_remaining()
        self.backend.on_capacity_change(self.servers)

    def _apply_capacity(self, ev: CapacityEvent, now: float):
        qt = qualify(ev.app, ev.task)
        if ev.delta >= 0:
            self.add_instances(qt, ev.delta, now, pool=ev.pool)
        else:
            pool = self.by_task.get(qt, [])
            if ev.pool is not None:
                pool = [s for s in pool if s.tup.pool == ev.pool]
                if not pool:
                    # fail as loud as the add path does — a pool-scoped
                    # retire that matches nothing is a scenario bug
                    raise RuntimeError(
                        f"task {qt!r} has no instances in pool "
                        f"{ev.pool!r} to retire")
            victims = [s.idx for s in pool[:-ev.delta]]
            if victims:
                # an intentional shrink is not a failure: don't feed the
                # closed-loop detector with planned elasticity
                self.fail_instances(victims, record=False)

    # ------------------------------------------------------------------
    def run(self, scenario: Scenario) -> SimMetrics:
        """Serve ``scenario`` to completion.  Dispatches to the
        vectorized event-calendar loop (``repro_torch.runtime.fastloop``,
        DESIGN.md §16) unless the runtime was built with ``fast=False``,
        which keeps the incumbent per-event loop as the differential
        oracle — both produce field-exact-identical SimMetrics."""
        if self.fast:
            from repro_torch.runtime.fastloop import run_fast
            return run_fast(self, scenario)
        return self._run_legacy(scenario)

    def _run_legacy(self, scenario: Scenario) -> SimMetrics:
        m = SimMetrics()
        hooks = self.hooks
        # transition windows (constructor plan starts at t=0; scheduled
        # TransitionEvents open theirs when they fire) — requests
        # ARRIVING inside any window are additionally filed under the
        # ``m.window`` ledger so the reconfiguration cost stays visible
        windows: List[Tuple[float, float]] = []
        if self._transition is not None:
            windows.append((0.0, self._transition.makespan_s))
        if (self._transition is not None or scenario.transitions
                or self._monitor is not None):
            # a monitor may open emergency-transition windows mid-run
            m.window = SimMetrics()

        def in_window(t: float) -> bool:
            return any(a <= t < b for a, b in windows)

        # per-domain attainment: domain name -> failure time; requests
        # ARRIVING after it are additionally filed under m.domain(name)
        domain_open: Dict[str, float] = {}

        ids = self._ids
        seq = itertools.count()
        events: List[Tuple[float, int, str, object]] = []
        duration_s, warmup_s = scenario.duration_s, scenario.warmup_s
        # per-app deadline/drain allowance (each app keeps its own SLO)
        slo_s = {name: st.graph.slo_latency_ms / 1e3 * scenario.slo_scale
                 for name, st in self._apps.items()}
        # drain horizon: in-flight work may finish past duration_s; +10 s
        # is the legacy allowance, widened when scaled SLOs exceed it
        drain_s = duration_s + max(10.0, 2.0 * max(slo_s.values()))
        root_t = self._root_t

        def push(t, kind, payload):
            heapq.heappush(events, (t, next(seq), kind, payload))

        def sub(app: str) -> SimMetrics:
            """Per-app metrics bucket (the aggregate itself for the
            single-app legacy runtime)."""
            return m if app == "" else m.app(app)

        # -- arrivals: one independent process per app ------------------
        if scenario.apps:
            missing = [a.app for a in scenario.apps
                       if a.app not in self._apps]
            if missing:
                raise ValueError(f"scenario names unknown apps {missing} "
                                 f"(runtime has {list(self._apps)})")
            workloads = [(a.app, a.arrivals) for a in scenario.apps]
        else:
            if self._single is None:
                raise ValueError("multi-app runtime needs Scenario.multi "
                                 "(per-app arrival processes)")
            workloads = [("", scenario.arrivals)]
        for app, proc in workloads:
            st = self._apps[app]
            entry_q = qualify(app, st.graph.entry)
            for t in proc.times(self.rng, duration_s):
                if t > drain_s:
                    # past the drain horizon the loop never processes it —
                    # an idle arrival process can overshoot by ~1e9 s,
                    # which would otherwise blow up the demand bins
                    break
                if st.frontend is not None:
                    meta = st.frontend.submit(self.time_base_s + t)
                    deadline = t + (meta.deadline_s
                                    - (self.time_base_s + t)
                                    ) * scenario.slo_scale
                    # per-app frontends stamp independent id streams; the
                    # runtime-global id keeps root bookkeeping collision-
                    # free across apps (single-app: frontend id, legacy)
                    rid = meta.req_id if self._single is not None \
                        else next(ids)
                else:
                    rid = next(ids)
                    deadline = t + slo_s[app]
                root_t[rid] = t
                push(t, "arrive",
                     QueuedRequest(rid, rid, entry_q, t, deadline))
        for ev in scenario.failures:
            push(ev.at_s, "fail", ev)
        for ev in scenario.capacity:
            push(ev.at_s, "capacity", ev)
        for ev in scenario.transitions:
            push(ev.at_s, "transition", ev.plan)
        for ev in scenario.domain_failures:
            push(ev.at_s, "domain_fail", ev)
        for ev in scenario.preemptions:
            push(ev.at_s, "preempt", ev)
        chaos_events = scenario.domain_failures or scenario.preemptions \
            or any(f.pool is not None for f in scenario.failures)
        if chaos_events:
            # periodic queue sweeps from the first chaos event on: a
            # task with no live servers gets no poll events, so its
            # queued requests would otherwise never be counted dropped
            t0 = min(e.at_s for e in (scenario.domain_failures
                                      + scenario.preemptions
                                      + scenario.failures))
            t_scan = t0 + _CHAOS_SCAN_S
            while t_scan <= drain_s:
                push(t_scan, "chaos_scan", None)
                t_scan += _CHAOS_SCAN_S
        if self._monitor is not None:
            begin = getattr(self._monitor, "begin_run", None)
            if begin is not None:
                begin(self)
            interval = float(getattr(self._monitor, "interval_s", 0.5))
            t_mon = interval
            while t_mon <= duration_s:
                push(t_mon, "mon", None)
                t_mon += interval
        if self._transition is not None:
            # sweep each drain wave out once its hand-over passes — an
            # idle drained stream gets no 'done' event to retire it
            for t_r in sorted({a.retire_s
                               for a in self._transition.drains}):
                push(t_r, "retire_sweep", None)
        for qt, q in self.queues.items():
            if q:                   # leftover work from a prior run
                push(0.0, "poll", qt)

        def account_drop(app: str, task: str, g, rt0: float, reason: str,
                         root_id: int = -1):
            """File one request's fan-weighted drop into every ledger it
            belongs to (aggregate, per-app, transition window, failed
            domains), attributed to ``reason``."""
            in_main = rt0 >= warmup_s
            in_win = m.window is not None and in_window(rt0)
            doms = [d for d, tf in domain_open.items() if rt0 >= tf]
            if not (in_main or in_win or doms):
                return
            fan = max(1, round(sum(
                g.factor(task, g.tasks[task].most_accurate.name, t2)
                for t2 in g.successors(task)) or 1))
            if in_main:
                m.count_drop(fan, reason)
                if app:
                    sub(app).count_drop(fan, reason)
                if hooks is not None:
                    hooks.on_drop(app, task, reason, fan, rt0,
                                  root_id=root_id)
            if in_win:
                m.window.count_drop(fan, reason)
            for d in doms:
                m.domain(d).count_drop(fan, reason)

        def drop_scan(qt: str, now: float):
            """Early-drop pass over one (app, task) queue (paper §3.3)."""
            app, task = split_qualified(qt)
            g = self._apps[app].graph
            q = self.queues[qt]
            keep = []
            fastest = self._fastest[qt]
            timeout = self._timeout[qt]
            lossy = qt in self.lost_capacity
            for req in q:
                reason = early_drop(req, now, fastest, self.staleness_ms,
                                    timeout)
                if reason is None:
                    keep.append(req)
                else:
                    # attribution: a task that lost streams to a kill or
                    # preemption drops because capacity failed, not
                    # because the request was inherently unserviceable
                    rkey = ("failed_capacity" if lossy
                            else "deadline"
                            if reason == "deadline_unreachable" else reason)
                    account_drop(app, task, g, root_t[req.root_id], rkey,
                                 root_id=req.root_id)
            self.queues[qt] = keep

        def try_dispatch(qt: str, now: float):
            drop_scan(qt, now)
            q = self.queues[qt]
            while q:
                # a drained (retired) stream takes no NEW batches; an
                # incoming stream's warm-up is its initial busy_until
                # (.get: a chaos kill may have emptied the task's fleet)
                idle = [s for s in self.by_task.get(qt, [])
                        if s.busy_until <= now + 1e-12
                        and s.retire_at > now + 1e-12]
                if not idle:
                    break
                head_wait = (now - q[0].enqueue_t) * 1e3
                # pick the idle server that can drain the most
                srv = max(idle, key=lambda s: s.tup.batch)
                if not batch_ready(len(q), srv.tup.batch, head_wait,
                                   self._timeout[qt]):
                    break
                if len(q) < srv.tup.batch:
                    # partial launch on the smallest-batch idle server
                    srv = min(idle, key=lambda s: s.tup.batch)
                batch = q[: srv.tup.batch]
                del q[: srv.tup.batch]
                service = self.backend.service_s(srv, batch, now, self.rng)
                srv.busy_until = now + service
                if hooks is not None:
                    hooks.on_dispatch(srv, batch, now, service, len(q))
                push(srv.busy_until, "done", (srv.idx, batch))
            if q:
                # retired streams must not feed the poll clock: their
                # stale busy_until would pin min-busy in the past and
                # the queue could stall until the next arrival
                alive = [s for s in self.by_task.get(qt, [])
                         if s.retire_at > now + 1e-12]
                if not alive:
                    return
                t_poll = next_poll_time(
                    q[0].enqueue_t, self._timeout[qt],
                    min(s.busy_until for s in alive))
                if t_poll > now + 1e-9:
                    push(t_poll, "poll", qt)

        srv_by_idx = {s.idx: s for s in self.servers}

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if now > drain_s:
                break
            if kind == "arrive":
                req = payload
                if self._ladder is not None:
                    shed = self._ladder.gate(self, req.task, now, req=req)
                    if shed is not None:
                        app0, task0 = split_qualified(req.task)
                        account_drop(app0, task0,
                                     self._apps[app0].graph,
                                     root_t[req.root_id], shed,
                                     root_id=req.root_id)
                        continue
                req.enqueue_t = now
                self.queues[req.task].append(req)
                if hooks is not None:
                    app0, task0 = split_qualified(req.task)
                    hooks.on_arrival(app0, task0, now,
                                     len(self.queues[req.task]))
                try_dispatch(req.task, now)
            elif kind == "poll":
                try_dispatch(payload, now)
            elif kind == "mon":
                plan = self._monitor.check(self, now, m)
                if plan is not None:
                    # emergency re-plan executes exactly like a scheduled
                    # TransitionEvent: live drains/loads + its own window
                    self.apply_transition(plan, now)
                    windows.append((now, now + plan.makespan_s))
                    for a in plan.drains:
                        push(now + a.retire_s, "retire_sweep", None)
                    if hooks is not None:
                        hooks.on_transition(now, plan.makespan_s,
                                            emergency=True, plan=plan)
                if hooks is not None:
                    if self._ladder is not None:
                        hooks.on_ladder_level(self._ladder.level)
                    hooks.on_dead_units(self.dead_units())
                srv_by_idx = {s.idx: s for s in self.servers}
                for qt2 in self.queues:
                    try_dispatch(qt2, now)
            elif kind in ("fail", "capacity", "transition", "retire_sweep",
                          "domain_fail", "preempt", "chaos_scan"):
                if kind == "fail":
                    self._apply_failure(payload)
                elif kind == "capacity":
                    self._apply_capacity(payload, now)
                elif kind == "transition":
                    self.apply_transition(payload, now)
                    windows.append((now, now + payload.makespan_s))
                    for a in payload.drains:
                        push(now + a.retire_s, "retire_sweep", None)
                    if hooks is not None:
                        hooks.on_transition(now, payload.makespan_s,
                                            emergency=False, plan=payload)
                elif kind == "domain_fail":
                    self._apply_domain_failure(payload)
                    domain_open.setdefault(payload.domain, now)
                elif kind == "preempt":
                    self._apply_preemption(payload, now, push)
                elif kind == "chaos_scan":
                    pass        # the shared try_dispatch pass below
                else:
                    self._sweep_retired(now)
                srv_by_idx = {s.idx: s for s in self.servers}
                for qt2 in self.queues:
                    try_dispatch(qt2, now)
            elif kind == "done":
                idx, batch = payload
                srv = srv_by_idx.get(idx)
                if srv is None:
                    continue
                app, g = srv.app, self._apps[srv.app].graph
                task, variant = srv.tup.task, srv.tup.variant
                # qualified names are loop-invariant per batch — build
                # them once, not per serviced request (hot loop)
                qt_task = qualify(app, task)
                agg_key = (qt_task, variant)
                succ_q = [(t2, qualify(app, t2))
                          for t2 in g.successors(task)]
                for req in batch:
                    srv.served += 1
                    if srv.degraded:
                        m.degraded_served += 1
                        if app:
                            sub(app).degraded_served += 1
                    m.traffic[agg_key] = m.traffic.get(agg_key, 0) + 1
                    if app:
                        ms = sub(app)
                        ms.traffic[(task, variant)] = \
                            ms.traffic.get((task, variant), 0) + 1
                    if not succ_q:
                        rt0 = root_t[req.root_id]
                        in_win = m.window is not None and in_window(rt0)
                        doms = tuple(m.domain(d)
                                     for d, tf in domain_open.items()
                                     if rt0 >= tf)
                        if rt0 >= warmup_s or in_win or doms:
                            lat = (now - rt0) * 1e3
                            missed = now > req.deadline + 1e-9
                            sinks = (((m,) if app == ""
                                      else (m, sub(app)))
                                     if rt0 >= warmup_s else ())
                            for mm in (sinks + ((m.window,) if in_win
                                                else ()) + doms):
                                mm.latencies_ms.append(lat)
                                mm.completions += 1
                                if missed:
                                    mm.missed += 1
                            if sinks and hooks is not None:
                                hooks.on_complete(app, req.root_id,
                                                  lat, missed, now)
                        continue
                    for t2, qt2 in succ_q:
                        fan = self._sample_fanout(g.factor(task, variant,
                                                           t2))
                        for _ in range(fan):
                            child = QueuedRequest(
                                next(ids), req.root_id, qt2,
                                now, req.deadline, req.path_done + (task,))
                            self.queues[qt2].append(child)
                    for _, qt2 in succ_q:
                        try_dispatch(qt2, now)
                if srv.retire_at <= now + 1e-12:
                    # drained stream went idle past its hand-over point:
                    # its in-flight batch just completed — retire it
                    self._sweep_retired(now)
                    del srv_by_idx[idx]
                try_dispatch(qt_task, now)
        # summed span of the UNION of windows (overlaps merged)
        span, end = 0.0, -math.inf
        for a, b in sorted(windows):
            span += max(0.0, b - max(a, end))
            end = max(end, b)
        m.transition_window_s = span
        for name, st in self._apps.items():
            if st.frontend is not None:
                # report the exact datapath outcome (fan-weighted, leaf-
                # level — identical accounting to SimMetrics.violation_
                # rate) into each app's own re-plan trigger window
                ms = sub(name)
                st.frontend.record_bin_outcome(ms.total_requests,
                                               ms.violations)
        return m

    # ------------------------------------------------------------------
    def _sample_fanout(self, f: float) -> int:
        base = int(math.floor(f))
        return base + (1 if self.rng.random() < (f - base) else 0)
