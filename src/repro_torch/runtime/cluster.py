"""ClusterRuntime: the single shared serving event loop.

Control plane (queues, task-level batching per paper §3.3, early drop,
failure/elasticity bookkeeping, metrics) lives here; the data plane is a
pluggable :class:`~repro_torch.runtime.backend.ExecutionBackend` that only turns
(server, batch) into a service time.  Workloads arrive as declarative
:class:`~repro_torch.runtime.scenario.Scenario` objects.  The legacy
``Simulator`` of the JAX package is a thin shim over
``ClusterRuntime(SimBackend())`` and stays seed-deterministic.  This
runtime has one event loop, the vectorized one
(:mod:`repro_torch.runtime.fastloop`), and gives field-exact the
``SimMetrics`` of both of the reference's loops.  The cluster is the port's
:class:`~repro_torch.hwspec.ClusterSpec`; transition plans, monitors,
ladders and hooks are the port's own
:class:`~repro_torch.reconfig.TransitionPlan`,
:class:`~repro_torch.chaos.EmergencyReplanner`,
:class:`~repro_torch.chaos.DegradationLadder` and
:class:`~repro_torch.obs.Instrumentation`, taken duck-typed as the JAX
package takes them.

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

import itertools
import math
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Any, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.core.dispatch import QueuedRequest
from repro_torch.core.milp import PlanConfig
from repro_torch.core.taskgraph import TaskGraph, qualify, split_qualified
from repro_torch.runtime.backend import ExecutionBackend, SimBackend
from repro_torch.runtime.fastloop import run_fast
from repro_torch.runtime.metrics import Server, SimMetrics
from repro_torch.runtime.scenario import (CapacityEvent, DomainFailureEvent,
                                    FailureEvent, PreemptionEvent, Scenario)

if TYPE_CHECKING:   # pragma: no cover — typing only
    from repro_torch.hwspec import ClusterSpec

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
                 cluster: Optional["ClusterSpec"] = None,
                 monitor=None, ladder=None, hooks=None):
        self._setup({"": _AppState("", graph, config, frontend)},
                    backend, seed=seed, staleness_ms=staleness_ms,
                    time_base_s=time_base_s, transition=transition,
                    cluster=cluster, monitor=monitor, ladder=ladder,
                    hooks=hooks)

    @classmethod
    def multi(cls, apps: Mapping[str, Tuple[TaskGraph, PlanConfig]],
              backend: Optional[ExecutionBackend] = None, *,
              seed: int = 0, staleness_ms: float = 20.0,
              frontends: Optional[Mapping[str, object]] = None,
              time_base_s: float = 0.0,
              transition: Optional[Any] = None,
              cluster: Optional["ClusterSpec"] = None,
              monitor=None, ladder=None, hooks=None
              ) -> "ClusterRuntime":
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
                  hooks=hooks)
        return rt

    # ------------------------------------------------------------------
    def _setup(self, apps: Dict[str, _AppState],
               backend: Optional[ExecutionBackend], *, seed: int,
               staleness_ms: float, time_base_s: float,
               transition: Optional[Any] = None,
               cluster: Optional["ClusterSpec"] = None,
               monitor=None, ladder=None, hooks=None):
        self._apps = apps
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
        """Serve ``scenario`` to completion on the vectorized
        event-calendar loop (``repro_torch.runtime.fastloop``, DESIGN.md
        §16): field-exact the ``SimMetrics`` of the reference's
        ``repro.runtime`` loops, its per-event one and its vectorized
        one."""
        return run_fast(self, scenario)
