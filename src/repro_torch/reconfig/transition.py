"""Plan-diff transitions: incumbent → target as staged, timed actions.

A reconfiguration is modeled per deployed instance:

* **keep** — the tuple (t, v, s, b) survives with (part of) its count:
  zero cost, serves straight through.
* **drain** — the instance leaves the plan: it keeps accepting work until
  ``retire_s`` (the hand-over point: when its task's replacement capacity
  is warm), then finishes in-flight batches and retires.  In a pool whose
  scheme ``repartition_blocks`` (MIG) and that needs carving, outgoing
  instances retire immediately — the device cannot serve while it is
  re-partitioned.
* **load** — a new instance joins: it only starts serving at ``ready_s``,
  the weight-load time (model bytes / the device's staging bandwidth,
  sharded across the slice's devices) plus, when no drained slice with an
  identical physical footprint can be reused, the scheme's
  ``repartition_delay_s`` for carving a new slice (``carved=True``).

Physical-slice reuse is tracked per pool across ALL co-located apps: a
drained ``2g.10gb.s2`` slice can host an incoming ``2g.10gb.s1`` without
re-carving (streams are software), and a freed 2×2 torus rectangle can be
regrouped for any 4-chip tuple.  The packer's device-level state is not
consulted — this is the same pool-level approximation the MILP capacity
rows make (DESIGN.md §12).

``policy="atomic"`` is the naive baseline the benchmark regresses
against: EVERY instance is swapped at once, old capacity retires at t=0
and the whole new fleet becomes ready only at the global makespan.

A copy of the JAX package's ``reconfig/transition.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.configs import ARCHS
from repro_torch.core.milp import JointPlan, PlanConfig, TupleVar
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.hwspec import ClusterSpec, Slice, validate_pool_names

Key = Tuple[str, str, str, int]
PhysKey = Tuple[int, int, Optional[Tuple[int, int]], int]


def physical_key(sl: Slice) -> PhysKey:
    """The carve-relevant footprint of a slice: everything but the
    stream multiplicity (an MPS stream count is software — two slices
    differing only in streams share one physical partition)."""
    return (sl.cost, sl.devices, sl.shape, sl.mem_slots)


@dataclass(frozen=True)
class TransitionAction:
    """One staged step of a reconfiguration.

    ``ready_s`` / ``retire_s`` are offsets from the moment the transition
    starts (the runtime adds its own clock base when the plan executes as
    a scheduled event)."""
    kind: str                    # "keep" | "drain" | "load"
    app: str                     # "" = single-app namespace
    tup: TupleVar                # target tuple (loads/keeps), old (drains)
    count: int                   # instances (streams multiply at runtime)
    ready_s: float = 0.0         # load: when the instances join dispatch
    retire_s: float = 0.0        # drain: when they stop taking new work
    carved: bool = False         # load: needed a fresh physical slice


@dataclass
class TransitionPlan:
    """The staged reconfiguration between two plans.

    ``target`` holds the post-transition deployment per app so a runtime
    applying the plan mid-run can update its config/timeout state; the
    single-app namespace uses the empty app name."""
    keeps: Tuple[TransitionAction, ...]
    drains: Tuple[TransitionAction, ...]
    loads: Tuple[TransitionAction, ...]
    target: Dict[str, PlanConfig]
    makespan_s: float                       # max load ready_s (0 if none)
    repartition_pools: frozenset            # pools that carve new slices
    blocked_pools: frozenset                # carving pools that also block

    @property
    def is_empty(self) -> bool:
        return not self.drains and not self.loads

    @property
    def n_actions(self) -> int:
        return len(self.drains) + len(self.loads)

    def summary(self) -> str:
        return (f"keep={sum(a.count for a in self.keeps)} "
                f"drain={sum(a.count for a in self.drains)} "
                f"load={sum(a.count for a in self.loads)} "
                f"carved={sum(a.count for a in self.loads if a.carved)} "
                f"makespan={self.makespan_s:.2f}s")

    def audit_detail(self) -> Dict[str, object]:
        """Structured summary for the control-plane flight recorder
        (:class:`repro_torch.obs.audit.AuditLog`)."""
        return {
            "keep": sum(a.count for a in self.keeps),
            "drain": sum(a.count for a in self.drains),
            "load": sum(a.count for a in self.loads),
            "carved": sum(a.count for a in self.loads if a.carved),
            "actions": self.n_actions,
            "apps": sorted(self.target),
            "repartition_pools": sorted(self.repartition_pools),
        }


# ---------------------------------------------------------------------------
@dataclass
class TransitionPlanner:
    """Diffs two deployments into a :class:`TransitionPlan`.

    Arguments:
        cluster: the shared hardware model — slice lookups and per-pool
            repartition semantics come from here.
        graphs: app name → task graph (a bare :class:`TaskGraph` is
            accepted for the single-app namespace).  Needed to resolve a
            tuple's variant to its arch's weight bytes.
        policy: ``"staged"`` (default) or ``"atomic"`` (the naive
            swap-everything-after-the-full-delay baseline).
        delay_scale: multiplies every derived delay (0 → instantaneous
            transitions with the full staging bookkeeping — the parity
            knob the acceptance tests pin).
        drain_grace_s: retire offset for drained instances whose task
            receives no replacement capacity (pure shrinks).
    """
    cluster: ClusterSpec
    graphs: Union[TaskGraph, Mapping[str, TaskGraph]]
    policy: str = "staged"
    delay_scale: float = 1.0
    drain_grace_s: float = 0.0

    def __post_init__(self):
        if self.policy not in ("staged", "atomic"):
            raise ValueError(f"unknown transition policy {self.policy!r}")
        if isinstance(self.graphs, TaskGraph):
            self.graphs = {"": self.graphs}

    # ------------------------------------------------------------------
    def weight_load_s(self, app: str, tup: TupleVar) -> float:
        """Warm-up time of one instance: stage the variant's weights into
        the slice (sharded across its devices, each device loading its
        shard in parallel over its staging-bandwidth share)."""
        pool, sl = self.cluster.find_slice(tup.segment)
        graph = self.graphs[app]
        v = graph.tasks[tup.task].variant(tup.variant)
        n_total, _ = ARCHS[v.arch].param_count()
        wb = float(n_total) * pool.device.param_bytes(v.quant)
        per_dev = wb / max(sl.devices, 1)
        return pool.device.weight_load_s(per_dev, sl.memory_fraction)

    # ------------------------------------------------------------------
    def plan(self, old: Optional[PlanConfig], new: PlanConfig,
             dead_units: Optional[Mapping[str, int]] = None
             ) -> TransitionPlan:
        """Single-app transition (the empty app namespace).

        ``dead_units`` (units per pool name) shrinks the physical
        headroom warm-ups may use — failed capacity cannot host a
        loading instance."""
        return self._plan({"": old} if old is not None else None,
                          {"": new}, dead_units)

    def plan_joint(self, old: Optional[JointPlan], new: JointPlan,
                   dead_units: Optional[Mapping[str, int]] = None
                   ) -> TransitionPlan:
        """Multi-app transition: per-app diffs, but physical-slice reuse
        and repartition blocking are tracked per POOL across apps — the
        pools are shared, so one app's drained slice can host another
        app's incoming instance without carving."""
        return self._plan(dict(old.plans) if old is not None else None,
                          dict(new.plans), dead_units)

    # ------------------------------------------------------------------
    def _plan(self, old: Optional[Dict[str, PlanConfig]],
              new: Dict[str, PlanConfig],
              dead_units: Optional[Mapping[str, int]] = None
              ) -> TransitionPlan:
        missing = set(new) - set(self.graphs)
        if missing:
            raise ValueError(f"TransitionPlanner has no graphs for apps "
                             f"{sorted(missing)}")
        if dead_units:
            validate_pool_names(self.cluster, dead_units, "dead_units")
        keeps: List[TransitionAction] = []
        raw_drains: List[Tuple[str, TupleVar, int]] = []
        raw_loads: List[Tuple[str, TupleVar, int]] = []
        # iterate the UNION of apps: an app dropped from the target has
        # no loads, but its whole incumbent fleet must still drain
        for app in sorted(set(new) | set(old or {})):
            old_cfg = (old or {}).get(app)
            new_cfg = new.get(app)
            oc = {k: m for k, m in (old_cfg.counts if old_cfg else {}
                                    ).items() if m > 0}
            otup = old_cfg.tuples if old_cfg else {}
            nc = {k: m for k, m in (new_cfg.counts if new_cfg else {}
                                    ).items() if m > 0}
            for k in sorted(set(oc) | set(nc)):
                o, n = oc.get(k, 0), nc.get(k, 0)
                if o and n:
                    keeps.append(TransitionAction(
                        "keep", app, new_cfg.tuples[k], min(o, n)))
                if o > n:
                    raw_drains.append((app, otup[k], o - n))
                elif n > o:
                    raw_loads.append((app, new_cfg.tuples[k], n - o))
        if old is None:
            # cold start: nothing to diff against — the initial deploy is
            # outside the transition model (the controller's first bin)
            raw_drains = []
            keeps = [TransitionAction("keep", app, new[app].tuples[k], m)
                     for app in sorted(new)
                     for k, m in sorted(new[app].counts.items()) if m > 0]
            raw_loads = []
        if self.policy == "atomic" and (raw_drains or raw_loads):
            return self._plan_atomic(old or {}, new)
        return self._plan_staged(keeps, raw_drains, raw_loads, old or {},
                                 new, dead_units or {})

    # ------------------------------------------------------------------
    def _plan_staged(self, keeps, raw_drains, raw_loads,
                     old: Dict[str, PlanConfig],
                     new: Dict[str, PlanConfig],
                     dead_units: Mapping[str, int]) -> TransitionPlan:
        """Capacity-honest staging.  An incoming instance warms up on one
        of three capacity sources, and the source decides who covers the
        warm-up window:

        * *spare* pool headroom (physical units the incumbent leaves
          idle): the warm-up runs NEXT TO the old fleet — all drains
          keep serving until hand-over.  The spare region must still be
          carved (``carved=True``), so it pays the repartition delay.
        * a *freed matching slice* (a drained instance with the same
          physical footprint): no carving, but the donor drain retires
          immediately — one physical slice cannot host the outgoing AND
          the warming instance at once.
        * neither (the pool is tight and the freed footprints don't
          match): the pool is *reclaimed* — every drain in it retires
          immediately so the region can be re-carved, and the loads pay
          the repartition delay.

        Pools whose scheme ``repartition_blocks`` (MIG) prefer matching
        reuse (a carve pauses the device); non-blocking (torus) pools
        prefer spare so the outgoing capacity serves through the
        reshape."""
        scale = self.delay_scale
        # freed physical slices + old per-pool usage, across all apps
        freed: Dict[str, Dict[PhysKey, int]] = {}
        for app, tup, cnt in raw_drains:
            pool, sl = self.cluster.find_slice(tup.segment)
            d = freed.setdefault(pool.name, {})
            pk = physical_key(sl)
            d[pk] = d.get(pk, 0) + cnt
        used: Dict[str, int] = {}
        for cfg in old.values():
            for k, m in cfg.counts.items():
                if m > 0:
                    j = cfg.tuples[k]
                    used[j.pool] = used.get(j.pool, 0) + j.cost * m
        # headroom excludes dead capacity — a warm-up cannot be staged
        # on failed hardware
        spare = {p: max(0, self.cluster.pool(p).capacity_units
                        - dead_units.get(p, 0) - used.get(p, 0))
                 for p in {self.cluster.find_slice(t.segment)[0].name
                           for _a, t, _c in raw_loads}}
        # donated[pool][phys]: drained instances whose slice was handed
        # straight to a replacement (they retire at 0)
        donated: Dict[str, Dict[PhysKey, int]] = {}

        loads: List[TransitionAction] = []
        repart_pools = set()
        reclaimed = set()
        for app, tup, cnt in raw_loads:
            pool, sl = self.cluster.find_slice(tup.segment)
            pk = physical_key(sl)
            base = scale * self.weight_load_s(app, tup)
            carve_delay = scale * pool.scheme.repartition_delay_s

            def take_reuse(want: int) -> int:
                avail = freed.get(pool.name, {}).get(pk, 0)
                n = min(avail, want)
                if n:
                    freed[pool.name][pk] -= n
                    d = donated.setdefault(pool.name, {})
                    d[pk] = d.get(pk, 0) + n
                return n

            def take_spare(want: int) -> int:
                n = min(want, spare.get(pool.name, 0) // max(tup.cost, 1))
                if n:
                    spare[pool.name] -= n * tup.cost
                return n

            remaining = cnt
            reused = carved = 0
            if pool.scheme.repartition_blocks:
                reused = take_reuse(remaining)
                carved = take_spare(remaining - reused)
            else:
                carved = take_spare(remaining)
                reused = take_reuse(remaining - carved)
            remaining -= reused + carved
            if remaining:
                # tight pool, mismatched footprints: reclaim the drained
                # region wholesale and re-carve it
                reclaimed.add(pool.name)
            if reused:
                loads.append(TransitionAction("load", app, tup, reused,
                                              ready_s=base))
            if carved + remaining:
                repart_pools.add(pool.name)
                loads.append(TransitionAction(
                    "load", app, tup, carved + remaining,
                    ready_s=base + carve_delay, carved=True))
        blocked = frozenset(p for p in repart_pools
                            if self.cluster.pool(p).scheme.repartition_blocks)

        # hand-over per (app, task): outgoing capacity covers the warm-up
        handover: Dict[Tuple[str, str], float] = {}
        for a in loads:
            key = (a.app, a.tup.task)
            handover[key] = max(handover.get(key, 0.0), a.ready_s)
        drains: List[TransitionAction] = []
        for app, tup, cnt in raw_drains:
            pool, sl = self.cluster.find_slice(tup.segment)
            pk = physical_key(sl)
            give = 0
            if pool.name not in blocked and pool.name not in reclaimed:
                give = min(cnt, donated.get(pool.name, {}).get(pk, 0))
                if give:
                    donated[pool.name][pk] -= give
                    drains.append(TransitionAction(
                        "drain", app, tup, give, retire_s=0.0))
            rest = cnt - give
            if not rest:
                continue
            if pool.name in blocked or pool.name in reclaimed:
                retire = 0.0     # the device pauses / region re-carved
            else:
                retire = handover.get((app, tup.task),
                                      scale * self.drain_grace_s)
            drains.append(TransitionAction("drain", app, tup, rest,
                                           retire_s=retire))
        makespan = max((a.ready_s for a in loads), default=0.0)
        return TransitionPlan(tuple(keeps), tuple(drains), tuple(loads),
                              dict(new), makespan, frozenset(repart_pools),
                              blocked)

    # ------------------------------------------------------------------
    def _plan_atomic(self, old: Dict[str, PlanConfig],
                     new: Dict[str, PlanConfig]) -> TransitionPlan:
        """The naive baseline: the WHOLE fleet swaps at once.  Every old
        instance retires at t=0, every new instance (changed or not)
        reloads its weights, pools whose deployment changed at all pay a
        repartition, and nothing serves until the slowest warm-up — the
        'apply the new PlanConfig as one delayed atomic step' model."""
        scale = self.delay_scale
        changed_pools = set()
        for app in set(old) | set(new):
            oc = {k: m for k, m in (old.get(app).counts if app in old
                                    else {}).items() if m > 0}
            nc = {k: m for k, m in (new.get(app).counts if app in new
                                    else {}).items() if m > 0}
            for k in set(oc) | set(nc):
                if oc.get(k, 0) != nc.get(k, 0):
                    tup = (new[app].tuples[k] if app in new
                           and k in new[app].tuples else
                           old[app].tuples[k])
                    changed_pools.add(
                        self.cluster.find_slice(tup.segment)[0].name)
        drains = [TransitionAction("drain", app, old[app].tuples[k], m,
                                   retire_s=0.0)
                  for app in sorted(old)
                  for k, m in sorted(old[app].counts.items()) if m > 0]
        pre: List[Tuple[str, TupleVar, int, float, bool]] = []
        for app in sorted(new):
            for k, m in sorted(new[app].counts.items()):
                if m <= 0:
                    continue
                tup = new[app].tuples[k]
                pool, _ = self.cluster.find_slice(tup.segment)
                carved = pool.name in changed_pools
                d = scale * self.weight_load_s(app, tup)
                if carved:
                    d += scale * pool.scheme.repartition_delay_s
                pre.append((app, tup, m, d, carved))
        makespan = max((d for *_, d, _c in pre), default=0.0)
        loads = tuple(TransitionAction("load", app, tup, m,
                                       ready_s=makespan, carved=carved)
                      for app, tup, m, _d, carved in pre)
        blocked = frozenset(
            p for p in changed_pools
            if self.cluster.pool(p).scheme.repartition_blocks)
        return TransitionPlan((), tuple(drains), loads, dict(new),
                              makespan, frozenset(changed_pools), blocked)
