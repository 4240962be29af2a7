"""Runtime instrumentation hooks (DESIGN.md §14).

:class:`Instrumentation` is the one object threaded through the serving
stack as ``hooks=``: the :class:`~repro_torch.runtime.cluster.ClusterRuntime`
event loop, the :class:`~repro_torch.core.controller.Controller` /
``MultiAppController`` bin loops, the chaos monitors, and the live
gateway all call the same ``on_*`` methods, which fan into a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (Prometheus exposition) and
an optional :class:`~repro_torch.obs.tracing.Tracer` (Chrome-trace spans).

Counter parity with :class:`~repro_torch.runtime.metrics.SimMetrics` is a
contract (tested): ``*_completions_total`` / ``*_missed_total`` /
``*_drops_total{reason}`` increment exactly when the runtime's main
ledger does (same warm-up gating, same fan weighting), so a mid-run
scrape sums to the final SimMetrics totals.

Every call site in the runtime is guarded by ``if hooks is not None`` —
an uninstrumented run pays one pointer test per event, which keeps the
overhead pin (hooked throughput >= 0.95x bare, BENCH_gateway.json)
honest in the other direction too.

A copy of the JAX package's ``obs/hooks.py``.
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.obs.audit import AuditLog
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import SloPlane
from repro_torch.obs.tracing import Tracer

__all__ = ["Instrumentation"]

_PFX = "jigsaw"

# seconds-scaled buckets for service / request latency (serving SLOs sit
# in the 50 ms – 5 s band)
_LAT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4)
_OCC_BUCKETS = (0.25, 0.5, 0.75, 1.0)


@dataclass
class Instrumentation:
    """Metrics + tracing sink for every serving-stack hook point."""

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: Optional[Tracer] = None
    # SLO error-budget plane + control-plane flight recorder (DESIGN.md
    # §17) — both optional: a bare Instrumentation() pays nothing for
    # them, an attached plane costs one ledger bucket add per event
    # (re-verified against the overhead pin in BENCH_slo.json)
    slo: Optional[SloPlane] = None
    audit: Optional[AuditLog] = None

    def __post_init__(self) -> None:
        r = self.registry
        if self.slo is not None:
            self.slo.bind(r)
            if self.slo.audit is None:
                self.slo.audit = self.audit
        self.arrivals = r.counter(
            f"{_PFX}_arrivals_total",
            "Root requests admitted to the entry queue", ("app",))
        self.completions = r.counter(
            f"{_PFX}_completions_total",
            "Leaf sub-requests completed (SimMetrics.completions parity)",
            ("app",))
        self.missed = r.counter(
            f"{_PFX}_missed_total",
            "Completed leaf sub-requests past deadline", ("app",))
        self.drops = r.counter(
            f"{_PFX}_drops_total",
            "Fan-weighted dropped requests by reason", ("app", "reason"))
        self.served = r.counter(
            f"{_PFX}_served_total",
            "Sub-requests dispatched into batches", ("app", "task"))
        self.queue_depth = r.gauge(
            f"{_PFX}_queue_depth",
            "Task queue depth after the last dispatch pass",
            ("app", "task"))
        self.batch_occupancy = r.histogram(
            f"{_PFX}_batch_occupancy",
            "Dispatched batch size / max batch", ("app", "task"),
            buckets=_OCC_BUCKETS)
        self.service_seconds = r.histogram(
            f"{_PFX}_service_seconds",
            "Per-batch service time", ("app", "task"),
            buckets=_LAT_BUCKETS)
        self.request_latency = r.histogram(
            f"{_PFX}_request_latency_seconds",
            "End-to-end root latency at leaf completion", ("app",),
            buckets=_LAT_BUCKETS)
        self.attainment = r.gauge(
            f"{_PFX}_slo_attainment",
            "1 - (missed+dropped)/(completions+dropped), running",
            ("app",))
        self.dead_units_g = r.gauge(
            f"{_PFX}_dead_units",
            "Physical capacity units lost per pool", ("pool",))
        self.transitions = r.counter(
            f"{_PFX}_transitions_total",
            "Reconfiguration transitions applied", ("kind",))
        self.transition_seconds = r.counter(
            f"{_PFX}_transition_seconds_total",
            "Summed transition-window makespan")
        self.replans = r.counter(
            f"{_PFX}_replans_total", "Controller MILP re-plans", ("warm",))
        self.replan_latency = r.histogram(
            f"{_PFX}_replan_latency_seconds",
            "Controller MILP solve wall time",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0))
        self.spikes = r.counter(
            f"{_PFX}_spikes_total",
            "Demand spikes flagged by the emergency monitor")
        self.ladder_level = r.gauge(
            f"{_PFX}_ladder_level", "Degradation ladder level")
        self.rejects = r.counter(
            f"{_PFX}_admission_rejects_total",
            "Gateway submissions rejected at admission", ("app",))
        self.gw_retries = r.counter(
            f"{_PFX}_gateway_retries_total",
            "Dropped hops resubmitted by the gateway", ("app",))
        self.gw_retry_ok = r.counter(
            f"{_PFX}_gateway_retry_success_total",
            "Resubmitted hops that went on to complete", ("app",))
        # change-detection state for audited control-plane gauges (the
        # monitor re-reports level/dead-units every tick; the flight
        # recorder only wants transitions)
        self._last_ladder: Optional[int] = None
        self._last_dead: Dict[str, int] = {}
        # -- hot-path running state ------------------------------------
        # The data-plane hooks below fire once per runtime event; to
        # hold the >= 0.95x overhead pin, completions and dispatches
        # only append one scalar tuple to an event log.  The registry
        # collector drains the logs into the aggregate dicts and
        # materializes the Prometheus families at scrape time (cold
        # path) — so log memory is bounded by the scrape interval, and a
        # never-scraped run holds one small tuple per event.
        self._arr: Dict[str, int] = {}            # app -> arrivals
        self._dropped: Dict[tuple, float] = {}    # (app, reason) -> n
        # SLO ledger feeds are deferred the same way: the hot hooks
        # append (app, now, good, bad) onto the ledgers' own pending
        # logs (cached list refs — SloLedger drains in place on read)
        slo = self.slo
        self._lat_pending = slo.latency.pending if slo is not None \
            else None
        self._acc_pending = slo.accuracy.pending if slo is not None \
            else None
        self._comp_log: List[tuple] = []   # (app, latency_ms, missed)
        self._disp_log: List[tuple] = []   # (app, task, cap, n, svc, qlen)
        # app -> [completions, missed, lat bucket rows, lat sum]
        self._comp: Dict[str, list] = {}
        # (app, task) -> [served, occ rows, svc rows, occ sum, svc sum,
        #                 queue depth]
        self._disp: Dict[tuple, list] = {}
        r.add_collector(self._collect)

    # -- data plane (hot: one dict lookup per event) --------------------
    def on_arrival(self, app: str, task: str, now: float,
                   queue_len: int) -> None:
        d = self._arr
        d[app] = d.get(app, 0) + 1

    def on_drop(self, app: str, task: str, reason: str, n: int,
                now: float, root_id: int = -1) -> None:
        d = self._dropped
        k = (app, reason)
        d[k] = d.get(k, 0.0) + n
        lat = self._lat_pending
        if lat is not None:
            lat.append((app, now, 0.0, float(n)))
        if self.audit is not None:
            rid = root_id if root_id >= 0 else None
            if reason in ("admission", "shed"):
                # the ladder's deliberate load shedding is a decision,
                # not an SLO miss
                self.audit.record("shed", now, app=app, root_id=rid,
                                  task=task, reason=reason, n=n)
            else:
                # deadline/stale/failed_capacity drops ARE latency-SLO
                # violations (SimMetrics.violations = missed + dropped);
                # the root_id anchors AuditLog.explain() for the request
                self.audit.record("violation", now, app=app, root_id=rid,
                                  task=task, reason=reason, n=n)

    def on_complete(self, app: str, root_id: int, latency_ms: float,
                    missed: bool, now: float) -> None:
        self._comp_log.append((app, latency_ms, missed))
        lat = self._lat_pending
        if lat is not None:
            if missed:
                lat.append((app, now, 0.0, 1.0))
            else:
                lat.append((app, now, 1.0, 0.0))
        if missed and self.audit is not None:
            self.audit.record("violation", now, app=app, root_id=root_id,
                              latency_ms=round(latency_ms, 3))

    def on_dispatch(self, server: Any, batch: Sequence[Any], now: float,
                    service_s: float, queue_len: int) -> None:
        """Called at batch launch — service time is already known (the
        backend computed it), so queue/service/hop spans are recorded in
        one shot.  The scalars are captured NOW (the ladder mutates
        ``server.tup`` on downshifts, so deferring the attribute reads
        to scrape time would misattribute batches)."""
        tup = server.tup
        n = len(batch)
        self._disp_log.append((server.app, tup.task, tup.batch,
                               n, service_s, queue_len))
        acc = self._acc_pending
        if acc is not None:
            # accuracy-SLO proxy: sub-requests dispatched onto a ladder-
            # downshifted stream run a cheaper variant than planned.
            # Accounted at DISPATCH (flag read at launch) — SimMetrics'
            # degraded_served reads the flag at batch completion, so the
            # two can differ by in-flight ladder moves; the exact
            # invariant is ledger total == served sub-requests
            if server.degraded:
                acc.append((server.app, now, 0.0, float(n)))
            else:
                acc.append((server.app, now, float(n), 0.0))
        tr = self.tracer
        if tr is None:
            return
        app, task = server.app, tup.task
        end = now + service_s
        args = {"variant": tup.variant, "server": server.idx,
                "batch": len(batch)}
        for req in batch:
            if not tr.enabled_for(req.root_id):
                continue
            tr.record(f"{task}:queue", "queue", req.enqueue_t, now,
                      app, req.root_id)
            tr.record(f"{task}:service", "service", now, end,
                      app, req.root_id)
            tr.record(task, "hop", req.enqueue_t, end, app,
                      req.root_id, args)

    # -- scrape-time materialization ------------------------------------
    def _collect(self) -> None:
        """Registry collector: drain the hot-path event logs into the
        aggregate dicts, then fold those into the Prometheus families.
        Runs at every ``render()`` — the exposition is exact at scrape
        time while the event loop pays one list append per event."""
        clog, self._comp_log = self._comp_log, []
        comp = self._comp
        for app, lat_ms, missed in clog:
            st = comp.get(app)
            if st is None:
                st = comp[app] = [
                    0, 0, [0] * (len(_LAT_BUCKETS) + 1), 0.0]
            st[0] += 1
            if missed:
                st[1] += 1
            lat_s = lat_ms * 1e-3
            st[2][bisect_left(_LAT_BUCKETS, lat_s)] += 1
            st[3] += lat_s
        dlog, self._disp_log = self._disp_log, []
        disp = self._disp
        for app, task, cap, n, service_s, qlen in dlog:
            st = disp.get((app, task))
            if st is None:
                st = disp[(app, task)] = [
                    0, [0] * (len(_OCC_BUCKETS) + 1),
                    [0] * (len(_LAT_BUCKETS) + 1), 0.0, 0.0, 0]
            st[0] += n
            occ = n / cap if cap > 0 else 1.0
            st[1][bisect_left(_OCC_BUCKETS, occ)] += 1
            st[2][bisect_left(_LAT_BUCKETS, service_s)] += 1
            st[3] += occ
            st[4] += service_s
            st[5] = qlen
        arr = self.arrivals._samples
        for app, n in self._arr.items():
            arr[(app,)] = float(n)
        comp_s = self.completions._samples
        miss_s = self.missed._samples
        lat = self.request_latency
        for app, (c, miss, row, lsum) in self._comp.items():
            k = (app,)
            comp_s[k] = float(c)
            if miss:
                miss_s[k] = float(miss)
            lat._hist[k] = row
            lat._sum[k] = lsum
            lat._samples[k] = float(c)
        drops_s = self.drops._samples
        drop_by_app: Dict[str, float] = {}
        for (app, reason), n in self._dropped.items():
            drops_s[(app, reason)] = float(n)
            drop_by_app[app] = drop_by_app.get(app, 0.0) + n
        served_s = self.served._samples
        qd = self.queue_depth._samples
        occ_h, svc_h = self.batch_occupancy, self.service_seconds
        for k, (srv, occ_row, svc_row, osum, ssum, qlen) \
                in self._disp.items():
            served_s[k] = float(srv)
            qd[k] = float(qlen)
            batches = float(sum(occ_row))
            occ_h._hist[k] = occ_row
            occ_h._sum[k] = osum
            occ_h._samples[k] = batches
            svc_h._hist[k] = svc_row
            svc_h._sum[k] = ssum
            svc_h._samples[k] = batches
        # attainment == 1 - SimMetrics.violation_rate per app:
        # violations = missed + dropped, total = completions + dropped
        for app in set(self._comp) | set(drop_by_app):
            st = self._comp.get(app)
            c, miss = (st[0], st[1]) if st is not None else (0, 0)
            d = drop_by_app.get(app, 0.0)
            if c + d:
                self.attainment.set(1.0 - (miss + d) / (c + d), app)

    # -- control plane -------------------------------------------------
    def on_transition(self, now: float, makespan_s: float,
                      emergency: bool, plan: Any = None) -> None:
        self.transitions.inc(1.0, "emergency" if emergency else "scheduled")
        self.transition_seconds.inc(max(makespan_s, 0.0))
        if self.audit is not None:
            detail: Dict[str, Any] = {
                "makespan_s": round(makespan_s, 6), "emergency": emergency}
            if plan is not None:
                detail.update(plan.audit_detail())
            self.audit.record("transition", now, **detail)

    def on_dead_units(self, units: Mapping[str, int]) -> None:
        for pool, n in units.items():
            self.dead_units_g.set(n, pool)
        if self.audit is not None:
            d = dict(units)
            if d != self._last_dead:
                self._last_dead = d
                self.audit.record("dead_units", self._last_seen_now(),
                                  units=d)

    def on_ladder_level(self, level: int) -> None:
        self.ladder_level.set(level)
        if self.audit is not None and level != self._last_ladder:
            prev = self._last_ladder
            self._last_ladder = level
            self.audit.record("ladder", self._last_seen_now(),
                              level=level, previous=prev)

    def on_replan(self, milp_s: float, warm: bool, *, now: float = 0.0,
                  app: str = "", trigger: str = "",
                  demand_rps: Optional[float] = None) -> None:
        self.replans.inc(1.0, "true" if warm else "false")
        self.replan_latency.observe(milp_s)
        if self.audit is not None:
            self.audit.record(
                "replan", now, app=app, solve_ms=round(milp_s * 1e3, 3),
                warm=warm, trigger=trigger,
                **({} if demand_rps is None
                   else {"demand_rps": round(demand_rps, 3)}))

    def on_spike(self, now: float) -> None:
        self.spikes.inc()
        if self.audit is not None:
            self.audit.record("spike", now)

    def on_emergency_replan(self, now: float, *, app: str = "",
                            dead: Optional[Mapping[str, int]] = None,
                            plan: Any = None) -> None:
        """An EmergencyReplanner solved mid-bin and handed the runtime a
        rescue transition — record the why (observed dead capacity) and
        the what (the plan diff)."""
        if self.audit is not None:
            detail: Dict[str, Any] = {"dead_units": dict(dead or {})}
            if plan is not None:
                detail.update(plan.audit_detail())
            self.audit.record("emergency_replan", now, app=app, **detail)

    def _last_seen_now(self) -> float:
        """Best-effort timestamp for hooks that carry no ``now`` in
        their (frozen, parity-tested) signatures: the SLO ledger's
        high-water sim time when a plane is attached, else 0."""
        if self.slo is not None:
            return max(self.slo.latency.last_now,
                       self.slo.accuracy.last_now)
        return 0.0

    # -- gateway ---------------------------------------------------------
    def on_admission_reject(self, app: str, reason: str,
                            now: float) -> None:
        self.rejects.inc(1.0, app)
        d = self._dropped
        k = (app, reason)
        d[k] = d.get(k, 0.0) + 1.0
        if self.slo is not None:
            self.slo.latency.record(app, now, 0.0, 1.0)
        if self.audit is not None:
            self.audit.record("admission", now, app=app, reason=reason)

    def on_retry(self, app: str, now: float,
                 root_id: Optional[int] = None) -> None:
        self.gw_retries.inc(1.0, app)
        if self.audit is not None:
            self.audit.record("retry", now, app=app, root_id=root_id)

    def on_retry_success(self, app: str, now: float,
                         root_id: Optional[int] = None) -> None:
        self.gw_retry_ok.inc(1.0, app)
