"""SLO error-budget engine (DESIGN.md §17).

The raw counters in :mod:`repro_torch.obs.hooks` say *what happened*; this
module says *how fast the SLO error budget is burning*.  Three pieces:

* :class:`SloLedger` — per-app rolling good/bad sample buckets on the
  **simulated** clock.  Fed exclusively through the existing
  ``Instrumentation`` hook methods (``on_complete`` / ``on_drop`` for
  the latency SLO, ``on_dispatch`` for the accuracy proxy), so it
  inherits SimMetrics' warm-up gating and fan weighting, and the fast
  and legacy event loops feed it identically (hook parity is already
  gated by the differential harness).
* :class:`AlertRule` — declarative multi-window multi-burn-rate rules
  in the Google-SRE style (a fast 14.4x burn over a short horizon plus
  a slow 6x burn over a long one), scaled to sim bins via
  :func:`sre_rules`.  *Burn rate* is the window error rate divided by
  the error budget (``1 - slo_target``): burn 1.0 spends exactly the
  budget over the period, burn 14.4 exhausts it ~14x too fast.
* :class:`SloPlane` — evaluates the rules against the ledgers, keeps
  alert state (first-fire times survive clearing: they are the bench's
  lead-time measurement), exports burn rates / budget / alert state as
  metric families on the shared registry, and renders ``/alerts`` JSON
  for the gateway.  :class:`SloMonitor` runs the evaluation on the
  runtime monitor cadence and composes with an inner monitor (e.g. the
  :class:`~repro_torch.chaos.emergency.EmergencyReplanner`), since a runtime
  has exactly one monitor slot.

A firing page-severity alert can optionally feed the controller's
re-plan trigger: ``Controller(slo_replan=True)`` consults
:meth:`SloPlane.paging` next to ``Frontend.should_replan`` so budget
exhaustion reacts before the bin boundary.

A copy of the JAX package's ``obs/slo.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Counter, Gauge, MetricsRegistry

if TYPE_CHECKING:   # pragma: no cover — typing only
    from repro_torch.obs.audit import AuditLog

__all__ = ["Alert", "AlertRule", "SloLedger", "SloMonitor", "SloPlane",
           "sre_rules"]

_PFX = "jigsaw"


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AlertRule:
    """One multi-window burn-rate rule.

    Fires for an app when the burn rate over BOTH windows is at least
    ``burn_factor`` — the long window proves the burn is sustained, the
    short window proves it is still happening (so a cleared incident
    stops paging as soon as the short window drains)."""
    name: str
    slo: str = "latency"            # "latency" | "accuracy"
    long_window_s: float = 6.0
    short_window_s: float = 0.5
    burn_factor: float = 6.0
    min_requests: int = 5           # don't page on a near-empty window
    page: bool = True               # page-severity (feeds slo_replan)

    def to_dict(self) -> Dict[str, object]:
        return {"name": self.name, "slo": self.slo,
                "long_window_s": self.long_window_s,
                "short_window_s": self.short_window_s,
                "burn_factor": self.burn_factor,
                "min_requests": self.min_requests, "page": self.page}


def sre_rules(base_window_s: float, *, slo: str = "latency"
              ) -> Tuple[AlertRule, ...]:
    """The SRE-workbook two-rule ladder scaled to sim time:
    ``base_window_s`` plays the role of the canonical 1h window
    (14.4x fast burn with a 1/12 confirmation window) and ``6x`` that
    of the 6h slow burn."""
    if base_window_s <= 0:
        raise ValueError("base_window_s must be positive")
    return (
        AlertRule(f"{slo}_fast_burn", slo=slo,
                  long_window_s=base_window_s,
                  short_window_s=base_window_s / 12.0, burn_factor=14.4),
        AlertRule(f"{slo}_slow_burn", slo=slo,
                  long_window_s=6.0 * base_window_s,
                  short_window_s=base_window_s / 2.0, burn_factor=6.0),
    )


@dataclass(frozen=True)
class Alert:
    """One firing alert instance (rule x app)."""
    rule: str
    app: str
    slo: str
    since_s: float
    burn_long: float
    burn_short: float
    page: bool

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "app": self.app, "slo": self.slo,
                "since_s": round(self.since_s, 6),
                "burn_long": round(self.burn_long, 4),
                "burn_short": round(self.burn_short, 4),
                "page": self.page}


# ---------------------------------------------------------------------------
class SloLedger:
    """Per-app rolling good/bad counts in fixed sim-time buckets.

    The hot path (one event per completion / drop / dispatch when a
    :class:`SloPlane` is attached) does NOT bucket: ``Instrumentation``
    appends one ``(app, now, good, bad)`` tuple to :attr:`pending` —
    the same deferred-log idiom the hook counters use to hold the
    >= 0.95x overhead pin.  Every read method drains the log first, so
    callers never observe the deferral."""

    def __init__(self, *, bucket_s: float = 0.25,
                 horizon_s: float = 600.0) -> None:
        if bucket_s <= 0 or horizon_s <= bucket_s:
            raise ValueError("need bucket_s > 0 and horizon_s > bucket_s")
        self.bucket_s = float(bucket_s)
        self.horizon_s = float(horizon_s)
        # app -> [[bucket_start_s, good, bad, bucket_end_s], ...]
        # oldest-first; the end time is precomputed so the fold test
        # below is one compare, not a multiply
        self._buckets: Dict[str, List[List[float]]] = {}
        # app -> the newest row of _buckets[app] (fold-path alias)
        self._tail: Dict[str, List[float]] = {}
        # hot-path event log: (app, now, good, bad).  The hook object
        # caches a reference, so drain must clear IN PLACE.
        self.pending: List[Tuple[str, float, float, float]] = []
        self._last_now = 0.0

    @property
    def last_now(self) -> float:
        """High-water sim time across every recorded event."""
        self._drain()
        return self._last_now

    def _drain(self) -> None:
        log = self.pending
        if log:
            # length snapshot: a scrape may drain from its own thread
            # while the event loop appends — entries past n
            # survive for the next drain instead of being clobbered
            n = len(log)
            rec = self.record
            for i in range(n):
                app, now, good, bad = log[i]
                rec(app, now, good, bad)
            del log[:n]

    def record(self, app: str, now: float, good: float,
               bad: float) -> None:
        """Bucket one event immediately (the drain path; external
        callers may also feed the ledger directly)."""
        if now > self._last_now:
            self._last_now = now
        last = self._tail.get(app)
        if last is not None and now < last[3]:
            # same (or late-arriving older) bucket: two adds and out
            last[1] += good
            last[2] += bad
            return
        t0 = (now // self.bucket_s) * self.bucket_s
        row = [t0, good, bad, t0 + self.bucket_s]
        self._tail[app] = row
        rows = self._buckets.get(app)
        if rows is None:
            self._buckets[app] = [row]
            return
        rows.append(row)
        cut = t0 - self.horizon_s
        if rows[0][0] < cut:
            self._buckets[app] = [r for r in rows if r[0] >= cut]

    def apps(self) -> List[str]:
        self._drain()
        return sorted(self._buckets)

    def window_counts(self, app: str, window_s: float,
                      now: float) -> Tuple[float, float]:
        """(good, bad) totals over ``[now - window_s, now]`` — a bucket
        counts if any part of it overlaps the window."""
        self._drain()
        rows = self._buckets.get(app)
        if not rows:
            return 0.0, 0.0
        cut = now - window_s
        good = bad = 0.0
        for t0, g, b, _end in reversed(rows):
            if t0 + self.bucket_s <= cut:
                break
            good += g
            bad += b
        return good, bad

    def error_rate(self, app: str, window_s: float, now: float) -> float:
        good, bad = self.window_counts(app, window_s, now)
        total = good + bad
        return bad / total if total else 0.0

    def totals(self, app: str) -> Tuple[float, float]:
        """All-time (good, bad) still inside the horizon."""
        self._drain()
        good = bad = 0.0
        for _, g, b, _end in self._buckets.get(app, []):
            good += g
            bad += b
        return good, bad


# ---------------------------------------------------------------------------
class SloPlane:
    """Error-budget ledgers + alert rules + exported metric families.

    Construct standalone and hand it to ``Instrumentation(slo=...)`` —
    the hook object calls :meth:`bind` with its registry so the SLO
    families land in the same exposition the scrape reads."""

    def __init__(self, *, latency_budget: float = 0.05,
                 accuracy_budget: float = 0.05,
                 rules: Optional[Sequence[AlertRule]] = None,
                 bucket_s: float = 0.25, horizon_s: float = 600.0,
                 audit: Optional["AuditLog"] = None) -> None:
        if not (0.0 < latency_budget <= 1.0):
            raise ValueError("latency_budget must be in (0, 1]")
        if not (0.0 < accuracy_budget <= 1.0):
            raise ValueError("accuracy_budget must be in (0, 1]")
        self.latency_budget = float(latency_budget)
        self.accuracy_budget = float(accuracy_budget)
        self.rules: Tuple[AlertRule, ...] = tuple(
            rules if rules is not None
            else sre_rules(1.0) + sre_rules(1.0, slo="accuracy"))
        self.latency = SloLedger(bucket_s=bucket_s, horizon_s=horizon_s)
        self.accuracy = SloLedger(bucket_s=bucket_s, horizon_s=horizon_s)
        self.audit = audit
        # (rule, app) -> first time the CURRENT firing episode started
        self._active: Dict[Tuple[str, str], float] = {}
        # (rule, app) -> first time it EVER fired (lead-time measurement)
        self.first_fired: Dict[Tuple[str, str], float] = {}
        self._registry: Optional[MetricsRegistry] = None
        self._burn_g: Optional[Gauge] = None
        self._budget_g: Optional[Gauge] = None
        self._attain_g: Optional[Gauge] = None
        self._firing_g: Optional[Gauge] = None
        self._fired_c: Optional[Counter] = None

    # -- registry wiring ------------------------------------------------
    def bind(self, registry: MetricsRegistry) -> None:
        """Register the SLO families + a scrape-time collector; the
        plane then evaluates both at scrape AND on the monitor cadence
        (:class:`SloMonitor`)."""
        if self._registry is registry:
            return
        if self._registry is not None:
            raise ValueError("SloPlane is already bound to a registry")
        self._registry = registry
        self._burn_g = registry.gauge(
            f"{_PFX}_slo_burn_rate",
            "Error-budget burn rate per alert rule window",
            ("app", "rule", "window"))
        self._budget_g = registry.gauge(
            f"{_PFX}_slo_budget_remaining",
            "1 - burn over the rule set's longest window (can go "
            "negative while overspending)", ("app", "slo"))
        self._attain_g = registry.gauge(
            f"{_PFX}_slo_window_attainment",
            "Attainment over the rule set's longest window",
            ("app", "slo"))
        self._firing_g = registry.gauge(
            f"{_PFX}_slo_alert_firing",
            "1 while the burn-rate alert fires", ("rule", "app"))
        self._fired_c = registry.counter(
            f"{_PFX}_slo_alerts_fired_total",
            "Alert firing episodes started", ("rule", "app"))
        registry.add_collector(self._collect)

    def _collect(self) -> None:
        """Scrape-time hook: evaluate at the ledgers' high-water time."""
        self.evaluate()

    # -- ledger feeds (hot path, called by Instrumentation) -------------
    def record_latency(self, app: str, now: float, missed: bool,
                       n: float = 1.0) -> None:
        if missed:
            self.latency.record(app, now, 0.0, n)
        else:
            self.latency.record(app, now, n, 0.0)

    def record_accuracy(self, app: str, now: float, degraded: bool,
                        n: float = 1.0) -> None:
        if degraded:
            self.accuracy.record(app, now, 0.0, n)
        else:
            self.accuracy.record(app, now, n, 0.0)

    # -- evaluation ------------------------------------------------------
    def _ledger(self, slo: str) -> SloLedger:
        return self.latency if slo == "latency" else self.accuracy

    def _budget(self, slo: str) -> float:
        return (self.latency_budget if slo == "latency"
                else self.accuracy_budget)

    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        """Evaluate every rule at ``now`` (default: the latest sim time
        any ledger has seen); update alert state + exported gauges and
        return the currently-firing alerts."""
        if now is None:
            now = max(self.latency.last_now, self.accuracy.last_now)
        firing: List[Alert] = []
        longest: Dict[str, float] = {}
        for rule in self.rules:
            longest[rule.slo] = max(longest.get(rule.slo, 0.0),
                                    rule.long_window_s)
        for rule in self.rules:
            led = self._ledger(rule.slo)
            budget = self._budget(rule.slo)
            for app in led.apps():
                gl, bl = led.window_counts(app, rule.long_window_s, now)
                gs, bs = led.window_counts(app, rule.short_window_s, now)
                tl, ts = gl + bl, gs + bs
                burn_l = (bl / tl / budget) if tl else 0.0
                burn_s = (bs / ts / budget) if ts else 0.0
                key = (rule.name, app)
                fires = (tl >= rule.min_requests
                         and burn_l >= rule.burn_factor
                         and burn_s >= rule.burn_factor)
                if fires:
                    since = self._active.get(key)
                    if since is None:
                        since = self._active[key] = now
                        self.first_fired.setdefault(key, now)
                        if self._fired_c is not None:
                            self._fired_c.inc(1.0, rule.name, app)
                        if self.audit is not None:
                            self.audit.record(
                                "alert", now, app=app, rule=rule.name,
                                slo=rule.slo,
                                burn_long=round(burn_l, 4),
                                burn_short=round(burn_s, 4))
                    firing.append(Alert(rule.name, app, rule.slo, since,
                                        burn_l, burn_s, rule.page))
                    if self._firing_g is not None:
                        self._firing_g.set(1.0, rule.name, app)
                elif key in self._active:
                    del self._active[key]
                    if self._firing_g is not None:
                        self._firing_g.set(0.0, rule.name, app)
                if self._burn_g is not None:
                    self._burn_g.set(burn_l, app, rule.name, "long")
                    self._burn_g.set(burn_s, app, rule.name, "short")
        if self._budget_g is not None and self._attain_g is not None:
            for slo, win in longest.items():
                led = self._ledger(slo)
                for app in led.apps():
                    err = led.error_rate(app, win, now)
                    self._attain_g.set(1.0 - err, app, slo)
                    self._budget_g.set(1.0 - err / self._budget(slo),
                                       app, slo)
        return firing

    def paging(self, app: Optional[str] = None) -> bool:
        """True while any page-severity alert fires (for ``app``, or
        any app when None) — the optional extra re-plan trigger."""
        pages = {r.name for r in self.rules if r.page}
        return any(rule in pages and (app is None or a == app)
                   for rule, a in self._active)

    def alerts_json(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The gateway ``/alerts`` payload: a fresh evaluation."""
        firing = self.evaluate(now)
        return {
            "now_s": round(max(self.latency.last_now,
                               self.accuracy.last_now)
                           if now is None else now, 6),
            "alerts": [a.to_dict() for a in firing],
            "rules": [r.to_dict() for r in self.rules],
            "budgets": {"latency": self.latency_budget,
                        "accuracy": self.accuracy_budget},
        }


# ---------------------------------------------------------------------------
class SloMonitor:
    """Runtime monitor adapter: evaluate the alert rules every
    ``interval_s`` of sim time, then delegate to an optional inner
    monitor (the runtime has exactly ONE monitor slot, and chaos runs
    already spend it on the :class:`EmergencyReplanner`)."""

    def __init__(self, plane: SloPlane, *, interval_s: float = 0.5,
                 inner: Optional[object] = None) -> None:
        self.plane = plane
        self.interval_s = float(interval_s)
        self.inner = inner

    def begin_run(self, runtime: object) -> None:
        begin = getattr(self.inner, "begin_run", None)
        if begin is not None:
            begin(runtime)

    def check(self, runtime: object, now: float,
              metrics: object) -> Optional[Any]:
        self.plane.evaluate(now)
        chk = getattr(self.inner, "check", None)
        if chk is not None:
            return chk(runtime, now, metrics)
        return None
