"""Mid-bin emergency re-planning (DESIGN.md §13).

The controller's normal loop reacts at bin boundaries (minutes apart) —
a rack failure two seconds into a bin would burn the whole bin at
degraded capacity before anyone re-planned.  The
:class:`EmergencyReplanner` is a *runtime monitor*: the
:class:`~repro_torch.runtime.cluster.ClusterRuntime` calls :meth:`check`
every ``interval_s`` of simulated time, and a violation spike inside
that short window triggers an immediate re-plan executed LIVE through
the PR-5 transition machinery (drains + staged warm-ups), without
waiting for the bin to end.

Three deliberate design points:

* **One trigger.**  The spike test is
  :meth:`repro_torch.core.frontend.Frontend.should_replan` fed with the
  interval's explicit request/violation window — the same single
  implementation the bin-level controller uses, not a second one.
* **Diff against reality.**  The emergency solve diffs against
  ``runtime.effective_config()`` (live, non-draining streams), not the
  planned config — after a kill the planned config counts capacity that
  no longer exists, and a drain action against a dead stream would
  fail.  Dead capacity observed so far (``runtime.dead_units()``, plus
  ``base_dead_units`` carried in from prior bins by the detector) is
  subtracted from the planner's Eq. 8 budgets.
* **Shed while staging.**  While the rescue plan's weights stage (or
  when no feasible plan exists) the monitor escalates the runtime's
  :class:`~repro_torch.chaos.degrade.DegradationLadder` one rung per spiking
  interval; clean intervals relax it back down.

A copy of the JAX package's ``chaos/emergency.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Optional

if TYPE_CHECKING:   # pragma: no cover — typing only
    from repro_torch.core.frontend import Frontend
    from repro_torch.core.milp import Planner
    from repro_torch.reconfig.transition import TransitionPlan, TransitionPlanner


@dataclass
class EmergencyReplanner:
    """Runtime monitor: detect violation spikes, re-plan mid-bin.

    ``planner``/``reconfig`` may be None — the monitor then only drives
    the degradation ladder (detection-only mode, the bench baseline).
    Single-app runtimes only: the emergency path re-plans one app's
    deployment (multi-app joint emergency solves stay at bin boundaries,
    see ROADMAP).
    """
    frontend: "Frontend"
    planner: Optional["Planner"] = None
    reconfig: Optional["TransitionPlanner"] = None
    planned_for_rps: float = 0.0
    interval_s: float = 0.5        # runtime polls check() this often
    violation_trigger: float = 0.2  # interval vrate that counts as a spike
    min_requests: int = 10         # ignore windows too small to judge
    cooldown_s: float = 1.0        # settle time after a transition lands
    max_replans: int = 4           # runaway-storm backstop per run
    # dead capacity carried in from prior bins (the detector's view)
    base_dead_units: Dict[str, int] = field(default_factory=dict)
    # observability (DESIGN.md §14): spike counter + ladder-level gauge
    hooks: Optional[object] = None
    # ---- per-run state ------------------------------------------------
    replans: int = 0
    spikes: int = 0
    _last_req: int = 0
    _last_viol: int = 0
    _staging_until: float = -math.inf
    # dead-capacity view of the LAST successful emergency solve (audit)
    _last_dead_seen: Dict[str, int] = field(default_factory=dict)

    def begin_run(self, runtime):
        """Runtime handshake at t=0: reset the interval snapshots."""
        if len(runtime._apps) != 1 or "" not in runtime._apps:
            raise RuntimeError("EmergencyReplanner monitors single-app "
                               "runtimes (joint emergency re-planning is "
                               "a ROADMAP item)")
        self._last_req = self._last_viol = 0
        self._staging_until = -math.inf
        self.replans = self.spikes = 0

    # ------------------------------------------------------------------
    def check(self, runtime, now: float, metrics) -> Optional["TransitionPlan"]:
        """One monitor tick: judge the last interval's window, return a
        :class:`TransitionPlan` for the runtime to apply (or None)."""
        req, viol = metrics.total_requests, metrics.violations
        dreq, dviol = req - self._last_req, viol - self._last_viol
        self._last_req, self._last_viol = req, viol
        ladder = runtime._ladder
        if dreq < self.min_requests:
            return None
        spike = self.frontend.should_replan(
            self.planned_for_rps, violation_trigger=self.violation_trigger,
            demand_rps=self.planned_for_rps,    # mid-bin: no drift check
            requests=dreq, violations=dviol)
        if not spike:
            if ladder is not None:
                ladder.relax(runtime, now)
                if self.hooks is not None:
                    self.hooks.on_ladder_level(ladder.level)
            return None
        self.spikes += 1
        if self.hooks is not None:
            self.hooks.on_spike(now)
        if now < self._staging_until + self.cooldown_s \
                or self.replans >= self.max_replans:
            if ladder is not None:
                ladder.escalate(runtime, now)   # rescue still staging: shed
                if self.hooks is not None:
                    self.hooks.on_ladder_level(ladder.level)
            return None
        plan = self._replan(runtime, now)
        if plan is not None:
            # flight recorder (DESIGN.md §17): record WHY this mid-bin
            # rescue happened — guarded getattr keeps bare stub hooks
            # (spike/ladder-only probes) working unchanged
            cb = getattr(self.hooks, "on_emergency_replan", None)
            if cb is not None:
                cb(now, dead=dict(self._last_dead_seen), plan=plan)
            return plan
        if ladder is not None:
            ladder.escalate(runtime, now)       # infeasible: shed
            if self.hooks is not None:
                self.hooks.on_ladder_level(ladder.level)
        return None

    def _replan(self, runtime, now: float) -> Optional["TransitionPlan"]:
        if self.planner is None or self.reconfig is None:
            return None
        dead = dict(self.base_dead_units)
        for pool, units in runtime.dead_units().items():
            dead[pool] = dead.get(pool, 0) + units
        incumbent = runtime.effective_config()
        self.planner.dead_units = dead
        cfg = self.planner.plan(self.planned_for_rps, incumbent=incumbent)
        if cfg is None or cfg.counts == incumbent.counts:
            return None
        tr = self.reconfig.plan(incumbent, cfg, dead_units=dead)
        if tr.is_empty:
            return None
        self._staging_until = now + tr.makespan_s
        self.replans += 1
        self._last_dead_seen = dead
        return tr
