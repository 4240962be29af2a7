"""Graceful-degradation ladder (DESIGN.md §13).

When emergency re-planning can't help *yet* — the solve was infeasible
against the surviving budgets, or the rescue streams are still staging
weights — the system has more load than capacity and must shed.  The
ladder sheds in a principled order, cheapest-first in user-visible harm:

1. **Admission control** (level 1): cap each app's entry queue at what
   the surviving entry fleet can clear inside the SLO; arrivals beyond
   the cap are refused at the door (``drop_reasons["admission"]``)
   instead of timing out deep in the pipeline after consuming upstream
   stages' work.
2. **Accuracy downshift** (level 2): swap every live stream to the
   cheapest profiled variant of its (task, slice, batch) — same
   hardware, lower latency, lower accuracy.  Served-but-degraded beats
   dropped; requests these streams serve are counted under
   ``SimMetrics.degraded_served`` so the accuracy cost stays visible.
3. **Deadline-aware shed** (level 3): shed exactly the arrivals least
   likely to make their SLO — the predicted finish time (queue drain at
   the surviving entry fleet's rate + the fastest remaining path) is
   already past the deadline (``drop_reasons["shed"]``).  Callers that
   cannot supply the request (legacy ``gate()`` signature) fall back to
   the original proportional random coin.

The :class:`~repro_torch.chaos.emergency.EmergencyReplanner` monitor drives
the level: each interval with a violation spike it can't fix escalates
``escalate_step`` rungs; each clean interval relaxes ``relax_step``.
Dropping below level 2 restores the original (full-accuracy) tuples.
Hold-downs (``escalate_hold_s`` / ``relax_hold_s``) add hysteresis: a
relax is refused until the level has held for ``relax_hold_s`` seconds
since the LAST change in either direction, so the ladder stops
oscillating one rung per monitor interval around the shed threshold.

A copy of the JAX package's ``chaos/degrade.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Mapping, Optional, Union

from repro_torch.core.taskgraph import split_qualified

if TYPE_CHECKING:   # pragma: no cover — typing only
    from repro_torch.core.milp import TupleVar
    from repro_torch.core.profiler import Profiler


@dataclass
class DegradationLadder:
    """Load-shedding state machine: level 0 (off) → 3 (drop).

    ``profiler`` supplies the variant catalogue for the level-2
    downshift — a single :class:`Profiler` for single-app runtimes, or
    an ``{app: Profiler}`` mapping for multi-app ones.  Without it,
    level 2 is a no-op rung (the ladder escalates through it).
    """
    profiler: Union["Profiler", Mapping[str, "Profiler"], None] = None
    queue_cap_mult: float = 1.0    # admission cap = mult × slo_s × entry rps
    min_queue_cap: int = 4         # never refuse below this queue depth
    shed_fraction: float = 0.5     # level-3 coin when no request context
    max_level: int = 3
    level: int = 0
    # hysteresis: rungs moved per escalate/relax, and minimum seconds the
    # current level must hold before the next move in that direction
    # (defaults reproduce the legacy one-rung-per-interval behavior)
    escalate_step: int = 1
    relax_step: int = 1
    escalate_hold_s: float = 0.0
    relax_hold_s: float = 0.0
    # idx → original tuple of streams downshifted at level 2
    _orig: Dict[int, "TupleVar"] = field(default_factory=dict)
    _last_change_s: float = field(default=-math.inf, repr=False)
    _last_escalate_s: float = field(default=-math.inf, repr=False)

    # ------------------------------------------------------------------
    def reset(self):
        self.level = 0
        self._orig.clear()
        self._last_change_s = -math.inf
        self._last_escalate_s = -math.inf

    def _prof(self, app: str) -> Optional["Profiler"]:
        if self.profiler is None:
            return None
        if isinstance(self.profiler, Mapping):
            return self.profiler.get(app)
        return self.profiler if app == "" else None

    # ------------------------------------------------------------------
    def escalate(self, runtime, now: float):
        """``escalate_step`` rungs up (monitor saw a spike it couldn't
        re-plan away), refused inside the escalate hold-down."""
        if self.level >= self.max_level:
            return
        if now - self._last_escalate_s < self.escalate_hold_s:
            return
        was = self.level
        self.level = min(self.level + max(self.escalate_step, 1),
                         self.max_level)
        self._last_change_s = self._last_escalate_s = now
        if was < 2 <= self.level:
            self._downshift(runtime)

    def relax(self, runtime, now: float):
        """``relax_step`` rungs down (monitor saw a clean interval),
        refused until the level has held ``relax_hold_s`` seconds since
        the last change in EITHER direction — a fresh escalation resets
        the clock, which is what stops the one-rung oscillation."""
        if self.level <= 0:
            return
        if now - self._last_change_s < self.relax_hold_s:
            return
        self.level = max(self.level - max(self.relax_step, 1), 0)
        self._last_change_s = now
        if self.level < 2 and self._orig:
            self._restore(runtime)

    # ------------------------------------------------------------------
    def gate(self, runtime, qt: str, now: float,
             req=None) -> Optional[str]:
        """Admission decision for one arrival at entry queue ``qt``:
        ``None`` admits; a reason string sheds (the runtime files it
        under ``drop_reasons``).  Checked cheapest-harm-first.

        ``req`` (a :class:`~repro_torch.core.dispatch.QueuedRequest`) enables
        the deadline-aware level-3 shed: only arrivals whose predicted
        finish already misses their deadline are shed.  Without it the
        legacy proportional random coin applies."""
        if self.level <= 0:
            return None
        if len(runtime.queues[qt]) >= self._entry_cap(runtime, qt, now):
            return "admission"
        if self.level >= 3:
            if req is not None:
                if self._predicted_miss(runtime, qt, now, req):
                    return "shed"
            elif runtime.rng.random() < self.shed_fraction:
                return "shed"
        return None

    def _predicted_miss(self, runtime, qt: str, now: float, req) -> bool:
        """Level-3 shed criterion: estimated entry-queue drain time (at
        the surviving entry fleet's aggregate per-stream rate) plus the
        fastest remaining path already overruns the request's deadline.
        A dead entry fleet sheds everything — nothing can be served."""
        rps = sum(s.tup.throughput / max(s.tup.streams, 1)
                  for s in runtime.by_task.get(qt, ())
                  if s.retire_at > now)
        if rps <= 0.0:
            return True
        wait_s = len(runtime.queues[qt]) / rps
        fastest_s = runtime._fastest.get(qt, 0.0) / 1e3
        return now + wait_s + fastest_s > req.deadline + 1e-9

    def _entry_cap(self, runtime, qt: str, now: float) -> int:
        """Queue-depth cap: what the SURVIVING entry fleet can clear
        inside the SLO (recomputed per arrival — the fleet shrinks under
        chaos and grows as rescue streams come up)."""
        app, _ = split_qualified(qt)
        slo_s = runtime._apps[app].graph.slo_latency_ms / 1e3
        rps = sum(s.tup.throughput / max(s.tup.streams, 1)
                  for s in runtime.by_task.get(qt, ())
                  if s.retire_at > now)
        return max(self.min_queue_cap,
                   int(self.queue_cap_mult * slo_s * rps))

    # ------------------------------------------------------------------
    def _downshift(self, runtime):
        """Swap every live stream to the cheapest (lowest-latency)
        profiled variant of its (task, slice, batch) on the same pool.
        Streams keep their hardware and in-flight work; only the model
        behind them changes."""
        from repro_torch.core.milp import TupleVar

        swapped = False
        for s in runtime.servers:
            if s.degraded or s.retire_at != math.inf:
                continue
            prof = self._prof(s.app)
            if prof is None:
                continue
            graph = runtime._apps[s.app].graph
            t = s.tup
            best = None
            for (task, var, sl, b), e in prof.entries_for_task(t.task).items():
                if sl != t.segment or b != t.batch or e.pool != t.pool:
                    continue
                if best is None or e.latency_ms < best[1].latency_ms:
                    best = ((task, var, sl, b), e)
            if best is None or best[0][1] == t.variant:
                continue
            (task, var, sl, b), e = best
            if e.latency_ms >= t.latency_ms:
                continue        # incumbent already the cheapest
            self._orig[s.idx] = t
            s.tup = TupleVar(task, var, sl, b, e.latency_ms,
                             e.throughput_rps, e.chips,
                             graph.tasks[task].variant(var).accuracy,
                             e.pool, e.streams)
            s.degraded = True
            swapped = True
        if swapped:
            runtime.refresh_capacity()

    def _restore(self, runtime):
        """Undo the downshift: full-accuracy tuples back on every stream
        that still exists (killed streams just drop out of the map)."""
        restored = False
        for s in runtime.servers:
            orig = self._orig.pop(s.idx, None)
            if orig is not None:
                s.tup = orig
                s.degraded = False
                restored = True
        self._orig.clear()
        if restored:
            runtime.refresh_capacity()
