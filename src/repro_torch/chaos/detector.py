"""Closed-loop failure detection (DESIGN.md §13).

The :class:`~repro_torch.runtime.cluster.ClusterRuntime` already records the
per-pool capacity it watched die — every killed server adds its
``cost / streams`` slice-unit share, every preemption notice its
reclaimed physical units (``ClusterRuntime.dead_units``).  The
:class:`FailureDetector` is the controller-side accumulator of those
observations: the controllers feed each bin's runtime through
:meth:`observe` and pass :meth:`dead_units` to the planner's Eq. 8
budgets, replacing the manually supplied ``dead_units=`` dict (which
stays available as a fail-loud override, see
``repro_torch.core.controller``).

A copy of the JAX package's ``chaos/detector.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class FailureDetector:
    """Accumulates per-pool dead capacity observed across runtime bins.

    Units are the planner's slice units (``Pool.capacity_units`` rows of
    Eq. 8).  Failures are modelled as permanent until :meth:`forget` —
    a repaired/re-provisioned pool is an operator action, not something
    the datapath can observe.
    """
    _units: Dict[str, int] = field(default_factory=dict)
    bins_observed: int = 0

    def observe(self, runtime) -> Dict[str, int]:
        """Fold one finished bin's runtime observations in and return the
        updated cumulative per-pool dead units."""
        for pool, units in runtime.dead_units().items():
            self._units[pool] = self._units.get(pool, 0) + units
        self.bins_observed += 1
        return self.dead_units()

    def dead_units(self) -> Dict[str, int]:
        """Cumulative per-pool dead capacity (planner-ready)."""
        return {p: u for p, u in self._units.items() if u > 0}

    def forget(self, pool: str = ""):
        """Operator repair: clear ``pool`` (or everything when "")."""
        if pool:
            self._units.pop(pool, None)
        else:
            self._units.clear()
