"""Chaos engine (DESIGN.md §13): correlated failure injection, closed-
loop failure detection with mid-bin emergency re-planning, and a
graceful-degradation ladder.

The package closes the loop the paper's availability story needs but
the controller previously hand-waved: failures were hand-placed point
events and the planner learned about dead capacity through a manually
supplied ``dead_units`` dict.  Here the loop is observed end to end:

* ``runtime/scenario.py``'s :class:`DomainFailureEvent` /
  :class:`PreemptionEvent` expand inside the
  :class:`~repro_torch.runtime.cluster.ClusterRuntime` into correlated server
  kills (every member pool of a rack/power domain at once) and spot
  reclaim notices executed as drain hand-overs.
* :class:`FailureDetector` accumulates the runtime's observed per-pool
  dead capacity across controller bins — the controllers consume the
  derived value instead of the manual dict.
* :class:`EmergencyReplanner` is a runtime monitor: every
  ``interval_s`` it feeds the interval's violation window through
  ``Frontend.should_replan`` (THE single trigger) and, on a spike,
  solves an emergency re-plan against the EFFECTIVE live deployment and
  executes it mid-bin through the PR-5 transition machinery.
* :class:`DegradationLadder` sheds load in a principled order when the
  emergency solve is infeasible or still staging: admission control →
  per-task accuracy downshift → proportional drop, every decision
  counted in :class:`~repro_torch.runtime.metrics.SimMetrics`.
* :mod:`repro_torch.chaos.fuzz` searches the arrival×failure space with a
  seeded fuzzer and regression-pins SLO-breaking cases.

A copy of the JAX package's ``chaos/__init__.py``.
"""
from repro_torch.chaos.degrade import DegradationLadder
from repro_torch.chaos.detector import FailureDetector
from repro_torch.chaos.emergency import EmergencyReplanner

__all__ = ["DegradationLadder", "EmergencyReplanner", "FailureDetector"]
