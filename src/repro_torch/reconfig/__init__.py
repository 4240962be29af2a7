"""Live reconfiguration engine (DESIGN.md §12).

The controller's plan changes used to be applied as instantaneous atomic
swaps; this package makes a reconfiguration a first-class, time-consuming
process.  :class:`TransitionPlanner` diffs the incumbent deployment
against the target :class:`~repro_torch.core.milp.PlanConfig` (or multi-app
:class:`~repro_torch.core.milp.JointPlan`) into a staged
:class:`TransitionPlan` of keep / drain / load actions whose delays come
from the hardware model: weight loads are charged against the
:class:`~repro_torch.hwspec.DeviceSpec` staging bandwidth (derived from the
HBM roof), and carving a new physical slice pays the pool scheme's
``repartition_delay_s`` (MIG repartitions are slow AND block the device;
torus reshapes are cheap host-side regroupings).

The :class:`~repro_torch.runtime.cluster.ClusterRuntime` executes a
``TransitionPlan`` live: outgoing instances keep serving until their
replacements are warm (or retire immediately in a blocked MIG pool),
incoming instances only join dispatch after their warm-up completes, and
``SimMetrics.window`` reports SLO attainment inside the transition
window so the switching cost is visible.  ``Planner.stickiness`` closes
the loop by penalizing plans that are expensive to reach from the
incumbent.

A copy of the JAX package's ``reconfig/__init__.py``.
"""
from repro_torch.reconfig.transition import (TransitionAction, TransitionPlan,
                                       TransitionPlanner)

__all__ = ["TransitionAction", "TransitionPlan", "TransitionPlanner"]
