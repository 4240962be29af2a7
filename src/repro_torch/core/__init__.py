"""The port's copy of the JAX package's jax-free core that the runtime
needs: task graphs, the evaluated apps, dispatch, demand traces, the
accuracy model, the front end and the plan types (``milp``).  The planner,
profiler, registry and controller come in later slices."""
from repro_torch.core.apps import APPS, get_app
from repro_torch.core.frontend import Frontend
from repro_torch.core.milp import Key, PlanConfig, TupleVar
from repro_torch.core.taskgraph import (Task, TaskGraph, Variant, qualify,
                                        split_qualified)

__all__ = ["APPS", "Frontend", "Key", "PlanConfig", "Task", "TaskGraph",
           "TupleVar", "Variant", "get_app", "qualify", "split_qualified"]
