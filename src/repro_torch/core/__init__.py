"""The port's copy of the JAX package's core: JigsawServe's planning chain.

Compound-inference serving with joint optimization of (A) per-task model
variants, (S) fine-grained accelerator slice allocation, and (T) task-graph-
informed latency/accuracy/resource budgeting — paper Eq. 1-14 plus the
runtime (batching, early-drop, controller loop, placement).
"""
import importlib

from repro_torch.core.taskgraph import Task, TaskGraph, Variant, qualify, \
    split_qualified
from repro_torch.core.milp import (AppSpec, FeatureSet, JointPlan,
                                   JointPlanner, Key, PlanConfig, Planner,
                                   TupleVar)
from repro_torch.core.profiler import Profiler
from repro_torch.core.registry import (Registration, RegistrationError,
                                       register)
from repro_torch.core.frontend import Frontend
from repro_torch.core.apps import APPS, get_app
from repro_torch.core.controller import Controller, MultiAppController
from repro_torch.core.simulator import SimMetrics, Simulator

# runtime re-exports resolve lazily (PEP 562): repro_torch.runtime and
# repro_torch.core import each other's leaves, so eager package-level
# imports here would break whichever package is imported first
_RUNTIME_EXPORTS = {
    "ClusterRuntime": "repro_torch.runtime.cluster",
    "ExecutionBackend": "repro_torch.runtime.backend",
    "SimBackend": "repro_torch.runtime.backend",
    "EngineBackend": "repro_torch.runtime.backend",
    "Scenario": "repro_torch.runtime.scenario",
}


def __getattr__(name):
    mod = _RUNTIME_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


__all__ = [
    "APPS", "AppSpec", "Task", "TaskGraph", "Variant", "FeatureSet",
    "JointPlan", "JointPlanner", "Key", "PlanConfig", "Planner",
    "Profiler", "Registration", "RegistrationError", "register",
    "Controller", "Frontend", "MultiAppController", "SimMetrics",
    "Simulator", "TupleVar", "get_app", "qualify", "split_qualified",
    "ClusterRuntime", "ExecutionBackend", "SimBackend", "EngineBackend",
    "Scenario",
]
