"""The port's cluster runtime: one control plane, many data planes.

``ClusterRuntime`` executes a declarative ``Scenario`` (arrival process +
failure / capacity schedules + SLO scale) against any ``ExecutionBackend``
— the profiled-latency ``SimBackend`` or the real-engine ``EngineBackend``
— producing ``SimMetrics`` field-exact to the JAX package's runtime on the
same scenario.  The port's backends still fit the JAX package's protocol,
so its runtime can drive them too.
"""
from repro_torch.runtime.backend import (EngineBackend, ExecutionBackend,
                                         SimBackend)
from repro_torch.runtime.metrics import Server, SimMetrics
from repro_torch.runtime.cluster import ClusterRuntime
from repro_torch.runtime.scenario import (AppArrivals, ArrivalProcess,
                                          CapacityEvent, DomainFailureEvent,
                                          FailureEvent, PoissonArrivals,
                                          PreemptionEvent, Scenario,
                                          TraceArrivals, TransitionEvent)

__all__ = [
    "AppArrivals", "ArrivalProcess", "CapacityEvent", "ClusterRuntime",
    "DomainFailureEvent", "EngineBackend", "ExecutionBackend",
    "FailureEvent", "PoissonArrivals", "PreemptionEvent", "Scenario",
    "Server", "SimBackend", "SimMetrics", "TraceArrivals",
    "TransitionEvent",
]
