"""Execution backends of the port, for ``repro.runtime.ClusterRuntime``."""
from repro_torch.runtime.backend import EngineBackend, SimBackend

__all__ = ["EngineBackend", "SimBackend"]
