"""Serving datapath of the port: ``Engine`` and the ``Batcher`` in front."""
from repro_torch.serving.batcher import Batcher, ServeRequest
from repro_torch.serving.engine import Engine, EngineConfig

__all__ = ["Batcher", "Engine", "EngineConfig", "ServeRequest"]
