"""PyTorch/CUDA port of the serving data plane, for one NVIDIA H100.

The package mirrors ``repro``'s layout (``configs``, ``kernels``,
``models``, ``serving``, ``runtime``) so each module has an obvious JAX
counterpart, which stays the reference the port is tested against.  It
imports ``torch`` and never ``jax`` or ``repro``.  Its hot path runs
through hand-written CUDA kernels for Hopper (``kernels/csrc``); on a CPU
tensor the kernels' plain PyTorch versions run instead.

Entry points (``models.Model``, ``runtime.EngineBackend``,
``launch/train.py``) take ``device``, which defaults to ``"cuda"`` and
raises when no card is present; pass ``device="cpu"`` to run on the host.
``serving.Engine`` runs on its model's device.  ``Model`` also takes a
``sharding.policy.ShardingPolicy``: over a ``DeviceMesh`` its parameters
are DTensors, and ``launch/train.py`` builds one (under ``torchrun``) for
more than one rank or ``--model-parallel`` > 1.
"""
