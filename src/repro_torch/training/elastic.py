"""Elastic scaling: rebuild the mesh from the live rank set and reshard.

PyTorch counterpart of ``repro.training.elastic``.  On a changed rank set
(a failed host, an added pod) the job rebuilds the mesh with the same
axis names but a new data extent, and restores the latest checkpoint onto
it: ``training/checkpoint.restore(placements=...)`` does the placement.
The model axis extent is kept fixed; only the data axes stretch or shrink.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple


def viable_mesh_shape(n_devices: int, model_parallel: int,
                      prefer_pods: Optional[int] = None
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) grid that fits the live device count.

    Drops stragglers below the nearest multiple (standard elastic policy:
    a 511-device set runs as 31×16 + model=16... i.e. uses 496)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel="
            f"{model_parallel}")
    data = n_devices // model_parallel
    if prefer_pods and data % prefer_pods == 0 and prefer_pods > 1:
        return ((prefer_pods, data // prefer_pods, model_parallel),
                ("pod", "data", "model"))
    return ((data, model_parallel), ("data", "model"))


def make_elastic_mesh(model_parallel: int,
                      ranks: Optional[Sequence[int]] = None,
                      prefer_pods: Optional[int] = None,
                      device_type: str = "cuda"):
    """A ``DeviceMesh`` of :func:`viable_mesh_shape` over ``ranks`` (default:
    every rank of the default group), the first ``prod(shape)`` of them,
    row-major."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    shape, names = viable_mesh_shape(len(ranks), model_parallel, prefer_pods)
    used = math.prod(shape)
    grid = torch.tensor(ranks[:used], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def reshard_plan(old_mesh, new_mesh) -> dict:
    """Describes the data-extent change for logging/validation."""
    def shape(mesh):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))

    def dp(mesh):
        return math.prod(n for a, n in shape(mesh).items() if a != "model")

    return {
        "old_devices": old_mesh.size(),
        "new_devices": new_mesh.size(),
        "old_dp": dp(old_mesh),
        "new_dp": dp(new_mesh),
        "model_parallel_unchanged":
            shape(old_mesh).get("model") == shape(new_mesh).get("model"),
    }
