"""Mesh construction over ``torch.distributed.device_mesh.DeviceMesh``.

PyTorch counterpart of ``repro.launch.mesh``.  Meshes come from functions
(no module-level mesh), so importing this module touches no process
group.  A ``DeviceMesh`` spans the ranks of the default process group,
which the caller initializes (``torch.distributed.init_process_group``);
each function takes ``device_type``, ``"cuda"`` by default: a CPU mesh is
asked for, never fallen back to.  The production shapes come from the
port's ``hwspec.default_cluster`` (the reference's TPU pods), so they name
a layout, not this card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.hwspec import default_cluster


def production_geometry() -> Tuple[int, Tuple[int, int]]:
    """(num_pods, pod_shape) of the default cluster's torus pool: the
    single source the production mesh shapes derive from."""
    pool = default_cluster().pools[0]
    pod_shape = pool.scheme.pod_shape
    return pool.count // (pod_shape[0] * pod_shape[1]), pod_shape


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: one pod as ('data','model'), or all pods as
    ('pod','data','model'), over as many ranks as it has devices."""
    num_pods, pod_shape = production_geometry()
    shape = (num_pods,) + pod_shape if multi_pod else pod_shape
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(tuple(shape), axes, device_type)


def make_segment_mesh(chips: int, *, max_model: int = 16,
                      device_type: str = "cuda"):
    """Mesh for one segment of ``chips`` devices arranged (data, model):
    the model axis gets as many as possible (<= max_model), the rest form
    the data axis."""
    if chips & (chips - 1):
        raise ValueError(f"segment chips must be a power of two, got {chips}")
    model = 1
    while model * 2 <= min(chips, max_model):
        model *= 2
    return _mesh((chips // model, model), ("data", "model"), device_type)


def make_host_mesh(axes: Sequence[Tuple[str, int]],
                   device_type: str = "cuda"):
    """An arbitrary mesh, ``axes`` as (name, extent) pairs."""
    return _mesh(tuple(s for _, s in axes), tuple(n for n, _ in axes),
                 device_type)


def device_count() -> int:
    """The default group's world size when one is initialized, otherwise
    the number of visible cards."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()
