"""First-class hardware model (DESIGN.md §10), the port's copy.

A copy of the JAX package's ``hwspec`` with the port's own H100 presets
(:data:`H100_SXM`, :data:`H100_MIG_PROFILES`, :func:`h100_cluster`).
``DEFAULT_POOL`` stays ``"v5e"``: it names a pool, not a device, and keeps
the port's plans and metrics equal to the JAX package's.

``repro_torch.hwspec`` makes the accelerator pluggable instead of a bag of
module-level TPU v5e constants:

* :class:`DeviceSpec` — one accelerator's roofs (peak FLOPS per dtype,
  HBM bytes/bandwidth, interconnect bandwidth) plus the serving-stack
  efficiency calibration.
* :class:`Slice` / :class:`PartitionScheme` — a pluggable partition
  catalogue.  :class:`TorusScheme` is the existing contiguous-rectangle
  catalogue on a chip torus; :class:`MigScheme` is a MIG-style named-slice
  catalogue (1g/2g/3g/4g/7g with per-slice memory and NVIDIA-style start
  alignment rules).  Both carry MPS-style stream multiplicity.
* :class:`Pool` / :class:`ClusterSpec` — named heterogeneous pools, each
  ``DeviceSpec × device count × PartitionScheme`` with a relative slice
  price; every layer (profiler tables, MILP capacity rows, packers,
  runtime capacity events) keys on this.

Worked example — a MIG pool next to a TPU pod, profiled and planned
end to end::

    from repro_torch.core import Planner, Profiler
    from repro_torch.core.apps import get_app
    from repro_torch.hwspec import (A100_40GB, ClusterSpec, MigScheme, Pool,
                              TorusScheme, TPU_V5E)

    cluster = ClusterSpec(pools=(
        # 16 v5e chips, legacy power-of-two rectangle slices (1 capacity
        # unit per chip -> 16 units)
        Pool("v5e", TPU_V5E, 16, TorusScheme(max_chips=8)),
        # 2 MIG-capable A100s: each carves into 1g/2g/3g/4g/7g slices
        # with per-slice memory + NVIDIA start-offset placement rules
        # (7 g-units per device -> 14 units), priced 20% cheaper
        Pool("mig", A100_40GB, 2, MigScheme(), slice_price=0.8),
    ))
    graph = get_app("social_media")
    prof = Profiler(graph, cluster=cluster)       # per-(pool, slice) L/H
    planner = Planner(graph, prof, s_avail=cluster.total_units)
    cfg = planner.plan(120.0)                     # Eq. 8 row PER POOL
    print(cfg.pool_slices())                      # {'v5e': 6} — mig is
    # cheaper but slower here; shrink the v5e pool (or raise demand) and
    # the plan spills into the MIG slices

Slice names are cluster-unique (``"2x2s4"`` can only live in one pool),
so a profiler key's slice name alone identifies its pool; plans record
``pool_budgets`` and placement uses one packer per pool
(``repro_torch.core.placement.make_placer``).

``repro_torch.core.hw`` remains a thin shim over :data:`TPU_V5E` so existing
imports keep working.
"""
from repro_torch.hwspec.cluster import (ClusterSpec, Pool, chaos_cluster,
                                        default_cluster, h100_cluster,
                                        hetero_cluster, tight_hetero_cluster,
                                        validate_domain_names,
                                        validate_pool_names)
from repro_torch.hwspec.device import (A100_40GB, DEFAULT_POOL, H100_SXM,
                                       TPU_V5E, DeviceSpec)
from repro_torch.hwspec.partition import (A100_MIG_PROFILES,
                                          H100_MIG_PROFILES, ExplicitScheme,
                                          MigProfile, MigScheme,
                                          PartitionScheme, Slice, TorusScheme,
                                          slice_from_segment)

__all__ = [
    "A100_40GB", "A100_MIG_PROFILES", "ClusterSpec", "DEFAULT_POOL",
    "DeviceSpec", "ExplicitScheme", "H100_MIG_PROFILES", "H100_SXM",
    "MigProfile", "MigScheme", "PartitionScheme", "Pool", "Slice",
    "TorusScheme", "TPU_V5E", "chaos_cluster", "default_cluster",
    "h100_cluster", "hetero_cluster", "slice_from_segment",
    "tight_hetero_cluster", "validate_domain_names", "validate_pool_names",
]
