"""The hardware model's names that the runtime reads (DESIGN.md §10).

A copy of ``DEFAULT_POOL`` (``hwspec/device.py``) and of the pool- and
domain-name checks (``hwspec/cluster.py``) of the JAX package.  The rest of
the hardware model (device specs, partition catalogues, ``ClusterSpec``)
comes to the port in a later slice; until then a cluster is a duck-typed
argument with ``pools`` (each with a ``name``) and ``domain_names``.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

# The key of the single default pool.  It names a pool, not a device, and
# stays equal to the JAX package's so plans and metrics compare equal.
DEFAULT_POOL = "v5e"

__all__ = ["DEFAULT_POOL", "validate_domain_names", "validate_pool_names"]


def validate_domain_names(cluster: Optional[Any],
                          names: Iterable[str], what: str) -> None:
    """Fail loud when ``names`` references a failure domain no pool
    declares — a typo'd domain in a chaos schedule would otherwise
    silently kill nothing."""
    known = set(cluster.domain_names) if cluster is not None else set()
    unknown = set(names) - known
    if unknown:
        raise ValueError(f"{what} names unknown failure domains "
                         f"{sorted(unknown)} (cluster has {sorted(known)})")


def validate_pool_names(cluster: Optional[Any],
                        names: Iterable[str], what: str) -> None:
    """Fail loud when ``names`` references a pool the cluster doesn't
    have — a typo'd pool name in a per-pool mapping (dead capacity,
    dead hosts, ...) would otherwise silently model the input as zero.
    ``cluster=None`` means the legacy single default pool."""
    known = ({p.name for p in cluster.pools} if cluster is not None
             else {DEFAULT_POOL})
    unknown = set(names) - known
    if unknown:
        raise ValueError(f"{what} names unknown pools {sorted(unknown)} "
                         f"(cluster has {sorted(known)})")
