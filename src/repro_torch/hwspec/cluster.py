"""ClusterSpec: named heterogeneous pools of partitionable devices.

A :class:`Pool` is ``DeviceSpec × device count × PartitionScheme`` plus a
relative ``slice_price`` (what one capacity unit of this pool costs in the
MILP objective — a MIG g-unit and a v5e chip need not cost the same).
A :class:`ClusterSpec` is an ordered set of pools with globally unique
slice names, so a profiler key's slice name alone identifies its pool.

A copy of the JAX package's ``hwspec/cluster.py`` with one preset of the
port's own, :func:`h100_cluster`.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.hwspec.device import (A100_40GB, DEFAULT_POOL, H100_SXM,
                                      TPU_V5E, DeviceSpec)
from repro_torch.hwspec.partition import (H100_MIG_PROFILES, MigScheme,
                                          PartitionScheme, Slice, TorusScheme)


@dataclass(frozen=True)
class Pool:
    """One homogeneous pool: N identical devices under one scheme.

    Arguments:
        name: cluster-unique pool name — profiler entries, MILP capacity
            rows, placements and runtime capacity events all key on it.
        device: the :class:`DeviceSpec` every device in the pool shares.
        count: devices in the pool (chips for a torus pool, whole GPUs
            for a MIG pool).
        scheme: the :class:`PartitionScheme` carving each device into
            slices; it defines the pool's capacity unit
            (``units_per_device``).
        slice_price: relative objective cost of one capacity unit — lets
            the MILP prefer e.g. spot/MIG capacity (< 1.0) over reserved
            chips without touching the constraint rows.
        domains: named correlated-failure domains (racks, power groups)
            the pool's devices are spread over, round-robin by device
            index (device ``i`` sits in ``domains[i % len(domains)]``).
            Domain names are CLUSTER-scoped, not pool-scoped: two pools
            naming the same domain share the blast radius — one
            ``DomainFailureEvent`` takes capacity from both at once.
            Empty (default) = the pool has no modeled blast radius.
    """
    name: str
    device: DeviceSpec
    count: int                    # devices (chips for a torus pool)
    scheme: PartitionScheme
    slice_price: float = 1.0      # objective $/capacity-unit, relative
    domains: Tuple[str, ...] = ()

    @property
    def capacity_units(self) -> int:
        """Total MILP capacity units (Σ s_n budget) this pool offers."""
        return self.count * self.scheme.units_per_device

    def domain_units(self) -> Dict[str, int]:
        """Capacity units of THIS pool per failure domain (devices are
        spread round-robin over ``domains``; empty → no domains)."""
        out: Dict[str, int] = {}
        if not self.domains:
            return out
        for i in range(self.count):
            d = self.domains[i % len(self.domains)]
            out[d] = out.get(d, 0) + self.scheme.units_per_device
        return out


@dataclass(frozen=True)
class ClusterSpec:
    """An ordered set of named pools with cluster-unique slice names.

    The single hardware input every layer shares: the profiler builds
    L/H tables per (pool, slice), the planner emits one Eq. 8 capacity
    row per pool (budgets from :meth:`budgets`), placement packs each
    pool with its own packer, and the runtime scopes capacity events by
    pool name.  Slice-name uniqueness across pools is enforced here so
    a profiler key's slice name alone identifies its pool."""
    pools: Tuple[Pool, ...]

    def __post_init__(self) -> None:
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {names}")
        seen: Dict[str, str] = {}
        for p in self.pools:
            for s in p.scheme.slices():
                if s.name in seen:
                    raise ValueError(
                        f"slice name {s.name!r} appears in both pool "
                        f"{seen[s.name]!r} and pool {p.name!r} — slice "
                        "names must be cluster-unique")
                seen[s.name] = p.name

    # ------------------------------------------------------------------
    @cached_property
    def _slice_index(self) -> Dict[str, Tuple[Pool, Slice]]:
        return {s.name: (p, s) for p in self.pools
                for s in p.scheme.slices()}

    def pool(self, name: str) -> Pool:
        for p in self.pools:
            if p.name == name:
                return p
        raise KeyError(f"no pool {name!r} (have {[p.name for p in self.pools]})")

    def find_slice(self, slice_name: str) -> Tuple[Pool, Slice]:
        try:
            return self._slice_index[slice_name]
        except KeyError:
            raise KeyError(f"no slice {slice_name!r} in any pool") from None

    @property
    def total_units(self) -> int:
        return sum(p.capacity_units for p in self.pools)

    def budgets(self) -> Dict[str, int]:
        return {p.name: p.capacity_units for p in self.pools}

    def prices(self) -> Dict[str, float]:
        return {p.name: p.slice_price for p in self.pools}

    # -- correlated failure domains ------------------------------------
    @property
    def domain_names(self) -> Tuple[str, ...]:
        """All failure-domain names, in first-appearance pool order."""
        seen: Dict[str, None] = {}
        for p in self.pools:
            for d in p.domains:
                seen.setdefault(d, None)
        return tuple(seen)

    def domain_units(self) -> Dict[str, Dict[str, int]]:
        """Per-domain blast radius: domain name → {pool name → capacity
        units that domain hosts in that pool}.  A domain spanning
        several pools (shared rack/power group) appears with one entry
        per member pool — the correlated-kill surface a
        ``DomainFailureEvent`` expands into."""
        out: Dict[str, Dict[str, int]] = {}
        for p in self.pools:
            for d, u in p.domain_units().items():
                out.setdefault(d, {})[p.name] = u
        return out


# ---------------------------------------------------------------------------
def validate_domain_names(cluster: Optional[ClusterSpec],
                          names: Iterable[str], what: str) -> None:
    """Fail loud when ``names`` references a failure domain no pool
    declares — a typo'd domain in a chaos schedule would otherwise
    silently kill nothing."""
    known = set(cluster.domain_names) if cluster is not None else set()
    unknown = set(names) - known
    if unknown:
        raise ValueError(f"{what} names unknown failure domains "
                         f"{sorted(unknown)} (cluster has {sorted(known)})")


# ---------------------------------------------------------------------------
def validate_pool_names(cluster: Optional[ClusterSpec],
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


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------
def default_cluster(num_pods: int = 2) -> ClusterSpec:
    """The historical single-pool deployment: ``num_pods`` 16×16 v5e pods
    with the legacy rectangle catalogue (slice names, costs and profiles
    identical to the pre-hwspec ``sharding.segments.catalogue()``)."""
    scheme = TorusScheme()
    chips_per_pod = scheme.pod_shape[0] * scheme.pod_shape[1]
    return ClusterSpec(pools=(
        Pool(DEFAULT_POOL, TPU_V5E, num_pods * chips_per_pod, scheme),))


def hetero_cluster(v5e_pods: int = 1, mig_devices: int = 8, *,
                   mig_price: float = 1.0,
                   v5e_price: float = 1.0) -> ClusterSpec:
    """Two-pool heterogeneous cluster: a v5e torus pod pool plus a
    MIG-sliced A100 pool (the heterogeneous end-to-end scenario)."""
    torus = TorusScheme()
    chips_per_pod = torus.pod_shape[0] * torus.pod_shape[1]
    return ClusterSpec(pools=(
        Pool(DEFAULT_POOL, TPU_V5E, v5e_pods * chips_per_pod, torus,
             slice_price=v5e_price),
        Pool("mig", A100_40GB, mig_devices, MigScheme(),
             slice_price=mig_price),
    ))


def tight_hetero_cluster() -> ClusterSpec:
    """The capacity-pressure two-pool scenario: 8 v5e chips + 2 MIG
    devices (14 g) — small enough that a few hundred rps forces the
    planner to spill into both pools.  ONE definition shared by the
    acceptance tests (tests/test_hetero.py) and the CI-regressed
    benchmark (benchmarks/bench_hetero.py), so the pinned numbers and
    the tested scenario cannot drift apart."""
    return ClusterSpec(pools=(
        Pool(DEFAULT_POOL, TPU_V5E, 8, TorusScheme(max_chips=4)),
        Pool("mig", A100_40GB, 2, MigScheme()),
    ))


def chaos_cluster() -> ClusterSpec:
    """The chaos-engineering scenario cluster (DESIGN.md §13): the
    tight two-pool capacity shape of :func:`tight_hetero_cluster` with
    failure domains layered on top — 8 reserved v5e chips split over
    racks ``r0``/``r1``, plus 2 discounted spot MIG devices (one per
    rack, ``slice_price=0.4``) that a :class:`~repro_torch.runtime.scenario.
    PreemptionEvent` can reclaim.  A ``DomainFailureEvent("r0")`` takes
    half the v5e pool AND one spot device at once (a shared rack dying
    under both pools).  ONE definition shared by tests/test_chaos.py,
    benchmarks/bench_chaos.py and the fuzzer, so pinned chaos numbers
    and the tested topology cannot drift apart."""
    return ClusterSpec(pools=(
        Pool(DEFAULT_POOL, TPU_V5E, 8, TorusScheme(max_chips=4),
             domains=("r0", "r1")),
        Pool("spot", A100_40GB, 2, MigScheme(), slice_price=0.4,
             domains=("r0", "r1")),
    ))


def h100_cluster(devices: int = 1) -> ClusterSpec:
    """The port's own preset (not in the JAX package): one pool ``"h100"``
    of ``devices`` H100 SXM5 cards, each MIG-carved with the H100 80GB
    profiles (7 g-units a card)."""
    return ClusterSpec(pools=(
        Pool("h100", H100_SXM, devices,
             MigScheme(profiles=H100_MIG_PROFILES)),))
