"""PartitionScheme: how one pool's devices are carved into slices.

A :class:`Slice` is the allocation unit the MILP prices (the paper's "GPU
slice") plus an MPS-style stream multiplicity.  Two concrete catalogues:

* :class:`TorusScheme` — the existing contiguous power-of-two rectangles
  on a chip torus (TPU pods; chips are the allocation quantum, rectangles
  the placement constraint).
* :class:`MigScheme` — MIG-style named slices (1g/2g/3g/4g/7g) with
  per-slice memory and NVIDIA-style placement rules: a device has
  ``mem_slots`` memory slots, each profile occupies a contiguous run of
  slots starting at an allowed offset (e.g. 4g.20gb only at slot 0), and
  the compute budget is ``units_per_device`` g-units.

Schemes are hardware *description*; the packers that realize placements
live in :mod:`repro_torch.core.placement` so this module stays dependency-leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.sharding.segments import MAX_STREAMS, SegmentType, catalogue


@dataclass(frozen=True)
class Slice:
    """One partition type: resources as fractions of the pool's device.

    ``cost`` is s_n in the MILP (capacity units against the pool budget);
    ``devices`` is how many devices the slice spans (chips for a torus
    rectangle, always 1 for a MIG slice); the fractions are per spanned
    device, so a slice's absolute compute is
    ``devices * compute_fraction * DeviceSpec.peak(quant)``.

    Arguments:
        name: cluster-unique slice name (the ``s`` in profiler keys).
        streams: MPS-style concurrent request streams the slice hosts —
            the runtime spawns this many execution streams per planned
            instance.
        cost: capacity units charged against the pool's Eq. 8 budget.
        devices: devices spanned (tensor-parallel width on a torus).
        compute_fraction / memory_fraction: share of one device's
            compute and HBM (capacity AND bandwidth) the slice owns.
        shape: torus placement rectangle (rectangle packer input).
        mem_slots / starts: MIG placement rule — memory slots occupied
            and the allowed start offsets on the device.
    """
    name: str
    streams: int                 # MPS-style concurrent request streams
    cost: int                    # capacity units consumed (s_n)
    devices: int = 1             # devices spanned
    compute_fraction: float = 1.0
    memory_fraction: float = 1.0   # HBM capacity AND bandwidth share
    shape: Optional[Tuple[int, int]] = None   # torus placement rectangle
    mem_slots: int = 0           # MIG memory slots occupied (placement)
    starts: Tuple[int, ...] = () # MIG allowed start offsets (placement)


def slice_from_segment(seg: SegmentType) -> Slice:
    """Adapt a legacy :class:`SegmentType` (torus rectangle) to a Slice."""
    return Slice(name=seg.name, streams=seg.streams, cost=seg.chips,
                 devices=seg.chips, shape=seg.shape)


# ---------------------------------------------------------------------------
@runtime_checkable
class PartitionScheme(Protocol):
    """The pluggable partition catalogue of one pool."""

    @property
    def units_per_device(self) -> int:
        """Capacity units one device contributes to the pool budget."""
        ...

    @property
    def unopt_cost(self) -> int:
        """Slice cost of the 'whole accelerator' unit (spatial=False)."""
        ...

    @property
    def repartition_delay_s(self) -> float:
        """Seconds to carve a NEW physical slice that no drained slice
        already matches (MIG: destroy/create GPU instances; torus: a
        logical regrouping of chips).  Charged once per carved slice by
        the reconfiguration engine (``repro_torch.reconfig``)."""
        ...

    @property
    def repartition_blocks(self) -> bool:
        """Whether carving blocks the pool's outgoing capacity: a MIG
        device being repartitioned cannot keep serving its old slices,
        while a torus regrouping is a host-side bookkeeping change the
        old rectangles serve straight through."""
        ...

    def slices(self) -> Tuple[Slice, ...]:
        ...

    def slice(self, name: str) -> Slice:
        ...


class _SchemeBase:
    """Shared memoized name lookup over :meth:`slices`."""

    @cached_property
    def _by_name(self) -> Dict[str, Slice]:
        return {s.name: s for s in self.slices()}

    def slice(self, name: str) -> Slice:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"{type(self).__name__}: unknown slice "
                           f"{name!r}") from None


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TorusScheme(_SchemeBase):
    """Contiguous rectangles on a ``pod_shape`` chip torus.

    The slice set IS the legacy ``sharding.segments.catalogue()`` (one
    source of truth — same names, costs and stream multiplicities), so
    the default cluster is drop-in compatible with the pre-hwspec
    profiler tables and MILP plans.
    """
    pod_shape: Tuple[int, int] = (16, 16)
    max_chips: int = 64
    max_streams: int = MAX_STREAMS
    unopt_chips: int = 8          # the 'one H100' analogue (DESIGN.md §2)
    # regrouping chips into a new rectangle is a host-side change
    repartition_delay_s: float = 0.25

    @property
    def units_per_device(self) -> int:
        return 1                  # the device IS the chip

    @property
    def unopt_cost(self) -> int:
        return self.unopt_chips

    @property
    def repartition_blocks(self) -> bool:
        return False              # old rectangles serve through a reshape

    def slices(self) -> Tuple[Slice, ...]:
        return self._slices

    @cached_property
    def _slices(self) -> Tuple[Slice, ...]:
        return tuple(slice_from_segment(s)
                     for s in catalogue(self.max_chips, self.max_streams))


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MigProfile:
    """One MIG instance profile with its placement rule."""
    name: str                    # e.g. "2g.10gb"
    g: int                       # compute slices (the MILP cost)
    mem_slots: int               # memory slots occupied
    starts: Tuple[int, ...]      # allowed start offsets on the device


# A100-40GB-style profile table: 7 compute slices, 8 memory slots, and the
# NVIDIA placement alignment (4g only at slot 0, 3g at {0,4}, 2g even...).
A100_MIG_PROFILES: Tuple[MigProfile, ...] = (
    MigProfile("1g.5gb", 1, 1, tuple(range(7))),
    MigProfile("2g.10gb", 2, 2, (0, 2, 4)),
    MigProfile("3g.20gb", 3, 4, (0, 4)),
    MigProfile("4g.20gb", 4, 4, (0,)),
    MigProfile("7g.40gb", 7, 8, (0,)),
)

# The port's own profile table (not in the JAX package): H100 80GB, from
# NVIDIA's MIG user guide -- 7 compute slices, 8 memory slots, the same
# start alignment as the A100's; the ``+me`` (media-engine) variants are
# left out.  Use it as ``MigScheme(profiles=H100_MIG_PROFILES)``.
H100_MIG_PROFILES: Tuple[MigProfile, ...] = (
    MigProfile("1g.10gb", 1, 1, tuple(range(7))),
    MigProfile("1g.20gb", 1, 2, (0, 2, 4, 6)),
    MigProfile("2g.20gb", 2, 2, (0, 2, 4)),
    MigProfile("3g.40gb", 3, 4, (0, 4)),
    MigProfile("4g.40gb", 4, 4, (0,)),
    MigProfile("7g.80gb", 7, 8, (0,)),
)


@dataclass(frozen=True)
class MigScheme(_SchemeBase):
    """MIG-style named slices with per-slice memory + placement rules."""
    profiles: Tuple[MigProfile, ...] = A100_MIG_PROFILES
    total_g: int = 7              # compute budget per device
    total_mem_slots: int = 8      # memory slots per device
    max_streams: int = MAX_STREAMS
    # destroying/creating MIG GPU instances takes the device through a
    # reconfiguration pause (ParvaGPU: repartitioning overhead is a
    # first-order cost of spatial GPU sharing)
    repartition_delay_s: float = 8.0

    @property
    def units_per_device(self) -> int:
        return self.total_g

    @property
    def unopt_cost(self) -> int:
        return max(p.g for p in self.profiles)

    @property
    def repartition_blocks(self) -> bool:
        return True               # the device pauses while re-carved

    def slices(self) -> Tuple[Slice, ...]:
        return self._slices

    @cached_property
    def _slices(self) -> Tuple[Slice, ...]:
        out: List[Slice] = []
        for p in self.profiles:
            for k in range(1, self.max_streams + 1):
                out.append(Slice(
                    name=f"{p.name}.s{k}", streams=k, cost=p.g, devices=1,
                    compute_fraction=p.g / self.total_g,
                    memory_fraction=p.mem_slots / self.total_mem_slots,
                    mem_slots=p.mem_slots, starts=p.starts))
        return tuple(out)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExplicitScheme(_SchemeBase):
    """An explicit slice list (legacy custom segment catalogues)."""
    explicit: Tuple[Slice, ...]
    pod_shape: Tuple[int, int] = (16, 16)
    unopt: int = 8
    repartition_delay_s: float = 0.0   # ad-hoc catalogues: free reshapes

    @property
    def units_per_device(self) -> int:
        return 1

    @property
    def unopt_cost(self) -> int:
        return self.unopt

    @property
    def repartition_blocks(self) -> bool:
        return False

    def slices(self) -> Tuple[Slice, ...]:
        return self.explicit
