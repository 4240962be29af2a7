"""Packing slices onto devices (paper §3.1) behind a Placer protocol.

The paper packs MIG instances onto GPUs with a greedy rule-based
bin-packer (Turkkan et al.).  The hardware model makes the packer
pluggable per :class:`~repro_torch.hwspec.cluster.Pool`:

* :class:`RectanglePlacer` — the 2-D packer for torus pools: contiguous
  rectangles on a 16×16 pod grid, sort-by-area-descending first-fit over
  anchors aligned to the segment's own shape (fragmentation-free for the
  power-of-two catalogue).  ``Placer`` remains an alias for it.
* :class:`MigSlicePacker` — the MIG packer: each device has
  ``total_mem_slots`` memory slots and a ``total_g`` compute budget;
  a slice occupies a contiguous slot run starting at one of its profile's
  allowed offsets (the NVIDIA placement rules), and per-device g-budgets
  are conserved.

``make_placer(pool, ...)`` picks the right packer for a pool's scheme.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np

from repro_torch.hwspec import DEFAULT_POOL, MigScheme, Pool, Slice
from repro_torch.sharding.segments import by_name

POD_SHAPE = (16, 16)


@dataclass(frozen=True)
class Placement:
    """One packed instance.  For a torus pool, (row, col, rows, cols) is
    the rectangle on pod ``pod``; for a MIG pool, ``pod`` is the device,
    ``row`` the start memory slot and ``rows`` the slots occupied."""
    instance_id: int
    segment: str              # slice / segment type name
    pod: int
    row: int
    col: int
    rows: int
    cols: int
    pool: str = DEFAULT_POOL


@runtime_checkable
class PlacerProtocol(Protocol):
    """A pool-specific packer: slice-type names → placements (or None
    when the pool's capacity/placement rules refuse the mix)."""

    def pack(self, segments: List[str]) -> Optional[List[Placement]]:
        ...


@dataclass
class PodState:
    grid: np.ndarray          # bool occupancy [16,16]

    @classmethod
    def empty(cls, shape: Tuple[int, int] = POD_SHAPE) -> "PodState":
        return cls(np.zeros(shape, dtype=bool))

    def fits(self, r: int, c: int, h: int, w: int) -> bool:
        if r + h > self.grid.shape[0] or c + w > self.grid.shape[1]:
            return False
        return not self.grid[r:r + h, c:c + w].any()

    def place(self, r: int, c: int, h: int, w: int):
        self.grid[r:r + h, c:c + w] = True

    def free(self, r: int, c: int, h: int, w: int):
        self.grid[r:r + h, c:c + w] = False

    @property
    def used(self) -> int:
        return int(self.grid.sum())


class RectanglePlacer:
    """Packs torus-rectangle instances onto the minimum number of pods."""

    def __init__(self, num_pods: int = 2,
                 dead_hosts: Optional[List[Tuple[int, int, int]]] = None,
                 *, pod_shape: Tuple[int, int] = POD_SHAPE,
                 pool: str = DEFAULT_POOL,
                 slices: Optional[Sequence[Slice]] = None):
        self.num_pods = num_pods
        self.pod_shape = pod_shape
        self.pool = pool
        self.pods = [PodState.empty(pod_shape) for _ in range(num_pods)]
        # cells pre-occupied by a partial-pod mask (make_placer) — kept
        # out of the usage metrics; dead hosts stay counted, as before
        self._unusable = 0
        self._shapes: Optional[Dict[str, Tuple[int, int]]] = (
            {s.name: s.shape for s in slices} if slices is not None
            else None)
        # fault tolerance: mark failed chips (pod, row, col) as occupied so
        # the placer routes around them (controller re-solves with the
        # shrunken S_avail).
        for (p, r, c) in (dead_hosts or []):
            self.pods[p].grid[r, c] = True

    def _shape(self, name: str) -> Tuple[int, int]:
        shape = (self._shapes[name] if self._shapes is not None
                 else by_name(name).shape)
        if shape is None:
            raise ValueError(
                f"slice {name!r} has no rectangle shape — the rectangle "
                "packer needs torus-style slices (set Slice.shape or use "
                "a scheme with its own packer)")
        return shape

    # ------------------------------------------------------------------
    def pack(self, segments: List[str]) -> Optional[List[Placement]]:
        """segments: slice-type names (one per instance).  Returns
        placements or None if capacity is insufficient."""
        shapes = {n: self._shape(n) for n in set(segments)}
        order = sorted(range(len(segments)),
                       key=lambda i: -(shapes[segments[i]][0]
                                       * shapes[segments[i]][1]))
        out: List[Optional[Placement]] = [None] * len(segments)
        for i in order:
            h, w = shapes[segments[i]]
            placed = False
            for p, pod in enumerate(self.pods):
                # anchor positions aligned to the shape (power-of-two grid)
                for r in range(0, self.pod_shape[0] - h + 1, h):
                    for c in range(0, self.pod_shape[1] - w + 1, w):
                        if pod.fits(r, c, h, w):
                            pod.place(r, c, h, w)
                            out[i] = Placement(i, segments[i], p, r, c,
                                               h, w, self.pool)
                            placed = True
                            break
                    if placed:
                        break
                if placed:
                    break
            if not placed:
                return None
        return [pl for pl in out if pl is not None]

    # ------------------------------------------------------------------
    @property
    def chips_used(self) -> int:
        return sum(p.used for p in self.pods) - self._unusable

    @property
    def pods_used(self) -> int:
        return sum(1 for p in self.pods if p.used > 0)

    def utilization(self) -> float:
        total = (self.num_pods * self.pod_shape[0] * self.pod_shape[1]
                 - self._unusable)
        return self.chips_used / max(total, 1)


#: Historical name — the torus packer was THE placer before hwspec.
Placer = RectanglePlacer


# ---------------------------------------------------------------------------
class MigSlicePacker:
    """Packs MIG slices onto devices under the scheme's placement rules.

    Device state is a row of ``total_mem_slots`` memory slots plus a
    ``total_g`` compute budget; a slice needs a contiguous run of free
    slots starting at an allowed offset AND enough g-units.  Sort by
    memory footprint descending, first-fit across devices.
    """

    def __init__(self, num_devices: int, scheme: MigScheme,
                 dead_hosts: Optional[Sequence[int]] = None,
                 *, pool: str = "mig"):
        self.num_devices = num_devices
        self.scheme = scheme
        self.pool = pool
        self.dead = set(dead_hosts or ())
        self.slots = [np.zeros(scheme.total_mem_slots, dtype=bool)
                      for _ in range(num_devices)]
        self.g_used = [0] * num_devices

    # ------------------------------------------------------------------
    def pack(self, segments: List[str]) -> Optional[List[Placement]]:
        slices = {n: self.scheme.slice(n) for n in set(segments)}
        order = sorted(range(len(segments)),
                       key=lambda i: (-slices[segments[i]].mem_slots,
                                      -slices[segments[i]].cost))
        out: List[Optional[Placement]] = [None] * len(segments)
        for i in order:
            sl = slices[segments[i]]
            placed = False
            for d in range(self.num_devices):
                if d in self.dead:
                    continue
                if self.g_used[d] + sl.cost > self.scheme.total_g:
                    continue
                for start in sl.starts:
                    end = start + sl.mem_slots
                    if end > self.scheme.total_mem_slots:
                        continue
                    if self.slots[d][start:end].any():
                        continue
                    self.slots[d][start:end] = True
                    self.g_used[d] += sl.cost
                    out[i] = Placement(i, segments[i], d, start, 0,
                                       sl.mem_slots, 1, self.pool)
                    placed = True
                    break
                if placed:
                    break
            if not placed:
                return None
        return [pl for pl in out if pl is not None]

    # ------------------------------------------------------------------
    @property
    def g_total_used(self) -> int:
        return sum(self.g_used)

    def utilization(self) -> float:
        live = self.num_devices - len(self.dead)
        return self.g_total_used / max(live * self.scheme.total_g, 1)


# ---------------------------------------------------------------------------
def _partial_pod_mask(pod: PodState, free_chips: int):
    """Mark everything outside ``free_chips`` as occupied.

    The free region is the tallest h×w top-left rectangle with h a power
    of two dividing the count (8 → 2×4, 12 → 2×6, 64 → 8×8), so
    multi-row slices stay placeable on any such pool; counts admitting
    no rectangle fall back to the row-major prefix."""
    h_pod, w_pod = pod.grid.shape
    best_h = 0
    h = 1
    while h <= h_pod and h * h <= free_chips:
        if free_chips % h == 0 and free_chips // h <= w_pod:
            best_h = h
        h *= 2
    if best_h > 0:
        mask = np.ones_like(pod.grid)
        mask[:best_h, :free_chips // best_h] = False
        pod.grid |= mask            # OR: dead-host marks survive
        return
    flat = pod.grid.reshape(-1)
    flat[free_chips:] = True


def make_placer(pool: Pool, dead_hosts=None) -> PlacerProtocol:
    """The pool's packer: MIG slice packer for MIG schemes, the 2-D
    rectangle packer for torus-style schemes.  A torus pool smaller than
    a whole number of pods gets its unavailable chips masked, so the
    packer refuses mixes the pool physically cannot host."""
    if isinstance(pool.scheme, MigScheme):
        return MigSlicePacker(pool.count, pool.scheme, dead_hosts,
                              pool=pool.name)
    pod_shape = getattr(pool.scheme, "pod_shape", POD_SHAPE)
    chips_per_pod = pod_shape[0] * pod_shape[1]
    num_pods = max(1, -(-pool.count // chips_per_pod))
    placer = RectanglePlacer(num_pods, dead_hosts, pod_shape=pod_shape,
                             pool=pool.name, slices=pool.scheme.slices())
    partial = pool.count - (num_pods - 1) * chips_per_pod
    if partial < chips_per_pod:
        before = placer.pods[-1].used
        _partial_pod_mask(placer.pods[-1], partial)
        placer._unusable = placer.pods[-1].used - before
    return placer


def pack_config(instance_segments: List[str], num_pods: int = 2,
                dead_hosts=None) -> Optional[List[Placement]]:
    return RectanglePlacer(num_pods, dead_hosts).pack(instance_segments)
