"""TPU *segment* catalogue — the MIG-instance analogue (DESIGN.md §2).

A segment is a contiguous rectangular sub-mesh of the 16×16 pod torus plus
a *stream multiplicity* k∈{1..4} (the MPS-concurrency analogue: k request
streams round-robin on one segment's executables).  Chips are the
allocation quantum (the paper's "GPU slice"); rectangles are the placement
constraint (the paper's MIG placement rules — a 3-chip segment is as
expensive as 2×2 because sub-meshes must be contiguous rectangles).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class SegmentType:
    chips: int
    streams: int
    shape: Tuple[int, int]     # (rows, cols) on the pod grid

    @property
    def name(self) -> str:
        return f"{self.shape[0]}x{self.shape[1]}s{self.streams}"

    @property
    def cost(self) -> int:
        """s_n in the MILP — GPU-slice analogue = chips."""
        return self.chips


# contiguous power-of-two rectangles on a 16x16 pod
SEGMENT_SHAPES: Dict[int, Tuple[int, int]] = {
    1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4),
    16: (4, 4), 32: (4, 8), 64: (8, 8),
}

MAX_STREAMS = 4  # paper: up to 4 MPS processes per MIG instance


@lru_cache(maxsize=None)
def _catalogue(max_chips: int, max_streams: int, spatial: bool,
               unopt_chips: int) -> Tuple[SegmentType, ...]:
    if not spatial:
        return (SegmentType(unopt_chips, 1, SEGMENT_SHAPES[unopt_chips]),)
    out = []
    for chips, shape in SEGMENT_SHAPES.items():
        if chips > max_chips:
            continue
        for k in range(1, max_streams + 1):
            out.append(SegmentType(chips, k, shape))
    return tuple(out)


def catalogue(max_chips: int = 64, max_streams: int = MAX_STREAMS,
              spatial: bool = True, unopt_chips: int = 8
              ) -> List[SegmentType]:
    """All segment types up to ``max_chips``.

    ``spatial=False`` reproduces the no-partitioning baselines: only the
    whole-accelerator unit (``unopt_chips`` — the 'one H100' analogue in
    our scale mapping, see DESIGN.md §2) with a single stream.
    """
    return list(_catalogue(max_chips, max_streams, spatial, unopt_chips))


@lru_cache(maxsize=None)
def by_name(name: str) -> SegmentType:
    """Memoized name lookup — this sits in the packer hot loop, so it must
    not rebuild the catalogue per call (frozen SegmentTypes are shareable).
    Resolves against ``catalogue()``'s own defaults so the two can never
    drift apart."""
    for s in catalogue():
        if s.name == name:
            return s
    raise KeyError(name)
