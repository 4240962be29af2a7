"""Offline profiler: L(t,v,s,b) and H(t,v,s,b)  (paper §3.1).

The paper profiles every (variant × GPU-segment × batch) combination on
real hardware for 7-12 hours.  This container has no TPU, so the profiler
derives the same table from a *closed-form roofline model* over the arch
configs — the identical FLOP/byte accounting the dry-run roofline uses,
validated against compiled ``cost_analysis()`` numbers in
``tests/test_profiler.py``.

The hardware is a first-class input: the profiler builds its tables per
``(pool, slice)`` of a :class:`~repro_torch.hwspec.cluster.ClusterSpec`
(DESIGN.md §10), so a heterogeneous deployment (e.g. a v5e torus pool
plus a MIG-sliced A100 pool) gets per-pool rooflines keyed by
cluster-unique slice names.  The default cluster reproduces the legacy
single-pool v5e catalogue bit-for-bit.

Stream multiplicity model (the MPS analogue, DESIGN.md §2): a single
stream leaves the MXU idle for ``1-u`` of the time (u = compute-time /
batch-time).  k streams interleave: aggregate demand ``k·u``; below 1 they
don't contend (k× throughput, same latency), above 1 the segment
saturates (throughput caps at 1/u, latency stretches by k·u).  This gives
the paper's qualitative profile — memory-bound small models love high
concurrency on small segments, compute-bound giants don't.

Runtime refinement (paper §3.1): ``observe()`` folds measured latencies
back with an EWMA.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig
from repro_torch.core import hw
from repro_torch.core.taskgraph import TaskGraph, Variant
from repro_torch.hwspec import (ClusterSpec, DEFAULT_POOL, DeviceSpec,
                          ExplicitScheme, Pool, Slice, TPU_V5E,
                          default_cluster, slice_from_segment)
from repro_torch.sharding.segments import SegmentType

BATCH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)   # paper Table 2
P95_FACTOR = 1.10                             # p95 over mean

Key = Tuple[str, str, str, int]               # (task, variant, slice, batch)


@dataclass(frozen=True)
class ProfileEntry:
    latency_ms: float          # p95 per-batch latency
    throughput_rps: float      # requests/s of ONE instance
    chips: int                 # capacity units (slice cost; chips on torus)
    streams: int
    utilization: float         # single-stream MXU busy fraction
    hbm_per_chip: float        # bytes per spanned device
    pool: str = DEFAULT_POOL   # owning ClusterSpec pool

    @property
    def throughput_per_chip(self) -> float:
        return self.throughput_rps / self.chips


# ---------------------------------------------------------------------------
# closed-form request cost model
# ---------------------------------------------------------------------------
def request_flops(arch: ArchConfig, quant: str, batch: int, seq: int,
                  gen: int) -> Tuple[float, float]:
    """(prefill_flops, per-decode-step flops) for a batch of requests."""
    _, n_active = arch.param_count()
    fl_prefill = 2.0 * n_active * batch * seq
    # attention score/value FLOPs (full attention archs): 2 * 2 * B*S^2*H*hd
    if arch.num_heads:
        n_attn = arch.num_layers if arch.family != "hybrid" else \
            -(-arch.num_layers // arch.hybrid.attn_every)
        fl_prefill += (2.0 * n_attn * batch * seq * seq
                       * arch.num_heads * arch.head_dim)  # QK^T + PV, /2 causal *2 ops
    fl_decode = 2.0 * n_active * batch
    if arch.num_heads:
        n_attn = arch.num_layers if arch.family != "hybrid" else \
            -(-arch.num_layers // arch.hybrid.attn_every)
        fl_decode += 4.0 * n_attn * batch * seq * arch.num_heads * arch.head_dim
    return fl_prefill, fl_decode


def request_bytes(arch: ArchConfig, quant: str, batch: int, seq: int
                  ) -> Tuple[float, float, float]:
    """(weight_bytes, kv_bytes(batch, seq), act_bytes(batch, seq))."""
    n_total, _ = arch.param_count()
    wb = float(n_total) * hw.param_bytes(quant)
    from repro_torch.models.kvcache import cache_bytes
    kv = float(cache_bytes(arch, batch, seq))
    act = 2.0 * batch * seq * arch.d_model * 12  # rough live-activation set
    return wb, kv, act


def _as_slice(seg: Union[Slice, SegmentType]) -> Slice:
    return seg if isinstance(seg, Slice) else slice_from_segment(seg)


# ---------------------------------------------------------------------------
@dataclass
class Profiler:
    """Builds and refines the (t,v,s,b) profile table for one task graph.

    Hardware comes from ``cluster`` (any :class:`ClusterSpec`); passing a
    legacy ``segments`` list instead wraps it into a single default-pool
    cluster.  Slice names are cluster-unique, so table keys stay the
    4-tuple ``(task, variant, slice_name, batch)`` and each entry records
    its pool.
    """
    graph: TaskGraph
    segments: Optional[Sequence[Union[Slice, SegmentType]]] = None
    batches: Tuple[int, ...] = BATCH_SIZES
    ewma: float = 0.3
    table: Dict[Key, ProfileEntry] = field(default_factory=dict)
    cluster: Optional[ClusterSpec] = None

    def __post_init__(self):
        # legacy callers never see the ClusterSpec we synthesize here; the
        # controller uses this flag to keep honoring its num_pods knob on
        # such implicit clusters while treating user clusters as final
        self.cluster_implicit = self.cluster is None
        if self.cluster is None:
            if self.segments is not None:
                self.cluster = ClusterSpec(pools=(Pool(
                    DEFAULT_POOL, TPU_V5E, 512, ExplicitScheme(
                        tuple(_as_slice(s) for s in self.segments))),))
            else:
                self.cluster = default_cluster()
        elif self.segments is not None:
            raise ValueError("pass either cluster= or segments=, not both")
        if not self.table:
            self.profile_all()

    # ------------------------------------------------------------------
    def pool_of(self, slice_name: str) -> str:
        return self.cluster.find_slice(slice_name)[0].name

    def profile_all(self):
        for pool in self.cluster.pools:
            for tname, task in self.graph.tasks.items():
                for v in task.variants:
                    for sl in pool.scheme.slices():
                        for b in self.batches:
                            e = self.profile_one(v, sl, b, pool=pool)
                            if e is not None:
                                self.table[(tname, v.name, sl.name, b)] = e

    def profile_one(self, v: Variant, seg: Union[Slice, SegmentType],
                    batch: int, pool: Optional[Pool] = None
                    ) -> Optional[ProfileEntry]:
        """Roofline latency/throughput of one instance, or None if it
        doesn't fit the slice's HBM (the paper's OOM-excluded configs).

        ``pool`` supplies the :class:`DeviceSpec`; omitted, the default
        v5e device is assumed (legacy single-pool callers)."""
        sl = _as_slice(seg)
        dev: DeviceSpec = pool.device if pool is not None else TPU_V5E
        pname = pool.name if pool is not None else DEFAULT_POOL
        arch = ARCHS[v.arch]
        c = sl.devices
        comp = c * sl.compute_fraction      # device-equivalents of compute
        mem = c * sl.memory_fraction        # device-equivalents of HBM BW
        wb, kv, act = request_bytes(arch, v.quant, batch,
                                    v.seq_len + v.gen_len)
        # all k streams co-resident: weights shared, kv/activations per stream
        hbm_per_dev = (wb + (kv + act) * sl.streams) / c
        if hbm_per_dev > (dev.hbm_bytes * sl.memory_fraction
                          * dev.hbm_usable_fraction):
            return None

        fl_p, fl_d = request_flops(arch, v.quant, batch, v.seq_len, v.gen_len)
        peak = dev.peak(v.quant) * dev.flops_efficiency
        bw = dev.hbm_bw * dev.hbm_efficiency

        t_pre = max(fl_p / (comp * peak), (wb + kv) / (mem * bw))
        # each decode step re-reads weights + the growing cache (avg ~ full)
        t_dec = max(fl_d / (comp * peak), (wb + kv) / (mem * bw))
        t_comp = fl_p / (comp * peak) + v.gen_len * fl_d / (comp * peak)
        t1 = t_pre + v.gen_len * t_dec

        # tensor-parallel interconnect: 2 collectives/layer over activations
        # (only multi-device slices pay this; a MIG slice is intra-device)
        if c > 1:
            toks = batch * (v.seq_len + v.gen_len)
            ici_bytes = 4.0 * arch.num_layers * toks * arch.d_model * 2 \
                * (c - 1) / c
            t1 += ici_bytes / (c * dev.ici_bw_per_link * dev.ici_efficiency)

        u = min(1.0, t_comp / t1)
        k = sl.streams
        latency = t1 * max(1.0, k * u)
        mult = min(float(k), 1.0 / max(u, 1e-6))
        throughput = batch * mult / t1
        return ProfileEntry(
            latency_ms=latency * 1e3 * P95_FACTOR,
            throughput_rps=throughput,
            chips=sl.cost, streams=k, utilization=u,
            hbm_per_chip=hbm_per_dev, pool=pname)

    # ------------------------------------------------------------------
    def get(self, task: str, variant: str, segment: str, batch: int
            ) -> Optional[ProfileEntry]:
        return self.table.get((task, variant, segment, batch))

    def entries_for_task(self, task: str) -> Dict[Key, ProfileEntry]:
        return {k: e for k, e in self.table.items() if k[0] == task}

    def observe(self, key: Key, measured_latency_ms: float):
        """Runtime refinement: EWMA-blend a measured latency (paper §3.1)."""
        e = self.table.get(key)
        if e is None:
            return
        lat = (1 - self.ewma) * e.latency_ms + self.ewma * measured_latency_ms
        scale = e.latency_ms / max(lat, 1e-9)
        self.table[key] = dataclasses.replace(
            e, latency_ms=lat, throughput_rps=e.throughput_rps * scale)
