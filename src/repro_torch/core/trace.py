"""Diurnal demand trace (paper §4.1: Twitter-trace shaped).

288 five-minute bins over one day: a diurnal sinusoid with an evening
peak, lognormal jitter, and a few bursty spikes — the broad trends the
paper preserves when scaling the Twitter trace.  Deterministic per seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

BINS_PER_DAY = 288
BIN_SECONDS = 300.0


@dataclass(frozen=True)
class DemandTrace:
    rps: np.ndarray               # [BINS] mean demand per bin

    @property
    def num_bins(self) -> int:
        return len(self.rps)

    def scaled_to_max(self, max_rps: float) -> "DemandTrace":
        """Scale so the trace peak equals ``max_rps`` (paper: scaled to the
        max demand JigsawServe can serve, preserving trends)."""
        return DemandTrace(self.rps * (max_rps / self.rps.max()))

    def window(self, lo: int, hi: int) -> "DemandTrace":
        return DemandTrace(self.rps[lo:hi])


def diurnal_trace(seed: int = 0, bins: int = BINS_PER_DAY,
                  base: float = 0.35, peak_bin: float = 0.75,
                  jitter: float = 0.06, n_spikes: int = 4) -> DemandTrace:
    """Unit-scale diurnal trace (max ≈ 1)."""
    rng = np.random.default_rng(seed)
    t = np.arange(bins) / bins
    # double-humped diurnal: morning shoulder + evening peak
    diurnal = (base
               + 0.45 * np.exp(-0.5 * ((t - peak_bin) / 0.10) ** 2)
               + 0.25 * np.exp(-0.5 * ((t - 0.38) / 0.08) ** 2))
    noise = rng.lognormal(mean=0.0, sigma=jitter, size=bins)
    rps = diurnal * noise
    for _ in range(n_spikes):
        at = rng.integers(0, bins)
        width = int(rng.integers(1, 4))
        rps[at:at + width] *= rng.uniform(1.15, 1.45)
    return DemandTrace(rps / rps.max())


def burst_trace(base_rps: float, burst_rps: float, bins: int = 40,
                period_bins: int = 10, duty: float = 0.3) -> DemandTrace:
    """On/off bursty demand: ``base_rps`` with periodic square bursts to
    ``burst_rps`` lasting ``duty`` of each period (deterministic)."""
    rps = np.full(bins, float(base_rps))
    on = max(1, int(round(period_bins * duty)))
    for start in range(0, bins, max(period_bins, 1)):
        rps[start:start + on] = float(burst_rps)
    return DemandTrace(rps)


def predict_demand(history: List[float], slack: float = 0.05) -> float:
    """Paper §4.2: mean of the last 5 observed bins + slack."""
    if not history:
        return 0.0
    recent = history[-5:]
    return float(np.mean(recent)) * (1.0 + slack)
