"""Operations and bytes counted from shapes, and the card's published peaks.

Kernel work is counted from the shapes of each call, so it stays the same
whatever implements the call.  The per-call arithmetic follows the dry-run's
``_flash_work`` and ``_decode_work``: each input byte read once, each
output byte written once, and only the query/key pairs the call needs.
Which calls a model's requests and batches make is its family's
(``portbench/arch/<model_type>.py``: ``sequence_flops``, ``kernel_work``).
"""
from __future__ import annotations

from typing import Optional, Tuple

# One NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of the
    operations at the bf16 peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S)


def mfu_pct(run) -> Optional[float]:
    """The model FLOPs a run served over the seconds they took, as a share
    of the card's bf16 peak (``run.model_flops`` over ``run.model_s``); no
    reading off the card or without work."""
    if not run.on_cuda or not run.model_flops or not run.model_s > 0:
        return None
    return 100.0 * run.model_flops / (run.model_s * PEAK_BF16_FLOPS)


def flash_work(B: int, S: int, H: int, KV: int, hd: int,
               itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal prefill attention call over S rows:
    QK^T and PV over the S(S+1)/2 causal pairs; q, k, v read once and the
    output written once."""
    pairs = S * (S + 1) // 2
    flops = 4.0 * B * H * hd * pairs
    nbytes = float(itemsize) * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    return flops, nbytes


def decode_work(B: int, L: int, H: int, KV: int, hd: int,
                itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode attention call: one query row a
    sequence against ``L`` cache positions, which it alone reads."""
    flops = 4.0 * B * H * hd * L
    nbytes = float(itemsize) * (2 * B * H * hd + 2 * B * L * KV * hd)
    return flops, nbytes
