"""TPU v5e hardware constants — thin shim over :mod:`repro_torch.hwspec`.

The values live in :data:`repro_torch.hwspec.device.TPU_V5E` (the default
pool's :class:`~repro_torch.hwspec.device.DeviceSpec`); this module re-exports
them as the historical module-level constants so BOTH the serving
profiler (closed-form latency/throughput model) and the dry-run roofline
analysis keep importing one consistent source.  New code should take a
``DeviceSpec`` instead of importing these globals.
"""
from repro_torch.hwspec.device import TPU_V5E

SPEC = TPU_V5E

PEAK_FLOPS_BF16 = SPEC.peak_flops["bf16"]   # per chip
PEAK_FLOPS_INT8 = SPEC.peak_flops["int8"]   # int8 MXU rate = 2x bf16 on v5e
HBM_BW = SPEC.hbm_bw                        # B/s per chip
ICI_BW_PER_LINK = SPEC.ici_bw_per_link      # B/s per link
HBM_BYTES = SPEC.hbm_bytes                  # 16 GiB per chip
HBM_USABLE_FRACTION = SPEC.hbm_usable_fraction

# Calibration of the closed-form serving profile (roofline fractions a
# well-tuned serving stack achieves; folded into L/H identically so the
# MILP's *relative* choices are calibration-invariant).
FLOPS_EFFICIENCY = SPEC.flops_efficiency
HBM_EFFICIENCY = SPEC.hbm_efficiency
ICI_EFFICIENCY = SPEC.ici_efficiency


def peak_flops(quant: str) -> float:
    return SPEC.peak(quant)


def param_bytes(quant: str) -> int:
    return SPEC.param_bytes(quant)
