"""DeviceSpec: one accelerator model's roofs + serving calibration.

A copy of the JAX package's ``hwspec/device.py`` with one addition of the
port's own: the :data:`H100_SXM` preset of the card the port serves on.

The values feeding the closed-form roofline profiler and the dry-run
roofline used to be module-level constants in ``repro_torch.core.hw``; that
module is now a thin shim over :data:`TPU_V5E` so the two stay consistent
by construction while other accelerators (e.g. a MIG-sliced A100 pool)
become expressible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

DEFAULT_POOL = "v5e"


@dataclass(frozen=True)
class DeviceSpec:
    """Peak roofs of ONE device (a TPU chip, a whole GPU, ...).

    ``peak_flops`` maps dtype → FLOP/s; dtypes absent from the map fall
    back to the ``"bf16"`` entry (the dense-math default).  The efficiency
    fields calibrate the closed-form serving profile (roofline fractions a
    well-tuned serving stack achieves; folded into L/H identically so the
    MILP's *relative* choices are calibration-invariant).

    Arguments:
        name: stable identifier (shows up in reports, never parsed).
        peak_flops: dtype → peak dense FLOP/s of one device.
        hbm_bytes: HBM capacity per device (bytes).
        hbm_bw: peak HBM bandwidth per device (bytes/s).
        ici_bw_per_link: interconnect bandwidth per link (bytes/s) —
            charged only by slices spanning >1 device (tensor-parallel
            collectives); MIG slices are intra-device and never pay it.
        hbm_usable_fraction: share of HBM the serving stack may fill
            before a config is rejected as OOM (profiler filter).
        flops_efficiency / hbm_efficiency / ici_efficiency: achieved
            fraction of each roof; fit these from measured engine runs
            to calibrate a new device.
        weight_load_bw: checkpoint-staging bandwidth (bytes/s) into one
            device — the host/NIC/PCIe path weights travel on during a
            reconfiguration, NOT the on-device HBM roof.  ``None``
            derives it from the HBM roof as ``hbm_bw / 256`` (a
            PCIe/NIC-class link is roughly two orders of magnitude below
            HBM: ~3.2 GB/s on v5e, ~6 GB/s on A100), which is what the
            reconfiguration engine charges per weight load.
    """
    name: str
    peak_flops: Mapping[str, float]      # dtype -> FLOP/s
    hbm_bytes: int                       # per device
    hbm_bw: float                        # B/s per device
    ici_bw_per_link: float               # B/s per interconnect link
    hbm_usable_fraction: float = 0.9
    flops_efficiency: float = 0.55
    hbm_efficiency: float = 0.80
    ici_efficiency: float = 0.75
    weight_load_bw: Optional[float] = None   # None -> hbm_bw / 256

    def peak(self, quant: str) -> float:
        try:
            return self.peak_flops[quant]
        except KeyError:
            return self.peak_flops["bf16"]

    def param_bytes(self, quant: str) -> int:
        return 1 if quant == "int8" else 2

    @property
    def usable_hbm_bytes(self) -> float:
        return self.hbm_bytes * self.hbm_usable_fraction

    @property
    def staging_bw(self) -> float:
        """Weight-staging bandwidth into one device (see weight_load_bw)."""
        return (self.weight_load_bw if self.weight_load_bw is not None
                else self.hbm_bw / 256.0)

    def weight_load_s(self, nbytes: float,
                      memory_fraction: float = 1.0) -> float:
        """Seconds to stage ``nbytes`` of weights into one device (a
        partition owning ``memory_fraction`` of the device gets the same
        share of the staging path — MIG slices load proportionally
        slower)."""
        return float(nbytes) / max(self.staging_bw * memory_fraction, 1.0)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------
#: The assignment-specified TPU v5e chip (the historical ``core.hw``
#: constants, verbatim).
TPU_V5E = DeviceSpec(
    name="tpu-v5e",
    peak_flops={"bf16": 197e12, "int8": 394e12},  # int8 MXU rate = 2x bf16
    hbm_bytes=16 * 2 ** 30,
    hbm_bw=819e9,
    ici_bw_per_link=50e9,
)

#: A MIG-capable datacenter GPU (A100-40GB-class roofs) for the
#: heterogeneous-pool scenarios (ParvaGPU / Lee et al. 2024 style slices).
A100_40GB = DeviceSpec(
    name="a100-40gb",
    peak_flops={"bf16": 312e12, "int8": 624e12},
    hbm_bytes=40 * 10 ** 9,
    hbm_bw=1555e9,
    ici_bw_per_link=600e9,               # NVLink aggregate
)

#: The port's own preset (not in the JAX package): one H100 SXM5 80GB, the
#: card the port serves on.  Dense peaks from the H100 SXM5 datasheet
#: (bf16 989.4 TFLOP/s, int8 1,979 TOPS without sparsity), 80 GB of HBM3 at
#: 3.35 TB/s and 900 GB/s of NVLink.  The efficiencies and the staging
#: bandwidth keep the defaults; ``chip_smoke.py`` fits the efficiencies to
#: the card it runs on and plans with ``dataclasses.replace``.
H100_SXM = DeviceSpec(
    name="h100-sxm",
    peak_flops={"bf16": 989e12, "int8": 1979e12},
    hbm_bytes=80 * 10 ** 9,
    hbm_bw=3.35e12,
    ici_bw_per_link=900e9,               # NVLink 4 aggregate
)
