"""Config registry of the port: the five dense-family architectures, the
Mamba2 SSM (mamba2-130m) and the Zamba2 hybrid (zamba2-7b).

Usage::

    from repro_torch.configs import get_arch, ARCHS
    cfg = get_arch("qwen2-7b")

The MoE architectures of ``repro.configs`` are not served by this port yet
(ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ArchConfig, HybridConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.granite_3_2b import CONFIG as _granite_3_2b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.musicgen_large import CONFIG as _musicgen_large
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral_12b
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7b
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2_7b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (_gemma_2b, _granite_3_2b, _qwen2_7b, _pixtral_12b,
              _musicgen_large, _mamba2_130m, _zamba2_7b)
}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    # allow "<name>-reduced"
    if name.endswith("-reduced") and name[: -len("-reduced")] in ARCHS:
        return ARCHS[name[: -len("-reduced")]].reduced()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "ArchConfig", "HybridConfig", "MoEConfig", "SSMConfig",
           "get_arch"]
