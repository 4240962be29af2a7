"""Config registry of the port: the reference's 10 architectures + shapes.

Copies of ``repro.configs`` (the port imports nothing of the JAX package),
held field by field against the originals by the port's tests: the dense
family (deepseek-67b, gemma-2b, granite-3-2b, qwen2-7b, pixtral-12b and
musicgen-large behind their stub frontends), the MoE family (llama4 scout
and maverick), the Mamba2 SSM (mamba2-130m) and the Zamba2 hybrid
(zamba2-7b).

Usage::

    from repro_torch.configs import get_arch, ARCHS, SHAPES
    cfg = get_arch("qwen2-7b")
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ArchConfig, HybridConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                        SHAPES, TRAIN_4K, ShapeConfig,
                                        applicable, skip_reason)

from repro_torch.configs.deepseek_67b import CONFIG as _deepseek_67b
from repro_torch.configs.gemma_2b import CONFIG as _gemma_2b
from repro_torch.configs.granite_3_2b import CONFIG as _granite_3_2b
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7b
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral_12b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4_scout
from repro_torch.configs.llama4_maverick_400b_a17b import \
    CONFIG as _llama4_maverick
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2_7b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.musicgen_large import CONFIG as _musicgen_large

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _deepseek_67b,
        _gemma_2b,
        _granite_3_2b,
        _qwen2_7b,
        _pixtral_12b,
        _llama4_scout,
        _llama4_maverick,
        _zamba2_7b,
        _mamba2_130m,
        _musicgen_large,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    # allow "<name>-reduced"
    if name.endswith("-reduced") and name[: -len("-reduced")] in ARCHS:
        return ARCHS[name[: -len("-reduced")]].reduced()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """Yield every assigned (arch, shape) cell with its applicability."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            yield arch, shape, applicable(arch, shape), skip_reason(arch, shape)


__all__ = [
    "ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "MoEConfig", "SSMConfig",
    "HybridConfig", "get_arch", "get_shape", "all_cells", "applicable",
    "skip_reason", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
