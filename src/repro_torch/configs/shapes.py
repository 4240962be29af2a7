"""Assigned input shapes (a copy of ``repro.configs.shapes``).

Each LM-family shape is (seq_len, global_batch).  ``decode_*``/``long_*``
lower ``serve_step`` (one new token against a KV cache of ``seq_len``), NOT
``train_step``.  ``long_500k`` requires sub-quadratic attention and is only
run for SSM/hybrid archs (assignment rule; skip recorded in the dry-run
table for the full-attention archs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """Assignment applicability rule for an (arch, shape) cell."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True


def skip_reason(arch: ArchConfig, shape: ShapeConfig) -> str:
    if applicable(arch, shape):
        return ""
    return ("long_500k requires sub-quadratic attention; "
            f"{arch.name} is a pure full-attention arch (skip per assignment)")
