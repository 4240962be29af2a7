"""``input_specs()``: ``meta`` tensors standing in for every model input.

PyTorch counterpart of ``repro.launch.specs``: where the reference builds
``jax.ShapeDtypeStruct``s, the port builds tensors on the ``meta`` device,
which carry shape and dtype and allocate nothing; the dry-run steps
against these.  For training that is {tokens, labels}; for prefill the
token batch (+ stub frontend embeddings for vlm/audio); for decode the
one-token batch, the KV/SSM caches (``kvcache.init_cache`` on ``meta``,
one tensor per layer where the reference stacks ``[L, ...]``) and
``cache_len``.  Token ids are int64, as the port's ``Model`` and
``Engine`` take them (the reference's are int32).  ``cache_len`` is a
host int, as ``Model.decode_step`` takes it: the last position a step at
``seq_len`` can write (``seq_len - 1``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import kvcache
from repro_torch.models.model import NUM_FRONTEND_POSITIONS

TOKEN_DTYPE = torch.int64
META = torch.device("meta")


def _meta(*shape: int, dtype: torch.dtype = TOKEN_DTYPE) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Inputs for the step the (arch, shape) cell counts."""
    B, S = shape.global_batch, shape.seq_len
    frontend = ({"frontend_embeds": _meta(B, NUM_FRONTEND_POSITIONS,
                                          arch.d_model, dtype=torch.bfloat16)}
                if arch.frontend != "none" else {})
    if shape.kind == "train":
        return {"tokens": _meta(B, S), "labels": _meta(B, S), **frontend}
    if shape.kind == "prefill":
        return {"tokens": _meta(B, S), **frontend}
    if shape.kind == "decode":
        return {
            "tokens": _meta(B, 1),
            "cache": kvcache.init_cache(arch, B, S, torch.bfloat16, META),
            "cache_len": S - 1,
        }
    raise ValueError(shape.kind)
