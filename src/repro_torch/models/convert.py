"""Weights of the JAX package's ``Model.init`` as the port's state dict.

``torch.Generator`` cannot reproduce ``jax.random``, so tests that hold the
port against the JAX package initialise once in JAX and convert.  The JAX
block weights are stacked ``[L, ...]``; each layer's slice keeps its layout
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ...) under ``blocks.<i>.<name>``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import DENSE_FAMILIES


def _tensor(x: Any) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)            # a copy: jax hands out read-only arrays


def from_jax_params(arch: ArchConfig,
                    params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``repro.models.Model.init`` params (arrays or numpy arrays) ->
    ``repro_torch.models.Model`` state dict, on the CPU."""
    if arch.family not in DENSE_FAMILIES:
        raise NotImplementedError(f"{arch.name}: family {arch.family!r} has "
                                  f"no port yet")
    out = {"embed": _tensor(params["embed"]),
           "final_norm": _tensor(params["final_norm"])}
    if not arch.tie_embeddings:
        out["lm_head"] = _tensor(params["lm_head"])
    for name, stacked in params["blocks"].items():
        stacked = _tensor(stacked)
        if stacked.shape[0] != arch.num_layers:
            raise ValueError(f"blocks/{name}: {stacked.shape[0]} layers, "
                             f"{arch.name} has {arch.num_layers}")
        for i in range(arch.num_layers):
            out[f"blocks.{i}.{name}"] = stacked[i]
    return out
