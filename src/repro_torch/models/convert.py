"""Weights of the JAX package's ``Model.init`` as the port's state dict.

``torch.Generator`` cannot reproduce ``jax.random``, so tests that hold the
port against the JAX package initialise once in JAX and convert.  The JAX
block weights are stacked ``[L, ...]``; each layer's slice keeps its layout
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ``wz [d, nh, hd]``, ...) under
``blocks.<i>.<name>``.  A hybrid's shared attention block, stacked
``[1, ...]``, goes to ``shared_attn.<name>``.  An MoE model's blocks are
stacked per group of ``moe_every`` layers: ``blocks/moe/<name>``
``[n_groups, ...]`` is each group's last layer, ``blocks/dense/<name>``
``[n_groups, moe_every - 1, ...]`` its dense layers before it.  Dtypes are kept: the SSM's
``A_log`` and ``dt_bias`` are fp32 in every model.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import FAMILIES


def _tensor(x: Any) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)            # a copy: jax hands out read-only arrays


def _unstack(prefix: str, stacked: Mapping[str, Any], n: int,
             out: Dict[str, torch.Tensor], index: bool = True) -> None:
    for name, w in stacked.items():
        w = _tensor(w)
        if w.shape[0] != n:
            raise ValueError(f"{prefix}/{name}: {w.shape[0]} layers, "
                             f"expected {n}")
        for i in range(n):
            out[f"{prefix}.{i}.{name}" if index else f"{prefix}.{name}"] = w[i]


def from_jax_params(arch: ArchConfig,
                    params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``repro.models.Model.init`` params (arrays or numpy arrays) ->
    ``repro_torch.models.Model`` state dict, on the CPU."""
    if arch.family not in FAMILIES:
        raise ValueError(f"{arch.name}: unknown family {arch.family!r}")
    out = {"embed": _tensor(params["embed"]),
           "final_norm": _tensor(params["final_norm"])}
    if not arch.tie_embeddings:
        out["lm_head"] = _tensor(params["lm_head"])
    if arch.family == "moe":
        per = arch.moe.moe_every
        n_groups = arch.num_layers // per
        for name, w in params["blocks"]["moe"].items():
            w = _tensor(w)
            for g in range(n_groups):
                out[f"blocks.{g * per + per - 1}.{name}"] = w[g]
        for name, w in params["blocks"].get("dense", {}).items():
            w = _tensor(w)
            for g, j in itertools.product(range(n_groups), range(per - 1)):
                out[f"blocks.{g * per + j}.{name}"] = w[g, j]
    else:
        _unstack("blocks", params["blocks"], arch.num_layers, out)
    if arch.family == "hybrid":
        _unstack("shared_attn", params["shared_attn"], 1, out, index=False)
    return out
