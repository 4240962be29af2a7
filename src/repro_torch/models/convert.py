"""Weights of the JAX package's ``Model.init`` as the port's state dict,
and back.

``torch.Generator`` cannot reproduce ``jax.random``, so tests that hold the
port against the JAX package initialise once in JAX and convert.  The JAX
block weights are stacked ``[L, ...]``; each layer's slice keeps its layout
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ``wz [d, nh, hd]``, ...) under
``blocks.<i>.<name>``.  A hybrid's shared attention block, stacked
``[1, ...]``, goes to ``shared_attn.<name>``.  An MoE model's blocks are
stacked per group of ``moe_every`` layers: ``blocks/moe/<name>``
``[n_groups, ...]`` is each group's last layer, ``blocks/dense/<name>``
``[n_groups, moe_every - 1, ...]`` its dense layers before it.  Dtypes are kept: the SSM's
``A_log`` and ``dt_bias`` are fp32 in every model.  ``to_jax_params`` is
the inverse, so the port's train state and checkpoints keep the
reference's tree (and leaf order).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import FAMILIES


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
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
    """``repro.models.Model.init`` params (arrays, numpy arrays or
    tensors) -> ``repro_torch.models.Model`` state dict: tensors stay where
    they are (each layer a view of its stacked leaf), the rest go to the
    CPU."""
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


def to_jax_params(arch: ArchConfig, state_dict: Mapping[str, torch.Tensor],
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params`: a state dict of
    ``repro_torch.models.Model`` (or any dict under its names, such as the
    optimizer's moments) -> the reference's nested tree of stacked
    ``[L, ...]`` tensors, dtypes kept.  Each layer's tensor moves to
    ``device`` (where it is, if None) before it is stacked there."""
    if arch.family not in FAMILIES:
        raise ValueError(f"{arch.name}: unknown family {arch.family!r}")

    def leaf(key: str) -> torch.Tensor:
        t = state_dict[key]
        return t if device is None else t.to(device)

    def names(prefix: str) -> list:
        return [k[len(prefix):] for k in state_dict if k.startswith(prefix)]

    def stack(layers: list) -> Dict[str, torch.Tensor]:
        return {name: torch.stack([leaf(f"blocks.{i}.{name}")
                                   for i in layers])
                for name in names(f"blocks.{layers[0]}.")}

    out: Dict[str, Any] = {"embed": leaf("embed"),
                           "final_norm": leaf("final_norm")}
    if not arch.tie_embeddings:
        out["lm_head"] = leaf("lm_head")
    if arch.family == "moe":
        per = arch.moe.moe_every
        n_groups = arch.num_layers // per
        out["blocks"] = {"moe": stack([g * per + per - 1
                                       for g in range(n_groups)])}
        if per > 1:
            dense = {name: w.unflatten(0, (n_groups, per - 1)) for name, w in
                     stack([g * per + j for g in range(n_groups)
                            for j in range(per - 1)]).items()}
            out["blocks"]["dense"] = dense
    else:
        out["blocks"] = stack(list(range(arch.num_layers)))
    if arch.family == "hybrid":
        out["shared_attn"] = {name: leaf(f"shared_attn.{name}")[None]
                              for name in names("shared_attn.")}
    return out


def leaf_groups(arch: ArchConfig, names) -> List[List[str]]:
    """For each leaf of the reference's tree, the ``names`` (a ``Model``'s
    parameter names, or any dict's keys under them) that
    :func:`to_jax_params` stacks into that leaf, in stacking order."""
    names = list(names)
    groups: List[List[str]] = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            groups.append([names[i] for i in t.flatten().tolist()])

    walk(to_jax_params(arch, {n: torch.tensor([i])
                              for i, n in enumerate(names)}))
    return groups
