"""AdamW with fp32 master weights and moments.

PyTorch counterpart of ``repro.training.optimizer``, as plain functions on
dicts of tensors keyed by the model's parameter names.  The state is
``master``, ``m``, ``v`` (fp32, one tensor per parameter) and ``step`` (a
0-d int32 tensor).  The update runs in fp32 with the reference's
arithmetic, in its order, and casts back to the param dtype (bf16): the
standard mixed-precision recipe.  ``torch.optim.AdamW`` computes it in
another order, so it is not used.  On DTensor parameters (a model under a
mesh) the state is DTensors on the same placements, and the gradient norm
is over the whole tensors, as under GSPMD.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.sharding.policy import PartitionSpec

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros shaped (and, for a DTensor, placed) as ``p``."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def state_specs(param_specs: Mapping) -> Dict:
    """Specs of the optimizer state: ``master``, ``m`` and ``v`` mirror the
    params, ``step`` is replicated (the reference's ``state_specs``)."""
    return {"master": param_specs, "m": param_specs, "v": param_specs,
            "step": PartitionSpec()}


def init_state(params: Mapping[str, torch.Tensor]) -> Dict:
    """fp32 copies of ``params`` (``master``), zero moments, step 0."""
    first = next(iter(params.values()))
    return {
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in params.items()},
        "m": {k: _zeros32(p) for k, p in params.items()},
        "v": {k: _zeros32(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio`` (fp32)."""
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))


def apply_updates(cfg: AdamWConfig, state: Dict, grads: Mapping[str, torch.Tensor],
                  param_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[Tensors, Dict]:
    """One AdamW step.  Returns (new params in ``param_dtype``, new state).

    ``master``, ``m`` and ``v`` are updated in place (the reference's
    jitted step donates them); the new state holds them and the new step.
    Nothing is read back to the host."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    for k, g in grads.items():
        mast, m, v = state["master"][k], state["m"][k], state["v"][k]
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        delta.add_(cfg.weight_decay * mast)
        mast.sub_(lr * delta)
    new_state = {"master": state["master"], "m": state["m"],
                 "v": state["v"], "step": step}
    new_params = {k: w.to(param_dtype) for k, w in state["master"].items()}
    return new_params, new_state
