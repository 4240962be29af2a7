"""Dense layers shared by the dense-family architectures.

PyTorch counterparts of ``repro.models.layers``: weights keep the JAX
package's unflattened layouts (``[d, H, hd]`` projections) and norm,
rotary and logit math runs in fp32 whatever the parameter dtype (in
float64 in a float64 model, the yardstick of the fp32 gradients).
Attention itself lives in ``repro_torch.kernels``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.policy import is_dtensor


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is when it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + weight)`` (weights are zero-initialised)."""
    xf = upcast(x)
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.to(xf.dtype))).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[head_dim // 2] inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=dtype,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S].  Split-half convention: the
    first half of each head pairs with the second half."""
    xf = upcast(x)
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device, xf.dtype)
    angles = positions.to(xf.dtype)[..., None] * inv_freq  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, KV*q_per_kv, hd] by repeating each kv head."""
    if q_per_kv == 1:
        return x
    return x.repeat_interleave(q_per_kv, dim=2)


def gated_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, activation: str,
              pin: Optional[Callable] = None) -> torch.Tensor:
    """SwiGLU / GeGLU: (act(x@wg) * (x@wu)) @ wd; GeGLU's gelu is the tanh
    approximation, as ``jax.nn.gelu(approximate=True)``.  ``pin``, when
    given, constrains the sharding of ``x@wg`` (the reference pins it)."""
    g = x @ wg
    u = x @ wu
    if pin is not None:
        g = pin(g)
    if activation == "silu":
        g = F.silu(g)
    elif activation == "gelu":
        g = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return (g * u) @ wd


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table``.  A DTensor table split over more than one rank
    goes through ``F.embedding``, whose sharding rule keeps a vocab-sharded
    table sharded (the result is pending a masked sum: pin it at once);
    any other table is indexed, whose backward sums a row's gradients in
    the order the plain model does."""
    if is_dtensor(table) and any(
            p.is_shard() and n > 1
            for p, n in zip(table.placements, table.device_mesh.shape)):
        return F.embedding(tokens, table)
    return table[tokens]


def logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """[B,S,d] @ [d,V] -> fp32 logits.  The products of two bf16 values are
    exact in fp32, so this equals an fp32-accumulated bf16 product."""
    return upcast(x) @ upcast(head)
