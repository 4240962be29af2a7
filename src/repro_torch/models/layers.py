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

from repro_torch.sharding.policy import is_dtensor, redistribute


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


def _folds(x: torch.Tensor) -> bool:
    """Whether :func:`fold` folds ``x`` on its local shards: a DTensor
    whose leading dims (all but the last) are sharded on another dim than
    the first, evenly.  DTensor in torch 2.11 flattens a group of dims
    only when the first of them is the one sharded."""
    if not is_dtensor(x) or x.dim() <= 2:
        return False
    lead = x.dim() - 1
    if not any(p.is_shard() and 0 < p.dim < lead for p in x.placements):
        return False
    ways = [1] * lead
    for p, n in zip(x.placements, x.device_mesh.shape):
        if p.is_shard() and p.dim < lead:
            ways[p.dim] *= n
    return all(x.shape[d] % ways[d] == 0 for d in range(lead))


def fold(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] as rows [N, K].  A DTensor sharded on a leading dim
    past the first is reshaped on its local shards, the rows sharded (dim
    0) over each mesh dim that shards a leading dim; :func:`unfold` is
    the inverse for a row-wise result.  Otherwise a reshape.  Folded rows
    come rank block by rank block, not in the flattened order, so only
    row-wise work may run between the two."""
    if not _folds(x):
        return x.reshape(-1, x.shape[-1])
    from torch.distributed.tensor import DTensor, Shard
    lead = x.dim() - 1
    places = [Shard(0 if p.dim < lead else 1) if p.is_shard() else p
              for p in x.placements]
    local = x.to_local()
    return DTensor.from_local(local.reshape(-1, local.shape[-1]),
                              x.device_mesh, places, run_check=False)


def unfold(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Rows ``y`` [N, M] computed row by row from ``fold(like)`` back in
    ``like``'s leading shape and sharding: [..., M]."""
    if not _folds(like):
        return y.reshape(*like.shape[:-1], y.shape[-1])
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lead = like.dim() - 1
    rows = [p.is_shard() and p.dim < lead for p in like.placements]
    # a pending sum is reduced here (its reshard's backward would ask
    # DTensor for a Shard -> Partial redistribute)
    want = [Shard(0) if r else (Replicate() if q.is_partial() or (
        q.is_shard() and q.dim == 0) else q)
        for r, q in zip(rows, y.placements)]
    y = redistribute(y, want)
    places = [p if r else (Shard(lead) if q.is_shard() else q)
              for r, p, q in zip(rows, like.placements, want)]
    local = y.to_local()
    shape = like._local_tensor.shape[:-1] + (local.shape[-1],)
    return DTensor.from_local(local.reshape(shape), y.device_mesh, places,
                              run_check=False)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations [..., K] and a weight [K, N], through
    :func:`fold` where DTensor cannot flatten ``x``'s leading dims."""
    if not _folds(x):
        return x @ w
    return unfold(fold(x) @ w, x)


def gated_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, activation: str,
              pin: Optional[Callable] = None) -> torch.Tensor:
    """SwiGLU / GeGLU: (act(x@wg) * (x@wu)) @ wd; GeGLU's gelu is the tanh
    approximation, as ``jax.nn.gelu(approximate=True)``.  ``pin``, when
    given, constrains the sharding of ``x@wg`` (the reference pins it)."""
    g = linear(x, wg)
    u = linear(x, wu)
    if pin is not None:
        g = pin(g)
    if activation == "silu":
        g = F.silu(g)
    elif activation == "gelu":
        g = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return linear(g * u, wd)


def heads_whole(policy, w: torch.Tensor, heads: str,
                out: bool = False) -> torch.Tensor:
    """A projection weight ([d, heads, hd], or [heads, hd, d] with
    ``out``) sharded by its ``heads`` axis alone under ``policy`` (a
    ``ShardingPolicy``): its storage-only shards (``embed`` under FSDP, a
    head dim sharded where the heads do not divide) gathered, as GSPMD
    gathers them for the product.  DTensor cannot split a flattened
    heads x hd dim sharded over more ranks than there are heads, and
    against a sharded contraction dim it shards the product that way.  A
    no-op without a mesh."""
    if policy.mesh is None:
        return w
    logical = (heads, None, None) if out else (None, heads, None)
    want = policy.placements_of(policy.pin_spec(tuple(w.shape), *logical))
    if tuple(w.placements) == tuple(want):
        return w
    return policy.pin(w, *logical)


class _GradPlaced(torch.autograd.Function):
    """Identity on a DTensor whose backward reduces a pending sum in the
    gradient onto the input's own placement on that mesh dim (a
    reduce-scatter where the input is sharded there); the gradient's other
    mesh dims stay as they are."""

    @staticmethod
    def forward(ctx, w):
        ctx.mesh, ctx.placements = w.device_mesh, tuple(w.placements)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        want = tuple(p if g.is_partial() else g
                     for g, p in zip(grad.placements, ctx.placements))
        if tuple(grad.placements) == want:
            return grad
        return grad.redistribute(ctx.mesh, want)


def grad_placed(w: torch.Tensor) -> torch.Tensor:
    """``w`` itself, where ``w`` is a DTensor that autograd records, its
    gradient leaving no pending sum (:class:`_GradPlaced`): a weight used
    twice (a tied embedding: lookup and head) then sums two gradients none
    of which is pending.  DTensor in torch 2.11 cannot add a pending sum to
    a sharded gradient (it asks for a Shard -> Partial redistribute)."""
    if is_dtensor(w) and w.requires_grad and torch.is_grad_enabled():
        return _GradPlaced.apply(w)
    return w


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table``.  A DTensor table split over more than one rank
    goes through ``F.embedding``, whose sharding rule keeps a vocab-sharded
    table sharded (the result is pending a masked sum: pin it at once);
    any other table is indexed, whose backward sums a row's gradients in
    the order the plain model does.  A sharded table's gradient leaves the
    lookup on the table's placements (:func:`grad_placed`)."""
    if is_dtensor(table) and any(
            p.is_shard() and n > 1
            for p, n in zip(table.placements, table.device_mesh.shape)):
        return F.embedding(tokens, grad_placed(table))
    return table[tokens]


def logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """[B,S,d] @ [d,V] -> fp32 logits.  The products of two bf16 values are
    exact in fp32, so this equals an fp32-accumulated bf16 product."""
    return linear(upcast(x), upcast(head))
