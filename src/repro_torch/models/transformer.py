"""Dense transformer blocks (GQA/MQA/MHA + gated MLP).

PyTorch counterpart of ``repro.models.transformer``.  One ``DenseBlock``
holds one layer's parameters in the JAX package's per-layer layouts
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ...); the model runs its layers in a
Python loop.  ``impl`` picks the attention path: ``"kernel"`` goes through
``kernels.ops`` (the CUDA kernels on a CUDA tensor, their plain versions on
a CPU one), ``"plain"`` calls the plain versions directly, so the card can
run the same model both ways.

Sharding enters only through ``policy.pin`` calls at the reference's
places (a ``ShardingPolicy``; ``None`` or one without a mesh changes
nothing).  Under a mesh the parameters are DTensors, the attention runs on
local shards (``ops.on_shards``), and a decode step writes the new K/V
with the reference's one-hot select, an elementwise write that a
sequence-sharded cache takes without a collective.

An arch without rotary positions (``arch.rope`` False: Granite-4.0-H's
NoPE attention) skips them, and ``arch.attention_multiplier``, where it
is set, is the scale of the attention scores instead of ``1/sqrt(hd)``.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.sharding.policy import (NULL_POLICY, PartitionSpec,
                                         ShardingPolicy, redistribute)

def attn_shapes(arch: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter shapes of one layer's attention (``transformer.py``
    init_attn without the leading layer dim)."""
    d, H, KV, hd = (arch.d_model, arch.num_heads, arch.num_kv_heads,
                    arch.head_dim)
    shapes = {"attn_norm": (d,), "wq": (d, H, hd), "wk": (d, KV, hd),
              "wv": (d, KV, hd), "wo": (H, hd, d)}
    if arch.qkv_bias:
        shapes.update(bq=(H, hd), bk=(KV, hd), bv=(KV, hd))
    return shapes


def block_shapes(arch: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter shapes of one dense layer (``transformer.py`` init_attn and
    init_mlp without the leading layer dim)."""
    d, f = arch.d_model, arch.d_ff
    return {**attn_shapes(arch), "mlp_norm": (d,), "wg": (d, f),
            "wu": (d, f), "wd": (f, d)}


def attn_specs(arch: ArchConfig, policy: ShardingPolicy
               ) -> Dict[str, PartitionSpec]:
    """Specs of one layer's attention parameters: the reference's
    ``attn_specs`` without its leading ``"layers"`` entry."""
    sp = policy.spec
    p = {
        "attn_norm": sp(None),
        "wq": sp("embed", "qheads", "head_dim"),
        "wk": sp("embed", "kvheads", "head_dim"),
        "wv": sp("embed", "kvheads", "head_dim"),
        "wo": sp("qheads", "head_dim", "embed"),
    }
    if arch.qkv_bias:
        p["bq"] = sp("qheads", "head_dim")
        p["bk"] = sp("kvheads", "head_dim")
        p["bv"] = sp("kvheads", "head_dim")
    return p


def mlp_specs(arch: ArchConfig, policy: ShardingPolicy
              ) -> Dict[str, PartitionSpec]:
    sp = policy.spec
    return {
        "mlp_norm": sp(None),
        "wg": sp("embed", "ff"),
        "wu": sp("embed", "ff"),
        "wd": sp("ff", "embed"),
    }


def dense_block_specs(arch: ArchConfig, policy: ShardingPolicy
                      ) -> Dict[str, PartitionSpec]:
    return {**attn_specs(arch, policy), **mlp_specs(arch, policy)}


def init_scale(arch: ArchConfig, name: str) -> float:
    """Std of the normal init of one block parameter; 0 means zeros."""
    d, f = arch.d_model, arch.d_ff
    return {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
            "wo": (arch.num_heads * arch.head_dim) ** -0.5,
            "wg": d ** -0.5, "wu": d ** -0.5,
            # an arch whose MLPs are all MoE blocks has d_ff 0
            "wd": f ** -0.5 if f else 0.0}.get(name, 0.0)


def register_empty(module: nn.Module, shapes: Dict[str, Tuple[int, ...]],
                   device: torch.device, dtype: torch.dtype) -> None:
    """One uninitialised, frozen parameter per entry of ``shapes``."""
    for name, shape in shapes.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, device=device, dtype=dtype),
            requires_grad=False))


class DenseBlock(nn.Module):
    """One dense layer's parameters (attention + gated MLP)."""

    def __init__(self, arch: ArchConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        register_empty(self, block_shapes(arch), device, dtype)


def _project_qkv(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                 policy: ShardingPolicy = NULL_POLICY):
    B, S, _ = h.shape
    H, KV, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    wq, wk, wv = (layers.heads_whole(policy, w, heads) for w, heads in (
        (p.wq, "qheads"), (p.wk, "kvheads"), (p.wv, "kvheads")))
    q = layers.linear(h, wq.flatten(1)).view(B, S, H, hd)
    k = layers.linear(h, wk.flatten(1)).view(B, S, KV, hd)
    v = layers.linear(h, wv.flatten(1)).view(B, S, KV, hd)
    if arch.qkv_bias:           # before RoPE, as the reference does
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = policy.pin(q, "batch", "seq", "qheads", None)
    k = policy.pin(k, "batch", "seq", "kvheads", None)
    v = policy.pin(v, "batch", "seq", "kvheads", None)
    return q, k, v


def _rotate(x: torch.Tensor, positions: torch.Tensor,
            arch: ArchConfig) -> torch.Tensor:
    """``x`` at ``positions`` by rotary positions, where the arch has them."""
    return layers.apply_rope(x, positions, arch.rope_theta) if arch.rope \
        else x


def scaled(arch: ArchConfig) -> dict:
    """The attention calls' ``scale=`` where ``arch.attention_multiplier``
    is set; nothing (the kernels' ``1/sqrt(hd)``) where it is not."""
    m = arch.attention_multiplier
    return {"scale": m} if m else {}


def _attend(impl: str, kernel, plain, sharded: bool):
    """The attention call of ``impl``; under a mesh the plain version also
    runs on local shards, as the kernel does."""
    if impl == "kernel":
        return kernel
    return partial(ops.on_shards, plain) if sharded else plain


def attention_full(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                   positions: torch.Tensor, impl: str = "kernel",
                   policy: Optional[ShardingPolicy] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention over the whole sequence (prefill).

    Returns (output [B,S,d], (k, v) [B,S,KV,hd] for the cache).  K/V reach
    the attention un-repeated: the kernel maps query head h to kv head
    h // (H/KV) itself.  In context-parallel mode the narrow K/V are
    gathered over the sequence shards before the attention (pinned with
    the sequence unsharded), as the reference gathers them."""
    policy = policy or NULL_POLICY
    hn = layers.rms_norm(h, p.attn_norm, arch.norm_eps, impl)
    q, k, v = _project_qkv(hn, p, arch, policy)
    q, k = _rotate(q, positions, arch), _rotate(k, positions, arch)
    if policy.attn_mode == "context" and arch.q_per_kv > 1:
        k = policy.pin(k, "batch", None, "kvheads", None)
        v = policy.pin(v, "batch", None, "kvheads", None)
    attend = _attend(impl, ops.flash_attention, ref.flash_attention_ref,
                     policy.mesh is not None)
    out = attend(q, k, v, causal=True, **scaled(arch))
    out = policy.pin(out, "batch", "seq", "qheads", None)
    return attention_out(out, p, policy), (k, v)


def decode_qkv(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: torch.Tensor, index,
               policy: Optional[ShardingPolicy] = None,
               impl: str = "kernel") -> torch.Tensor:
    """The new token's rotated query [B,1,H,hd]; its K/V are written into
    the caches IN PLACE at ``index``: a host int, or a one-element int64
    tensor on the caches' device (which a captured CUDA graph reads when
    it is replayed).  ``pos``: [B, 1] int32 positions.  Under a mesh the
    write is the reference's one-hot select (``where(iota == index, new,
    cache)``), elementwise on a sequence-sharded cache, copied back into
    the cache.  ``impl`` routes the norm (:func:`layers.rms_norm`)."""
    policy = policy or NULL_POLICY
    hn = layers.rms_norm(h, p.attn_norm, arch.norm_eps, impl)
    q, k, v = _project_qkv(hn, p, arch, policy)
    q, k = _rotate(q, pos, arch), _rotate(k, pos, arch)
    if policy.mesh is not None:
        from torch.distributed.tensor import Replicate
        sel = (torch.arange(k_cache.shape[1], device=k_cache.device)
               == index)[None, :, None, None]
        for cache, new in ((k_cache, k), (v_cache, v)):
            # the token on the cache's placements, whole over the mesh
            # dims that shard the positions: the select then moves
            # nothing (torch 2.11's DTensor otherwise reshards the cache
            # to the token's head shards and back, two all-to-alls)
            new = redistribute(new.to(cache.dtype), [
                Replicate() if p.is_shard(1) else p
                for p in cache.placements])
            new = torch.where(sel, new, cache)
            cache.copy_(policy.pin(new, "batch", "cache_seq", "kvheads",
                                   None))
    elif isinstance(index, torch.Tensor):
        k_cache.index_copy_(1, index, k)
        v_cache.index_copy_(1, index, v)
    else:
        k_cache[:, index] = k[:, 0]
        v_cache[:, index] = v[:, 0]
    return q


def attention_out(o: torch.Tensor, p: DenseBlock,
                  policy: ShardingPolicy = NULL_POLICY) -> torch.Tensor:
    """The output projection of attention [B,S,H,hd] -> [B,S,d]."""
    wo = layers.heads_whole(policy, p.wo, "qheads", out=True)
    return layers.linear(o.flatten(2), wo.flatten(0, 1))


def attention_decode(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, impl: str = "kernel",
                     policy: Optional[ShardingPolicy] = None
                     ) -> torch.Tensor:
    """One-token attention against the KV cache ([B, Smax, KV, hd]).

    The new token's K/V is written into the caches IN PLACE at
    ``cache_len``.  On one device this replaces the JAX package's one-hot
    select (``where(iota == cache_len, new, cache)``), which keeps a
    sequence-sharded cache free of collectives: the in-place write moves
    one row instead of the cache.  Under a mesh the select is kept."""
    policy = policy or NULL_POLICY
    pos = torch.full((h.shape[0], 1), cache_len, dtype=torch.int32,
                     device=h.device)
    q = decode_qkv(h, p, arch, k_cache, v_cache, pos, cache_len, policy,
                   impl)
    attend = _attend(impl, ops.decode_attention, ref.decode_attention_ref,
                     policy.mesh is not None)
    return attention_out(attend(q, k_cache, v_cache, cache_len + 1,
                                **scaled(arch)), p, policy)


def mlp(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
        policy: Optional[ShardingPolicy] = None,
        impl: str = "kernel") -> torch.Tensor:
    """The gated MLP on the normalised h (``impl`` routes the norm)."""
    policy = policy or NULL_POLICY
    hn = layers.rms_norm(h, p.mlp_norm, arch.norm_eps, impl)
    return layers.gated_mlp(
        hn, p.wg, p.wu, p.wd, arch.mlp_activation,
        pin=lambda g: policy.pin(g, "batch", "seq", "ff"))


def dense_block_full(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                     positions: torch.Tensor, impl: str = "kernel",
                     policy: Optional[ShardingPolicy] = None):
    """Pre-norm residual block, full-sequence mode.  Returns (h, (k, v))."""
    policy = policy or NULL_POLICY
    a, kv = attention_full(h, p, arch, positions, impl, policy)
    h = h + a
    h = h + mlp(h, p, arch, policy, impl)
    return policy.pin(h, "batch", "seq", None), kv


def residual(h: torch.Tensor, x: torch.Tensor,
             policy: Optional[ShardingPolicy] = None) -> torch.Tensor:
    """``h + x`` for a decode step, pinned whole over the model axis: a
    pending sum in ``x`` (the out-projection's, the MLP's) is all-reduced,
    as GSPMD keeps the reference's one-token residual replicated.  Left to
    DTensor, the sum is reduce-scattered over the model dim and the next
    products gather their weights instead (the MLP's, the head's: two
    orders of magnitude more bytes a step at the reduced widths)."""
    return (policy or NULL_POLICY).pin(h + x, "batch", "seq", None)


def dense_block_decode(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       cache_len: int, impl: str = "kernel",
                       policy: Optional[ShardingPolicy] = None
                       ) -> torch.Tensor:
    """Pre-norm residual block for one token; updates the caches in place."""
    policy = policy or NULL_POLICY
    h = residual(h, attention_decode(h, p, arch, k_cache, v_cache, cache_len,
                                     impl, policy), policy)
    return residual(h, mlp(h, p, arch, policy, impl), policy)
