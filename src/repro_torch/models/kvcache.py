"""Decode caches of every ported family.

A cache is a dict of per-layer lists, the JAX package's layout per layer
(it stacks them ``[L, ...]`` for its layer scan; a Python loop over layers
has no use for the stack):

* dense / moe / vlm / audio : ``{"k": [L x [B,S,KV,hd]], "v": [...]}``
  (every layer of an MoE model attends, its MoE layers too)
* ssm                 : ``{"ssm": [L x SSMLayerState]}``
* hybrid              : ``{"k": [G x [B,S,KV,hd]], "v": [...],
  "ssm": [L x SSMLayerState]}`` with G the number of shared-attention
  applications, each keeping its own KV cache (per Zamba2).
* hybrid_moe          : ``{"k": [A x ...], "v": [...], "ssm": [M x
  SSMLayerState]}``, A and M the attention and Mamba2 layers of
  ``layer_types``, each list in layer order.

``cache_len`` travels separately as a host int.  Under a sharding
policy with a mesh the KV caches are DTensors pinned
``("batch", "cache_seq", "kvheads", None)`` (:func:`cache_specs`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.sharding.policy import (NULL_POLICY, ShardingPolicy,
                                         is_dtensor, redistribute, seq_rank)

Cache = Dict[str, List]


def num_attn_applications(arch: ArchConfig) -> int:
    """How many attention layers need a KV cache."""
    if arch.family == "hybrid_moe":
        return arch.layer_types.count("attention")
    if arch.family == "ssm":
        return 0
    if arch.family == "hybrid":
        ae = arch.hybrid.attn_every
        return -(-arch.num_layers // ae)  # ceil
    return arch.num_layers


def num_ssm_layers(arch: ArchConfig) -> int:
    """How many layers keep a Mamba2 state."""
    if arch.ssm is None:
        return 0
    if arch.family == "hybrid_moe":
        return arch.layer_types.count("mamba")
    return arch.num_layers


def init_kv(arch: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype,
            device: torch.device,
            policy: Optional[ShardingPolicy] = None) -> Cache:
    """Zeroed KV caches of the attention applications (none for ssm),
    pinned by ``policy`` when it has a mesh."""
    policy = policy or NULL_POLICY
    n = num_attn_applications(arch)
    if not n:
        return {}
    shape = (batch, max_seq, arch.num_kv_heads, arch.head_dim)
    return {name: [policy.pin(torch.zeros(shape, dtype=dtype, device=device),
                              "batch", "cache_seq", "kvheads", None)
                   for _ in range(n)] for name in ("k", "v")}


def write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """``new`` [B,S,KV,hd] written IN PLACE into the first S positions of
    ``cache`` [B,max_seq,KV,hd].  A DTensor cache is written on its local
    shards (no ``F.pad`` or slice assignment of a DTensor, which torch
    2.11 refuses on a sharded dim): ``new`` goes to the cache's placements
    but whole on the mesh dims that shard the cache's positions, and each
    rank copies the positions its shard holds."""
    if not is_dtensor(cache):
        cache[:, :new.shape[1]] = new
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements)
           if p.is_shard() and p.dim == 1]
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = redistribute(new, [Replicate() if i in seq else p
                             for i, p in enumerate(cache.placements)])
    local = cache.to_local()
    S_local = local.shape[1]
    start = seq_rank(mesh, seq) * S_local
    n = min(max(new.shape[1] - start, 0), S_local)
    if n:
        local[:, :n] = new.to_local()[:, start:start + n]


def init_cache(arch: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype, device: torch.device,
               policy: Optional[ShardingPolicy] = None) -> Cache:
    """Zeroed caches for ``batch`` sequences of up to ``max_seq`` tokens
    (the KV caches pinned by ``policy`` when it has a mesh)."""
    cache = init_kv(arch, batch, max_seq, dtype, device, policy)
    if arch.ssm is not None:
        cache["ssm"] = [ssm_mod.init_layer_state(arch, batch, dtype, device)
                        for _ in range(num_ssm_layers(arch))]
    return cache


def cache_specs(arch: ArchConfig, policy: ShardingPolicy) -> Cache:
    """Specs of one layer's caches: the reference's ``cache_specs``
    without the leading ``"layers"`` entry (every entry of a list of
    per-layer caches has the same spec)."""
    sp = policy.spec
    specs: Cache = {}
    if num_attn_applications(arch):
        specs["k"] = sp("batch", "cache_seq", "kvheads", None)
        specs["v"] = sp("batch", "cache_seq", "kvheads", None)
    if arch.ssm is not None:
        specs["ssm"] = ssm_mod.state_specs(policy)
    return specs


def cache_bytes(arch: ArchConfig, batch: int, max_seq: int,
                dtype_bytes: int = 2) -> int:
    """Closed-form cache footprint (the formula of ``repro.models.kvcache``)."""
    total = 0
    n_attn = num_attn_applications(arch)
    if n_attn:
        total += (2 * n_attn * batch * max_seq * arch.num_kv_heads
                  * arch.head_dim * dtype_bytes)
    if arch.ssm is not None:
        s = arch.ssm
        nh, hd = s.num_heads(arch.d_model), s.head_dim
        n = num_ssm_layers(arch)
        total += n * batch * nh * hd * s.d_state * 4  # fp32
        total += n * batch * (s.conv_width - 1) * (
            nh * hd + 2 * s.d_state) * dtype_bytes
    return total
