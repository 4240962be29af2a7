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

``cache_len`` travels separately as a host int.  Under a sharding
policy with a mesh the KV caches are DTensors pinned
``("batch", "cache_seq", "kvheads", None)`` (:func:`cache_specs`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.sharding.policy import NULL_POLICY, ShardingPolicy

Cache = Dict[str, List]


def num_attn_applications(arch: ArchConfig) -> int:
    """How many attention layers need a KV cache."""
    if arch.family == "ssm":
        return 0
    if arch.family == "hybrid":
        ae = arch.hybrid.attn_every
        return -(-arch.num_layers // ae)  # ceil
    return arch.num_layers


def init_kv(arch: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype,
            device: torch.device) -> Cache:
    """Zeroed KV caches of the attention applications (none for ssm)."""
    n = num_attn_applications(arch)
    if not n:
        return {}
    shape = (batch, max_seq, arch.num_kv_heads, arch.head_dim)
    return {name: [torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(n)] for name in ("k", "v")}


def init_cache(arch: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype, device: torch.device,
               policy: Optional[ShardingPolicy] = None) -> Cache:
    """Zeroed caches for ``batch`` sequences of up to ``max_seq`` tokens
    (the KV caches pinned by ``policy`` when it has a mesh)."""
    policy = policy or NULL_POLICY
    cache = init_kv(arch, batch, max_seq, dtype, device)
    for name in ("k", "v"):
        if name in cache:
            cache[name] = [policy.pin(c, "batch", "cache_seq", "kvheads",
                                      None) for c in cache[name]]
    if arch.ssm is not None:
        cache["ssm"] = [ssm_mod.init_layer_state(arch, batch, dtype, device)
                        for _ in range(arch.num_layers)]
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
        total += arch.num_layers * batch * nh * hd * s.d_state * 4  # fp32
        total += arch.num_layers * batch * (s.conv_width - 1) * (
            nh * hd + 2 * s.d_state) * dtype_bytes
    return total
