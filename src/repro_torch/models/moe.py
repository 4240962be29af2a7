"""Mixture-of-experts layer (llama4-style: top-k routed + shared expert).

PyTorch counterpart of ``repro.models.moe``, computing what it computes:
dispatch is the sort-free *rank-in-expert* scatter into capacity buffers.

1. the router picks the top-k experts of each token (fp32 softmax, then
   top-k, then the k gates renormalised),
2. each (token, k)'s *rank* within its expert is an exclusive cumsum of
   the one-hot dispatch matrix over the flattened (token, k) order,
3. rows scatter into an ``[E, cap, d]`` buffer per group; a rank at or past
   ``cap`` drops the row (GShard's capacity factor) to a sentinel row,
4. the experts run as batched products over the leading E dim,
5. results gather back through the same slots, scaled by the gate.

``"grouped"`` dispatch (the default) takes each batch row as a group,
``"global"`` takes all B*S tokens as one; a batch of one always dispatches
globally, and ``"auto"`` is ``"global"`` only when the policy shards the
sequence, as the reference picks it.  Nothing here reads a value back to
the host.

Under a policy with a mesh the reference's pins apply: tokens pinned by
group, the capacity buffer moved from group-sharded to expert-sharded for
the expert products (DTensor matmuls on expert-parallel weights), and back.
DTensor has no sharding rule for the rank cumsum and the capacity scatter
and gather, so routing + scatter and the combine run on local shards
(``kernels.ops.run_local``) over placements on which each group is whole.

The expert products are plain batched matrix products (``torch.matmul`` on
``[E, rows, d]`` stacks), as the reference computes them with einsums
outside any Pallas kernel.  The block's attention is the dense one,
through ``transformer.attention_full`` / ``attention_decode``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.sharding.policy import (NULL_POLICY, PartitionSpec,
                                         ShardingPolicy)

DISPATCHES = ("auto", "grouped", "global")
EXPERT_WEIGHTS = ("we_g", "we_u", "we_d")   # [E, ...]: drawn one at a time


def capacity(arch: ArchConfig, n_tokens: int) -> int:
    """Rows per expert in a group of ``n_tokens`` tokens: GShard's capacity
    factor, ``round_up(max(int(cf*K*N/E), 1), 8)``."""
    m = arch.moe
    cap = max(int(m.capacity_factor * m.experts_per_token * n_tokens
                  / m.num_experts), 1)
    return (cap + 7) // 8 * 8


def moe_shapes(arch: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the MoE parameters of one layer (``moe.py`` init_moe
    without the leading layer dim)."""
    m = arch.moe
    d, fe, E = arch.d_model, m.d_ff_expert, m.num_experts
    shapes = {"moe_norm": (d,), "router": (d, E), "we_g": (E, d, fe),
              "we_u": (E, d, fe), "we_d": (E, fe, d)}
    if m.shared_expert:
        shapes.update(ws_g=(d, fe), ws_u=(d, fe), ws_d=(fe, d))
    return shapes


def moe_specs(arch: ArchConfig, policy: ShardingPolicy
              ) -> Dict[str, PartitionSpec]:
    """Specs of one layer's MoE parameters: the reference's ``moe_specs``
    without its leading ``"layers"`` entry."""
    sp = policy.spec
    p = {
        "moe_norm": sp(None),
        "router": sp("embed", None),
        "we_g": sp("experts", "expert_embed", "expert_ff"),
        "we_u": sp("experts", "expert_embed", "expert_ff"),
        "we_d": sp("experts", "expert_ff", "expert_embed"),
    }
    if arch.moe.shared_expert:
        p["ws_g"] = sp("embed", "ff")
        p["ws_u"] = sp("embed", "ff")
        p["ws_d"] = sp("ff", "embed")
    return p


def init_scale(arch: ArchConfig, name: str) -> float:
    """Std of the normal init of one MoE-block parameter; 0 means zeros."""
    if name in tfm.attn_shapes(arch):
        return tfm.init_scale(arch, name)
    d, fe = arch.d_model, arch.moe.d_ff_expert
    return {"router": d ** -0.5, "we_g": d ** -0.5, "we_u": d ** -0.5,
            "we_d": fe ** -0.5, "ws_g": d ** -0.5, "ws_u": d ** -0.5,
            "ws_d": fe ** -0.5}.get(name, 0.0)


class MoEBlock(nn.Module):
    """One MoE layer's parameters: attention under ``DenseBlock``'s names,
    then ``moe_norm``, ``router [d,E]``, ``we_g/we_u [E,d,fe]``,
    ``we_d [E,fe,d]`` and, with a shared expert, ``ws_g/ws_u [d,fe]``,
    ``ws_d [fe,d]``."""

    def __init__(self, arch: ArchConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        tfm.register_empty(self, {**tfm.attn_shapes(arch), **moe_shapes(arch)},
                           device, dtype)


class Routes(NamedTuple):
    """One MoE layer's dispatch over G groups of N tokens (G = 1 when
    global), for reports: ``probs`` [G, N, E] the fp32 router
    probabilities, ``idx`` [G, N, K] the chosen experts, ``keep`` and
    ``slot`` [G, N*K] in (token, k) order."""
    probs: torch.Tensor
    idx: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def _route(x: torch.Tensor, blk: MoEBlock, arch: ArchConfig):
    """fp32 routing -> (gate, idx, probs): top-k over the last dim, the k
    gates renormalised to sum to one."""
    logits = layers.linear(layers.upcast(x), layers.upcast(blk.router))
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, arch.moe.experts_per_token, dim=-1)
    return gate / gate.sum(-1, keepdim=True), idx, probs


def _ranks(idx: torch.Tensor, E: int) -> torch.Tensor:
    """[..., N, K] expert ids -> [..., N*K] rank of each (token, k) within
    its expert: the exclusive cumsum of the one-hot over (token, k)."""
    flat = (idx.flatten(-2).unsqueeze(-1)
            == torch.arange(E, device=idx.device)).to(torch.int32)
    rank = torch.cumsum(flat, dim=-2) - flat
    return (rank * flat).sum(-1)


class _Router(NamedTuple):
    """A block's router alone (what :func:`_route` reads)."""
    router: torch.Tensor


def _expert_ffn(xb: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                policy: ShardingPolicy = NULL_POLICY,
                groups: Optional[str] = None) -> torch.Tensor:
    """Batched expert MLP over the leading E dim: xb [E, ..., d] (the extra
    dims fold into the rows of each expert's product).  ``groups`` is the
    logical axis of the rows (their group-major order), for the pins."""
    E, d = xb.shape[0], xb.shape[-1]
    y = layers.gated_mlp(
        xb.reshape(E, -1, d), blk.we_g, blk.we_u, blk.we_d,
        arch.mlp_activation,
        pin=lambda g: policy.pin(g, "experts", groups, "expert_ff"))
    return policy.pin(y.reshape(xb.shape), "experts", groups,
                      *(None,) * (xb.dim() - 2))


def _scatter(x: torch.Tensor, blk, arch: ArchConfig,
             routes: Optional[List[Routes]] = None):
    """Routing and the capacity scatter of x [G, N, d]: (the buffer
    [G, E, cap, d], each (token, k)'s slot [G, N*K], and its weight, the
    gate where kept and 0 where dropped, in x's dtype)."""
    m = arch.moe
    G, N, d = x.shape
    E, K = m.num_experts, m.experts_per_token
    gate, idx, probs = _route(x, blk, arch)                 # [G, N, K]
    cap = capacity(arch, N)
    rank = _ranks(idx, E)                                   # [G, N*K]
    expert = idx.reshape(G, N * K)
    keep = rank < cap
    slot = torch.where(keep, expert * cap + rank,
                       torch.full_like(rank, E * cap))
    if routes is not None:
        routes.append(Routes(probs, idx, keep, slot))

    xk = x.repeat_interleave(K, dim=1)                      # [G, N*K, d]
    at = slot.unsqueeze(-1).expand(G, N * K, d)
    buf = x.new_zeros(G, E * cap + 1, d).scatter_(
        1, at, torch.where(keep.unsqueeze(-1), xk, 0))
    weight = (keep * gate.reshape(G, N * K)).to(x.dtype)
    return buf[:, :E * cap].reshape(G, E, cap, d), slot, weight


def _combine(yb: torch.Tensor, slot: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """The experts' rows [G, E, cap, d] gathered back through the slots
    (the sentinel slot reads zeros), scaled by the weights -> [G, N*K, d]
    in (token, k) order."""
    G, E, cap, d = yb.shape
    NK = slot.shape[1]
    ybuf = torch.cat([yb.reshape(G, E * cap, d), yb.new_zeros(G, 1, d)],
                     dim=1)
    yk = torch.gather(ybuf, 1, slot.unsqueeze(-1).expand(G, NK, d))
    return yk * weight.unsqueeze(-1)


def _dispatch_grouped(x: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                      routes: Optional[List[Routes]] = None,
                      policy: ShardingPolicy = NULL_POLICY,
                      grouped: bool = True) -> torch.Tensor:
    """Per-group dispatch: x [G, N, d] -> [G, N, d], each batch row a group
    (G = B).  Per group, the capacity is :func:`capacity` of N, ranks run
    over the group's own (token, k) order, and dropped rows write zeros to
    the sentinel row ``E*cap``.  Under a mesh (``grouped=False``: the
    global dispatch, one replicated group) the reference's pins apply."""
    K = arch.moe.experts_per_token
    G, N, d = x.shape
    if policy.mesh is None:
        xb, slot, weight = _scatter(x, blk, arch, routes)
        ye = _expert_ffn(xb.transpose(0, 1), blk, arch)     # [E, G, cap, d]
        return _combine(ye.transpose(0, 1), slot, weight).reshape(
            G, N, K, d).sum(2)
    mesh = policy.mesh
    x = policy.pin(x, "batch" if grouped else None, None, None)
    p = tuple(x.placements)
    from torch.distributed.tensor import Replicate
    full = (Replicate(),) * mesh.ndim
    E, cap = arch.moe.num_experts, capacity(arch, N)
    xb, slot, weight = ops.run_local(
        lambda xl, r: _scatter(xl, _Router(r), arch), mesh,
        (x, blk.router), (p, full), (p, p, p),
        ((G, E, cap, d), (G, N * K), (G, N * K)))
    if grouped:
        xb = policy.pin(xb, "token_groups", None, None, None)
    xe = policy.pin(xb.transpose(0, 1), "experts",
                    "token_groups_data" if grouped else None, None, None)
    ye = _expert_ffn(xe, blk, arch, policy,
                     "token_groups_data" if grouped else None)
    yb = ye.transpose(0, 1)
    if grouped:
        yb = policy.pin(yb, "token_groups", None, None, None)
    q = tuple(yb.placements) if grouped else full
    y = ops.run_local(_combine, mesh, (yb, slot, weight), (q, q, q), (q,),
                      ((G, N * K, d),))
    return y.reshape(G, N, K, d).sum(2)


def _dispatch_global(x: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                     routes: Optional[List[Routes]] = None,
                     policy: ShardingPolicy = NULL_POLICY) -> torch.Tensor:
    """Single-group dispatch over N = B*S tokens: x [N, d] -> [N, d], the
    grouped dispatch of one group."""
    return _dispatch_grouped(x.unsqueeze(0), blk, arch, routes, policy,
                             grouped=False)[0]


def _shared_expert(hn: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                   policy: ShardingPolicy = NULL_POLICY) -> torch.Tensor:
    """The shared expert on the normed input."""
    return layers.gated_mlp(
        hn, blk.ws_g, blk.ws_u, blk.ws_d, arch.mlp_activation,
        pin=lambda g: policy.pin(g, "batch", "seq", "ff"))


def moe_mlp(h: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
            dispatch: str = "grouped",
            routes: Optional[List[Routes]] = None,
            policy: Optional[ShardingPolicy] = None) -> torch.Tensor:
    """[B, S, d] -> [B, S, d]: top-k routed experts (+ the shared expert)
    on ``rms_norm(h, moe_norm)``.  ``routes``, when given, receives this
    layer's :class:`Routes` (device tensors; nothing is synchronised;
    not under a mesh)."""
    policy = policy or NULL_POLICY
    B, S, d = h.shape
    hn = layers.rms_norm(h, blk.moe_norm, arch.norm_eps)
    if dispatch == "auto":
        dispatch = "global" if policy.rules.get("seq") else "grouped"
    if dispatch == "global" or B == 1:
        # one group in the reference's batch-major token order (capacity
        # ranks run over it): the dispatch replicates its rows anyway, so
        # they are gathered before the flatten, not after; the result is
        # pinned back after its unflatten, so that the gradient reaches
        # the unflatten replicated (torch 2.11 cannot flatten a seq-
        # sharded one)
        flat = policy.pin(hn, None, None, None).reshape(B * S, d)
        y = policy.pin(_dispatch_global(flat, blk, arch, routes,
                                        policy).reshape(B, S, d),
                       "batch", "seq", None)
    else:
        y = _dispatch_grouped(hn, blk, arch, routes, policy)
    if arch.moe.shared_expert:
        y = y + _shared_expert(hn, blk, arch, policy)
    return y


def _mlp(h, blk, arch, dispatch, policy: ShardingPolicy):
    """:func:`moe_mlp` as the blocks call it: the policy is passed only
    when it has a mesh, so a wrapper of the four-argument call (a route
    log) sees the call it wraps."""
    if policy.mesh is None:
        return moe_mlp(h, blk, arch, dispatch)
    return moe_mlp(h, blk, arch, dispatch, policy=policy)


def moe_block_full(h: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                   positions: torch.Tensor, impl: str = "kernel",
                   dispatch: str = "grouped",
                   policy: Optional[ShardingPolicy] = None):
    """Attention + MoE MLP block, full-sequence mode.  Returns (h, (k, v))."""
    policy = policy or NULL_POLICY
    a, kv = tfm.attention_full(h, blk, arch, positions, impl, policy)
    h = h + a
    h = h + _mlp(h, blk, arch, dispatch, policy)
    return policy.pin(h, "batch", "seq", None), kv


def moe_block_decode(h: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, impl: str = "kernel",
                     dispatch: str = "grouped",
                     policy: Optional[ShardingPolicy] = None) -> torch.Tensor:
    """Attention + MoE MLP block for one token; updates the caches in
    place."""
    h = h + tfm.attention_decode(h, blk, arch, k_cache, v_cache, cache_len,
                                 impl, policy)
    return h + _mlp(h, blk, arch, dispatch, policy or NULL_POLICY)
