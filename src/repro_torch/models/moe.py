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
globally, and ``"auto"`` is ``"grouped"`` on one device (the reference
picks ``"global"`` only when the sequence is sharded).  Nothing here reads
a value back to the host.

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
from repro_torch.models import layers
from repro_torch.models import transformer as tfm

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
    logits = layers.upcast(x) @ layers.upcast(blk.router)
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


def _expert_ffn(xb: torch.Tensor, blk: MoEBlock,
                arch: ArchConfig) -> torch.Tensor:
    """Batched expert MLP over the leading E dim: xb [E, ..., d] (the extra
    dims fold into the rows of each expert's product)."""
    E, d = xb.shape[0], xb.shape[-1]
    y = layers.gated_mlp(xb.reshape(E, -1, d), blk.we_g, blk.we_u, blk.we_d,
                         arch.mlp_activation)
    return y.reshape(xb.shape)


def _dispatch_grouped(x: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                      routes: Optional[List[Routes]] = None) -> torch.Tensor:
    """Per-group dispatch: x [G, N, d] -> [G, N, d], each batch row a group
    (G = B).  Per group, the capacity is :func:`capacity` of N, ranks run
    over the group's own (token, k) order, and dropped rows write zeros to
    the sentinel row ``E*cap``."""
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
    xe = buf[:, :E * cap].reshape(G, E, cap, d).transpose(0, 1)

    ye = _expert_ffn(xe, blk, arch)                         # [E, G, cap, d]

    ybuf = torch.cat([ye.transpose(0, 1).reshape(G, E * cap, d),
                      x.new_zeros(G, 1, d)], dim=1)
    yk = torch.gather(ybuf, 1, at)
    yk = yk * (keep * gate.reshape(G, N * K)).to(x.dtype).unsqueeze(-1)
    return yk.reshape(G, N, K, d).sum(2)


def _dispatch_global(x: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                     routes: Optional[List[Routes]] = None) -> torch.Tensor:
    """Single-group dispatch over N = B*S tokens: x [N, d] -> [N, d], the
    grouped dispatch of one group."""
    return _dispatch_grouped(x.unsqueeze(0), blk, arch, routes)[0]


def _shared_expert(hn: torch.Tensor, blk: MoEBlock,
                   arch: ArchConfig) -> torch.Tensor:
    """The shared expert on the normed input."""
    return layers.gated_mlp(hn, blk.ws_g, blk.ws_u, blk.ws_d,
                            arch.mlp_activation)


def moe_mlp(h: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
            dispatch: str = "grouped",
            routes: Optional[List[Routes]] = None) -> torch.Tensor:
    """[B, S, d] -> [B, S, d]: top-k routed experts (+ the shared expert)
    on ``rms_norm(h, moe_norm)``.  ``routes``, when given, receives this
    layer's :class:`Routes` (device tensors; nothing is synchronised)."""
    B, S, d = h.shape
    hn = layers.rms_norm(h, blk.moe_norm, arch.norm_eps)
    if dispatch == "global" or B == 1:
        y = _dispatch_global(hn.reshape(B * S, d), blk, arch,
                             routes).reshape(B, S, d)
    else:                       # "auto" on one device: no sequence sharding
        y = _dispatch_grouped(hn, blk, arch, routes)
    if arch.moe.shared_expert:
        y = y + _shared_expert(hn, blk, arch)
    return y


def moe_block_full(h: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                   positions: torch.Tensor, impl: str = "kernel",
                   dispatch: str = "grouped"):
    """Attention + MoE MLP block, full-sequence mode.  Returns (h, (k, v))."""
    a, kv = tfm.attention_full(h, blk, arch, positions, impl)
    h = h + a
    return h + moe_mlp(h, blk, arch, dispatch), kv


def moe_block_decode(h: torch.Tensor, blk: MoEBlock, arch: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, impl: str = "kernel",
                     dispatch: str = "grouped") -> torch.Tensor:
    """Attention + MoE MLP block for one token; updates the caches in
    place."""
    h = h + tfm.attention_decode(h, blk, arch, k_cache, v_cache, cache_len,
                                 impl)
    return h + moe_mlp(h, blk, arch, dispatch)
