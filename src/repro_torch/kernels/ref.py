"""Plain PyTorch versions of the port's kernels.

They are the CPU path of ``ops`` and the oracles the CUDA kernels are held
against on the card.  Like ``repro.kernels.ref`` they are deliberately
naive: the whole ``S x S`` score matrix, fp32 math throughout, ``-1e30`` as
the mask value.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] (KV divides H). Naive softmax."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(B, Sq, KV, g, hd) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        mask = rows >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: int, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,1,H,hd]; caches [B,S,KV,hd]; softmax over the first
    ``cache_len`` cache positions."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float()[:, 0].reshape(B, KV, g, hd) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    valid = torch.arange(S, device=q.device) < cache_len
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
