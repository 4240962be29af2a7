"""Dispatch of the port's kernels by the device of the tensors they get.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version in ``ref``.  Nothing else
selects the path: no environment variable, and no fallback when a kernel
fails to build or launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B,Sq,H,hd] x [B,Skv,KV,hd]^2 -> [B,Sq,H,hd] (GQA, un-repeated KV)."""
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """[B,1,H,hd] vs caches [B,S,KV,hd] over ``cache_len`` positions."""
    if _on_cuda(q):
        return _decode.decode_attention(q, k_cache, v_cache, cache_len,
                                        scale=scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    scale=scale)
