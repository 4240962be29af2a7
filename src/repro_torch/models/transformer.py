"""Dense transformer blocks (GQA/MQA/MHA + gated MLP).

PyTorch counterpart of ``repro.models.transformer``.  One ``DenseBlock``
holds one layer's parameters in the JAX package's per-layer layouts
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ...); the model runs its layers in a
Python loop.  ``impl`` picks the attention path: ``"kernel"`` goes through
``kernels.ops`` (the CUDA kernels on a CUDA tensor, their plain versions on
a CPU one), ``"plain"`` calls the plain versions directly, so the card can
run the same model both ways.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

def block_shapes(arch: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter shapes of one dense layer (``transformer.py`` init_attn and
    init_mlp without the leading layer dim)."""
    d, H, KV, hd, f = (arch.d_model, arch.num_heads, arch.num_kv_heads,
                       arch.head_dim, arch.d_ff)
    shapes = {"attn_norm": (d,), "wq": (d, H, hd), "wk": (d, KV, hd),
              "wv": (d, KV, hd), "wo": (H, hd, d)}
    if arch.qkv_bias:
        shapes.update(bq=(H, hd), bk=(KV, hd), bv=(KV, hd))
    shapes.update(mlp_norm=(d,), wg=(d, f), wu=(d, f), wd=(f, d))
    return shapes


def init_scale(arch: ArchConfig, name: str) -> float:
    """Std of the normal init of one block parameter; 0 means zeros."""
    d, f = arch.d_model, arch.d_ff
    return {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
            "wo": (arch.num_heads * arch.head_dim) ** -0.5,
            "wg": d ** -0.5, "wu": d ** -0.5, "wd": f ** -0.5}.get(name, 0.0)


class DenseBlock(nn.Module):
    """One dense layer's parameters (attention + gated MLP)."""

    def __init__(self, arch: ArchConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        for name, shape in block_shapes(arch).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype),
                requires_grad=False))


def _project_qkv(h: torch.Tensor, p: DenseBlock, arch: ArchConfig):
    B, S, _ = h.shape
    H, KV, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    q = (h @ p.wq.flatten(1)).view(B, S, H, hd)
    k = (h @ p.wk.flatten(1)).view(B, S, KV, hd)
    v = (h @ p.wv.flatten(1)).view(B, S, KV, hd)
    if arch.qkv_bias:           # before RoPE, as the reference does
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def attention_full(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                   positions: torch.Tensor, impl: str = "kernel"
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention over the whole sequence (prefill).

    Returns (output [B,S,d], (k, v) [B,S,KV,hd] for the cache).  K/V reach
    the attention un-repeated: the kernel maps query head h to kv head
    h // (H/KV) itself."""
    hn = layers.rms_norm(h, p.attn_norm, arch.norm_eps)
    q, k, v = _project_qkv(hn, p, arch)
    q = layers.apply_rope(q, positions, arch.rope_theta)
    k = layers.apply_rope(k, positions, arch.rope_theta)
    attend = ops.flash_attention if impl == "kernel" else \
        ref.flash_attention_ref
    out = attend(q, k, v, causal=True)
    return attention_out(out, p), (k, v)


def decode_qkv(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: torch.Tensor, index) -> torch.Tensor:
    """The new token's rotated query [B,1,H,hd]; its K/V are written into
    the caches IN PLACE at ``index``: a host int, or a one-element int64
    tensor on the caches' device (which a captured CUDA graph reads when
    it is replayed).  ``pos``: [B, 1] int32 positions."""
    hn = layers.rms_norm(h, p.attn_norm, arch.norm_eps)
    q, k, v = _project_qkv(hn, p, arch)
    q = layers.apply_rope(q, pos, arch.rope_theta)
    k = layers.apply_rope(k, pos, arch.rope_theta)
    if isinstance(index, torch.Tensor):
        k_cache.index_copy_(1, index, k)
        v_cache.index_copy_(1, index, v)
    else:
        k_cache[:, index] = k[:, 0]
        v_cache[:, index] = v[:, 0]
    return q


def attention_out(o: torch.Tensor, p: DenseBlock) -> torch.Tensor:
    """The output projection of attention [B,S,H,hd] -> [B,S,d]."""
    return o.flatten(2) @ p.wo.flatten(0, 1)


def attention_decode(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, impl: str = "kernel"
                     ) -> torch.Tensor:
    """One-token attention against the KV cache ([B, Smax, KV, hd]).

    The new token's K/V is written into the caches IN PLACE at
    ``cache_len``.  This replaces the JAX package's one-hot select
    (``where(iota == cache_len, new, cache)``), which keeps a
    sequence-sharded cache free of collectives; one device needs no such
    trick, and the in-place write moves one row instead of the cache."""
    pos = torch.full((h.shape[0], 1), cache_len, dtype=torch.int32,
                     device=h.device)
    q = decode_qkv(h, p, arch, k_cache, v_cache, pos, cache_len)
    attend = ops.decode_attention if impl == "kernel" else \
        ref.decode_attention_ref
    return attention_out(attend(q, k_cache, v_cache, cache_len + 1), p)


def mlp(h: torch.Tensor, p: DenseBlock, arch: ArchConfig) -> torch.Tensor:
    hn = layers.rms_norm(h, p.mlp_norm, arch.norm_eps)
    return layers.gated_mlp(hn, p.wg, p.wu, p.wd, arch.mlp_activation)


def dense_block_full(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                     positions: torch.Tensor, impl: str = "kernel"):
    """Pre-norm residual block, full-sequence mode.  Returns (h, (k, v))."""
    a, kv = attention_full(h, p, arch, positions, impl)
    h = h + a
    return h + mlp(h, p, arch), kv


def dense_block_decode(h: torch.Tensor, p: DenseBlock, arch: ArchConfig,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       cache_len: int, impl: str = "kernel"
                       ) -> torch.Tensor:
    """Pre-norm residual block for one token; updates the caches in place."""
    h = h + attention_decode(h, p, arch, k_cache, v_cache, cache_len,
                             impl)
    return h + mlp(h, p, arch)
