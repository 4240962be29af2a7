"""Wrapper of the CUDA flash-decode kernel (``csrc/decode_attention.cu``).

Checks what the kernel takes, allocates the output and launches on the
current stream.  ``launches`` counts the launches made through it, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 112, 128, 256)
MAX_GROUP = 8          # query heads per kv head the kernel serves
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,1,H,hd]; caches [B,S,KV,hd] on one CUDA device -> [B,1,H,hd],
    attending to the first ``cache_len`` positions (a host int, 1..S)."""
    global launches
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    if (q.shape[0] != B or q.shape[1] != 1 or q.shape[3] != hd or KV == 0
            or H % KV):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not match "
                         f"caches {tuple(k_cache.shape)}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention: {H // KV} query heads per kv head;"
                         f" the kernel serves at most {MAX_GROUP}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if (q.dtype not in DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}; the kernel takes one of "
                        f"float32/bfloat16")
    if (q.device.type != "cuda" or k_cache.device != q.device
            or v_cache.device != q.device):
        raise ValueError(f"decode_attention: tensors must share one CUDA "
                         f"device, got {q.device}, {k_cache.device}, "
                         f"{v_cache.device}")
    cache_len = int(cache_len)
    if not 1 <= cache_len <= S:
        raise ValueError(f"decode_attention: cache_len {cache_len} not in "
                         f"[1, {S}]")
    if q.stride(3) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("decode_attention: head_dim must be contiguous")
    scale = scale if scale is not None else hd ** -0.5
    lib = build.library("decode_attention")
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), B, H, KV, hd, cache_len,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            out.stride(0), out.stride(2),
            float(scale), DTYPES[q.dtype], stream)
    build.check("decode_attention", code)
    launches += 1
    return out
