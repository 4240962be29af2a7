"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Checks what the kernel takes, allocates the output and launches on the
current stream.  ``launches`` counts the launches made through it, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 112, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] on one CUDA device -> [B,Sq,H,hd].

    Any S; the head_dim stride must be 1 (other strides are free)."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes one of float32/bfloat16")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors must share one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if min(Sq, Skv) < 1 or (causal and Sq > Skv):
        raise ValueError(f"flash_attention: needs 1 <= Sq (<= Skv when causal),"
                         f" got Sq {Sq}, Skv {Skv}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: head_dim must be contiguous")
    scale = scale if scale is not None else hd ** -0.5
    lib = build.library("flash_attention")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            float(scale), int(causal), DTYPES[q.dtype], stream)
    build.check("flash_attention", code)
    launches += 1
    return out
