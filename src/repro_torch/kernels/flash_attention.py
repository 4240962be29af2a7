"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Checks what the kernel takes, allocates the output and launches on the
current stream.  ``launches`` counts the launches made through it, so a run
can show that its path went through the kernel.  bfloat16 runs the wgmma
body fed by TMA, which needs 16-byte-aligned bases and strides (a tensor
that fails raises ``ValueError``; nothing is copied); float32 runs the
FP32-FMA body.
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

    Any S; the head_dim stride must be 1.  Other strides are free in
    float32; in bfloat16 the bases must be 16-byte aligned and the strides
    whole multiples of 16 bytes (``ValueError`` otherwise)."""
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
    if q.dtype == torch.bfloat16:
        qs, ks, vs = (_tma_strides(n, t) for n, t in (("q", q), ("k", k),
                                                       ("v", v)))
    else:
        qs, ks, vs = (t.stride()[:3] for t in (q, k, v))
    scale = scale if scale is not None else hd ** -0.5
    lib = build.library("flash_attention")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, hd,
            *qs, *ks, *vs,
            out.stride(0), out.stride(1), out.stride(2),
            float(scale), int(causal), DTYPES[q.dtype], stream)
    build.check("flash_attention", code)
    launches += 1
    return out


def _tma_strides(name: str, t: torch.Tensor) -> tuple:
    """Strides of dims 0-2 of a bf16 [B, S, heads, hd] tensor as the TMA
    map takes them.  TMA reads a 16-byte-aligned base with strides that are
    multiples of 16 bytes (8 elements); the stride of a dim of size 1 is
    never stepped, so it is given its contiguous value.  Raises
    ``ValueError`` on a tensor that fails."""
    _, S, H, hd = t.shape
    strides = tuple(st if n > 1 else c for st, n, c in
                    zip(t.stride()[:3], t.shape[:3], (S * H * hd, H * hd, hd)))
    if t.data_ptr() % 16 or any(st % 8 for st in strides):
        raise ValueError(f"flash_attention: bf16 {name} needs a 16-byte-aligned"
                         f" base and strides of whole 16 bytes, got address "
                         f"{t.data_ptr():#x}, strides {t.stride()}")
    return strides
