"""Dispatch of the port's kernels by the device of the tensors they get.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version in ``ref``.  Nothing else
selects the path: no environment variable, and no fallback when a kernel
fails to build or launch.  The kernels have no backward: on a CUDA tensor,
a call under grad mode with an input that requires grad raises (its
result would carry no gradient), so training runs the plain versions
(``Model(impl="plain")``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import quant_matmul as _qmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {x.device}")


def _kernel_path(name: str, *inputs: Optional[torch.Tensor]) -> bool:
    """Whether ``name``'s call goes to its kernel (its first input is on
    the card); raises there if autograd would need the kernel's backward."""
    if not _on_cuda(inputs[0]):
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; train with Model(impl='plain')")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B,Sq,H,hd] x [B,Skv,KV,hd]^2 -> [B,Sq,H,hd] (GQA, un-repeated KV)."""
    if _kernel_path("flash_attention", q, k, v):
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """[B,1,H,hd] vs caches [B,S,KV,hd] over ``cache_len`` positions."""
    if _kernel_path("decode_attention", q, k_cache, v_cache):
        return _decode.decode_attention(q, k_cache, v_cache, cache_len,
                                        scale=scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD over [B,S,nh,hd] -> (y, final state [B,nh,hd,ds]).
    ``chunk`` sets the plain version's chunk; the kernel walks fixed
    64-row chunks (the result is the same up to rounding)."""
    if _kernel_path("ssd_scan", x, dt, A, Bm, Cm, init_state):
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, init_state=init_state)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 [M,K] x int8 [K,N] -> ``out_dtype`` [M,N] with row/col scales."""
    if _kernel_path("quant_matmul", x_q, w_q, x_scale, w_scale):
        return _qmm.quant_matmul(x_q, w_q, x_scale, w_scale,
                                 out_dtype=out_dtype)
    return ref.quant_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation (plain PyTorch on either device, as the
    JAX package computes it outside any kernel)."""
    return ref.quantize_int8(x, axis)


def quant_linear(x: torch.Tensor, w_q: torch.Tensor,
                 w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation-quant linear: quantise x per row on the fly and
    run the int8 product.  x: [..., K]; w_q: [K, N] int8; w_scale: [N]."""
    shape = x.shape
    x_q, x_scale = ref.quantize_int8(x.reshape(-1, shape[-1]), axis=-1)
    out = quant_matmul(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32)
    return out.reshape(shape[:-1] + (w_q.shape[1],)).to(x.dtype)
