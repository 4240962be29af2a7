"""Wrapper of the CUDA int8 GEMM (``csrc/quant_matmul.cu``).

Checks what the kernel takes, picks the kernel's body from the layout of
``w_q`` (:func:`plan`), allocates the output (and, at a small M, the int32
scratch of the split-K sums) and launches on the current stream.
``launches`` counts the launches made through it, so a run can show that
its path went through the kernel.

The kernel's native layout of ``w_q`` [K,N] is K-major (``stride(0) ==
1``, as ``w.t().contiguous().t()`` gives it): ``wgmma`` reads 8-bit
operands from shared memory only K-major, and TMA copies them as they are.
A row-major ``w_q`` (``stride(1) == 1``) runs the ``mma.sync`` body, which
transposes its tiles in shared memory; the result is the same, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel accumulates in int32: |acc| <= 128^2 K stays below 2^31 for
# every int8 input only up to this K.
K_MAX = (2 ** 31 - 1) // 128 ** 2

# Below this M the operands swap (out^T = w^T x^T) and the kernel splits K
# across blocks: the decode path.
SMALL_M = 64
PATHS = {"mma_sync": 0, "wgmma": 1, "wgmma_small": 2}

launches = 0


def w_layout(w_q: torch.Tensor) -> tuple:
    """("row", K stride) if w_q's N stride is 1, else ("k", N stride) if its
    K stride is 1; raises for any other layout.  A matrix with a single row
    or column may satisfy both: it counts as row-major."""
    if w_q.stride(1) == 1 or w_q.shape[1] == 1:
        return "row", w_q.stride(0)
    if w_q.stride(0) == 1 or w_q.shape[0] == 1:
        return "k", w_q.stride(1)
    raise ValueError(f"quant_matmul: w_q must have its K or its N stride 1, "
                     f"got strides {tuple(w_q.stride())}")


def plan(x_q: torch.Tensor, w_q: torch.Tensor) -> str:
    """The kernel body for these operands, from their layout and alignment
    only: "wgmma" (K-major w_q, M > SMALL_M), "wgmma_small" (K-major w_q,
    M <= SMALL_M) or "mma_sync" (a row-major w_q, or bases or row strides
    that TMA cannot take: not multiples of 16 bytes)."""
    layout, ldw = w_layout(w_q)
    tma = (layout == "k" and x_q.data_ptr() % 16 == 0
           and w_q.data_ptr() % 16 == 0 and x_q.stride(0) % 16 == 0
           and ldw % 16 == 0)
    if not tma:
        return "mma_sync"
    return "wgmma_small" if x_q.shape[0] <= SMALL_M else "wgmma"


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x_q: [M,K] int8; w_q: [K,N] int8; x_scale: [M] and w_scale: [N]
    fp32, all on one CUDA device.  Returns [M,N] in ``out_dtype``:
    ``(float(x_q @ w_q) * x_scale[:, None]) * w_scale[None, :]``.

    Any M, N >= 1 and 1 <= K <= K_MAX work (the kernel masks the ragged
    edges).  x_q's K stride must be 1; w_q's K stride (K-major, the
    kernel's native layout) or its N stride (row-major) must be 1; the
    scales must be contiguous."""
    global launches
    if x_q.dim() != 2 or w_q.dim() != 2 or x_scale.dim() != 1 \
            or w_scale.dim() != 1:
        raise ValueError(f"quant_matmul: bad ranks x_q {tuple(x_q.shape)}, "
                         f"w_q {tuple(w_q.shape)}, x_scale "
                         f"{tuple(x_scale.shape)}, w_scale "
                         f"{tuple(w_scale.shape)}")
    M, K = x_q.shape
    N = w_q.shape[1]
    if (w_q.shape[0] != K or tuple(x_scale.shape) != (M,)
            or tuple(w_scale.shape) != (N,)):
        raise ValueError(f"quant_matmul: shapes do not match: x_q "
                         f"{tuple(x_q.shape)}, w_q {tuple(w_q.shape)}, "
                         f"x_scale {tuple(x_scale.shape)}, w_scale "
                         f"{tuple(w_scale.shape)}")
    if min(M, N, K) < 1:
        raise ValueError(f"quant_matmul: empty product {M}x{K} by {K}x{N}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"quant_matmul: x_q and w_q must be int8, got "
                        f"{x_q.dtype}, {w_q.dtype}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul: scales must be float32, got "
                        f"{x_scale.dtype}, {w_scale.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"quant_matmul: out_dtype {out_dtype} is not one of "
                        f"float32/bfloat16")
    if K > K_MAX:
        raise ValueError(f"quant_matmul: K {K} > {K_MAX} could overflow the "
                         f"int32 accumulator")
    tensors = (x_q, w_q, x_scale, w_scale)
    if x_q.device.type != "cuda" or any(t.device != x_q.device
                                        for t in tensors):
        raise ValueError(f"quant_matmul: tensors must share one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if (x_q.stride(1) != 1 or not x_scale.is_contiguous()
            or not w_scale.is_contiguous()):
        raise ValueError("quant_matmul: the rows of x_q and the scales must "
                         "be contiguous")
    layout, ldw = w_layout(w_q)
    path = plan(x_q, w_q)
    lib = build.library("quant_matmul")
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    scratch = (torch.empty(M * N, dtype=torch.int32, device=x_q.device)
               if path == "wgmma_small" else None)
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        code = lib.quant_matmul_launch(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), M, N, K,
            x_q.stride(0), ldw, out.stride(0), int(layout == "k"),
            PATHS[path], OUT_DTYPES[out_dtype], stream)
    build.check("quant_matmul", code)
    launches += 1
    return out
