"""Wrapper of the CUDA RMSNorm kernel (``csrc/rms_norm.cu``).

Checks what the kernel takes, allocates the output and launches on the
current stream.  ``launches`` counts the launches made through it, so a run
can show that its path went through the kernel (under CUDA graphs: eager
calls and captures, not replays).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

CHUNK = 8               # elements a thread loads at once: widths divide by it
MAX_WIDTH = 16384       # the widest group: 256 threads x 8 chunks of 8
_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` ([rows, d]) as it is: its last dim
    contiguous, its start and every row's on a 16-byte boundary."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and t.stride(0) * t.element_size() % 16 == 0)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, *,
             z: Optional[torch.Tensor] = None,
             group: Optional[int] = None) -> torch.Tensor:
    """x: [rows, d] and, where gated, z: [rows, d], each bf16 or fp32 with
    its rows 16-byte aligned; weight: [d], contiguous; ``group`` (with z
    only): the width of the groups normalised on their own, dividing d
    (default d).  Returns [rows, d] contiguous, of x's dtype, or z's where
    gated: ``ref.rms_norm_ref`` in one pass."""
    global launches
    tensors = (x, weight) + (() if z is None else (z,))
    if x.dim() != 2 or weight.dim() != 1 or (z is not None and z.dim() != 2):
        raise ValueError(f"rms_norm: bad ranks x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}"
                         + ("" if z is None else f", z {tuple(z.shape)}"))
    rows, d = x.shape
    if (tuple(weight.shape) != (d,)
            or (z is not None and z.shape != x.shape)):
        raise ValueError(f"rms_norm: shapes do not match: x {tuple(x.shape)},"
                         f" weight {tuple(weight.shape)}"
                         + ("" if z is None else f", z {tuple(z.shape)}"))
    if rows < 1:
        raise ValueError(f"rms_norm: empty input x {tuple(x.shape)}")
    if group is not None and z is None:
        raise ValueError("rms_norm: a group width is given with a gate only")
    g = d if group is None else int(group)
    if (g < 1 or d % g or g % CHUNK or d % CHUNK or g > MAX_WIDTH):
        raise ValueError(f"rms_norm: width d {d} and group {g} must be "
                         f"multiples of {CHUNK}, the group dividing d and at "
                         f"most {MAX_WIDTH}")
    if any(t.dtype not in _CODES for t in tensors):
        raise TypeError(f"rms_norm: the kernel takes float32 and bfloat16 "
                        f"only, got {[t.dtype for t in tensors]}")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"rms_norm: tensors must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if (not weight.is_contiguous() or weight.data_ptr() % 16
            or not all(rows_aligned(t) for t in tensors if t.dim() == 2)):
        raise ValueError("rms_norm: x and z need a contiguous last dim and "
                         "rows on 16-byte boundaries, weight contiguous and "
                         "16-byte aligned")
    lib = build.library("rms_norm")
    like = x if z is None else z
    out = torch.empty((rows, d), dtype=like.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.rms_norm_launch(
            x.data_ptr(), x.stride(0), _CODES[x.dtype],
            None if z is None else z.data_ptr(),
            0 if z is None else z.stride(0),
            _CODES[x.dtype if z is None else z.dtype],
            weight.data_ptr(), _CODES[weight.dtype], out.data_ptr(),
            _CODES[out.dtype], rows, d, g, build.sm_count(x.device),
            float(eps), stream)
    build.check("rms_norm", code)
    launches += 1
    return out
