"""Wrapper of the CUDA SSD decode-step kernel (``csrc/ssd_step.cu``).

Checks what the kernel takes, allocates y (and the new state, unless
``out`` is given), and launches on the current stream.  ``launches`` counts
the launches made through it, so a run can show that its path went through
the kernel (under CUDA graphs: eager calls and captures, not replays).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# hd 64 is every served model's; 32 and 16 are its slices on 2 or 4 ranks
# of a mesh that shards the state's head dim
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (64, 128)       # zamba2-7b; mamba2-130m and Granite-4.0-H

launches = 0


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the bytes of two contiguous tensors overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor, *, out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,nh,hd]; dt: [B,nh] (softplus'd); A, D: [nh]; Bm, Cm: [B,ds];
    state: [B,nh,hd,ds]; all fp32, contiguous, on one CUDA device.
    Returns (y [B,nh,hd], the new state): ``out`` ([B,nh,hd,ds], which may
    be ``state`` itself: updated in place) or a new tensor."""
    global launches
    if (x.dim() != 3 or dt.dim() != 2 or A.dim() != 1 or Bm.dim() != 2
            or D.dim() != 1 or state.dim() != 4):
        raise ValueError(f"ssd_step: bad ranks x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, D {tuple(D.shape)}, state "
                         f"{tuple(state.shape)}")
    B, nh, hd = x.shape
    ds = Bm.shape[1]
    if (tuple(dt.shape) != (B, nh) or tuple(A.shape) != (nh,)
            or tuple(D.shape) != (nh,) or tuple(Bm.shape) != (B, ds)
            or Cm.shape != Bm.shape
            or tuple(state.shape) != (B, nh, hd, ds)
            or (out is not None and out.shape != state.shape)):
        raise ValueError(f"ssd_step: shapes do not match: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)}, state {tuple(state.shape)}"
                         + ("" if out is None
                            else f", out {tuple(out.shape)}"))
    if min(B, nh) < 1:
        raise ValueError(f"ssd_step: empty input x {tuple(x.shape)}")
    if hd not in HEAD_DIMS or ds not in STATE_DIMS:
        raise ValueError(f"ssd_step: head_dim {hd} not in {HEAD_DIMS} or "
                         f"d_state {ds} not in {STATE_DIMS}")
    tensors = (x, dt, A, Bm, Cm, D, state) + (() if out is None else (out,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd_step: the kernel takes float32 only, got "
                        f"{[t.dtype for t in tensors]}")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"ssd_step: tensors must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_step: every input (and out) must be contiguous")
    if any(t.data_ptr() % 16 for t in (Bm, Cm, state) + tensors[7:]):
        raise ValueError("ssd_step: Bm, Cm, state and out must start on a "
                         "16-byte boundary")
    if (out is not None and out.data_ptr() != state.data_ptr()
            and _overlap(out, state)):
        raise ValueError("ssd_step: out must be the state itself or not "
                         "overlap it")
    lib = build.library("ssd_step")
    y = torch.empty((B, nh, hd), dtype=torch.float32, device=x.device)
    new = torch.empty_like(state) if out is None else out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_step_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), state.data_ptr(), new.data_ptr(),
            y.data_ptr(), B, nh, hd, ds, stream)
    build.check("ssd_step", code)
    launches += 1
    return y, new
