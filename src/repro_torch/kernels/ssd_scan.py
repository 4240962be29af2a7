"""Wrapper of the CUDA SSD-scan kernel (``csrc/ssd_scan.cu``).

Checks what the kernel takes, picks the width of the head-dim slice each
block owns (:func:`slice_plan`), allocates the outputs and the scratch of
each chunk's C B^T, and launches on the current stream (a first kernel for
C B^T, then the scan; one call is one counted launch).  ``launches`` counts the launches made through it, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
CHUNK = 64             # rows per chunk inside the kernel; any S is masked
MIN_SLICE = 16         # narrowest slice of hd a block owns (one mma row tile)
MAX_SLICE_DS128 = 32   # widest slice whose tiles fit shared memory at ds 128
# Blocks wanted per SM before hd is split further.  A block holds one SM
# (8 warps, up to 220 KiB of shared memory) and walks its chunks in order;
# each slice repeats the chunk's loads of B and C, the decay's scan and L,
# so splitting past two waves costs more than it fills (on an H100 at
# mamba2-130m's shape 768 blocks of P 16 run slower than 384 of P 32, at
# zamba2-7b's 1,792 of P 32 slower than 896 of P 64; chip_smoke.py's SSD
# rows time both).
BLOCKS_PER_SM = 2

launches = 0


def slice_plan(B: int, nh: int, hd: int, ds: int, sm_count: int) -> int:
    """The width P of the slice of hd each block owns: hd split into the
    fewest slices (1, 2 or 4, each at least MIN_SLICE wide) that give
    ``B * nh * slices >= BLOCKS_PER_SM * sm_count`` blocks, or the most
    that hd allows; at ds 128 at most MAX_SLICE_DS128 wide (shared memory).
    Every slice repeats the per-chunk work that does not depend on hd (the
    loads of B and C, the decay, L), so more slices cost work; y and the
    state's rows split exactly."""
    if min(B, nh, hd, ds, sm_count) < 1:
        raise ValueError(f"slice_plan: needs positive sizes, got B {B}, nh "
                         f"{nh}, hd {hd}, ds {ds}, sm_count {sm_count}")
    slices = 1
    while (hd // (2 * slices) >= MIN_SLICE and hd % (2 * slices) == 0
           and (B * nh * slices < BLOCKS_PER_SM * sm_count
                or (ds >= 128 and hd // slices > MAX_SLICE_DS128))):
        slices *= 2
    return hd // slices


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,nh,hd]; dt: [B,S,nh]; A: [nh]; Bm, Cm: [B,S,ds];
    init_state: [B,nh,hd,ds] or None; all fp32 on one CUDA device.
    Returns (y [B,S,nh,hd], final state [B,nh,hd,ds]).

    The kernel walks fixed chunks of ``CHUNK`` rows and masks the ragged
    last one, so any S works.  The innermost stride of x, dt, Bm and Cm
    must be 1; init_state must be contiguous."""
    global launches
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or A.dim() != 1:
        raise ValueError(f"ssd_scan: bad ranks x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    B, S, nh, hd = x.shape
    ds = Bm.shape[2]
    if (tuple(dt.shape) != (B, S, nh) or tuple(A.shape) != (nh,)
            or tuple(Bm.shape) != (B, S, ds) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: shapes do not match: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if min(B, S, nh) < 1:
        raise ValueError(f"ssd_scan: empty input x {tuple(x.shape)}")
    if hd not in HEAD_DIMS or ds not in STATE_DIMS:
        raise ValueError(f"ssd_scan: head_dim {hd} not in {HEAD_DIMS} or "
                         f"d_state {ds} not in {STATE_DIMS}")
    tensors = (x, dt, A, Bm, Cm) + ((init_state,) if init_state is not None
                                    else ())
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd_scan: the kernel takes float32 only, got "
                        f"{[t.dtype for t in tensors]}")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"ssd_scan: tensors must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if (x.stride(3) != 1 or dt.stride(2) != 1 or Bm.stride(2) != 1
            or Cm.stride(2) != 1 or not A.is_contiguous()):
        raise ValueError("ssd_scan: the innermost dims of x, dt, Bm, Cm and "
                         "A must be contiguous")
    if init_state is not None and (
            tuple(init_state.shape) != (B, nh, hd, ds)
            or not init_state.is_contiguous()):
        raise ValueError(f"ssd_scan: init_state must be a contiguous "
                         f"{(B, nh, hd, ds)}, got {tuple(init_state.shape)}")
    P = slice_plan(B, nh, hd, ds, build.sm_count(x.device))
    lib = build.library("ssd_scan")
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=x.device)
    final = torch.empty((B, nh, hd, ds), dtype=torch.float32, device=x.device)
    # C B^T of each (batch, chunk), shared by every head and slice
    cb = torch.empty((B, -(-S // CHUNK), CHUNK, CHUNK), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), final.data_ptr(), cb.data_ptr(), B, S, nh, hd, ds,
            P,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            y.stride(0), y.stride(1), y.stride(2), stream)
    build.check("ssd_scan", code)
    launches += 1
    return y, final
