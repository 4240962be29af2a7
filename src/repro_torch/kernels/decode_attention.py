"""Wrapper of the CUDA split-KV flash-decode (``csrc/decode_attention.cu``).

Checks what the kernels take, plans the split of the cache on the host
(:func:`split_plan`), allocates the output and the fp32 scratch of the
partials and launches on the current stream.  One call enqueues two
kernels: the split kernel and, with more than one split, the merge kernel.
``launches`` counts the calls made through it (one per call), so a run can
show that its path went through the kernels.

:func:`decode_attention_partial` is one cache shard's share of a decode
step (its output and log-sum-exp), which a rank of a mesh whose cache is
sequence-sharded computes before the ranks merge their shares
(``ops``); ``partial_launches`` counts its launches.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 112, 128, 256)
MAX_GROUP = 8          # query heads per kv head the kernel serves
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_UNIT = 64        # a split is a whole number of 64-position tiles
BLOCKS_PER_SM = 2      # the split kernel's grid aims at this many blocks an SM

launches = 0
partial_launches = 0


def split_plan(B: int, KV: int, cache_len: int,
               sm_count: int) -> Tuple[int, int]:
    """(split length, number of splits) for a cache of ``cache_len``
    positions: the splits cover ``[0, cache_len)`` once, none is empty, the
    length is a multiple of 64, and splits x KV x B reaches
    ``BLOCKS_PER_SM * sm_count`` blocks wherever ``ceil(cache_len / 64) x B
    x KV`` allows it (else every split is one tile)."""
    if min(B, KV, cache_len, sm_count) < 1:
        raise ValueError(f"split_plan: needs positive sizes, got B {B}, KV "
                         f"{KV}, cache_len {cache_len}, sm_count {sm_count}")
    tiles = -(-cache_len // SPLIT_UNIT)
    wanted = -(-BLOCKS_PER_SM * sm_count // (B * KV))
    split_len = SPLIT_UNIT * max(1, tiles // wanted)
    return split_len, -(-cache_len // split_len)


def _checked(name: str, q: torch.Tensor, k_cache: torch.Tensor,
             v_cache: torch.Tensor, cache_len: int, lowest: int = 1,
             what: str = "cache_len") -> int:
    """What the kernels take, checked; returns ``cache_len`` as an int in
    ``lowest..S``."""
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    if (q.shape[0] != B or q.shape[1] != 1 or q.shape[3] != hd or KV == 0
            or H % KV):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match "
                         f"caches {tuple(k_cache.shape)}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{name}: {H // KV} query heads per kv head;"
                         f" the kernel serves at most {MAX_GROUP}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if (q.dtype not in DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"{name}: dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}; the kernel takes one of "
                        f"float32/bfloat16")
    if (q.device.type != "cuda" or k_cache.device != q.device
            or v_cache.device != q.device):
        raise ValueError(f"{name}: tensors must share one CUDA "
                         f"device, got {q.device}, {k_cache.device}, "
                         f"{v_cache.device}")
    cache_len = int(cache_len)
    if not lowest <= cache_len <= S:
        raise ValueError(f"{name}: {what} {cache_len} not in "
                         f"[{lowest}, {S}]")
    if q.stride(3) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError(f"{name}: head_dim must be contiguous")
    per16 = 16 // q.element_size()
    for label, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.data_ptr() % 16 or any(st % per16 for st in c.stride()[:3]):
            raise ValueError(f"{name}: {label} needs a 16-byte-"
                             f"aligned base and strides of whole 16 bytes, "
                             f"got address {c.data_ptr():#x}, strides "
                             f"{c.stride()}")
    return cache_len


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,1,H,hd]; caches [B,S,KV,hd] on one CUDA device -> [B,1,H,hd],
    attending to the first ``cache_len`` positions (a host int, 1..S).
    The caches' bases must be 16-byte aligned and their strides whole
    multiples of 16 bytes (the kernel copies 16 bytes at a time)."""
    global launches
    cache_len = _checked("decode_attention", q, k_cache, v_cache, cache_len)
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    split_len, n_splits = split_plan(B, KV, cache_len,
                                     build.sm_count(q.device))
    lib = build.library("decode_attention")
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part = (torch.empty(B * KV * n_splits * (H // KV) * (hd + 2),
                        dtype=torch.float32, device=q.device)
            if n_splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            B, H, KV, hd, cache_len, split_len,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            out.stride(0), out.stride(2),
            float(scale), DTYPES[q.dtype], stream)
    build.check("decode_attention", code)
    launches += 1
    return out


def decode_attention_partial(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, valid_len: int, *,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cache shard's share of a decode step on one CUDA device (the
    kernel of ``ref.decode_attention_partial_ref``): q [B,1,H,hd] against
    the first ``valid_len`` positions of the shard [B,S_local,KV,hd] ->
    ``(o, lse)``, ``o`` [B,1,H,hd] fp32 normalised over those positions,
    ``lse`` [B,H] fp32 (``m + log l``).  The checks are
    :func:`decode_attention`'s, with ``valid_len`` in ``0..S_local``.  An
    empty shard (``valid_len == 0``) is decided here, on the host: ``o = 0``
    and ``lse = -inf`` are filled and no kernel is launched (nor counted).
    Otherwise the split kernel and the merge kernel run, the merge with one
    split too: it writes the log-sum-exp."""
    global partial_launches
    valid_len = _checked("decode_attention_partial", q, k_shard, v_shard,
                         valid_len, lowest=0, what="valid_len")
    B, S, KV, hd = k_shard.shape
    H = q.shape[2]
    o = torch.zeros((B, 1, H, hd), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H), -math.inf, dtype=torch.float32, device=q.device)
    if valid_len == 0:
        return o, lse
    scale = scale if scale is not None else hd ** -0.5
    split_len, n_splits = split_plan(B, KV, valid_len,
                                     build.sm_count(q.device))
    lib = build.library("decode_attention")
    part = torch.empty(B * KV * n_splits * (H // KV) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.decode_attention_partial_launch(
            q.data_ptr(), k_shard.data_ptr(), v_shard.data_ptr(),
            o.data_ptr(), lse.data_ptr(), part.data_ptr(),
            B, H, KV, hd, valid_len, split_len,
            q.stride(0), q.stride(2),
            k_shard.stride(0), k_shard.stride(1), k_shard.stride(2),
            v_shard.stride(0), v_shard.stride(1), v_shard.stride(2),
            o.stride(0), o.stride(2),
            float(scale), DTYPES[q.dtype], stream)
    build.check("decode_attention", code)
    partial_launches += 1
    return o, lse
