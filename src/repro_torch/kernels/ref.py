"""Plain PyTorch versions of the port's kernels.

They are the CPU path of ``ops`` and the oracles the CUDA kernels are held
against on the card.  Like ``repro.kernels.ref`` they are deliberately
naive: the whole ``S x S`` score matrix, fp32 math (float64 for float64
inputs), ``-1e30`` as the mask value.  ``decode_attention_split_ref``
is the split-KV algebra of the decode kernels (for the tests).
``decode_attention_partial_ref`` is one cache shard's share of a decode
step (its output and log-sum-exp) and ``merge_partials`` the merge of the
shards' shares, which ``ops`` runs across the ranks of a mesh whose cache
is sequence-sharded.
``ssd_scan_ref`` is the SSD's chunked dual form (the CPU path of
``ops.ssd_scan``); ``ssd_ref`` is its exact sequential recurrence, the
oracle both are held against.  ``ssd_step_ref`` is one decode step of that
recurrence with the skip term (the CPU path of ``ops.ssd_step``).  ``quant_matmul_ref`` and ``quantize_int8``
are the int8 path's (``repro.kernels.ref``'s of the same names).
``rms_norm_ref`` is the models' RMSNorm, plain or SiLU-gated, as the chain
of ops the models ran before the kernel (the plain route of
``layers.rms_norm`` and ``layers.gated_rms_norm``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] (KV divides H). Naive softmax.

    Causal: query row i sits at key position ``q_offset + i`` and sees the
    keys up to it; ``None`` puts the last row at the last key (offset
    ``Skv - Sq``).  A rank of a sequence-sharded prefill passes its rows'
    global offset and the whole K/V, as the reference's
    ``layers.flash_attention(q, k, v, positions, positions)`` masks them."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    f = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(f).reshape(B, Sq, KV, g, hd) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(f))
    if causal:
        off = Skv - Sq if q_offset is None else int(q_offset)
        rows = torch.arange(Sq, device=q.device)[:, None] + off
        mask = rows >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(f))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: int, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,1,H,hd]; caches [B,S,KV,hd]; softmax over the first
    ``cache_len`` cache positions."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    f = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(f)[:, 0].reshape(B, KV, g, hd) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(f))
    valid = torch.arange(S, device=q.device) < cache_len
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(f))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, cache_len: int,
                               split_len: int, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_attention_ref` computed the way the split-KV kernels
    compute it (used by the tests only): for each split of ``split_len``
    positions of ``[0, cache_len)`` the partial softmax m_i (row max), l_i
    (sum of e^(s - m_i)) and acc_i (their weighted sum of V), then
    ``acc = sum_i e^(m_i - m) acc_i`` and ``l = sum_i e^(m_i - m) l_i`` with
    m the largest m_i, and ``acc / max(l, 1e-30)``."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    f = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(f)[:, 0].reshape(B, KV, g, hd) * scale
    ms, ls, accs = [], [], []
    for start in range(0, cache_len, split_len):
        end = min(start + split_len, cache_len)
        s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache[:, start:end].to(f))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p,
                                 v_cache[:, start:end].to(f)))
    m_i = torch.stack(ms)
    w = torch.exp(m_i - m_i.amax(dim=0))
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_partial_ref(q: torch.Tensor, k_shard: torch.Tensor,
                                 v_shard: torch.Tensor, valid_len: int, *,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cache shard's share of a decode step: q [B,1,H,hd] against the
    first ``valid_len`` (a host int in ``0..S_local``) positions of
    ``k_shard``/``v_shard`` [B,S_local,KV,hd].  Returns ``(o, lse)``: ``o``
    [B,1,H,hd] normalised over the shard's valid positions and ``lse``
    [B,H], the log of the softmax's denominator (``m + log l``), both fp32
    (float64 for float64 inputs).  ``valid_len == 0`` gives ``o = 0`` and
    ``lse = -inf``.  :func:`merge_partials` combines the shards' shares."""
    B, S, KV, hd = k_shard.shape
    H = q.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    f = torch.promote_types(q.dtype, torch.float32)
    valid_len = int(valid_len)
    if valid_len == 0:
        return (torch.zeros(B, 1, H, hd, dtype=f, device=q.device),
                torch.full((B, H), -math.inf, dtype=f, device=q.device))
    qf = q.to(f)[:, 0].reshape(B, KV, g, hd) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_shard.to(f))
    valid = torch.arange(S, device=q.device) < valid_len
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_shard.to(f)) / l[..., None]
    return o.reshape(B, 1, H, hd), (m + torch.log(l)).reshape(B, H)


def merge_weights(lse: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``exp(lse - m)`` with ``m`` the largest ``lse`` of a row: a shard
    with no valid position (``lse = -inf``) weighs 0, also where every
    shard of the row is empty (``m = -inf``: no NaN)."""
    return torch.exp(lse - torch.where(torch.isinf(m), torch.zeros_like(m), m))


def merge_partials(os: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The decode output of shards' shares stacked on a leading dim (``os``
    [n,B,1,H,hd], ``lses`` [n,B,H] of :func:`decode_attention_partial_ref`
    or the kernel's), as ``ops`` merges them across ranks: ``m`` the
    largest ``lse``, ``w_i = exp(lse_i - m)``, and ``sum_i w_i o_i /
    sum_i w_i`` (0 where every shard is empty), in the shares' dtype."""
    m = lses.amax(dim=0)
    w = merge_weights(lses, m)
    num = (w[:, :, None, :, None] * os).sum(dim=0)
    den = w.sum(dim=0)[:, None, :, None]
    return num / torch.clamp_min(den, 1e-30)


def _segsum_exp(cs: torch.Tensor) -> torch.Tensor:
    """cs: [..., q] cumulative log-decay -> L[..., i, j] = exp(cs_i - cs_j)
    for i >= j, else 0.  The mask goes on the exponent: masked
    differences are positive and their exp could overflow."""
    q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=cs.device).tril()
    return torch.exp(diff.masked_fill(~mask, NEG_INF))


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD in chunked dual form (``repro.models.ssm.ssd_chunked``).

    x: [B,S,nh,hd]; dt: [B,S,nh] (softplus'd); A: [nh] (< 0); Bm, Cm:
    [B,S,ds]; init_state: [B,nh,hd,ds]; all fp32.  The chunk shrinks until
    it divides S, as the reference's does.  Returns (y [B,S,nh,hd], final
    state [B,nh,hd,ds]).

    The cumulative log-decay is summed in float64, the products stay fp32:
    with A down to -16 the sums reach about -1000 in a chunk, and in fp32
    the rounding of two such sums, ~6e-5, is the relative error of the
    near-diagonal ``L`` entries, which leaves y ~1e-5 (of its largest
    value) off the exact recurrence instead of ~1e-7."""
    B_, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    q = min(chunk, S)
    while S % q:
        q -= 1
    c = S // q
    xc = x.reshape(B_, c, q, nh, hd)
    dtc = dt.reshape(B_, c, q, nh)
    Bc = Bm.reshape(B_, c, q, ds)
    Cc = Cm.reshape(B_, c, q, ds)

    dA_cs = torch.cumsum(dtc.double() * A.double(), dim=2)  # [B,c,q,nh]
    xdt = xc * dtc[..., None]                             # [B,c,q,nh,hd]

    # 1. within each chunk: (L o C B^T) (x dt)
    Lmat = _segsum_exp(dA_cs.movedim(-1, -2)).to(x.dtype)  # [B,c,nh,q,q]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)      # [B,c,q,q]
    y_diag = torch.einsum("bchij,bcjhp->bcihp",
                          Lmat * scores[:, :, None], xdt)

    # 2. each chunk's contribution to the state it leaves
    decay_states = torch.exp(dA_cs[:, :, -1:] - dA_cs).to(x.dtype)
    states = torch.einsum("bcjhp,bcjn->bchpn",
                          xc * (decay_states * dtc)[..., None], Bc)

    # 3. the state entering each chunk, chunk by chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1]).to(x.dtype)  # [B,c,nh]
    state = (init_state if init_state is not None
             else torch.zeros(B_, nh, hd, ds, dtype=x.dtype, device=x.device))
    entering = []
    for i in range(c):
        entering.append(state)
        state = state * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(entering, dim=1)            # [B,c,nh,hd,ds]

    # 4. what the entering state adds to each row of its chunk
    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, prev_states) \
        * torch.exp(dA_cs).to(x.dtype)[..., None]
    return (y_diag + y_off).reshape(B_, S, nh, hd), state


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential SSD recurrence (``repro.kernels.ref.ssd_ref``):
    state_t = state_{t-1} exp(dt_t A) + dt_t x_t (x) B_t;  y_t = state_t . C_t.
    Shapes as :func:`ssd_scan_ref`.  Computes in fp32, or in float64 when x
    is float64 (the yardstick of both fp32 forms)."""
    B_, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    dtype = torch.promote_types(x.dtype, torch.float32)
    x, dt, A, Bm, Cm = (t.to(dtype) for t in (x, dt, A, Bm, Cm))
    state = (init_state.to(dtype) if init_state is not None
             else torch.zeros(B_, nh, hd, ds, dtype=dtype, device=x.device))
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                   # [B,nh]
        upd = torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                           Bm[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_step_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                 state: torch.Tensor, out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD decode step with the skip term.  x: [B,nh,hd];
    dt: [B,nh]; A, D: [nh]; Bm, Cm: [B,ds]; state: [B,nh,hd,ds] ->
    (y = state' . C + D x [B,nh,hd], state' = state exp(dt A) + dt x (x) B),
    state' written into ``out`` (which may be ``state``) where given."""
    dA = torch.exp(dt * A)
    upd = torch.einsum("bhp,bn->bhpn", x * dt[..., None], Bm)
    new = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new, Cm) + x * D[:, None]
    if out is None:
        return y, new
    out.copy_(new)
    return y, out


def quant_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                     x_scale: torch.Tensor, w_scale: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 [M,K] x int8 [K,N] -> ``out_dtype`` [M,N] with a per-row
    ``x_scale`` [M] and a per-column ``w_scale`` [N] (fp32).

    The integer product is taken in float64, where it is exact (|acc| <=
    127^2 K < 2^53) on either device: cuBLAS has no int32 matmul.  Then
    ``(float32(acc) * x_scale) * w_scale`` in that order, as the kernel's
    epilogue does."""
    acc = x_q.double() @ w_q.double()
    out = acc.float() * x_scale[:, None] * w_scale[None, :]
    return out.to(out_dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation along ``axis``: (q int8, scale fp32)
    with ``scale = max(amax, 1e-8) / 127`` and ``q = round(x / scale)``
    (half to even) clamped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
                 z: Optional[torch.Tensor] = None,
                 group: Optional[int] = None) -> torch.Tensor:
    """RMSNorm over x's last dim scaled by ``(1 + weight)`` (weights are
    zero-initialised), in fp32 (float64 stays float64), of x's dtype.  With
    a gate ``z`` (x's shape): ``x * silu(z)`` normalised, each run of
    ``group`` channels of the last dim on its own (default: all of it), of
    z's dtype.  ``weight`` broadcasts against x's trailing dims."""
    if z is None:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (xf * (1.0 + weight.to(xf.dtype))).to(x.dtype)
    y = x * F.silu(z.to(torch.promote_types(z.dtype, torch.float32)))
    if group is not None and group != y.shape[-1]:
        g = y.unflatten(-1, (-1, group))
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
        y = g.flatten(-2)
    else:
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)
    return (y * (1.0 + weight.to(y.dtype))).to(z.dtype)
