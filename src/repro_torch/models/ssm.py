"""Mamba2 (SSD, state-space duality) blocks.

PyTorch counterpart of ``repro.models.ssm``.  One ``SSMBlock`` holds one
layer's parameters in the JAX package's per-layer layouts (``wz``/``wx``
``[d, nh, hd]``, ``wo [nh, hd, d]``, ...); ``A_log`` and ``dt_bias`` stay
fp32 in a bf16 model, as the reference keeps them.  Full-sequence
mode runs the SSD through ``kernels.ops.ssd_scan`` (the CUDA kernel on a
CUDA tensor, its plain dual form on a CPU one) or, with ``impl="plain"``,
the plain version directly.  Decode keeps the recurrent state
(SSD state ``[B, nh, hd, ds]`` in fp32 plus the conv tails) and steps the
SSD state through ``kernels.ops.ssd_step`` (a CUDA kernel of the port's
own that reads and writes the state once, in place where the caller hands
it ``ssd_out``; the JAX package steps it in jnp) or, with
``impl="plain"``, its plain version.  ``ssm_step_routes`` tallies the
decode steps by route.

Granite-4.0-H's Mamba2 (``arch.conv_bias``, ``arch.gate_norm_groups``; the
port's own ``hybrid_moe`` family) adds a bias to the conv over x, B and C
(``conv_x_bias``, ``conv_B_bias``, ``conv_C_bias``) and normalises the
gated output over groups of its d_inner channels instead of each head's.
:func:`ssm_mixer_full` and :func:`ssm_mixer_decode` give the mixer's
output without the residual, for blocks that scale it.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.sharding.policy import (NULL_POLICY, PartitionSpec,
                                         ShardingPolicy, is_dtensor,
                                         redistribute)

_FP32 = ("A_log", "dt_bias")     # kept fp32 in a bf16 model


class SSMLayerState(NamedTuple):
    """Recurrent per-layer decode state."""
    ssd: torch.Tensor       # [B, nh, hd, ds] fp32
    conv_x: torch.Tensor    # [B, cw-1, nh, hd]  pre-activation conv inputs
    conv_B: torch.Tensor    # [B, cw-1, ds]
    conv_C: torch.Tensor    # [B, cw-1, ds]


def block_shapes(arch: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter shapes of one Mamba2 layer (``ssm.init_ssm`` without the
    leading layer dim)."""
    s, d = arch.ssm, arch.d_model
    nh, hd, ds, cw = s.num_heads(d), s.head_dim, s.d_state, s.conv_width
    shapes = {"ssm_norm": (d,), "wz": (d, nh, hd), "wx": (d, nh, hd),
              "wB": (d, ds), "wC": (d, ds), "wdt": (d, nh),
              "conv_x": (cw, nh, hd), "conv_B": (cw, ds), "conv_C": (cw, ds),
              "A_log": (nh,), "dt_bias": (nh,), "D": (nh,),
              "gate_norm": (nh, hd), "wo": (nh, hd, d)}
    if arch.conv_bias:
        shapes.update(conv_x_bias=(nh, hd), conv_B_bias=(ds,),
                      conv_C_bias=(ds,))
    return shapes


def ssm_specs(arch: ArchConfig, policy: ShardingPolicy
              ) -> Dict[str, PartitionSpec]:
    """Specs of one Mamba2 layer's parameters: the reference's
    ``ssm_specs`` without its leading ``"layers"`` entry."""
    sp = policy.spec
    specs = {
        "ssm_norm": sp(None),
        "wz": sp("embed", "ssm_heads", "ssm_pdim"),
        "wx": sp("embed", "ssm_heads", "ssm_pdim"),
        "wB": sp("embed", None),
        "wC": sp("embed", None),
        "wdt": sp("embed", None),
        "conv_x": sp(None, "ssm_heads", "ssm_pdim"),
        "conv_B": sp(None, None),
        "conv_C": sp(None, None),
        "A_log": sp(None),
        "dt_bias": sp(None),
        "D": sp(None),
        "gate_norm": sp("ssm_heads", "ssm_pdim"),
        "wo": sp("ssm_heads", "ssm_pdim", "embed"),
    }
    if arch.conv_bias:
        specs.update(conv_x_bias=sp("ssm_heads", "ssm_pdim"),
                     conv_B_bias=sp(None), conv_C_bias=sp(None))
    return specs


def state_specs(policy: ShardingPolicy) -> "SSMLayerState":
    """Specs of one layer's decode state (the reference's ``state_specs``
    unstacked)."""
    sp = policy.spec
    return SSMLayerState(
        ssd=sp("batch", "ssm_heads", "ssm_pdim", None),
        conv_x=sp("batch", None, "ssm_heads", "ssm_pdim"),
        conv_B=sp("batch", None, None),
        conv_C=sp("batch", None, None),
    )


def init_scale(arch: ArchConfig, name: str) -> float:
    """Std of the normal init of one Mamba2 parameter; 0 means zeros.
    ``A_log`` and ``D`` are not drawn: see :meth:`SSMBlock.init_constants`."""
    s, d = arch.ssm, arch.d_model
    cw = s.conv_width
    return {"wz": d ** -0.5, "wx": d ** -0.5, "wB": d ** -0.5,
            "wC": d ** -0.5, "wdt": d ** -0.5, "conv_x": cw ** -0.5,
            "conv_B": cw ** -0.5, "conv_C": cw ** -0.5,
            "wo": (s.num_heads(d) * s.head_dim) ** -0.5}.get(name, 0.0)


class SSMBlock(nn.Module):
    """One Mamba2 layer's parameters."""

    def __init__(self, arch: ArchConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        for name, shape in block_shapes(arch).items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, device=device,
                dtype=(torch.promote_types(dtype, torch.float32)
                       if name in _FP32 else dtype)),
                requires_grad=False))

    @torch.no_grad()
    def init_constants(self) -> None:
        """The reference's deterministic parameters: A in [-16, -1] from a
        log-spaced ``A_log``, ``D`` ones, ``dt_bias`` zeros."""
        nh = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh,
                                                  dtype=torch.float32)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()


def init_layer_state(arch: ArchConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> SSMLayerState:
    """A zero state for one layer (conv tails in ``dtype``)."""
    s, d = arch.ssm, arch.d_model
    nh, hd, ds, cw = s.num_heads(d), s.head_dim, s.d_state, s.conv_width
    return SSMLayerState(
        ssd=torch.zeros(batch, nh, hd, ds, dtype=torch.float32,
                        device=device),
        conv_x=torch.zeros(batch, cw - 1, nh, hd, dtype=dtype, device=device),
        conv_B=torch.zeros(batch, cw - 1, ds, dtype=dtype, device=device),
        conv_C=torch.zeros(batch, cw - 1, ds, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """x: [B, S, ...] with ``n`` zero rows put in front of S."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (n, 0))


def causal_shift_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as a sum of shifted copies.
    x: [B, S, *ch]; w: [cw, *ch] -> [B, S, *ch] (SiLU by the caller).
    A DTensor ``x`` takes :func:`conv_and_tail`."""
    cw, S = w.shape[0], x.shape[1]
    out = x * w[cw - 1]
    for i in range(cw - 1):
        shift = cw - 1 - i
        shifted = _pad_seq(x, shift)[:, :S]
        out = out + shifted * w[i]
    return out


def _tail(v: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` rows of v's sequence (dim 1), left-padded with zeros
    when there are fewer."""
    S = v.shape[1]
    if S >= n:       # a copy: a view would keep all of v alive
        return v[:, S - n:].clone()
    return _pad_seq(v, n - S)


def _conv_rows(x: torch.Tensor, prev: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """:func:`causal_shift_conv` of rows ``x`` [B, S, *ch] preceded by the
    ``cw - 1`` rows ``prev``, in its order of products and sums."""
    cw, S = w.shape[0], x.shape[1]
    ext = torch.cat([prev, x], dim=1)
    out = x * w[cw - 1]
    for i in range(cw - 1):
        out = out + ext[:, i:i + S] * w[i]
    return out


def conv_and_tail(x: torch.Tensor, w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`causal_shift_conv` of a DTensor ``x`` [B, S, *ch] and the
    decode tail (its last ``cw - 1`` rows), both on local shards: no
    DTensor pad or slice of a sharded dim (torch 2.11 refuses both).

    Each sequence shard's last ``cw - 1`` rows (left-padded with zeros
    when the whole sequence is shorter) are all-gathered over the mesh
    dims that shard the sequence, if any (the halo GSPMD emits for the
    reference's pad; autograd sends the halo's gradient back to its
    shard), and each rank puts its predecessor's in front of its own
    rows; the first shard takes zeros, the reference's pad.  The tail is
    the last shard's.  ``w`` [cw, *ch] is taken to the channel shards of
    ``x``.  Returns DTensors on ``x``'s placements (the tail replicated
    where the sequence is sharded).  Raises ``ValueError`` for a sequence
    shard shorter than ``cw - 1`` rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, cw = x.device_mesh, w.shape[0]
    n = cw - 1
    x = redistribute(x, [Replicate() if q.is_partial() else q
                         for q in x.placements])
    places = tuple(x.placements)
    seq = [i for i, q in enumerate(places) if q.is_shard(1)]
    shards = math.prod(mesh.shape[i] for i in seq)
    rows = x.to_local()
    if shards > 1 and (rows.shape[1] < n or x.shape[1] % shards):
        raise ValueError(
            f"causal conv on {shards} sequence shards of {x.shape[1]} rows: "
            f"each shard needs at least cw - 1 = {n} rows, evenly split")
    w_p = tuple(Shard(q.dim - 1) if q.is_shard() and q.dim >= 2
                else Replicate() for q in places)
    tail_p = tuple(Replicate() if i in seq else q
                   for i, q in enumerate(places))
    halo_shape = (x.shape[0], n * shards) + tuple(x.shape[2:])
    halo = redistribute(DTensor.from_local(
        _tail(rows, n), mesh, places, run_check=False,
        shape=torch.Size(halo_shape), stride=ops._contiguous(halo_shape)),
        tail_p)
    coord = mesh.get_coordinate()
    index = 0
    for i in seq:               # the shard's place in the sequence
        index = index * mesh.shape[i] + coord[i]

    def local(xl, wl, hl):
        # zeros in front of the halo: every rank's graph holds the halo, so
        # every rank joins its gradient's collective in the backward
        ext = torch.cat([hl.new_zeros((hl.shape[0], n) + hl.shape[2:]), hl],
                        dim=1)
        return (_conv_rows(xl, ext[:, index * n:(index + 1) * n], wl),
                hl[:, -n:].clone())

    return ops.run_local(local, mesh, (x, w, halo), (places, w_p, tail_p),
                         (places, tail_p),
                         (x.shape, (x.shape[0], n) + tuple(x.shape[2:])))


# Decode steps by route: "kernel" (``ops.ssd_step`` on the card) or
# "plain" (the plain arithmetic: CPU tensors, or ``impl="plain"``), as
# :func:`ssm_mixer_decode` dispatches them.  Under CUDA graphs it counts
# eager calls and captures, not replays.
ssm_step_routes = {"kernel": 0, "plain": 0}


def _step_fn(route: str, x: torch.Tensor, state: torch.Tensor):
    """The SSD decode step of ``route``: ``ops.ssd_step``, or the plain
    version, on local shards where the state or ``x`` is a DTensor sharded
    on its head dim (dim 2; torch 2.11's einsum cannot flatten it)."""
    if route == "kernel":
        return ops.ssd_step
    if any(is_dtensor(t) and any(q.is_shard(2) for q in t.placements)
           for t in (state, x)):
        return partial(ops.on_shards, ref.ssd_step_ref)
    return ref.ssd_step_ref


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: SSMBlock,
               arch: ArchConfig,
               policy: ShardingPolicy = NULL_POLICY,
               impl: str = "kernel") -> torch.Tensor:
    """Gated RMSNorm (scaled by ``1 + gate_norm``) and the out-projection.
    y (fp32), z: [B, S, nh, hd] -> [B, S, d].  The norm runs over each
    head's hd channels, or with ``arch.gate_norm_groups`` over each group
    of the nh * hd channels, routed by ``impl``."""
    y = layers.gated_rms_norm(y, z, p.gate_norm, arch.norm_eps,
                              arch.gate_norm_groups, impl)
    y = policy.pin(y, "batch", "seq", "ssm_heads", "ssm_pdim")
    if is_dtensor(y) and any(q.is_shard(3) for q in y.placements):
        return _out_proj_local(y, p.wo)
    wo = layers.heads_whole(policy, p.wo, "ssm_heads", out=True)
    return layers.linear(y.flatten(2), wo.flatten(0, 1))


def _out_proj_local(y: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``y`` [B, S, nh, hd] (a DTensor) times ``wo`` [nh, hd, d] on local
    shards, for a ``y`` whose head dim is sharded (DTensor in torch 2.11
    will not flatten [nh, hd] there): each rank's [B, S, nh*hd/r] rows by
    its matching rows of ``wo``, a pending sum over the mesh dims that
    shard heads or head dim, reduced before it is returned."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    places = tuple(y.placements)
    wo_p = tuple(Shard(q.dim - 2) if q.is_shard() and q.dim >= 2
                 else Replicate() for q in places)
    out_p = tuple(Partial() if q.is_shard() and q.dim >= 2 else q
                  for q in places)
    out = ops.run_local(
        lambda yl, wl: yl.flatten(2) @ wl.flatten(0, 1), y.device_mesh,
        (y, wo), (places, wo_p), (out_p,), (y.shape[:2] + wo.shape[2:],))
    return redistribute(out, [Replicate() if q.is_partial() else q
                              for q in out.placements])


def _project(hn: torch.Tensor, p: SSMBlock, arch: ArchConfig,
             policy: ShardingPolicy = NULL_POLICY):
    """z, x, B, C in the model's dtype and dt from an fp32 product."""
    s = arch.ssm
    nh, hd = s.num_heads(arch.d_model), s.head_dim
    lead = hn.shape[:-1]
    wz, wx = (layers.heads_whole(policy, w, "ssm_heads") for w in (p.wz,
                                                                  p.wx))
    z = layers.linear(hn, wz.flatten(1)).view(*lead, nh, hd)
    x = layers.linear(hn, wx.flatten(1)).view(*lead, nh, hd)
    dt = layers.linear(layers.upcast(hn), layers.upcast(p.wdt))
    return z, x, layers.linear(hn, p.wB), layers.linear(hn, p.wC), dt


def _conv(v: torch.Tensor, w: torch.Tensor, cw: int,
          bias: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SiLU of the causal conv (plus ``bias``, where the arch has one) and
    the ``cw - 1`` rows decode starts from (pre-activation conv inputs,
    left-padded with zeros when S < cw - 1)."""
    if is_dtensor(v):
        out, tail = conv_and_tail(v, w)
    else:
        out, tail = causal_shift_conv(v, w), _tail(v, cw - 1)
    return F.silu(out if bias is None else out + bias), tail


def _conv_biases(p: SSMBlock, arch: ArchConfig) -> Tuple:
    """The conv's biases of x, B and C, or three Nones."""
    if not arch.conv_bias:
        return None, None, None
    return p.conv_x_bias, p.conv_B_bias, p.conv_C_bias


def ssm_block_full(h: torch.Tensor, p: SSMBlock, arch: ArchConfig,
                   init_state: Optional[SSMLayerState] = None,
                   impl: str = "kernel",
                   policy: Optional[ShardingPolicy] = None
                   ) -> Tuple[torch.Tensor, SSMLayerState]:
    """Full-sequence Mamba2 block.  Returns (h + out, the state to decode
    from: the final SSD state and the last ``cw - 1`` pre-activation conv
    inputs, left-padded with zeros when S < cw - 1)."""
    out, state = ssm_mixer_full(h, p, arch, init_state, impl, policy)
    return h + out, state


def ssm_mixer_full(h: torch.Tensor, p: SSMBlock, arch: ArchConfig,
                   init_state: Optional[SSMLayerState] = None,
                   impl: str = "kernel",
                   policy: Optional[ShardingPolicy] = None
                   ) -> Tuple[torch.Tensor, SSMLayerState]:
    """:func:`ssm_block_full` without the residual: (out, state)."""
    policy = policy or NULL_POLICY
    s = arch.ssm
    hn = layers.rms_norm(h, p.ssm_norm, arch.norm_eps, impl)
    z, x_pre, B_pre, C_pre, dt = _project(hn, p, arch, policy)
    x_pre = policy.pin(x_pre, "batch", "seq", "ssm_heads", "ssm_pdim")
    z = policy.pin(z, "batch", "seq", "ssm_heads", "ssm_pdim")

    bx, bB, bC = _conv_biases(p, arch)
    x, tail_x = _conv(x_pre, p.conv_x, s.conv_width, bx)
    Bm, tail_B = _conv(B_pre, p.conv_B, s.conv_width, bB)
    Cm, tail_C = _conv(C_pre, p.conv_C, s.conv_width, bC)

    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log)
    s0 = init_state.ssd if init_state is not None else None
    scan = ops.ssd_scan if impl == "kernel" else ref.ssd_scan_ref
    if impl != "kernel" and policy.mesh is not None:
        scan = partial(ops.on_shards, ref.ssd_scan_ref)
    x = layers.upcast(x)
    y, final = scan(x, dt, A, layers.upcast(Bm), layers.upcast(Cm),
                    chunk=s.chunk_size, init_state=s0)
    y = y + x * p.D.to(x.dtype)[:, None]
    out = _gated_out(y, z, p, arch, policy, impl)

    return out, SSMLayerState(ssd=final, conv_x=tail_x, conv_B=tail_B,
                              conv_C=tail_C)


def ssm_block_decode(h: torch.Tensor, p: SSMBlock, arch: ArchConfig,
                     state: SSMLayerState, impl: str = "kernel",
                     policy: Optional[ShardingPolicy] = None
                     ) -> Tuple[torch.Tensor, SSMLayerState]:
    """One-token Mamba2 step against the recurrent state.  h: [B, 1, d].
    Returns (h + out, the new state)."""
    out, state = ssm_mixer_decode(h, p, arch, state, impl, policy)
    return h + out, state


def ssm_mixer_decode(h: torch.Tensor, p: SSMBlock, arch: ArchConfig,
                     state: SSMLayerState, impl: str = "kernel",
                     policy: Optional[ShardingPolicy] = None,
                     ssd_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, SSMLayerState]:
    """:func:`ssm_block_decode` without the residual: (out, state).  The
    new SSD state is written into ``ssd_out`` where given (it may be
    ``state.ssd``: the step then updates it in place), else into a new
    tensor; the conv tails are always new."""
    policy = policy or NULL_POLICY
    hn = layers.rms_norm(h, p.ssm_norm, arch.norm_eps, impl)[:, 0]  # [B, d]
    z, x_new, B_new, C_new, dt = _project(hn, p, arch, policy)

    def conv_step(tail, new, w, bias):
        full = torch.cat([tail, new[:, None]], dim=1)             # [B, cw, ...]
        out = (layers.upcast(full) * layers.upcast(w)).sum(1)
        if bias is not None:
            out = out + layers.upcast(bias)
        return F.silu(out.to(new.dtype)), full[:, 1:]

    bx, bB, bC = _conv_biases(p, arch)
    x, conv_x = conv_step(state.conv_x, x_new, p.conv_x, bx)
    Bm, conv_B = conv_step(state.conv_B, B_new, p.conv_B, bB)
    Cm, conv_C = conv_step(state.conv_C, C_new, p.conv_C, bC)

    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log)
    x = layers.upcast(x)
    route = "kernel" if impl == "kernel" and ops._on_cuda(x) else "plain"
    ssm_step_routes[route] += 1
    y, ssd = _step_fn(route, x, state.ssd)(
        x, dt, A, layers.upcast(Bm), layers.upcast(Cm), p.D.to(x.dtype),
        state.ssd, out=ssd_out)
    out = _gated_out(y[:, None], z[:, None], p, arch, policy, impl)
    return out, SSMLayerState(ssd=ssd, conv_x=conv_x, conv_B=conv_B,
                              conv_C=conv_C)
