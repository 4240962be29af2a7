"""Mamba2 (SSD, state-space duality) blocks.

PyTorch counterpart of ``repro.models.ssm``.  One ``SSMBlock`` holds one
layer's parameters in the JAX package's per-layer layouts (``wz``/``wx``
``[d, nh, hd]``, ``wo [nh, hd, d]``, ...); ``A_log`` and ``dt_bias`` stay
fp32 in a bf16 model, as the reference keeps them.  Full-sequence
mode runs the SSD through ``kernels.ops.ssd_scan`` (the CUDA kernel on a
CUDA tensor, its plain dual form on a CPU one) or, with ``impl="plain"``,
the plain version directly.  Decode keeps the recurrent state
(SSD state ``[B, nh, hd, ds]`` in fp32 plus the conv tails) and steps it
in plain PyTorch: the JAX package has no kernel for that step either.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.sharding.policy import (NULL_POLICY, PartitionSpec,
                                         ShardingPolicy)

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
    return {"ssm_norm": (d,), "wz": (d, nh, hd), "wx": (d, nh, hd),
            "wB": (d, ds), "wC": (d, ds), "wdt": (d, nh),
            "conv_x": (cw, nh, hd), "conv_B": (cw, ds), "conv_C": (cw, ds),
            "A_log": (nh,), "dt_bias": (nh,), "D": (nh,),
            "gate_norm": (nh, hd), "wo": (nh, hd, d)}


def ssm_specs(arch: ArchConfig, policy: ShardingPolicy
              ) -> Dict[str, PartitionSpec]:
    """Specs of one Mamba2 layer's parameters: the reference's
    ``ssm_specs`` without its leading ``"layers"`` entry."""
    sp = policy.spec
    return {
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
    x: [B, S, *ch]; w: [cw, *ch] -> [B, S, *ch] (SiLU by the caller)."""
    cw, S = w.shape[0], x.shape[1]
    out = x * w[cw - 1]
    for i in range(cw - 1):
        shift = cw - 1 - i
        shifted = _pad_seq(x, shift)[:, :S]
        out = out + shifted * w[i]
    return out


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step.  x: [B,nh,hd]; dt: [B,nh]; A: [nh];
    Bm, Cm: [B,ds]; state: [B,nh,hd,ds] -> (y [B,nh,hd], state)."""
    dA = torch.exp(dt * A)
    upd = torch.einsum("bhp,bn->bhpn", x * dt[..., None], Bm)
    state = state * dA[..., None, None] + upd
    return torch.einsum("bhpn,bn->bhp", state, Cm), state


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: SSMBlock,
               arch: ArchConfig,
               policy: ShardingPolicy = NULL_POLICY) -> torch.Tensor:
    """Gated RMSNorm (scaled by ``1 + gate_norm``) and the out-projection.
    y (fp32), z: [B, S, nh, hd] -> [B, S, d]."""
    y = y * F.silu(layers.upcast(z))
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + arch.norm_eps)
    y = (y * (1.0 + p.gate_norm.to(y.dtype))).to(z.dtype)
    y = policy.pin(y, "batch", "seq", "ssm_heads", "ssm_pdim")
    wo = layers.heads_whole(policy, p.wo, "ssm_heads", out=True)
    return layers.linear(y.flatten(2), wo.flatten(0, 1))


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


def ssm_block_full(h: torch.Tensor, p: SSMBlock, arch: ArchConfig,
                   init_state: Optional[SSMLayerState] = None,
                   impl: str = "kernel",
                   policy: Optional[ShardingPolicy] = None
                   ) -> Tuple[torch.Tensor, SSMLayerState]:
    """Full-sequence Mamba2 block.  Returns (h + out, the state to decode
    from: the final SSD state and the last ``cw - 1`` pre-activation conv
    inputs, left-padded with zeros when S < cw - 1)."""
    policy = policy or NULL_POLICY
    s = arch.ssm
    S = h.shape[1]
    hn = layers.rms_norm(h, p.ssm_norm, arch.norm_eps)
    z, x_pre, B_pre, C_pre, dt = _project(hn, p, arch, policy)
    x_pre = policy.pin(x_pre, "batch", "seq", "ssm_heads", "ssm_pdim")
    z = policy.pin(z, "batch", "seq", "ssm_heads", "ssm_pdim")

    x = F.silu(causal_shift_conv(x_pre, p.conv_x))
    Bm = F.silu(causal_shift_conv(B_pre, p.conv_B))
    Cm = F.silu(causal_shift_conv(C_pre, p.conv_C))

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
    out = _gated_out(y, z, p, arch, policy)

    cw = s.conv_width

    def tail(v: torch.Tensor) -> torch.Tensor:
        if S >= cw - 1:       # a copy: a view would keep all of v alive
            return v[:, S - (cw - 1):].clone()
        return _pad_seq(v, cw - 1 - S)

    return h + out, SSMLayerState(ssd=final, conv_x=tail(x_pre),
                                  conv_B=tail(B_pre), conv_C=tail(C_pre))


def ssm_block_decode(h: torch.Tensor, p: SSMBlock, arch: ArchConfig,
                     state: SSMLayerState,
                     policy: Optional[ShardingPolicy] = None
                     ) -> Tuple[torch.Tensor, SSMLayerState]:
    """One-token Mamba2 step against the recurrent state.  h: [B, 1, d].
    Returns (h + out, the new state)."""
    policy = policy or NULL_POLICY
    hn = layers.rms_norm(h, p.ssm_norm, arch.norm_eps)[:, 0]     # [B, d]
    z, x_new, B_new, C_new, dt = _project(hn, p, arch, policy)

    def conv_step(tail, new, w):
        full = torch.cat([tail, new[:, None]], dim=1)             # [B, cw, ...]
        out = (layers.upcast(full) * layers.upcast(w)).sum(1).to(new.dtype)
        return F.silu(out), full[:, 1:]

    x, conv_x = conv_step(state.conv_x, x_new, p.conv_x)
    Bm, conv_B = conv_step(state.conv_B, B_new, p.conv_B)
    Cm, conv_C = conv_step(state.conv_C, C_new, p.conv_C)

    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log)
    x = layers.upcast(x)
    y, ssd = ssd_step(x, dt, A, layers.upcast(Bm), layers.upcast(Cm),
                      state.ssd)
    y = y + x * p.D.to(x.dtype)[:, None]
    out = _gated_out(y[:, None], z[:, None], p, arch, policy)
    return h + out, SSMLayerState(ssd=ssd, conv_x=conv_x, conv_B=conv_B,
                                  conv_C=conv_C)
