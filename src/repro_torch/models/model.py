"""The port's model: the dense-family decoders (dense, vlm, audio), the
MoE family, the Mamba2 SSM family and the Zamba2 hybrid family.

PyTorch counterpart of ``repro.models.Model`` with the same entry points,
holding its parameters as an ``nn.Module``:

* ``forward(tokens, frontend_embeds=None)``           -- fp32 logits [B,S,V]
* ``prefill(tokens, frontend_embeds=None, max_seq=None)`` -- last-token
  logits and the cache (KV and/or SSM states)
* ``decode_step(cache, cache_len, tokens)``            -- one token vs cache
* ``loss(batch)``                                      -- the training
  objective, mean next-token cross-entropy (``labels == LOSS_IGNORE``
  masked), with autograd on

Modality frontends (vlm/audio) are stubs, as in the reference: the first P
positions take precomputed embeddings.  A hybrid runs one shared attention
block (``shared_attn``) before each group of ``attn_every`` Mamba2 layers,
with one KV cache per application.  An MoE model runs groups of
``moe_every`` layers: ``moe_every - 1`` dense layers, then one MoE layer
(``models.moe``), each with its own KV cache.

Parameters are made frozen; ``model.requires_grad_(True)`` makes them
trainable (``training.train_step`` does).  The serving entry points run
under ``torch.no_grad()``, so their outputs never carry a graph.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache, layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm

NUM_FRONTEND_POSITIONS = 64
LOSS_IGNORE = -1
DENSE_FAMILIES = ("dense", "vlm", "audio")
FAMILIES = DENSE_FAMILIES + ("moe", "ssm", "hybrid")
IMPLS = ("kernel", "plain")
REMATS = ("none", "full", "dots")
# "dots" keeps what jax.checkpoint_policies.dots_with_no_batch_dims_saveable
# keeps: the products with no batch dims (x @ w).  Attention's and the SSD's
# einsums (bmm) and everything elementwise are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present, so the port never drops to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device is available; pass "
                           "device='cpu' to run on the host")
    return dev


class Model(nn.Module):
    """A dense-family, MoE, SSM or hybrid decoder on one device.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    ``"meta"`` builds the shapes without allocating.  Parameters are made
    with ``torch.empty``: fill them with :meth:`init` or
    ``load_state_dict`` (e.g. from ``convert.from_jax_params``).
    ``impl`` routes every kernel of the model (attention and SSD) through
    ``kernels.ops`` (``"kernel"``) or to the plain versions directly
    (``"plain"``).  ``moe_dispatch`` is the MoE layers' dispatch
    (``models.moe.DISPATCHES``).  ``remat`` (``REMATS``, the reference's)
    recomputes each block in the backward pass under autograd: all of it
    (``"full"``) or all but its ``x @ w`` products (``"dots"``).  The CUDA
    kernels have no backward: training runs ``impl="plain"``."""

    def __init__(self, arch: ArchConfig,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 impl: str = "kernel", moe_dispatch: str = "auto",
                 remat: str = "none"):
        super().__init__()
        if arch.family not in FAMILIES:
            raise ValueError(f"{arch.name}: unknown family {arch.family!r}")
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")
        if moe_dispatch not in moe_mod.DISPATCHES:
            raise ValueError(f"moe_dispatch {moe_dispatch!r} not in "
                             f"{moe_mod.DISPATCHES}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} not in {REMATS}")
        self.arch = arch
        self.device = resolve_device(device)
        self.dtype = dtype
        self.impl = impl
        self.moe_dispatch = moe_dispatch
        self.remat = remat
        d, V = arch.d_model, arch.vocab_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=self.device,
                                            dtype=dtype), requires_grad=False)

        self.embed = param(V, d)
        self.final_norm = param(d)
        if not arch.tie_embeddings:
            self.lm_head = param(d, V)
        self.blocks = nn.ModuleList(block(arch, self.device, dtype)
                                    for block in self._layer_kinds())
        if arch.family == "hybrid":
            self.shared_attn = tfm.DenseBlock(arch, self.device, dtype)

    def _layer_kinds(self) -> list:
        """The block class of each layer, in layer order."""
        arch = self.arch
        if arch.family == "moe":
            n_groups, dense_per = self.moe_group
            return ([tfm.DenseBlock] * dense_per + [moe_mod.MoEBlock]) \
                * n_groups
        block = ssm_mod.SSMBlock if arch.ssm is not None else tfm.DenseBlock
        return [block] * arch.num_layers

    @property
    def moe_group(self) -> Tuple[int, int]:
        """(n_groups, dense_per_group) of an MoE arch: each group is
        ``dense_per_group`` dense layers, then one MoE layer."""
        m = self.arch.moe
        return self.arch.num_layers // m.moe_every, m.moe_every - 1

    @property
    def hybrid_groups(self) -> List[Tuple[int, int]]:
        """(start, stop) Mamba2-layer ranges, one per shared-attention
        application: ``(g * attn_every, min((g + 1) * attn_every, L))``."""
        ae, L = self.arch.hybrid.attn_every, self.arch.num_layers
        return [(g * ae, min((g + 1) * ae, L)) for g in range(-(-L // ae))]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the reference's scales: normals drawn in fp32
        from ``generator`` (on its own device) and cast; norms and biases
        zero; the SSM's ``A_log``, ``D`` and ``dt_bias`` as the reference
        sets them.  An expert weight is drawn one expert at a time, so no
        fp32 temporary holds all E experts.  ``torch.Generator`` does not
        reproduce ``jax.random``: for parity with the JAX package, load
        converted weights instead."""
        arch = self.arch

        def normal(param: nn.Parameter, scale: float) -> None:
            if scale == 0.0:
                param.zero_()
                return
            x = torch.randn(param.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            param.copy_(x * scale)

        normal(self.embed, 0.02)
        normal(self.final_norm, 0.0)
        if not arch.tie_embeddings:
            normal(self.lm_head, arch.d_model ** -0.5)
        scales = {tfm.DenseBlock: tfm.init_scale,
                  moe_mod.MoEBlock: moe_mod.init_scale,
                  ssm_mod.SSMBlock: ssm_mod.init_scale}
        for blk in self.blocks:
            scale = scales[type(blk)]
            for name, param in blk.named_parameters():
                if name in moe_mod.EXPERT_WEIGHTS:
                    for expert in param:
                        normal(expert, scale(arch, name))
                else:
                    normal(param, scale(arch, name))
            if arch.ssm is not None:
                blk.init_constants()
        if arch.family == "hybrid":
            for name, param in self.shared_attn.named_parameters():
                normal(param, tfm.init_scale(arch, name))
        return self

    # ------------------------------------------------------------------
    def embed_inputs(self, tokens: torch.Tensor,
                     frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        h = layers.embed(tokens, self.embed).to(self.dtype)
        if frontend_embeds is not None:
            P = frontend_embeds.shape[1]
            h = torch.cat([frontend_embeds.to(h.dtype), h[:, P:]], dim=1)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        h = layers.rms_norm(h, self.final_norm, self.arch.norm_eps)
        table = self.embed.T if self.arch.tie_embeddings else self.lm_head
        return layers.logits(h, table)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32,
                            device=self.device).expand(B, S)

    def _block(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass as ``remat``
        says when autograd records it."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn(*args)
        extra = ({"context_fn": partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)}
            if self.remat == "dots" else {})
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **extra)

    # ------------------------------------------------------------------
    def _body_full(self, h: torch.Tensor, kv_seq: Optional[int] = None,
                   want_cache: bool = True
                   ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """Every block over the whole sequence; returns (h, cache).  With
        ``kv_seq`` the KV caches are zero-padded to ``kv_seq`` positions,
        without it they hold S; SSM states are per sequence, never padded.
        ``want_cache=False`` keeps nothing (the cache comes back empty)."""
        arch = self.arch
        B, S = h.shape[:2]
        positions = self._positions(B, S)
        if kv_seq is not None:
            cache = kvcache.init_kv(arch, B, kv_seq, self.dtype, self.device)
        elif kvcache.num_attn_applications(arch):
            cache = {"k": [], "v": []}
        else:
            cache = {}
        if arch.ssm is not None:
            cache["ssm"] = []

        def attend(h, blk, i):
            if isinstance(blk, moe_mod.MoEBlock):
                h, (k, v) = self._block(
                    moe_mod.moe_block_full, h, blk, arch, positions,
                    self.impl, self.moe_dispatch)
            else:
                h, (k, v) = self._block(tfm.dense_block_full, h, blk, arch,
                                        positions, self.impl)
            if kv_seq is not None:
                cache["k"][i][:, :S] = k
                cache["v"][i][:, :S] = v
            elif want_cache:
                cache["k"].append(k)
                cache["v"].append(v)
            return h

        def mamba(h, lo, hi):
            for blk in self.blocks[lo:hi]:
                h, state = self._block(ssm_mod.ssm_block_full, h, blk,
                                       arch, None, self.impl)
                if want_cache:
                    cache["ssm"].append(state)
            return h

        if arch.family == "ssm":
            h = mamba(h, 0, arch.num_layers)
        elif arch.family == "hybrid":
            for g, (lo, hi) in enumerate(self.hybrid_groups):
                h = mamba(attend(h, self.shared_attn, g), lo, hi)
        else:
            for i, blk in enumerate(self.blocks):
                h = attend(h, blk, i)
        return h, cache

    def _logits(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        h, _ = self._body_full(self.embed_inputs(tokens, frontend_embeds),
                               want_cache=False)
        return self.head(h)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Full-sequence forward -> fp32 logits [B, S, V]."""
        return self._logits(tokens, frontend_embeds)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy over the labels that are not
        ``LOSS_IGNORE`` (0 when all are), as the reference computes it:
        ``logsumexp`` of the fp32 logits minus the label's logit.
        ``batch``: ``tokens`` and ``labels`` [B, S] (integer), and
        ``frontend_embeds`` for a vlm/audio arch, on the model's device."""
        logits = self._logits(batch["tokens"], batch.get("frontend_embeds"))
        labels = batch["labels"].long()
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels != LOSS_IGNORE).to(logits.dtype)
        return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """Forward + cache build.  Returns (last-token logits [B,1,V],
        cache).  With ``max_seq`` the KV caches are zero-padded to
        ``max_seq`` positions, ready for ``decode_step``; without it they
        hold S."""
        S = tokens.shape[1]
        h = self.embed_inputs(tokens, frontend_embeds)
        pad = max_seq is not None and max_seq > S
        h, cache = self._body_full(h, max_seq if pad else None)
        return self.head(h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: kvcache.Cache, cache_len: int,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """One decode step at position ``cache_len`` (a host int).
        tokens: [B, 1].  Returns (logits [B,1,V], cache); the KV caches are
        written in place and each layer's SSM state is replaced in its
        list."""
        arch = self.arch
        h = layers.embed(tokens, self.embed).to(self.dtype)

        def attend(h, blk, i):
            if isinstance(blk, moe_mod.MoEBlock):
                return moe_mod.moe_block_decode(
                    h, blk, arch, cache["k"][i], cache["v"][i], cache_len,
                    self.impl, self.moe_dispatch)
            return tfm.dense_block_decode(h, blk, arch, cache["k"][i],
                                          cache["v"][i], cache_len,
                                          self.impl)

        def mamba(h, lo, hi):
            for i in range(lo, hi):
                h, cache["ssm"][i] = ssm_mod.ssm_block_decode(
                    h, self.blocks[i], arch, cache["ssm"][i])
            return h

        if arch.family == "ssm":
            h = mamba(h, 0, arch.num_layers)
        elif arch.family == "hybrid":
            for g, (lo, hi) in enumerate(self.hybrid_groups):
                h = mamba(attend(h, self.shared_attn, g), lo, hi)
        else:
            for i, blk in enumerate(self.blocks):
                h = attend(h, blk, i)
        return self.head(h), cache

    def init_cache(self, batch: int, max_seq: int) -> kvcache.Cache:
        return kvcache.init_cache(self.arch, batch, max_seq, self.dtype,
                                  self.device)
