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
(``models.moe``), each with its own KV cache.  The ``hybrid_moe`` family
(the port's own, ``configs.base.GraniteHybridConfig``: IBM Granite-4.0-H)
runs each layer's mixer, a Mamba2 (``HybridMambaBlock``) or a NoPE
attention (``moe.MoEBlock``'s) as ``layer_types`` says, then the layer's
dropless MoE block, each branch added to the residual times
``residual_multiplier``; its embedding and logits carry Granite's
multipliers.  Its cache holds one KV pair an attention layer and one
state a Mamba2 layer.

Parameters are made frozen; ``model.requires_grad_(True)`` makes them
trainable (``training.train_step`` does).  The serving entry points run
under ``torch.no_grad()``, so their outputs never carry a graph.

``tracer`` (an ``obs.Tracer``, which ``serving.Engine`` hands over) makes
the Mamba2 layers record an ``ssm.scan`` span at prefill (arg ``layer``)
and an ``ssm.step`` span at decode (args ``layer`` and ``route``: the
route ``ssm.ssm_step_routes`` tallied, the kernel or the plain step), and
the ``hybrid_moe`` family's MoE calls a ``moe.experts`` span (args ``layer``, ``route``,
``rows``: the routed (token, expert) pairs); host time around the
enqueue, no synchronisation.  Without one nothing is recorded.

``policy`` (a ``sharding.policy.ShardingPolicy``) pins activations by
logical axis at the reference's places; ``None`` or a policy without a
mesh changes nothing.  With a mesh, :meth:`distribute` places each
parameter as a DTensor per :meth:`param_specs` (after the weights are
loaded), and the entry points run with plain inputs taken as replicated
(``implicit_replication``); the kernels run on local shards
(``kernels.ops.on_shards``).  The layers are one module each, so every
per-layer spec is the reference's stacked spec without its ``"layers"``
entry.
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache, layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.sharding.policy import (NULL_POLICY, PartitionSpec,
                                         ShardingPolicy, is_dtensor)

NUM_FRONTEND_POSITIONS = 64
LOSS_IGNORE = -1
DENSE_FAMILIES = ("dense", "vlm", "audio")
FAMILIES = DENSE_FAMILIES + ("moe", "ssm", "hybrid")
# families of the port alone (the JAX package has none of them)
PORT_FAMILIES = ("hybrid_moe",)
IMPLS = ("kernel", "plain")
REMATS = ("none", "full", "dots")
# "dots" keeps what jax.checkpoint_policies.dots_with_no_batch_dims_saveable
# keeps: the products with no batch dims (x @ w).  Attention's and the SSD's
# einsums (bmm) and everything elementwise are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class HybridMambaBlock(ssm_mod.SSMBlock):
    """A ``hybrid_moe`` Mamba2 layer: ``SSMBlock``'s parameters, then the
    MoE block's (``moe.moe_shapes``)."""

    def __init__(self, arch: ArchConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__(arch, device, dtype)
        tfm.register_empty(self, moe_mod.moe_shapes(arch), device, dtype)


def _hybrid_scale(arch: ArchConfig, name: str) -> float:
    if name in moe_mod.moe_shapes(arch):
        return moe_mod.init_scale(arch, name)
    return ssm_mod.init_scale(arch, name)


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
    ``impl`` routes every kernel of the model (attention, SSD, norms)
    through ``kernels.ops`` (``"kernel"``) or to the plain versions
    directly (``"plain"``).  ``moe_dispatch`` is the MoE layers' dispatch
    (``models.moe.DISPATCHES``).  ``remat`` (``REMATS``, the reference's)
    recomputes each block in the backward pass under autograd: all of it
    (``"full"``) or all but its ``x @ w`` products (``"dots"``).  The CUDA
    kernels have no backward: training runs ``impl="plain"``.  ``policy``
    (default none) shards the model over its mesh (module docstring); a
    mesh of another device type than ``device`` raises (a ``meta`` model,
    shapes and specs alone, takes any mesh)."""

    def __init__(self, arch: ArchConfig,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 impl: str = "kernel", moe_dispatch: str = "auto",
                 remat: str = "none",
                 policy: Optional[ShardingPolicy] = None):
        super().__init__()
        if arch.family not in FAMILIES + PORT_FAMILIES:
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
        self.policy = policy if policy is not None else NULL_POLICY
        self.tracer = None
        mesh = self.policy.mesh
        if mesh is not None and arch.family in PORT_FAMILIES:
            raise NotImplementedError(f"{arch.name}: the {arch.family} "
                                      f"family runs on one device")
        if (mesh is not None and self.device.type != "meta"
                and mesh.device_type != self.device.type):
            raise ValueError(f"{arch.name}: the policy's mesh is on "
                             f"{mesh.device_type!r}, the model on "
                             f"{self.device.type!r}")
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
        if arch.family == "hybrid_moe":
            return [HybridMambaBlock if t == "mamba" else moe_mod.MoEBlock
                    for t in arch.layer_types]
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
    @property
    def sharded(self) -> bool:
        """Whether the policy has a mesh."""
        return self.policy.mesh is not None

    def param_specs(self) -> Dict[str, Any]:
        """The reference's ``Model.param_specs`` tree, each block's specs
        per layer (without the ``"layers"`` entry)."""
        arch, pol = self.arch, self.policy
        sp = pol.spec
        specs: Dict[str, Any] = {"embed": sp("vocab", "embed"),
                                 "final_norm": sp(None)}
        if not arch.tie_embeddings:
            specs["lm_head"] = sp("embed", "vocab")
        if arch.family == "moe":
            body = {"moe": {**tfm.attn_specs(arch, pol),
                            **moe_mod.moe_specs(arch, pol)}}
            if self.moe_group[1]:
                body["dense"] = tfm.dense_block_specs(arch, pol)
            specs["blocks"] = body
        elif arch.ssm is not None:
            specs["blocks"] = ssm_mod.ssm_specs(arch, pol)
        else:
            specs["blocks"] = tfm.dense_block_specs(arch, pol)
        if arch.family == "hybrid":
            specs["shared_attn"] = tfm.dense_block_specs(arch, pol)
        return specs

    def named_param_specs(self) -> Dict[str, PartitionSpec]:
        """Parameter name (``named_parameters``) -> its spec."""
        specs = self.param_specs()
        out = {k: specs[k] for k in ("embed", "final_norm", "lm_head")
               if k in specs}
        for i, blk in enumerate(self.blocks):
            table = specs["blocks"]
            if self.arch.family == "moe":
                table = (table["moe"] if isinstance(blk, moe_mod.MoEBlock)
                         else table["dense"])
            out.update({f"blocks.{i}.{n}": table[n]
                        for n, _ in blk.named_parameters()})
        if self.arch.family == "hybrid":
            out.update({f"shared_attn.{n}": specs["shared_attn"][n]
                        for n, _ in self.shared_attn.named_parameters()})
        return out

    def cache_specs(self) -> kvcache.Cache:
        return kvcache.cache_specs(self.arch, self.policy)

    @torch.no_grad()
    def distribute(self) -> "Model":
        """Each parameter as a DTensor on the policy's mesh, placed per
        :meth:`named_param_specs` (``distribute_tensor`` from rank 0's
        values); a no-op without a mesh or when already placed."""
        if not self.sharded:
            return self
        from torch.distributed.tensor import DTensor, distribute_tensor
        mesh, specs = self.policy.mesh, self.named_param_specs()
        for name, p in list(self.named_parameters()):
            if isinstance(p, DTensor):
                continue
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            placed = distribute_tensor(
                p.detach(), mesh, self.policy.placements_of(specs[name]))
            module.register_parameter(leaf, nn.Parameter(
                placed, requires_grad=p.requires_grad))
        return self

    def on_mesh(self):
        """The context the entry points run in: under a mesh, plain
        tensors (tokens, positions, masks) count as replicated."""
        if not self.sharded:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

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
                  ssm_mod.SSMBlock: ssm_mod.init_scale,
                  HybridMambaBlock: _hybrid_scale}
        for blk in self.blocks:
            scale = scales[type(blk)]
            for name, param in blk.named_parameters():
                if name in moe_mod.EXPERT_WEIGHTS:
                    for expert in param:
                        normal(expert, scale(arch, name))
                else:
                    normal(param, scale(arch, name))
            if isinstance(blk, ssm_mod.SSMBlock):
                blk.init_constants()
        if arch.family == "hybrid":
            for name, param in self.shared_attn.named_parameters():
                normal(param, tfm.init_scale(arch, name))
        return self

    # ------------------------------------------------------------------
    def _token_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens`` split on the batch where the embedding table is
        vocab-sharded and whole over the batch's mesh dims: each rank then
        looks up, and reduces the lookup's pending sum of, its own rows
        only (with the tokens whole, every rank reduced the whole batch)."""
        table = self.embed
        if not (self.sharded and is_dtensor(table) and any(
                p.is_shard() and n > 1
                for p, n in zip(table.placements, table.device_mesh.shape))):
            return tokens
        pol = self.policy
        want = pol.placements_of(pol.pin_spec(tuple(tokens.shape), "batch",
                                              None))
        if any(w.is_shard() and not t.is_replicate()
               for w, t in zip(want, table.placements)):
            return tokens
        return pol.pin(tokens, "batch", None)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' rows of the table, times the arch's embedding
        multiplier where it has one."""
        h = layers.embed(self._token_rows(tokens), self.embed).to(self.dtype)
        m = self.arch.embedding_multiplier
        return h if m == 1.0 else h * m

    def embed_inputs(self, tokens: torch.Tensor,
                     frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        h = self._embed(tokens)
        if frontend_embeds is not None:
            h = self.policy.pin(h, "batch", "seq", None)
            P = frontend_embeds.shape[1]
            h = torch.cat([frontend_embeds.to(h.dtype), h[:, P:]], dim=1)
        return self.policy.pin(h, "batch", "seq", None)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        h = layers.rms_norm(h, self.final_norm, self.arch.norm_eps,
                            self.impl)
        table = (layers.grad_placed(self.embed).T if self.arch.tie_embeddings
                 else self.lm_head)
        out = layers.logits(h, table)
        if self.arch.logits_scaling != 1.0:
            out = out / self.arch.logits_scaling
        return self.policy.pin(out, "batch", "seq", "vocab")

    def _span(self, name: str, **args):
        """A span of the model's tracer (module docstring), or nothing."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, "model", **args)

    def _ssm_step(self, i: int, fn, *args):
        """Layer ``i``'s Mamba2 decode step ``fn(*args)`` in an
        ``ssm.step`` span, its ``route`` the one ``ssm_step_routes``
        tallied for it."""
        if self.tracer is None:
            return fn(*args)
        before = dict(ssm_mod.ssm_step_routes)
        with self._span("ssm.step", layer=i) as span:
            out = fn(*args)
            span.args["route"] = "+".join(
                r for r, n in ssm_mod.ssm_step_routes.items()
                if n > before[r])
        return out

    def _moe(self, h: torch.Tensor, blk, i: int) -> torch.Tensor:
        """Layer ``i``'s MoE block on h [B, S, d] (the ``hybrid_moe``
        family)."""
        arch = self.arch
        if self.tracer is None:
            return moe_mod.moe_mlp(h, blk, arch, self.moe_dispatch, layer=i,
                                   impl=self.impl)
        route = moe_mod.route_of(arch, self.moe_dispatch, self.policy)
        rows = h.shape[0] * h.shape[1] * arch.moe.experts_per_token
        with self._span("moe.experts", layer=i, route=route, rows=rows):
            return moe_mod.moe_mlp(h, blk, arch, self.moe_dispatch, layer=i,
                                   impl=self.impl)

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
                   want_cache: bool = True,
                   into: Optional[kvcache.Cache] = None
                   ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """Every block over the whole sequence; returns (h, cache).  With
        ``kv_seq`` the KV caches are zero-padded to ``kv_seq`` positions,
        without it they hold S; SSM states are per sequence, never padded.
        ``want_cache=False`` keeps nothing (the cache comes back empty).
        ``into`` (a cache of this batch's rows, KV of at least S positions)
        takes the KV prefix and the states in place and is returned."""
        arch, pol = self.arch, self.policy
        B, S = h.shape[:2]
        positions = self._positions(B, S)
        if into is not None:
            cache = into
        elif kv_seq is not None:
            # the reference pads the prefill's K/V to max_seq, then the
            # decode steps pin the cache on cache_seq: the port allocates
            # the cache on those placements and writes the prefix into it
            cache = kvcache.init_kv(arch, B, kv_seq, self.dtype, self.device,
                                    pol)
        elif kvcache.num_attn_applications(arch):
            cache = {"k": [], "v": []}
        else:
            cache = {}
        if arch.ssm is not None and into is None:
            cache["ssm"] = []

        def keep_state(j, state):
            if into is not None:
                for dst, src in zip(cache["ssm"][j], state):
                    dst.copy_(src)
            elif want_cache:
                cache["ssm"].append(state)

        def keep(i, k, v):
            if kv_seq is not None or into is not None:
                kvcache.write_prefix(cache["k"][i], k)
                kvcache.write_prefix(cache["v"][i], v)
            elif want_cache:
                cache["k"].append(k)
                cache["v"].append(v)

        def attend(h, blk, i):
            if isinstance(blk, moe_mod.MoEBlock):
                h, (k, v) = self._block(
                    moe_mod.moe_block_full, h, blk, arch, positions,
                    self.impl, self.moe_dispatch, pol)
            else:
                h, (k, v) = self._block(tfm.dense_block_full, h, blk, arch,
                                        positions, self.impl, pol)
            keep(i, k, v)
            return h

        def mamba(h, lo, hi):
            for i in range(lo, hi):
                with self._span("ssm.scan", layer=i):
                    h, state = self._block(ssm_mod.ssm_block_full, h,
                                           self.blocks[i], arch, None,
                                           self.impl, pol)
                keep_state(i, state)
            return h

        def hybrid_moe(h):
            m, a, j = arch.residual_multiplier, 0, 0
            for i, blk in enumerate(self.blocks):
                if isinstance(blk, ssm_mod.SSMBlock):
                    with self._span("ssm.scan", layer=i):
                        out, state = ssm_mod.ssm_mixer_full(
                            h, blk, arch, None, self.impl)
                    keep_state(j, state)
                    j += 1
                else:
                    out, (k, v) = tfm.attention_full(h, blk, arch, positions,
                                                     self.impl)
                    keep(a, k, v)
                    a += 1
                h = h + out * m
                h = h + self._moe(h, blk, i) * m
            return h

        if arch.family == "hybrid_moe":
            h = hybrid_moe(h)
        elif arch.family == "ssm":
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
        with self.on_mesh():
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
        with self.on_mesh():
            labels = batch["labels"].long()
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, labels.clamp_min(0)[..., None])
            # on vocab-sharded logits the gather is a pending masked sum
            ll = self.policy.pin(ll, "batch", "seq", None)[..., 0]
            mask = (labels != LOSS_IGNORE).to(logits.dtype)
            return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None,
                into: Optional[kvcache.Cache] = None
                ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """Forward + cache build.  Returns (last-token logits [B,1,V],
        cache).  With ``max_seq`` the KV caches are zero-padded to
        ``max_seq`` positions, ready for ``decode_step``; without it they
        hold S.  With ``into`` (caches of this batch's rows, such as
        ``GraphedDecode.rows``) the KV prefix and the states are written
        into it in place, and it is the cache returned."""
        S = tokens.shape[1]
        with self.on_mesh():
            h = self.embed_inputs(tokens, frontend_embeds)
            pad = max_seq is not None and max_seq > S
            h, cache = self._body_full(h, max_seq if pad else None,
                                       into=into)
            return self.head(h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: kvcache.Cache, cache_len: int,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """One decode step at position ``cache_len`` (a host int).
        tokens: [B, 1].  Returns (logits [B,1,V], cache); the KV caches are
        written in place and each layer's SSM state is replaced in its
        list."""
        with self.on_mesh():
            return self._decode(cache, cache_len, tokens)

    def _decode(self, cache: kvcache.Cache, cache_len: int,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, kvcache.Cache]:
        arch, pol = self.arch, self.policy
        h = pol.pin(self._embed(tokens), "batch", None, None)

        def attend(h, blk, i):
            if isinstance(blk, moe_mod.MoEBlock):
                return moe_mod.moe_block_decode(
                    h, blk, arch, cache["k"][i], cache["v"][i], cache_len,
                    self.impl, self.moe_dispatch, pol)
            return tfm.dense_block_decode(h, blk, arch, cache["k"][i],
                                          cache["v"][i], cache_len,
                                          self.impl, pol)

        def mamba(h, lo, hi):
            for i in range(lo, hi):
                h, cache["ssm"][i] = self._ssm_step(
                    i, ssm_mod.ssm_block_decode, h, self.blocks[i], arch,
                    cache["ssm"][i], self.impl, pol)
            return h

        def hybrid_moe(h):
            m, a, j = arch.residual_multiplier, 0, 0
            for i, blk in enumerate(self.blocks):
                if isinstance(blk, ssm_mod.SSMBlock):
                    out, cache["ssm"][j] = self._ssm_step(
                        i, ssm_mod.ssm_mixer_decode, h, blk, arch,
                        cache["ssm"][j], self.impl)
                    j += 1
                else:
                    out = tfm.attention_decode(h, blk, arch, cache["k"][a],
                                               cache["v"][a], cache_len,
                                               self.impl)
                    a += 1
                h = h + out * m
                h = h + self._moe(h, blk, i) * m
            return h

        if arch.family == "hybrid_moe":
            h = hybrid_moe(h)
        elif arch.family == "ssm":
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
                                  self.device, self.policy)
