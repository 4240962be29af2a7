"""The port's model: the dense-family decoders (dense, vlm, audio).

PyTorch counterpart of ``repro.models.Model`` with the same entry points,
holding its parameters as an ``nn.Module``:

* ``forward(tokens, frontend_embeds=None)``           -- fp32 logits [B,S,V]
* ``prefill(tokens, frontend_embeds=None, max_seq=None)`` -- last-token
  logits and the KV cache
* ``decode_step(cache, cache_len, tokens)``            -- one token vs cache

Modality frontends (vlm/audio) are stubs, as in the reference: the first P
positions take precomputed embeddings.  MoE, SSM and hybrid families and
the training loss are later slices of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import kvcache, layers
from repro_torch.models import transformer as tfm

NUM_FRONTEND_POSITIONS = 64
DENSE_FAMILIES = ("dense", "vlm", "audio")
_LATER = {"moe": "ROADMAP queue 1, next item 4 (models/moe.py)",
          "ssm": "ROADMAP queue 1, next item 3 (models/ssm.py)",
          "hybrid": "ROADMAP queue 1, next item 3 (models/ssm.py)"}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present, so the port never drops to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device is available; pass "
                           "device='cpu' to run on the host")
    return dev


class Model(nn.Module):
    """A dense-family decoder on one device.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    ``"meta"`` builds the shapes without allocating.  Parameters are made
    with ``torch.empty``: fill them with :meth:`init` or
    ``load_state_dict`` (e.g. from ``convert.from_jax_params``)."""

    def __init__(self, arch: ArchConfig,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "kernel"):
        super().__init__()
        if arch.family not in DENSE_FAMILIES:
            raise NotImplementedError(
                f"{arch.name}: family {arch.family!r} is not ported yet: "
                f"{_LATER.get(arch.family, 'unknown family')}")
        if attn_impl not in tfm.ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {tfm.ATTN_IMPLS}")
        self.arch = arch
        self.device = resolve_device(device)
        self.dtype = dtype
        self.attn_impl = attn_impl
        d, V = arch.d_model, arch.vocab_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=self.device,
                                            dtype=dtype), requires_grad=False)

        self.embed = param(V, d)
        self.final_norm = param(d)
        if not arch.tie_embeddings:
            self.lm_head = param(d, V)
        self.blocks = nn.ModuleList(
            tfm.DenseBlock(arch, self.device, dtype)
            for _ in range(arch.num_layers))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the reference's scales: normals drawn in fp32
        from ``generator`` (on its own device) and cast; norms and biases
        zero.  ``torch.Generator`` does not reproduce ``jax.random``: for
        parity with the JAX package, load converted weights instead."""
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
        for blk in self.blocks:
            for name, param in blk.named_parameters():
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

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Full-sequence forward -> fp32 logits [B, S, V]."""
        B, S = tokens.shape
        h = self.embed_inputs(tokens, frontend_embeds)
        positions = self._positions(B, S)
        for blk in self.blocks:
            h, _ = tfm.dense_block_full(h, blk, self.arch, positions,
                                        self.attn_impl)
        return self.head(h)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """Forward + cache build.  Returns (last-token logits [B,1,V],
        cache).  With ``max_seq`` the caches are zero-padded to ``max_seq``
        positions, ready for ``decode_step``; without it they hold S."""
        B, S = tokens.shape
        h = self.embed_inputs(tokens, frontend_embeds)
        positions = self._positions(B, S)
        pad = max_seq is not None and max_seq > S
        cache = (self.init_cache(B, max_seq) if pad
                 else {"k": [], "v": []})
        for i, blk in enumerate(self.blocks):
            h, (k, v) = tfm.dense_block_full(h, blk, self.arch, positions,
                                             self.attn_impl)
            if pad:
                cache["k"][i][:, :S] = k
                cache["v"][i][:, :S] = v
            else:
                cache["k"].append(k)
                cache["v"].append(v)
        return self.head(h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: kvcache.Cache, cache_len: int,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, kvcache.Cache]:
        """One decode step at position ``cache_len`` (a host int).
        tokens: [B, 1].  Returns (logits [B,1,V], cache); the caches are
        updated in place."""
        h = layers.embed(tokens, self.embed).to(self.dtype)
        for i, blk in enumerate(self.blocks):
            h = tfm.dense_block_decode(h, blk, self.arch, cache["k"][i],
                                       cache["v"][i], cache_len,
                                       self.attn_impl)
        return self.head(h), cache

    def init_cache(self, batch: int, max_seq: int) -> kvcache.Cache:
        return kvcache.init_cache(self.arch, batch, max_seq, self.dtype,
                                  self.device)
