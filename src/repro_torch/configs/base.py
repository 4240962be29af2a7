"""Architecture configuration schema.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package); ``tests/test_torch_models.py`` holds the two field by field.
Every architecture is described by one :class:`ArchConfig` in its own
module under ``repro_torch.configs``; CPU tests use ``reduced()`` variants
of the same family, the card runs the full widths.

:class:`GraniteHybridConfig` is the port's own (the JAX package has no
such family): Granite-4.0-H's settings are its fields, and
:class:`ArchConfig` holds their neutral values as class variables, so the
ten configurations' fields stay the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import ClassVar, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    # llama4-style shared expert that every token also passes through.
    shared_expert: bool = True
    # capacity factor used when dropping tokens in the dense-dispatch path.
    capacity_factor: float = 1.25
    # every `moe_every`-th layer is MoE; the rest use the dense MLP (d_ff).
    # llama4-maverick interleaves MoE every other layer.
    moe_every: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyper-parameters."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: a Mamba2 backbone with a *shared* attention
    transformer block invoked every ``attn_every`` backbone layers (weights
    shared across invocations, per Zamba2)."""

    attn_every: int = 6


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads; 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    mlp_activation: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # Modality frontend. The backbone is real; the frontend is a STUB:
    # input_specs() provides precomputed patch/frame embeddings.
    frontend: str = "none"  # none | vision_stub | audio_stub
    # number of frontend embedding positions prepended for vlm/audio stubs
    source: str = ""  # citation string

    # Settings that only GraniteHybridConfig makes fields; here their
    # neutral values, which leave every other family's arithmetic as it is.
    layer_types: ClassVar[Tuple[str, ...]] = ()
    shared_ff: ClassVar[int] = 0     # 0: the shared expert is d_ff_expert wide
    embedding_multiplier: ClassVar[float] = 1.0
    attention_multiplier: ClassVar[float] = 0.0   # 0: 1/sqrt(head_dim)
    residual_multiplier: ClassVar[float] = 1.0
    logits_scaling: ClassVar[float] = 1.0
    rope: ClassVar[bool] = True
    conv_bias: ClassVar[bool] = False       # Mamba2's conv over x, B, C
    # Mamba2's gated RMSNorm: 0 normalises each head's channels (the JAX
    # package's), g > 0 each of g groups of the d_inner channels
    gate_norm_groups: ClassVar[int] = 0
    moe_dropless: ClassVar[bool] = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("moe",) and self.moe is None:
            raise ValueError(f"{self.name}: moe family requires MoEConfig")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: ssm/hybrid family requires SSMConfig")

    # -- derived sizes --------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (assignment rule:
        long_500k runs only for SSM/hybrid archs)."""
        return self.family in ("ssm", "hybrid")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def attn_params(self) -> int:
        if self.num_heads == 0:
            return 0
        hd = self.head_dim
        qk = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return qk + kv + o + bias

    def mlp_params(self) -> int:
        if self.d_ff == 0:
            return 0
        return 3 * self.d_model * self.d_ff  # gate, up, down

    def moe_params_per_layer(self) -> Tuple[int, int]:
        """(total, active) MoE params for one MoE layer."""
        if self.moe is None:
            return (0, 0)
        m = self.moe
        per_expert = 3 * self.d_model * m.d_ff_expert
        router = self.d_model * m.num_experts
        shared = per_expert if m.shared_expert else 0
        total = m.num_experts * per_expert + router + shared
        active = m.experts_per_token * per_expert + router + shared
        return total, active

    def ssm_params_per_layer(self) -> int:
        """Matches repro.models.ssm.init_ssm exactly (ngroups=1 SSD)."""
        if self.ssm is None:
            return 0
        s = self.ssm
        d_in = s.d_inner(self.d_model)
        nh = s.num_heads(self.d_model)
        in_proj = self.d_model * (2 * d_in + 2 * s.d_state + nh)
        conv = s.conv_width * (d_in + 2 * s.d_state)
        out = d_in * self.d_model
        extra = 3 * nh + d_in + self.d_model  # A_log, dt_bias, D, gate_norm, norm
        return in_proj + conv + out + extra

    def param_count(self) -> Tuple[int, int]:
        """Returns (total_params, active_params). active differs from total
        only for MoE archs (top-k routing)."""
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        norms = 2 * self.num_layers * self.d_model + self.d_model

        if self.family == "hybrid":
            # backbone of mamba2 layers + ONE shared attention+mlp block
            per_layer = self.ssm_params_per_layer()
            body = self.num_layers * per_layer
            shared_blk = self.attn_params() + self.mlp_params()
            total = emb + head + norms + body + shared_blk
            return total, total
        if self.family == "ssm":
            body = self.num_layers * self.ssm_params_per_layer()
            total = emb + head + norms + body
            return total, total
        if self.moe is not None:
            moe_total, moe_active = self.moe_params_per_layer()
            n_moe = self.num_layers // self.moe.moe_every
            n_dense = self.num_layers - n_moe
            attn = self.num_layers * self.attn_params()
            dense = n_dense * self.mlp_params()
            return (emb + head + norms + attn + dense + n_moe * moe_total,
                    emb + head + norms + attn + dense + n_moe * moe_active)
        per_layer = self.attn_params() + self.mlp_params()
        total = emb + head + norms + self.num_layers * per_layer
        return total, total

    # -- smoke-test reduction -------------------------------------------
    def reduced(self) -> "ArchConfig":
        """A tiny config of the same family for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=64,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
        )
        if self.num_heads:
            kw["num_heads"] = 4
            kw["num_kv_heads"] = min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4
            kw["head_dim"] = 16
        else:
            kw["num_heads"] = 0
            kw["num_kv_heads"] = 0
            kw["head_dim"] = 0
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=4,
                experts_per_token=self.moe.experts_per_token,
                d_ff_expert=128,
                shared_expert=self.moe.shared_expert,
            )
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                                  conv_width=self.ssm.conv_width, chunk_size=32)
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(attn_every=2)
            kw["num_layers"] = 4
            kw["num_heads"] = 4
            kw["num_kv_heads"] = 4
            kw["head_dim"] = 16
            kw["d_ff"] = 128
        return dataclasses.replace(self, **kw)

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class GraniteHybridConfig(ArchConfig):
    """IBM Granite-4.0-H (Hugging Face ``granitemoehybrid``), family
    ``"hybrid_moe"``: each layer is a mixer, Mamba2 or grouped-query
    attention as ``layer_types`` says, then an MoE block (top-k routed
    experts, dropless, and a shared SwiGLU MLP ``shared_ff`` wide), each
    branch added to the residual times ``residual_multiplier``.  The
    embedding is scaled by ``embedding_multiplier``, attention scores by
    ``attention_multiplier`` with no positional encoding, the logits
    divided by ``logits_scaling``; the Mamba2 conv over x, B and C has a
    bias and its gated RMSNorm runs over each of ``gate_norm_groups``
    groups of the d_inner channels.  ``d_ff`` is unused (0): every
    layer's MLP is its MoE block."""

    layer_types: Tuple[str, ...] = ()
    shared_ff: int = 0
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    conv_bias: bool = True
    gate_norm_groups: int = 1
    rope: ClassVar[bool] = False
    moe_dropless: ClassVar[bool] = True

    def __post_init__(self):
        super().__post_init__()
        if self.family != "hybrid_moe":
            raise ValueError(f"{self.name}: GraniteHybridConfig is the "
                             f"hybrid_moe family, not {self.family!r}")
        if self.moe is None or self.ssm is None:
            raise ValueError(f"{self.name}: hybrid_moe needs MoEConfig and "
                             f"SSMConfig")
        if len(self.layer_types) != self.num_layers or not set(
                self.layer_types) <= {"mamba", "attention"}:
            raise ValueError(f"{self.name}: layer_types must name mamba or "
                             f"attention for each of {self.num_layers} layers")
        if self.gate_norm_groups < 1 or \
                self.ssm.d_inner(self.d_model) % self.gate_norm_groups:
            raise ValueError(f"{self.name}: gate_norm_groups must divide "
                             f"d_inner")

    def param_count(self) -> Tuple[int, int]:
        """(total, active): the embedding (tied or not), the final norm, and
        each layer's mixer with its norm, then its MoE block (norm,
        router, experts, shared MLP, ``shared_ff`` wide) and, with
        ``conv_bias``, the conv's biases."""
        d, m, s = self.d_model, self.moe, self.ssm
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        expert = 3 * d * m.d_ff_expert
        shared = 3 * d * (self.shared_ff or m.d_ff_expert)
        moe_fixed = d + d * m.num_experts + shared
        bias = (s.d_inner(d) + 2 * s.d_state) if self.conv_bias else 0
        total = active = emb + d
        for kind in self.layer_types:
            mixer = (self.ssm_params_per_layer() + bias if kind == "mamba"
                     else self.attn_params() + d)
            total += mixer + moe_fixed + m.num_experts * expert
            active += mixer + moe_fixed + m.experts_per_token * expert
        return total, active

