"""Llama-4 Maverick ~400B total / 17B-active, 128 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Maverick-17B-128E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,   # GQA
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_activation="silu",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=1, d_ff_expert=8192,
                  shared_expert=True, moe_every=2),  # interleaved MoE (real maverick)
    source="hf:meta-llama/Llama-4-Maverick-17B-128E (unverified)",
)
