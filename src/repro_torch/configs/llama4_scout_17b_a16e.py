"""Llama-4 Scout 17B-active / 16 experts, top-1 routed MoE + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,   # GQA
    head_dim=128,
    d_ff=8192,        # shared-expert / dense ff width
    vocab_size=202048,
    mlp_activation="silu",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, experts_per_token=1, d_ff_expert=8192,
                  shared_expert=True),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
)
