"""Zamba2-7B hybrid: Mamba2 backbone + shared attention block. [arXiv:2411.15242; unverified]

81 backbone layers; a single shared transformer block (MHA kv=32, d_ff=14336)
is applied every ``attn_every`` backbone layers, weights shared across
applications (each application keeps its own KV cache).
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,   # MHA in the shared block
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    mlp_activation="silu",
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk_size=128),
    hybrid=HybridConfig(attn_every=6),
    source="arXiv:2411.15242 (unverified)",
)
