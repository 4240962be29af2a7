"""Pixtral-12B: pixtral-ViT frontend (STUB) + mistral-nemo-style backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a stub per the assignment: ``input_specs()``
provides precomputed patch embeddings of shape (batch, patches, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,   # GQA
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_activation="silu",
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    source="hf:mistralai/Pixtral-12B-2409 (unverified)",
)
