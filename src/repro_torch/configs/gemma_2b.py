"""Gemma-2B dense LM: GeGLU, head_dim=256, MQA (kv=1). [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,   # MQA on the 2b
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_activation="gelu",  # GeGLU
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2403.08295; hf:google/gemma-2b",
)
