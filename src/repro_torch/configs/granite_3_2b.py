"""IBM Granite-3.0-2B dense LM, GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,   # GQA
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    mlp_activation="silu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
