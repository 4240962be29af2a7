"""Qwen2-7B dense LM: GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,   # GQA
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mlp_activation="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-7B",
)
