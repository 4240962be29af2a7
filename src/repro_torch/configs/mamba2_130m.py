"""Mamba2-130M: attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,      # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk_size=128),
    source="arXiv:2405.21060 (unverified)",
)
