"""MusicGen-large: decoder-only transformer over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec audio frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings; the backbone predicts codebook tokens
(vocab 2048).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,   # MHA
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_activation="gelu",
    rope_theta=10_000.0,
    frontend="audio_stub",
    source="arXiv:2306.05284; hf:facebook/musicgen-large",
)
