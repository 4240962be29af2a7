"""A model of the port built from a configuration file of the benchmark.

The file gives the published sizes under their Hugging Face names; the
port's ``ArchConfig`` is made from them here, so the configuration that
runs is the file's and not the port's registry entry.
"""
from __future__ import annotations

from typing import Mapping

import torch

from portbench import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arch_config(cfg: Mapping):
    from repro_torch.configs.base import ArchConfig
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['name']}: only SiLU-gated MLPs are run")
    return ArchConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], mlp_activation="silu",
        qkv_bias=cfg["attention_bias"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]), source=cfg["source"])


def build(cfg: Mapping, seed: int, device: str):
    """The port's ``Model`` of this configuration on ``device``, in the
    configuration's dtype, holding the seeded weights."""
    from repro_torch.models import Model
    model = Model(arch_config(cfg), device=device,
                  dtype=DTYPES[cfg["torch_dtype"]])
    weights.load_into(model, cfg, seed)
    return model


def reference_weights(cfg: Mapping, seed: int, device: str):
    """The same weights, made again for the reference: ``name -> tensor``
    as a callable."""
    table = weights.all_weights(cfg, seed, device, DTYPES[cfg["torch_dtype"]])
    return table.__getitem__
