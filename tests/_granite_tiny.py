"""A tiny ``granitemoehybrid`` configuration (Granite-4.0-H's keys at d 64:
one period of the layer pattern, a Mamba2 layer, an attention layer and a
Mamba2 layer again, each with 8 experts top-2 and a shared MLP) and its
plain float32 reference, ``portbench/arch/granitemoehybrid.py``, for the
port's CPU tests."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import harness, weights  # noqa: E402

TINY = {
    "name": "granite-tiny", "source": "toy", "model_type": "granitemoehybrid",
    "hidden_act": "silu", "position_embedding_type": "nope",
    "normalization_function": "rmsnorm", "attention_bias": False,
    "mamba_proj_bias": False, "mamba_conv_bias": True,
    "tie_word_embeddings": True, "hidden_size": 64,
    "num_attention_heads": 4, "num_key_value_heads": 2, "mamba_n_heads": 8,
    "mamba_d_head": 16, "mamba_expand": 2, "mamba_n_groups": 1,
    "mamba_d_state": 16, "mamba_d_conv": 4, "mamba_chunk_size": 32,
    "num_local_experts": 8, "num_experts_per_tok": 2,
    "intermediate_size": 32, "shared_intermediate_size": 48,
    "vocab_size": 512, "num_hidden_layers": 3,
    "layer_types": ["mamba", "attention", "mamba"], "rms_norm_eps": 1e-5,
    "embedding_multiplier": 12.0, "attention_multiplier": 0.0625,
    "residual_multiplier": 0.22, "logits_scaling": 16.0,
    "torch_dtype": "float32", "serving": {"max_batch": 4, "max_seq": 64}}


def family():
    """The family file of the benchmark (reference, layout, build)."""
    return harness.family(REPO, "granitemoehybrid")


def model_and_weights(seed: int = 5, cfg=None):
    """The port's model of ``cfg`` (default :data:`TINY`) on the CPU with
    the seeded weights, and the reference's copy of them by name."""
    cfg = cfg or TINY
    fam = family()
    model = fam.build(cfg, seed, "cpu")
    w = weights.all_weights(fam.layout(cfg), seed, "cpu",
                            weights.served_dtype(cfg))
    return model, w


def reference(w, seqs, rows, cfg=None, quant=None):
    """The plain reference's fp32 logits of ``seqs`` at ``rows``."""
    return family().logits(cfg or TINY, w.__getitem__, seqs, rows,
                           quant=quant)
