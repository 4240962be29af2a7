"""Operations and bytes counted from shapes, and the card's published peaks.

Kernel work is counted from the shapes of each call, so it stays the same
whatever implements the call.  The per-call arithmetic follows the dry-run's
``_flash_work`` and ``_decode_work``: each input byte read once, each
output byte written once, and only the query/key pairs the call needs.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

# One NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of the
    operations at the bf16 peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S)


def mfu_pct(run) -> Optional[float]:
    """The model FLOPs a run served over the seconds they took, as a share
    of the card's bf16 peak (``run.model_flops`` over ``run.model_s``); no
    reading off the card or without work."""
    if not run.on_cuda or not run.model_flops or not run.model_s > 0:
        return None
    return 100.0 * run.model_flops / (run.model_s * PEAK_BF16_FLOPS)


def flash_work(B: int, S: int, H: int, KV: int, hd: int,
               itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal prefill attention call over S rows:
    QK^T and PV over the S(S+1)/2 causal pairs; q, k, v read once and the
    output written once."""
    pairs = S * (S + 1) // 2
    flops = 4.0 * B * H * hd * pairs
    nbytes = float(itemsize) * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    return flops, nbytes


def decode_work(B: int, L: int, H: int, KV: int, hd: int,
                itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode attention call: one query row a
    sequence against ``L`` cache positions, which it alone reads."""
    flops = 4.0 * B * H * hd * L
    nbytes = float(itemsize) * (2 * B * H * hd + 2 * B * L * KV * hd)
    return flops, nbytes


def layer_matmul_params(cfg: Mapping) -> int:
    """Weights one layer multiplies a token by: the q/k/v/o projections and
    the gated MLP (norms and biases add no products)."""
    d, H, KV, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    f = cfg["intermediate_size"]
    return d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f


def sequence_flops(cfg: Mapping, prompt_len: int, new_tokens: int) -> float:
    """Model FLOPs of serving one request greedily: every layer over the
    prompt and the ``new_tokens - 1`` generated tokens fed back, attention
    at the true (unpadded) lengths, and the logit head at the
    ``new_tokens`` rows that produce a token."""
    L = cfg["num_hidden_layers"]
    H, hd = cfg["num_attention_heads"], cfg["head_dim"]
    fed = prompt_len + max(new_tokens - 1, 0)
    flops = 2.0 * layer_matmul_params(cfg) * L * fed
    pairs = prompt_len * (prompt_len + 1) // 2
    pairs += sum(prompt_len + j + 1 for j in range(max(new_tokens - 1, 0)))
    flops += 4.0 * H * hd * pairs * L
    flops += 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * new_tokens
    return flops


def batch_attention_calls(cfg: Mapping, B: int, S: int, new_tokens: int
                          ) -> Tuple[list, list]:
    """The attention calls one batch of ``B`` prompts padded to ``S`` makes
    when it generates ``new_tokens``: one prefill call a layer, then one
    decode call a layer for each of the ``new_tokens - 1`` steps, step j
    over ``S + j + 1`` positions.  Returns (flash calls, decode calls), each
    a list of (FLOPs, bytes)."""
    L = cfg["num_hidden_layers"]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    flash = [flash_work(B, S, H, KV, hd)] * L
    decode = [decode_work(B, S + j + 1, H, KV, hd)
              for j in range(max(new_tokens - 1, 0)) for _ in range(L)]
    return flash, decode
