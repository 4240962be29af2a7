"""The ``qwen2`` family: a dense decoder of pre-norm residual blocks, each
grouped-query attention with rotary positions and an optional q/k/v bias,
then a SiLU-gated MLP; the logit head is the embedding table (tied) or its
own matrix.

The harness finds this file by the configuration's ``model_type`` and uses
only what ``__all__`` names:

* ``build(cfg, seed, device)``: the port's ``Model`` with the seeded weights;
* ``layout(cfg)``: (name, shape, std) of every parameter, in stream order;
* ``logits(cfg, weight, seqs, rows, quant)``: the plain float32 reference
  forward (the fp8 control with ``quant="fp8"``), which imports nothing of
  ``repro`` or ``repro_torch``;
* ``sequence_flops(cfg, prompt_len, new_tokens)``: one request's model FLOPs;
* ``kernel_work(cfg, B, S, new_tokens)``: one batch's attention calls by
  kernel, ``{"flash": [(FLOPs, bytes), ...], "decode": [...]}``.

The port's configuration (``ArchConfig``) is made from the file's published
sizes under their Hugging Face names, so the configuration that runs is the
file's and not the port's registry entry.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence

import torch

from portbench import count, weights
from portbench.reference import linear, no_tf32

__all__ = ("build", "layout", "logits", "sequence_flops", "kernel_work")

ATTN_ROWS = 2048          # query rows of one reference attention block


# -- the program ----------------------------------------------------------
def _arch_config(cfg: Mapping):
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
    model = Model(_arch_config(cfg), device=device,
                  dtype=weights.served_dtype(cfg))
    weights.load_into(model, layout(cfg), seed)
    return model


def layout(cfg: Mapping) -> weights.Layout:
    """(name, shape, standard deviation) of every parameter, in stream
    order, under the port's names and shapes (``wq [d, H, hd]``, ``wo [H,
    hd, d]``, ``wg [d, f]`` ...).  Norm weights act as ``1 + w`` and, like
    the q/k/v biases, are drawn small and non-zero, so the comparison
    reaches them."""
    d, H, KV, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    f, V = cfg["intermediate_size"], cfg["vocab_size"]
    out = [("embed", (V, d), 0.02), ("final_norm", (d,), 0.1)]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, V), d ** -0.5))
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        out += [(p + "attn_norm", (d,), 0.1),
                (p + "wq", (d, H, hd), d ** -0.5),
                (p + "wk", (d, KV, hd), d ** -0.5),
                (p + "wv", (d, KV, hd), d ** -0.5),
                (p + "wo", (H, hd, d), (H * hd) ** -0.5)]
        if cfg["attention_bias"]:
            out += [(p + "bq", (H, hd), 0.1), (p + "bk", (KV, hd), 0.1),
                    (p + "bv", (KV, hd), 0.1)]
        out += [(p + "mlp_norm", (d,), 0.1), (p + "wg", (d, f), d ** -0.5),
                (p + "wu", (d, f), d ** -0.5), (p + "wd", (f, d), f ** -0.5)]
    return out


# -- the plain float32 reference --------------------------------------------
# Written from the architecture's equations with plain ``torch`` operations
# (no kernel, cache or batching of the program).  RMSNorm scaled by
# ``1 + w``, q/k/v projections with an optional bias, split-half RoPE,
# causal grouped-query attention at ``1/sqrt(hd)``, output projection, a
# SiLU-gated MLP.  The layer loop runs over the layers outside and the
# sequences inside, so each layer's weights are made float32 once for all
# sequences.
def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1; the first half of a head pairs
    with the second half."""
    T, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               rows: int = ATTN_ROWS) -> torch.Tensor:
    """Causal GQA: q [T, H, hd], k/v [T, KV, hd] -> [T, H, hd], in blocks
    of ``rows`` query rows (each row's softmax is its own, so the blocks
    change nothing but the memory a long sequence needs)."""
    T, H, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(T, KV, H // KV, hd) * hd ** -0.5
    pos = torch.arange(T, device=q.device)
    out = []
    for a in range(0, T, rows):
        b = min(a + rows, T)
        s = torch.einsum("tkgd,skd->kgts", qg[a:b], k[:b])
        mask = pos[a:b, None] >= pos[None, :b]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("kgts,skd->tkgd", p, v[:b]))
    return torch.cat(out).reshape(T, H, hd)


def _block(h: torch.Tensor, w: Mapping[str, torch.Tensor], cfg: Mapping,
           quant: Optional[str]) -> torch.Tensor:
    T, d = h.shape
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    x = _rms_norm(h, w["attn_norm"], eps)
    q = linear(x, w["wq"].reshape(d, H * hd), quant).view(T, H, hd)
    k = linear(x, w["wk"].reshape(d, KV * hd), quant).view(T, KV, hd)
    v = linear(x, w["wv"].reshape(d, KV * hd), quant).view(T, KV, hd)
    if cfg["attention_bias"]:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    o = _attention(q, k, v).reshape(T, H * hd)
    h = h + linear(o, w["wo"].reshape(H * hd, d), quant)
    x = _rms_norm(h, w["mlp_norm"], eps)
    g = torch.nn.functional.silu(linear(x, w["wg"], quant))
    return h + linear(g * linear(x, w["wu"], quant), w["wd"], quant)


@torch.no_grad()
def logits(cfg: Mapping, weight: Callable[[str], torch.Tensor],
           seqs: Sequence[torch.Tensor], rows: Sequence[slice],
           quant: Optional[str] = None) -> List[torch.Tensor]:
    """fp32 logits [rows, V] of each token sequence (positions from 0),
    at the rows ``rows[i]`` of sequence i.  ``weight(name)`` gives one
    weight by its name in :func:`layout`."""
    with no_tf32():
        embed = weight("embed")
        hs = [embed[s].float() for s in seqs]
        names = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wg",
                 "wu", "wd") + (("bq", "bk", "bv")
                                if cfg["attention_bias"] else ())
        for i in range(cfg["num_hidden_layers"]):
            w = {n: weight(f"blocks.{i}.{n}").float() for n in names}
            hs = [_block(h, w, cfg, quant) for h in hs]
            del w
        head = (embed.t() if cfg["tie_word_embeddings"]
                else weight("lm_head")).float()
        norm = weight("final_norm").float()
        return [linear(_rms_norm(h[r], norm, cfg["rms_norm_eps"]), head,
                       quant)
                for h, r in zip(hs, rows)]


# -- work counted from shapes ------------------------------------------------
def _layer_matmul_params(cfg: Mapping) -> int:
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
    flops = 2.0 * _layer_matmul_params(cfg) * L * fed
    pairs = prompt_len * (prompt_len + 1) // 2
    pairs += sum(prompt_len + j + 1 for j in range(max(new_tokens - 1, 0)))
    flops += 4.0 * H * hd * pairs * L
    flops += 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * new_tokens
    return flops


def kernel_work(cfg: Mapping, B: int, S: int, new_tokens: int) -> dict:
    """The attention calls one batch of ``B`` prompts padded to ``S`` makes
    when it generates ``new_tokens``, each as (FLOPs, bytes): under
    ``"flash"`` one prefill call a layer, under ``"decode"`` one call a
    layer for each of the ``new_tokens - 1`` steps, step j over
    ``S + j + 1`` positions."""
    L = cfg["num_hidden_layers"]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    flash = [count.flash_work(B, S, H, KV, hd)] * L
    decode = [count.decode_work(B, S + j + 1, H, KV, hd)
              for j in range(max(new_tokens - 1, 0)) for _ in range(L)]
    return {"flash": flash, "decode": decode}
