"""The ``granitemoehybrid`` family: IBM Granite-4.0-H.  Each layer is a
mixer, Mamba2 or grouped-query attention without positional encoding as
``layer_types`` says, then a mixture-of-experts block (top-k of the
routed SwiGLU experts, none dropped, plus a shared SwiGLU MLP); each
branch is added to the residual times ``residual_multiplier``.  The
embedding is scaled by ``embedding_multiplier``, attention scores by
``attention_multiplier``, the logits divided by ``logits_scaling``; the
logit head is the embedding table (tied).

The harness finds this file by the configuration's ``model_type`` and uses
only what ``__all__`` names:

* ``build(cfg, seed, device)``: the port's ``Model`` (family
  ``hybrid_moe``) with the seeded weights; it raises at once on a port
  without that family;
* ``layout(cfg)``: (name, shape, std) of every parameter, in stream order;
* ``logits(cfg, weight, seqs, rows, quant)``: the plain float32 reference
  forward (the fp8 control with ``quant="fp8"``), which imports nothing of
  ``repro``, ``repro_torch`` or ``transformers``;
* ``sequence_flops(cfg, prompt_len, new_tokens)``: one request's model FLOPs;
* ``kernel_work(cfg, B, S, new_tokens)``: one batch's calls by kernel,
  ``{"flash", "decode", "ssd_scan", "moe": [(FLOPs, bytes), ...]}``.

The port's configuration is made from the file's published keys under
their Hugging Face names, so the configuration that runs is the file's.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench import count, weights
from portbench.reference import linear, no_tf32

__all__ = ("build", "layout", "logits", "sequence_flops", "kernel_work")

ATTN_ROWS = 512           # query rows of one reference attention block
# the port's kernel and dispatch sizes that the counts follow: the SSD
# kernel's chunk (kernels/ssd_scan.py CHUNK) and the tokens of one dropless
# MoE call (models/moe.py DROPLESS_TOKENS)
SSD_CHUNK = 64
MOE_TOKENS = 8192
# Two scales of the seeded weights, below the fan-in rule, so that bf16
# rounding stays a small error and the fp8 control a large one.  At the
# fan-in rule the bf16 program's logits lay about half their spread from
# the fp32 reference's (an fp32 reference with bf16-rounded operands read
# the same): a top-10 choice flipped by rounding moved a token's residual,
# and B and C out of the SiLU with a large common positive part (B . C
# over 128 state channels) carried that token's error into every later
# token's Mamba2 output.  The program's widest gap then lay within 1.8 to
# 3.4 times of the control's, both near where the gap saturates.
CONV_BC = 0.15            # the conv weights over B and C, times cw^-1/2
EXPERT_OUT = 0.3          # the routed experts' down-projections, times f^-1/2


def _sizes(cfg: Mapping) -> dict:
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    nh, hd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    if nh * hd != cfg["mamba_expand"] * d:
        raise ValueError(f"{cfg['name']}: mamba_n_heads x mamba_d_head must "
                         f"be mamba_expand x hidden_size")
    if cfg["mamba_n_groups"] != 1:
        raise ValueError(f"{cfg['name']}: one B/C group (mamba_n_groups 1) "
                         f"is run")
    return dict(d=d, H=H, KV=cfg["num_key_value_heads"], hd=d // H, nh=nh,
                p=hd, ds=cfg["mamba_d_state"], cw=cfg["mamba_d_conv"],
                E=cfg["num_local_experts"], K=cfg["num_experts_per_tok"],
                f=cfg["intermediate_size"], fs=cfg["shared_intermediate_size"],
                V=cfg["vocab_size"])


# -- the program ----------------------------------------------------------
def _arch_config(cfg: Mapping):
    try:
        from repro_torch.configs.base import (GraniteHybridConfig,
                                              MoEConfig, SSMConfig)
    except ImportError as e:
        raise RuntimeError(f"{cfg['name']}: this port has no hybrid_moe "
                           f"family (granitemoehybrid)") from e
    for key, want in (("hidden_act", "silu"),
                      ("position_embedding_type", "nope"),
                      ("normalization_function", "rmsnorm"),
                      ("attention_bias", False), ("mamba_proj_bias", False),
                      ("mamba_conv_bias", True),
                      ("tie_word_embeddings", True)):
        if cfg[key] != want:
            raise ValueError(f"{cfg['name']}: only {key} {want!r} is run")
    z = _sizes(cfg)
    return GraniteHybridConfig(
        name=cfg["name"], family="hybrid_moe",
        num_layers=cfg["num_hidden_layers"], d_model=z["d"],
        num_heads=z["H"], num_kv_heads=z["KV"], head_dim=z["hd"], d_ff=0,
        vocab_size=z["V"], mlp_activation="silu", tie_embeddings=True,
        norm_eps=float(cfg["rms_norm_eps"]),
        moe=MoEConfig(num_experts=z["E"], experts_per_token=z["K"],
                      d_ff_expert=z["f"], shared_expert=True),
        ssm=SSMConfig(d_state=z["ds"], head_dim=z["p"],
                      expand=cfg["mamba_expand"], conv_width=z["cw"],
                      chunk_size=cfg["mamba_chunk_size"]),
        layer_types=tuple(cfg["layer_types"]), shared_ff=z["fs"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        gate_norm_groups=cfg["mamba_n_groups"], source=cfg["source"])


def build(cfg: Mapping, seed: int, device: str):
    """The port's ``Model`` of this configuration on ``device``, in the
    configuration's dtype, holding the seeded weights."""
    arch = _arch_config(cfg)
    from repro_torch.models import Model
    model = Model(arch, device=device, dtype=weights.served_dtype(cfg))
    weights.load_into(model, layout(cfg), seed)
    return model


def _mamba_layout(z: dict) -> list:
    d, nh, p, ds, cw = z["d"], z["nh"], z["p"], z["ds"], z["cw"]
    return [("ssm_norm", (d,), 0.1), ("wz", (d, nh, p), d ** -0.5),
            ("wx", (d, nh, p), d ** -0.5), ("wB", (d, ds), d ** -0.5),
            ("wC", (d, ds), d ** -0.5),
            # dt before its softplus spreads over about +-4: heads that
            # keep their state for hundreds of tokens beside ones that
            # forget it at once
            ("wdt", (d, nh), 2.0 * d ** -0.5),
            ("conv_x", (cw, nh, p), cw ** -0.5),
            # B and C small (CONV_BC below)
            ("conv_B", (cw, ds), CONV_BC * cw ** -0.5),
            ("conv_C", (cw, ds), CONV_BC * cw ** -0.5),
            ("conv_x_bias", (nh, p), 0.1), ("conv_B_bias", (ds,), 0.1),
            ("conv_C_bias", (ds,), 0.1),
            # A = -exp(A_log) over about -0.14 .. -7
            ("A_log", (nh,), 1.0), ("dt_bias", (nh,), 1.0), ("D", (nh,), 1.0),
            ("gate_norm", (nh, p), 0.1), ("wo", (nh, p, d), (nh * p) ** -0.5)]


def _attn_layout(z: dict) -> list:
    d, H, KV, hd = z["d"], z["H"], z["KV"], z["hd"]
    return [("attn_norm", (d,), 0.1), ("wq", (d, H, hd), d ** -0.5),
            ("wk", (d, KV, hd), d ** -0.5), ("wv", (d, KV, hd), d ** -0.5),
            ("wo", (H, hd, d), (H * hd) ** -0.5)]


def _moe_layout(z: dict) -> list:
    d, E, f, fs = z["d"], z["E"], z["f"], z["fs"]
    return [("moe_norm", (d,), 0.1), ("router", (d, E), d ** -0.5),
            ("we_g", (E, d, f), d ** -0.5), ("we_u", (E, d, f), d ** -0.5),
            ("we_d", (E, f, d), EXPERT_OUT * f ** -0.5),
            ("ws_g", (d, fs), d ** -0.5),
            ("ws_u", (d, fs), d ** -0.5), ("ws_d", (fs, d), fs ** -0.5)]


def layout(cfg: Mapping) -> weights.Layout:
    """(name, shape, standard deviation) of every parameter, in stream
    order, under the port's names and shapes (the Mamba2 in-projection
    split as ``wz``/``wx [d, nh, p]``, ``wB``/``wC [d, ds]``, ``wdt [d,
    nh]``; the experts ``we_g``/``we_u [E, d, f]``, ``we_d [E, f, d]``).
    Norm weights act as ``1 + w`` and are drawn small and non-zero, as are
    the conv biases; ``A_log``, ``dt_bias`` and ``D`` are drawn too, so the
    comparison reaches every parameter.  The embedding table is drawn at
    0.002 (below), so the logits' best token is a close race; the conv
    over B and C and the routed experts' down-projections below the
    fan-in rule (``CONV_BC``, ``EXPERT_OUT``)."""
    z = _sizes(cfg)
    # the tied table at 0.002: at 0.02 a token's own row, 12 times its
    # norm in the residual stream, outscored every other row by ~5
    # standard deviations, so greedy decoding repeated the input token and
    # the fp8 control read the same tokens as the reference
    out = [("embed", (z["V"], z["d"]), 0.002),
           ("final_norm", (z["d"],), 0.1)]
    for i, kind in enumerate(cfg["layer_types"]):
        mixer = _mamba_layout(z) if kind == "mamba" else _attn_layout(z)
        out += [(f"blocks.{i}.{n}", s, sd)
                for n, s, sd in mixer + _moe_layout(z)]
    return out


# -- the plain float32 reference --------------------------------------------
# Written from the published equations (Hugging Face transformers'
# modeling_granitemoehybrid.py) with plain ``torch`` operations: no kernel,
# cache or batching of the program.  The sequences run together, right-
# padded to the longest (every operation is causal or per token, so a
# sequence's rows never see the padding after them); the layer loop runs
# outside, so each layer's weights are made float32 once.
def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, rows: int = ATTN_ROWS) -> torch.Tensor:
    """Causal GQA without positions: q [n, T, H, hd], k/v [n, T, KV, hd]
    -> [n, T, H, hd], scores times ``scale``, in blocks of ``rows`` query
    rows."""
    n, T, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(n, T, KV, H // KV, hd) * scale
    pos = torch.arange(T, device=q.device)
    out = []
    for a in range(0, T, rows):
        b = min(a + rows, T)
        s = torch.einsum("ntkgd,nskd->nkgts", qg[:, a:b], k[:, :b])
        mask = pos[a:b, None] >= pos[None, :b]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("nkgts,nskd->ntkgd", p, v[:, :b]))
    return torch.cat(out, dim=1).reshape(n, T, H, hd)


def _attn_mixer(x: torch.Tensor, w: Mapping[str, torch.Tensor], cfg: Mapping,
                quant: Optional[str]) -> torch.Tensor:
    n, T, d = x.shape
    z = _sizes(cfg)
    H, KV, hd = z["H"], z["KV"], z["hd"]
    q = linear(x, w["wq"].reshape(d, H * hd), quant).view(n, T, H, hd)
    k = linear(x, w["wk"].reshape(d, KV * hd), quant).view(n, T, KV, hd)
    v = linear(x, w["wv"].reshape(d, KV * hd), quant).view(n, T, KV, hd)
    o = _attention(q, k, v, cfg["attention_multiplier"])
    return linear(o.reshape(n, T, H * hd), w["wo"].reshape(H * hd, d), quant)


def _mamba_mixer(x: torch.Tensor, w: Mapping[str, torch.Tensor],
                 cfg: Mapping, quant: Optional[str]) -> torch.Tensor:
    """Mamba2: the in-projection's z, xBC and dt; the depthwise causal conv
    over xBC with its bias, then SiLU; dt = softplus(dt + dt_bias), A =
    -exp(A_log); the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t + D x_t, step by step; the gated RMSNorm of y * silu(z)
    over all d_inner channels (one group); the out-projection."""
    n, T, d = x.shape
    z_ = _sizes(cfg)
    nh, p, ds, cw = z_["nh"], z_["p"], z_["ds"], z_["cw"]
    di = nh * p
    gate = linear(x, w["wz"].reshape(d, di), quant)
    xbc = torch.cat([linear(x, w["wx"].reshape(d, di), quant),
                     linear(x, w["wB"], quant), linear(x, w["wC"], quant)], -1)
    dt = linear(x, w["wdt"], quant)
    kern = torch.cat([w["conv_x"].reshape(cw, di), w["conv_B"], w["conv_C"]],
                     -1)                                    # [cw, di + 2 ds]
    bias = torch.cat([w["conv_x_bias"].reshape(di), w["conv_B_bias"],
                      w["conv_C_bias"]])
    padded = F.pad(xbc, (0, 0, cw - 1, 0))
    conv = sum(padded[:, j:j + T] * kern[j] for j in range(cw)) + bias
    xs, Bm, Cm = F.silu(conv).split([di, ds, ds], dim=-1)
    xs = xs.reshape(n, T, nh, p)
    dt = F.softplus(dt + w["dt_bias"])                      # [n, T, nh]
    A = -torch.exp(w["A_log"])
    state = x.new_zeros(n, nh, p, ds)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]
        upd = (dt[:, t, :, None] * xs[:, t])[..., None] * Bm[:, t, None, None]
        state = state * decay + upd
        ys.append(state @ Cm[:, t, None, :, None])          # [n, nh, p, 1]
    y = torch.stack(ys, 1)[..., 0] + w["D"][:, None] * xs   # [n, T, nh, p]
    g = y.reshape(n, T, di) * F.silu(gate)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True)
                        + cfg["rms_norm_eps"])
    g = g * (1.0 + w["gate_norm"].reshape(di))
    return linear(g, w["wo"].reshape(di, d), quant)


def _moe(x: torch.Tensor, w: Mapping[str, torch.Tensor], cfg: Mapping,
         quant: Optional[str]) -> torch.Tensor:
    """Top-k of the router's logits, their softmax as the gates; every
    routed (token, expert) pair through its expert's SwiGLU, none dropped;
    plus the shared SwiGLU."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    K = cfg["num_experts_per_tok"]
    top, idx = linear(xt, w["router"], quant).topk(K, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(xt)
    for e in range(cfg["num_local_experts"]):
        tok, k = (idx == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        r = xt[tok]
        h = F.silu(linear(r, w["we_g"][e], quant)) * linear(r, w["we_u"][e],
                                                           quant)
        out.index_add_(0, tok, linear(h, w["we_d"][e], quant)
                       * gates[tok, k, None])
    shared = F.silu(linear(xt, w["ws_g"], quant)) * linear(xt, w["ws_u"],
                                                           quant)
    return (out + linear(shared, w["ws_d"], quant)).reshape(*lead, d)


_MOE = tuple(n for n, _, _ in _moe_layout(dict(d=1, E=1, f=1, fs=1)))


def _layer(h: torch.Tensor, w: Mapping[str, torch.Tensor], cfg: Mapping,
           kind: str, quant: Optional[str]) -> torch.Tensor:
    eps, m = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    if kind == "mamba":
        h = h + _mamba_mixer(_rms_norm(h, w["ssm_norm"], eps), w, cfg,
                             quant) * m
    else:
        h = h + _attn_mixer(_rms_norm(h, w["attn_norm"], eps), w, cfg,
                            quant) * m
    return h + _moe(_rms_norm(h, w["moe_norm"], eps), w, cfg, quant) * m


@torch.no_grad()
def logits(cfg: Mapping, weight: Callable[[str], torch.Tensor],
           seqs: Sequence[torch.Tensor], rows: Sequence[slice],
           quant: Optional[str] = None) -> List[torch.Tensor]:
    """fp32 logits [rows, V] of each token sequence (positions from 0),
    at the rows ``rows[i]`` of sequence i.  ``weight(name)`` gives one
    weight by its name in :func:`layout`."""
    z = _sizes(cfg)
    with no_tf32():
        embed = weight("embed")
        T = max(len(s) for s in seqs)
        tokens = torch.zeros(len(seqs), T, dtype=torch.long,
                             device=embed.device)
        for i, s in enumerate(seqs):
            tokens[i, :len(s)] = s
        h = embed[tokens].float() * cfg["embedding_multiplier"]
        for i, kind in enumerate(cfg["layer_types"]):
            names = [n for n, _, _ in (_mamba_layout(z) if kind == "mamba"
                                       else _attn_layout(z))] + list(_MOE)
            w = {n: weight(f"blocks.{i}.{n}").float() for n in names}
            h = _layer(h, w, cfg, kind, quant)
            del w
        head = embed.t().float()
        norm = weight("final_norm").float()
        return [linear(_rms_norm(h[i, r], norm, cfg["rms_norm_eps"]), head,
                       quant) / cfg["logits_scaling"]
                for i, r in enumerate(rows)]


# -- work counted from shapes ------------------------------------------------
def _mixer_matmul_params(cfg: Mapping, kind: str) -> int:
    """Weights one mixer multiplies a token by."""
    z = _sizes(cfg)
    d = z["d"]
    if kind == "mamba":
        di = z["nh"] * z["p"]
        return d * (2 * di + 2 * z["ds"] + z["nh"]) + di * d
    return 2 * d * z["H"] * z["hd"] + 2 * d * z["KV"] * z["hd"]


def sequence_flops(cfg: Mapping, prompt_len: int, new_tokens: int) -> float:
    """Model FLOPs of serving one request greedily: every layer over the
    prompt and the ``new_tokens - 1`` generated tokens fed back: the
    mixers' products, the Mamba2 recurrence (5 p ds a head and token: the
    decay, the rank-1 update and y = h C), attention at the true
    (unpadded) lengths, the router, the k routed experts and the shared
    MLP; and the logit head at the ``new_tokens`` rows that produce a
    token."""
    z = _sizes(cfg)
    fed = prompt_len + max(new_tokens - 1, 0)
    pairs = prompt_len * (prompt_len + 1) // 2
    pairs += sum(prompt_len + j + 1 for j in range(max(new_tokens - 1, 0)))
    moe = z["d"] * z["E"] + 3 * z["d"] * (z["K"] * z["f"] + z["fs"])
    flops = 0.0
    for kind in cfg["layer_types"]:
        flops += 2.0 * (_mixer_matmul_params(cfg, kind) + moe) * fed
        if kind == "mamba":
            flops += 5.0 * z["nh"] * z["p"] * z["ds"] * fed
        else:
            flops += 4.0 * z["H"] * z["hd"] * pairs
    return flops + 2.0 * z["d"] * z["V"] * new_tokens


def _ssd_work(B: int, S: int, nh: int, p: int, ds: int):
    """(FLOPs, bytes) of one prefill SSD scan (no entering state): the
    smaller of the recurrence's FLOPs (5 p ds a row) and the dual form's
    at the kernel's chunks over the causal triangles only (C B^T and the
    masked product with x dt over r(r+1)/2 pairs, the chunk's state and
    its output), a head; x, dt, B, C read once, y and the final state
    written once, all fp32."""
    dual = 0
    for c0 in range(0, S, SSD_CHUNK):
        r = min(SSD_CHUNK, S - c0)
        dual += 2 * (r * (r + 1) // 2) * (ds + p) + 4 * r * ds * p
    flops = B * nh * min(dual, 5 * p * ds * S)
    nbytes = 4.0 * (2 * B * S * nh * p + B * S * nh + nh + 2 * B * S * ds
                    + B * nh * p * ds)
    return float(flops), nbytes


def _moe_work(N: int, z: dict):
    """(FLOPs, bytes) of the expert products of one dropless call over N
    tokens: 6 N K d f; the weights of min(E, N K) experts read once (the
    experts a call can touch: exact at prefill and at one token, high by
    the experts no row reaches, about 0.8 % at 32 tokens of top-10 of 72),
    the routed rows read and the products' rows written once, bf16."""
    E, K, d, f = z["E"], z["K"], z["d"], z["f"]
    rows = N * K
    flops = 6.0 * rows * d * f
    nbytes = 2.0 * (min(E, rows) * 3 * d * f + 2 * rows * d)
    return flops, nbytes


def kernel_work(cfg: Mapping, B: int, S: int, new_tokens: int) -> dict:
    """The calls one batch of ``B`` prompts padded to ``S`` makes when it
    generates ``new_tokens``, each as (FLOPs, bytes), by kernel:
    ``"flash"`` one prefill call an attention layer; ``"decode"`` one call
    an attention layer for each of the ``new_tokens - 1`` steps, step j
    over ``S + j + 1`` positions; ``"ssd_scan"`` one prefill scan a Mamba2
    layer; ``"moe"`` the grouped expert products of every MoE call (the
    prefill's in calls of at most ``MOE_TOKENS`` tokens, then B tokens a
    layer and step)."""
    z = _sizes(cfg)
    types = cfg["layer_types"]
    n_attn, n_mamba = types.count("attention"), types.count("mamba")
    H, KV, hd = z["H"], z["KV"], z["hd"]
    steps = max(new_tokens - 1, 0)
    flash = [count.flash_work(B, S, H, KV, hd)] * n_attn
    decode = [count.decode_work(B, S + j + 1, H, KV, hd)
              for j in range(steps) for _ in range(n_attn)]
    ssd = [_ssd_work(B, S, z["nh"], z["p"], z["ds"])] * n_mamba
    chunks = [min(MOE_TOKENS, B * S - a) for a in range(0, B * S, MOE_TOKENS)]
    moe = [_moe_work(n, z) for _ in types for n in chunks]
    moe += [_moe_work(B, z)] * (steps * len(types))
    return {"flash": flash, "decode": decode, "ssd_scan": ssd, "moe": moe}
