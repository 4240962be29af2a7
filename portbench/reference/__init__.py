"""Plain float32 dense-transformer forward: the yardstick of ``correct``.

Written from the architecture's equations with plain ``torch`` operations
(no kernel, cache or batching of the program; nothing of ``repro`` or
``repro_torch`` is imported).  Pre-norm residual blocks: RMSNorm scaled by
``1 + w``, q/k/v projections with an optional bias, split-half RoPE,
causal grouped-query attention at ``1/sqrt(hd)``, output projection, a
SiLU-gated MLP, and a logit head that is the embedding table (tied) or its
own matrix.  The layer loop runs over the layers outside and the sequences
inside, so each layer's weights are made float32 once for all sequences.

``quant="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (weights per output column, activations per row, scaled to
the format's largest value) before an fp32 product, the step below the
configuration's bf16 that a later change could take.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

FP8_MAX = 448.0
ATTN_ROWS = 2048          # query rows of one attention block


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] rounded to e4m3 with one scale a row."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
            ) -> torch.Tensor:
    """``x [T, K] @ w [K, N]`` in float32 (or on fp8-rounded operands)."""
    if quant == "fp8":
        return _fp8_rows(x) @ _fp8_rows(w.t()).t()
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions 0..T-1; the first half of a head pairs
    with the second half."""
    T, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
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


def block(h: torch.Tensor, w: Mapping[str, torch.Tensor], cfg: Mapping,
          quant: Optional[str]) -> torch.Tensor:
    T, d = h.shape
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    x = rms_norm(h, w["attn_norm"], eps)
    q = _linear(x, w["wq"].reshape(d, H * hd), quant).view(T, H, hd)
    k = _linear(x, w["wk"].reshape(d, KV * hd), quant).view(T, KV, hd)
    v = _linear(x, w["wv"].reshape(d, KV * hd), quant).view(T, KV, hd)
    if cfg["attention_bias"]:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attention(q, k, v).reshape(T, H * hd)
    h = h + _linear(o, w["wo"].reshape(H * hd, d), quant)
    x = rms_norm(h, w["mlp_norm"], eps)
    g = torch.nn.functional.silu(_linear(x, w["wg"], quant))
    return h + _linear(g * _linear(x, w["wu"], quant), w["wd"], quant)


@torch.no_grad()
def logits(cfg: Mapping, weight: Callable[[str], torch.Tensor],
           seqs: Sequence[torch.Tensor], rows: Sequence[slice],
           quant: Optional[str] = None) -> List[torch.Tensor]:
    """fp32 logits [rows, V] of each token sequence (positions from 0),
    at the rows ``rows[i]`` of sequence i.  ``weight(name)`` gives one
    weight by its name in ``weights.layout``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        embed = weight("embed")
        hs = [embed[s].float() for s in seqs]
        names = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wg",
                 "wu", "wd") + (("bq", "bk", "bv")
                                if cfg["attention_bias"] else ())
        for i in range(cfg["num_hidden_layers"]):
            w = {n: weight(f"blocks.{i}.{n}").float() for n in names}
            hs = [block(h, w, cfg, quant) for h in hs]
            del w
        head = (embed.t() if cfg["tie_word_embeddings"]
                else weight("lm_head")).float()
        norm = weight("final_norm").float()
        return [_linear(rms_norm(h[r], norm, cfg["rms_norm_eps"]), head, quant)
                for h, r in zip(hs, rows)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def served_gaps(ref_rows: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """For each row, how far the served token's reference logit lies below
    the reference's best: ``max(ref) - ref[served]`` (0 where they agree)."""
    best = ref_rows.max(-1).values
    return best - ref_rows.gather(-1, served.long()[:, None])[:, 0]


def judged_sequences(cfg: Mapping, weight: Callable[[str], torch.Tensor],
                     cases: Sequence[Dict], control: bool
                     ) -> Dict[str, float]:
    """The widest gap over ``cases``: each a dict with ``prompt`` (the
    token rows the program ran, padding included) and ``served`` (its
    greedy tokens).  The reference runs once over ``prompt + served[:-1]``;
    row ``len(prompt) - 1 + j`` is the one that chose ``served[j]``.  With
    ``control`` the fp8 control is read at the same rows: the gap of the
    token it puts first."""
    dev = weight("final_norm").device
    seqs, rows, served = [], [], []
    for c in cases:
        p = torch.as_tensor(c["prompt"], dtype=torch.long, device=dev)
        s = torch.as_tensor(c["served"], dtype=torch.long, device=dev)
        seqs.append(torch.cat([p, s[:-1]]))
        rows.append(slice(len(p) - 1, len(p) - 1 + len(s)))
        served.append(s)
    ref = logits(cfg, weight, seqs, rows)
    out = {"gap": max(float(served_gaps(r, s).max()) for r, s in
                      zip(ref, served)),
           "tokens": sum(len(s) for s in served)}
    if control:
        low = logits(cfg, weight, seqs, rows, quant="fp8")
        out["control_gap"] = max(float(served_gaps(r, l.argmax(-1)).max())
                                 for r, l in zip(ref, low))
    return out
