"""What every family's plain float32 reference shares, and the judgement of
served tokens by it.

A family's reference forward (``portbench/arch/<model_type>.py``
``logits``) is written from the architecture's equations with plain
``torch`` operations and imports nothing of ``repro`` or ``repro_torch``.
It makes its products with :func:`linear` under :func:`no_tf32`.

``quant="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (weights per output column, activations per row, scaled to
the format's largest value) before an fp32 product, the step below the
configuration's bf16 that a later change could take.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

FP8_MAX = 448.0


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] rounded to e4m3 with one scale a row."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    """``x [T, K] @ w [K, N]`` in float32 (or on fp8-rounded operands)."""
    if quant == "fp8":
        return _fp8_rows(x) @ _fp8_rows(w.t()).t()
    return x @ w


@contextlib.contextmanager
def no_tf32():
    """fp32 products with TF32 off, restored on leaving."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def served_gaps(ref_rows: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """For each row, how far the served token's reference logit lies below
    the reference's best: ``max(ref) - ref[served]`` (0 where they agree)."""
    best = ref_rows.max(-1).values
    return best - ref_rows.gather(-1, served.long()[:, None])[:, 0]


def judged_sequences(fam, cfg: Mapping,
                     weight: Callable[[str], torch.Tensor],
                     cases: Sequence[Dict], control: bool, device
                     ) -> Dict[str, float]:
    """The widest gap over ``cases`` by the reference of ``fam`` (the
    configuration's family file): each case a dict with ``prompt`` (the
    token rows the program ran, padding included) and ``served`` (its
    greedy tokens).  The reference runs once over ``prompt + served[:-1]``
    on ``device``; row ``len(prompt) - 1 + j`` is the one that chose
    ``served[j]``.  With ``control`` the fp8 control is read at the same
    rows: the gap of the token it puts first."""
    seqs, rows, served = [], [], []
    for c in cases:
        p = torch.as_tensor(c["prompt"], dtype=torch.long, device=device)
        s = torch.as_tensor(c["served"], dtype=torch.long, device=device)
        seqs.append(torch.cat([p, s[:-1]]))
        rows.append(slice(len(p) - 1, len(p) - 1 + len(s)))
        served.append(s)
    ref = fam.logits(cfg, weight, seqs, rows)
    out = {"gap": max(float(served_gaps(r, s).max()) for r, s in
                      zip(ref, served)),
           "tokens": sum(len(s) for s in served)}
    if control:
        low = fam.logits(cfg, weight, seqs, rows, quant="fp8")
        out["control_gap"] = max(float(served_gaps(r, l.argmax(-1)).max())
                                 for r, l in zip(ref, low))
    return out
