"""Seeded weights of a dense transformer, made on the device.

The weights are one stream of standard normals drawn in the served dtype
from a ``torch.Generator`` on the device, in chunks of ``CHUNK`` values (a
few large calls, not one a parameter); each parameter takes the next
values of the stream in a fixed order, times its own scale.  The same
seed on the same device gives the same bits, so the reference makes the
weights again after the program's state is freed instead of reading
anything the program holds.

Names and shapes are the port's parameter layout (``wq [d, H, hd]``,
``wo [H, hd, d]``, ``wg [d, f]`` ...); :func:`load_into` refuses a model
whose parameters differ from it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import torch

CHUNK = 1 << 28


def layout(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, standard deviation) of every parameter, in stream
    order.  Norm weights act as ``1 + w`` and, like the q/k/v biases, are
    drawn small and non-zero, so the comparison reaches them."""
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


class _Stream:
    """Standard normals in ``dtype`` from one generator, ``CHUNK`` at a
    draw."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.device, self.dtype = device, dtype
        self.buf = torch.empty(0, dtype=dtype, device=device)
        self.pos = 0

    def take(self, n: int) -> torch.Tensor:
        parts = []
        while n > 0:
            if self.pos == self.buf.numel():
                self.buf = torch.randn(CHUNK, generator=self.gen,
                                       dtype=self.dtype, device=self.device)
                self.pos = 0
            k = min(n, self.buf.numel() - self.pos)
            parts.append(self.buf[self.pos:self.pos + k])
            self.pos += k
            n -= k
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def stream(cfg: Mapping, seed: int, device, dtype: torch.dtype
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, weight) of every parameter in :func:`layout` order, each
    weight a fresh tensor of the served dtype."""
    s = _Stream(seed, torch.device(device), dtype)
    for name, shape, std in layout(cfg):
        n = 1
        for x in shape:
            n *= x
        yield name, (s.take(n) * std).view(shape)


@torch.no_grad()
def load_into(model: torch.nn.Module, cfg: Mapping, seed: int) -> None:
    """Copy the seeded weights into ``model``'s parameters."""
    params = dict(model.named_parameters())
    want = {name: shape for name, shape, _ in layout(cfg)}
    got = {name: tuple(p.shape) for name, p in params.items()}
    if got != want:
        raise ValueError(f"the model's parameters differ from the "
                         f"benchmark's layout: {sorted(set(got) ^ set(want))}"
                         f" or shapes")
    dtype = next(iter(params.values())).dtype
    for name, w in stream(cfg, seed, params["embed"].device, dtype):
        params[name].copy_(w)


def all_weights(cfg: Mapping, seed: int, device, dtype: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """Every weight, by name (the reference's copy, made anew)."""
    return dict(stream(cfg, seed, device, dtype))
