"""Seeded weights of a model, made on the device.

The weights are one stream of standard normals drawn in the served dtype
from a ``torch.Generator`` on the device, in chunks of ``CHUNK`` values (a
few large calls, not one a parameter); each parameter takes the next
values of the stream in a fixed order, times its own scale.  The same
seed on the same device gives the same bits, so the reference makes the
weights again after the program's state is freed instead of reading
anything the program holds.

Names, shapes and scales are the family's ``layout(cfg)``
(``portbench/arch/<model_type>.py``): the port's parameter names and
shapes, in stream order.  :func:`load_into` refuses a model whose
parameters differ from it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import torch

CHUNK = 1 << 28
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

Layout = List[Tuple[str, Tuple[int, ...], float]]


def served_dtype(cfg: Mapping) -> torch.dtype:
    """The dtype the configuration is served in (its ``torch_dtype``)."""
    return DTYPES[cfg["torch_dtype"]]


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


def stream(layout: Layout, seed: int, device, dtype: torch.dtype
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, weight) of every parameter in ``layout``'s order, each weight
    a fresh tensor of the served dtype."""
    s = _Stream(seed, torch.device(device), dtype)
    for name, shape, std in layout:
        n = 1
        for x in shape:
            n *= x
        yield name, (s.take(n) * std).view(shape)


@torch.no_grad()
def load_into(model: torch.nn.Module, layout: Layout, seed: int) -> None:
    """Copy the seeded weights of ``layout`` into ``model``'s parameters."""
    params = dict(model.named_parameters())
    want = {name: shape for name, shape, _ in layout}
    got = {name: tuple(p.shape) for name, p in params.items()}
    if got != want:
        raise ValueError(f"the model's parameters differ from the "
                         f"benchmark's layout: {sorted(set(got) ^ set(want))}"
                         f" or shapes")
    first = params[layout[0][0]]
    for name, w in stream(layout, seed, first.device, first.dtype):
        params[name].copy_(w)


def all_weights(layout: Layout, seed: int, device, dtype: torch.dtype
                ) -> Dict[str, torch.Tensor]:
    """Every weight, by name (the reference's copy, made anew)."""
    return dict(stream(layout, seed, device, dtype))
