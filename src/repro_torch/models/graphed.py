"""A dense model's decode step as CUDA graphs between its attention calls.

The JAX package jits its decode step, so a step is one compiled program.
Run eagerly, the port's step issues some seventy small ops a layer from the
host, and at serving batches the card idles for most of it.  Here each
stretch of the step between two attention calls is a segment:

* segment 0: the embedding and layer 0's query, key and value (K/V written
  into the cache);
* segment i (1 <= i < L): layer i-1's output projection, residual and MLP,
  then layer i's query, key and value;
* segment L: the last layer's tail, the final norm and the logits.

On the card each segment is captured once per batch size as a CUDA graph
and replayed.  The decode attention is not captured: it is called between
the segments through ``kernels.ops`` (or the plain version, as the model's
``impl`` says), as ``Model.decode_step`` calls it, so every launch of the
hand-written kernel goes through its wrapper and its count.

What a graph reads at replay lives in static buffers: the KV caches, of
``max_batch`` rows (a batch of B uses rows ``:B``), and per batch size the
input tokens, their position and the attention output.  A step writes the
token and position into them, replays the segments and returns the logits
buffer of segment L, which the next step overwrites.  Without capture (on
the CPU) the same segments run eagerly, so the split is held against
``Model.decode_step`` anywhere.

Given a ``tracer`` (``obs.Tracer``), it records ``graphed.capture`` per
batch size captured (args ``B``, ``graphs``), ``graphed.load`` per cache
copy, and in each step ``graphed.inputs`` (the token and position writes)
and one ``decode_attention`` span around each attention call: the host's
time in the wrapper.  The replays between them are the enclosing span's.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import kvcache, layers
from repro_torch.models import transformer as tfm
from repro_torch.models.model import DENSE_FAMILIES, Model

if TYPE_CHECKING:
    from repro_torch.obs.tracing import Tracer


class _Batch:
    """The static buffers, segments and graphs of one batch size."""

    def __init__(self, dec: "GraphedDecode", B: int):
        m = dec.model
        arch, dev = m.arch, m.device
        self.model = m
        self.tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.idx = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.attn = torch.zeros((B, 1, arch.num_heads, arch.head_dim),
                                dtype=m.dtype, device=dev)
        self.k = [c[:B] for c in dec.cache["k"]]
        self.v = [c[:B] for c in dec.cache["v"]]
        self.out: List = [None] * (arch.num_layers + 1)
        self.graphs: Optional[List[torch.cuda.CUDAGraph]] = None

    def segment(self, i: int):
        """Segment ``i``: (h, layer i's query), or the logits for i = L."""
        m, arch = self.model, self.model.arch
        if i == 0:
            h = layers.embed(self.tok, m.embed).to(m.dtype)
        else:
            blk = m.blocks[i - 1]
            h = self.out[i - 1][0] + tfm.attention_out(self.attn, blk)
            h = h + tfm.mlp(h, blk, arch)
        if i == arch.num_layers:
            return m.head(h)
        return h, tfm.decode_qkv(h, m.blocks[i], arch, self.k[i],
                                 self.v[i], self.pos, self.idx)

    def capture(self, pool, side: torch.cuda.Stream) -> None:
        """Run every segment once on the side stream (lazy initialisation
        stays outside the graphs), then capture each into a graph that
        shares ``pool``; the outputs of the capture are the static ones.
        Every batch size captures on the same stream, so the pool's freed
        blocks serve the next capture."""
        n = len(self.out)
        side.wait_stream(torch.cuda.current_stream(self.model.device))
        with torch.cuda.stream(side):
            for i in range(n):
                self.out[i] = self.segment(i)
        torch.cuda.current_stream(self.model.device).wait_stream(side)
        self.graphs = []
        with torch.cuda.stream(side):
            for i in range(n):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool)
                self.out[i] = self.segment(i)
                g.capture_end()
                self.graphs.append(g)
        torch.cuda.current_stream(self.model.device).wait_stream(side)

    def run(self, i: int) -> None:
        if self.graphs is None:
            self.out[i] = self.segment(i)
        else:
            self.graphs[i].replay()

    def load(self, cache: kvcache.Cache, S: int) -> None:
        """Copy a prefill's first ``S`` positions into the static caches."""
        for name, rows in (("k", self.k), ("v", self.v)):
            for dst, src in zip(rows, cache[name]):
                dst[:, :S].copy_(src[:, :S])

    def inputs(self, tokens: torch.Tensor, cache_len: int) -> None:
        """Write a step's tokens and position where the graphs read them."""
        self.tok.copy_(tokens)
        self.pos.fill_(cache_len)
        self.idx.fill_(cache_len)

    def attend(self, fn, i: int, cache_len: int) -> None:
        """Layer ``i``'s decode attention (``fn``) over ``cache_len + 1``
        positions, into the buffer the next segment reads."""
        self.attn.copy_(fn(self.out[i][1], self.k[i], self.v[i],
                           cache_len + 1))


class GraphedDecode:
    """Greedy decode steps of one dense-family model against static caches
    of ``max_batch`` rows and ``max_seq`` positions.

    On a card each batch size's segments are captured as CUDA graphs the
    first time :meth:`load` sees it (:meth:`capture_all` captures every
    size up front); elsewhere they run eagerly."""

    def __init__(self, model: Model, max_batch: int, max_seq: int,
                 tracer: Optional[Tracer] = None):
        if model.arch.family not in DENSE_FAMILIES:
            raise ValueError(f"{model.arch.name}: graphed decode serves the "
                             f"dense families {DENSE_FAMILIES}, not "
                             f"{model.arch.family!r}")
        self.model = model
        self.tracer = tracer
        self.max_batch, self.max_seq = max_batch, max_seq
        self.capture = model.device.type == "cuda"
        self.cache = kvcache.init_kv(model.arch, max_batch, max_seq,
                                     model.dtype, model.device)
        self._pool = self._side = None
        if self.capture:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(model.device)
        self._batches: Dict[int, _Batch] = {}

    @torch.no_grad()
    def _batch(self, B: int) -> _Batch:
        b = self._batches.get(B)
        if b is None:
            if not 1 <= B <= self.max_batch:
                raise ValueError(f"batch {B} not in [1, {self.max_batch}]")
            b = _Batch(self, B)
            if self.capture and self.tracer is None:
                b.capture(self._pool, self._side)
            elif self.capture:
                with self.tracer.span("graphed.capture", "graphed",
                                      app=self.model.arch.name, B=B,
                                      graphs=len(b.out)):
                    b.capture(self._pool, self._side)
            self._batches[B] = b
        return b

    def capture_all(self) -> None:
        """Build (and on a card capture) every batch size up to
        ``max_batch``, so no later step pays for a capture."""
        for B in range(1, self.max_batch + 1):
            self._batch(B)

    @torch.no_grad()
    def load(self, cache: kvcache.Cache, S: int) -> kvcache.Cache:
        """Copy a prefill's KV caches (their first ``S`` positions) into the
        static caches; returns the static caches' rows of this batch, the
        cache that :meth:`step` decodes against."""
        B = cache["k"][0].shape[0]
        if S >= self.max_seq:
            raise ValueError(f"{S} positions leave no room in max_seq "
                             f"{self.max_seq}")
        b = self._batch(B)
        if self.tracer is None:
            b.load(cache, S)
        else:
            with self.tracer.span("graphed.load", "graphed", B=B, S=S):
                b.load(cache, S)
        return {"k": b.k, "v": b.v}

    @torch.no_grad()
    def step(self, cache_len: int, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step at position ``cache_len`` (a host int) for
        tokens [B, 1] of a batch that :meth:`load` loaded -> logits
        [B, 1, V] (fp32), a buffer the next step of this batch size
        overwrites."""
        m = self.model
        b = self._batch(tokens.shape[0])
        if not 0 <= cache_len < self.max_seq:
            raise ValueError(f"cache_len {cache_len} not in "
                             f"[0, {self.max_seq})")
        tr = self.tracer
        if tr is None:
            b.inputs(tokens, cache_len)
        else:
            with tr.span("graphed.inputs", "graphed"):
                b.inputs(tokens, cache_len)
        attend = (ops.decode_attention if m.impl == "kernel"
                  else ref.decode_attention_ref)
        L = m.arch.num_layers
        for i in range(L):
            b.run(i)
            if tr is None:
                b.attend(attend, i, cache_len)
            else:
                with tr.span("decode_attention", "graphed", layer=i):
                    b.attend(attend, i, cache_len)
        b.run(L)
        return b.out[L]
