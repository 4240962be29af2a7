"""A dense or ``hybrid_moe`` model's decode step as CUDA graphs between its
attention calls.

The JAX package jits its decode step, so a step is one compiled program.
Run eagerly, the port's step issues some seventy small ops a layer from the
host, and at serving batches the card idles for most of it.  Here the
stretch of the step before each attention call, and after the last, is a
segment: a list of pieces, each a function of the previous piece's h,
which one composer builds from the blocks' types:

* the start: the embedding, or the previous attention layer's output
  projection and then its FFN (a ``DenseBlock``'s gated MLP, else its MoE
  block), each added to the residual;
* one piece a Mamba2 layer before the attention call (``hybrid_moe``): its
  SSD step against its static state, then its FFN;
* the end: the attention layer's query, key and value (K/V written into
  the cache), or the final norm and the logits.

Each branch is scaled by ``residual_multiplier`` where that is not 1.0, as
in ``Model.decode_step``.  On the card each segment is captured once per
batch size as one CUDA graph, or as one graph a piece where it holds a
Mamba2 layer: the graphs share one memory pool, so a piece's temporaries
(with the plain SSD step, state-sized products, 134 MB each at Granite's
widths and batch 32) are held once, not once a layer.  The decode
attention is not captured: it is called between the segments through
``kernels.ops`` (or the plain version, as the model's ``impl`` says), so
every launch of the hand-written kernel goes through its wrapper and its
count.

What a graph reads at replay lives in static buffers: the caches of
``max_batch`` rows (a batch of B uses rows ``:B`` of the KV caches and any
Mamba2 states), and per batch size the input tokens, their position and
the attention output.  Each SSD step updates its state in place and the
new conv tails are copied into theirs.  The prefill writes into a batch's
rows in place (``Model.prefill(into=)``, :meth:`GraphedDecode.rows`), so no
second copy of the cache is held.  A step writes the token and position,
replays the segments and returns the last segment's logits buffer, which
the next step overwrites.  The eager pass before a capture runs any MoE
blocks on the buffers' tokens: ``moe.expert_rows`` is restored after it.
Without capture (on the CPU) the same segments run eagerly, so the split
is held against ``Model.decode_step`` anywhere.

Given a ``tracer`` (``obs.Tracer``), it records ``graphed.capture`` per
batch size captured (args ``B``, ``graphs``), and in each step
``graphed.inputs`` (the token and position writes) and one
``decode_attention`` span around each attention call: the host's time in
the wrapper.  The replays between them are the enclosing span's.  Without
one each of those sites enters a null context.
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import kvcache
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.model import DENSE_FAMILIES, Model

FAMILIES = DENSE_FAMILIES + ("hybrid_moe",)

if TYPE_CHECKING:
    from repro_torch.obs.tracing import Tracer


def _rows(entry, B: int):
    """The first ``B`` rows of a cache entry: a tensor or a layer's SSM
    state."""
    if isinstance(entry, ssm_mod.SSMLayerState):
        return ssm_mod.SSMLayerState(*(t[:B] for t in entry))
    return entry[:B]


def _groups(segment: list) -> list:
    """A segment's pieces as captured: one graph where the segment holds no
    Mamba2 layer (a start and an end only), else one graph a piece."""
    return [segment] if len(segment) == 2 else [[p] for p in segment]


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
        self.cache: kvcache.Cache = {
            name: [_rows(c, B) for c in entries]
            for name, entries in dec.cache.items()}
        self.segments = self._compose()
        self.out: List = [None] * len(self.segments)
        self.graphs: Optional[List[List[torch.cuda.CUDAGraph]]] = None

    def _compose(self) -> List[List[Callable]]:
        """The segments' pieces (module docstring), split at the blocks
        that are not Mamba2 layers: the attention calls."""
        m, arch, c = self.model, self.model.arch, self.cache
        mult = arch.residual_multiplier

        def scaled(x):
            return x if mult == 1.0 else x * mult

        def ffn(h, i):
            blk = m.blocks[i]
            if isinstance(blk, tfm.DenseBlock):
                return h + scaled(tfm.mlp(h, blk, arch, impl=m.impl))
            return h + scaled(moe_mod.moe_mlp(h, blk, arch, m.moe_dispatch,
                                              layer=i, impl=m.impl))

        def start(_, j: int, prev: Optional[int]):
            if prev is None:
                return m._embed(self.tok)
            h = self.out[j - 1][0] + scaled(
                tfm.attention_out(self.attn, m.blocks[prev]))
            return ffn(h, prev)

        def mamba(h, i: int, n: int):
            st = c["ssm"][n]
            out, new = ssm_mod.ssm_mixer_decode(h, m.blocks[i], arch, st,
                                                m.impl, ssd_out=st.ssd)
            for dst, src in zip(st[1:], new[1:]):     # the conv tails
                dst.copy_(src)
            return ffn(h + scaled(out), i)

        def end(h, j: int, i: Optional[int]):
            if i is None:
                return m.head(h)
            return h, tfm.decode_qkv(h, m.blocks[i], arch, c["k"][j],
                                     c["v"][j], self.pos, self.idx,
                                     impl=m.impl)

        segments: List[List[Callable]] = []
        body: List[Callable] = []
        prev, n = None, 0
        for i, blk in enumerate([*m.blocks, None]):     # None: the head
            if isinstance(blk, ssm_mod.SSMBlock):
                body.append(partial(mamba, i=i, n=n))
                n += 1
                continue
            j = len(segments)
            segments.append([partial(start, j=j, prev=prev), *body,
                             partial(end, j=j, i=None if blk is None else i)])
            body, prev = [], i
        return segments

    @property
    def n_graphs(self) -> int:
        return sum(len(_groups(s)) for s in self.segments)

    def capture(self, pool, side: torch.cuda.Stream) -> None:
        """Run every segment once on the side stream (lazy initialisation
        stays outside the graphs) and restore ``moe.expert_rows`` after
        it, then capture each segment's graphs, all sharing ``pool``; the
        outputs of the capture are the static ones.  Every batch size
        captures on the same stream, so the pool's freed blocks serve the
        next capture."""
        saved = {k: v.clone() for k, v in moe_mod.expert_rows.items()}
        cur = torch.cuda.current_stream(self.model.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for j in range(len(self.segments)):
                self.run(j)
        cur.wait_stream(side)
        for k, v in moe_mod.expert_rows.items():
            if k in saved:
                v.copy_(saved[k])
            else:
                v.zero_()
        graphs = []
        with torch.cuda.stream(side):
            for j, segment in enumerate(self.segments):
                h, seg_graphs = None, []
                for group in _groups(segment):
                    g = torch.cuda.CUDAGraph()
                    g.capture_begin(pool=pool)
                    for piece in group:
                        h = piece(h)
                    g.capture_end()
                    seg_graphs.append(g)
                self.out[j] = h
                graphs.append(seg_graphs)
        cur.wait_stream(side)
        self.graphs = graphs

    def run(self, j: int) -> None:
        """Segment ``j``: its graphs replayed, or its pieces run eagerly."""
        if self.graphs is None:
            h = None
            for piece in self.segments[j]:
                h = piece(h)
            self.out[j] = h
        else:
            for g in self.graphs[j]:
                g.replay()

    def inputs(self, tokens: torch.Tensor, cache_len: int) -> None:
        """Write a step's tokens and position where the graphs read them."""
        self.tok.copy_(tokens)
        self.pos.fill_(cache_len)
        self.idx.fill_(cache_len)

    def attend(self, fn, j: int, cache_len: int) -> None:
        """Attention call ``j`` (``fn``) over ``cache_len + 1`` positions,
        into the buffer the next segment reads."""
        k, v = self.cache["k"][j], self.cache["v"][j]
        self.attn.copy_(fn(self.out[j][1], k, v, cache_len + 1,
                           **tfm.scaled(self.model.arch)))


class GraphedDecode:
    """Greedy decode steps of one dense-family or ``hybrid_moe`` model
    against static caches of ``max_batch`` rows and ``max_seq`` positions.

    On a card each batch size's segments are captured as CUDA graphs the
    first time :meth:`rows` sees it, ``max_batch``'s up front by
    :meth:`capture_max_batch`; elsewhere they run eagerly."""

    def __init__(self, model: Model, max_batch: int, max_seq: int,
                 tracer: Optional[Tracer] = None):
        if model.arch.family not in FAMILIES:
            raise ValueError(f"{model.arch.name}: graphed decode serves the "
                             f"dense families {DENSE_FAMILIES} and "
                             f"hybrid_moe, not {model.arch.family!r}")
        self.model = model
        self.tracer = tracer
        self.max_batch, self.max_seq = max_batch, max_seq
        self.capture = model.device.type == "cuda"
        self.cache = kvcache.init_cache(model.arch, max_batch, max_seq,
                                        model.dtype, model.device)
        self._pool = self._side = None
        if self.capture:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(model.device)
        self._batches: Dict[int, _Batch] = {}

    def _span(self, name: str, **args):
        """A span of the tracer (module docstring), or nothing."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, "graphed", **args)

    @torch.no_grad()
    def _batch(self, B: int) -> _Batch:
        b = self._batches.get(B)
        if b is None:
            if not 1 <= B <= self.max_batch:
                raise ValueError(f"batch {B} not in [1, {self.max_batch}]")
            b = _Batch(self, B)
            if self.capture:
                with self._span("graphed.capture", app=self.model.arch.name,
                                B=B, graphs=b.n_graphs):
                    b.capture(self._pool, self._side)
            self._batches[B] = b
        return b

    def capture_max_batch(self) -> None:
        """Build (and on a card capture) the graphs of ``max_batch``, the
        size a full queue runs, up front; every other size is captured
        when it first comes (:meth:`rows`, :meth:`step`)."""
        self._batch(self.max_batch)

    def rows(self, B: int) -> kvcache.Cache:
        """The static caches' rows of a batch of ``B`` (capturing its
        graphs first if need be): the cache a prefill may write into in
        place (``Model.prefill(into=)``) and :meth:`step` decodes
        against."""
        return self._batch(B).cache

    @torch.no_grad()
    def step(self, cache_len: int, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step at position ``cache_len`` (a host int) for
        tokens [B, 1] of a batch prefilled into :meth:`rows` -> logits
        [B, 1, V] (fp32), a buffer the next step of this batch size
        overwrites."""
        m = self.model
        b = self._batch(tokens.shape[0])
        if not 0 <= cache_len < self.max_seq:
            raise ValueError(f"cache_len {cache_len} not in "
                             f"[0, {self.max_seq})")
        with self._span("graphed.inputs"):
            b.inputs(tokens, cache_len)
        attend = (ops.decode_attention if m.impl == "kernel"
                  else ref.decode_attention_ref)
        L = len(b.segments) - 1
        for j in range(L):
            b.run(j)
            with self._span("decode_attention", layer=j):
                b.attend(attend, j, cache_len)
        b.run(L)
        return b.out[L]
