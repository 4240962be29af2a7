"""A dense or ``hybrid_moe`` model's decode step as CUDA graphs between its
attention calls.

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

A ``hybrid_moe`` model (Granite-4.0-H) attends in a few of its layers
only: a segment then runs every layer between two attention layers (its
Mamba2 step and its dropless MoE block, whose sort, offsets and grouped
products stay on the device), captured a layer to a graph, and the
residual multiplier scales each branch as in ``Model.decode_step``.  Its
Mamba2 states are static buffers too: the SSD step (``ops.ssd_step``, the
model's ``impl``) updates each SSD state in place, and each step's new
conv tails are copied into theirs.  Capturing replays nothing, but the
eager pass before it runs the MoE blocks on the buffers' tokens:
``moe.expert_rows`` is restored after it.

What a graph reads at replay lives in static buffers: the KV caches, of
``max_batch`` rows (a batch of B uses rows ``:B``), and per batch size the
input tokens, their position and the attention output.  The prefill writes
its KV prefix (and the Mamba2 states) into a batch's rows in place
(``Model.prefill(into=)``, :meth:`GraphedDecode.rows`), so no second copy
of the cache is held.  A step writes the token and position into them,
replays the segments and returns the logits buffer of segment L, which the
next step overwrites.  Without capture (on the CPU) the same segments run
eagerly, so the split is held against ``Model.decode_step`` anywhere.

Given a ``tracer`` (``obs.Tracer``), it records ``graphed.capture`` per
batch size captured (args ``B``, ``graphs``), and in each step
``graphed.inputs`` (the token and position writes) and one
``decode_attention`` span around each attention call: the host's time in
the wrapper.  The replays between them are the enclosing span's.
"""
from __future__ import annotations

from functools import partial
from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import kvcache, layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.model import DENSE_FAMILIES, Model

FAMILIES = DENSE_FAMILIES + ("hybrid_moe",)

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
        self.out: List = [None] * (len(self.k) + 1)
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

    @property
    def n_graphs(self) -> int:
        return len(self.out)

    def rows(self) -> kvcache.Cache:
        """This batch size's rows of the static caches."""
        return {"k": self.k, "v": self.v}

    def run(self, i: int) -> None:
        if self.graphs is None:
            self.out[i] = self.segment(i)
        else:
            self.graphs[i].replay()

    def inputs(self, tokens: torch.Tensor, cache_len: int) -> None:
        """Write a step's tokens and position where the graphs read them."""
        self.tok.copy_(tokens)
        self.pos.fill_(cache_len)
        self.idx.fill_(cache_len)

    def attend(self, fn, i: int, cache_len: int) -> None:
        """Layer ``i``'s decode attention (``fn``) over ``cache_len + 1``
        positions, into the buffer the next segment reads."""
        self.attn.copy_(fn(self.out[i][1], self.k[i], self.v[i],
                           cache_len + 1, **tfm.scaled(self.model.arch)))


class _HybridBatch(_Batch):
    """A ``hybrid_moe`` batch size: segment j runs from attention layer
    j - 1's output projection (or the embedding) through the Mamba2 and
    MoE layers up to attention layer j's query, key and value (or the
    logits), each Mamba2 layer against its static state.  A segment is
    captured as one graph a layer (its pieces), not one graph: the graphs
    share one memory pool, and a piece's temporaries (with the plain SSD
    step, its state-sized products, 134 MB each at Granite's widths and
    batch 32) are then held once, not once for each layer of a segment."""

    def __init__(self, dec: "GraphedDecode", B: int):
        super().__init__(dec, B)
        self.ssm = [ssm_mod.SSMLayerState(*(t[:B] for t in st))
                    for st in dec.cache["ssm"]]
        types = self.model.arch.layer_types
        self.attn_at = [i for i, t in enumerate(types) if t == "attention"]
        self.ssm_of = {i: n for n, i in enumerate(
            i for i, t in enumerate(types) if t == "mamba")}

    def pieces(self, j: int) -> list:
        """Segment ``j`` as functions of the previous piece's h."""
        m, arch = self.model, self.model.arch
        mult = arch.residual_multiplier

        def moe(h, i):
            return h + moe_mod.moe_mlp(h, m.blocks[i], arch, m.moe_dispatch,
                                       layer=i) * mult

        def start(_):
            if j == 0:
                return m._embed(self.tok)
            a = self.attn_at[j - 1]
            h = self.out[j - 1][0] + tfm.attention_out(
                self.attn, m.blocks[a]) * mult
            return moe(h, a)

        def mamba(h, i):
            st = self.ssm[self.ssm_of[i]]
            out, new = ssm_mod.ssm_mixer_decode(h, m.blocks[i], arch, st,
                                                m.impl, ssd_out=st.ssd)
            for dst, src in zip(st[1:], new[1:]):     # the conv tails
                dst.copy_(src)
            return moe(h + out * mult, i)

        def end(h):
            if j == len(self.attn_at):
                return m.head(h)
            a = self.attn_at[j]
            return h, tfm.decode_qkv(h, m.blocks[a], arch, self.k[j],
                                     self.v[j], self.pos, self.idx)

        lo = 0 if j == 0 else self.attn_at[j - 1] + 1
        hi = self.attn_at[j] if j < len(self.attn_at) else arch.num_layers
        return [start] + [partial(mamba, i=i) for i in range(lo, hi)] + [end]

    @property
    def n_graphs(self) -> int:
        return sum(len(self.pieces(j)) for j in range(len(self.out)))

    def segment(self, j: int):
        h = None
        for piece in self.pieces(j):
            h = piece(h)
        return h

    def capture(self, pool, side: torch.cuda.Stream) -> None:
        """As ``_Batch.capture``, a graph a piece; ``moe.expert_rows`` is
        restored after the eager pass."""
        saved = {k: v.clone() for k, v in moe_mod.expert_rows.items()}
        cur = torch.cuda.current_stream(self.model.device)
        n = len(self.out)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for j in range(n):
                self.out[j] = self.segment(j)
        cur.wait_stream(side)
        for k, v in moe_mod.expert_rows.items():
            if k in saved:
                v.copy_(saved[k])
            else:
                v.zero_()
        self.graphs = []
        with torch.cuda.stream(side):
            for j in range(n):
                h, graphs = None, []
                for piece in self.pieces(j):
                    g = torch.cuda.CUDAGraph()
                    g.capture_begin(pool=pool)
                    h = piece(h)
                    g.capture_end()
                    graphs.append(g)
                self.out[j] = h
                self.graphs.append(graphs)
        cur.wait_stream(side)

    def run(self, j: int) -> None:
        if self.graphs is None:
            self.out[j] = self.segment(j)
        else:
            for g in self.graphs[j]:
                g.replay()

    def rows(self) -> kvcache.Cache:
        return {"k": self.k, "v": self.v, "ssm": self.ssm}


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
        self._kind = (_HybridBatch if model.arch.family == "hybrid_moe"
                      else _Batch)
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
            b = self._kind(self, B)
            if self.capture and self.tracer is None:
                b.capture(self._pool, self._side)
            elif self.capture:
                with self.tracer.span("graphed.capture", "graphed",
                                      app=self.model.arch.name, B=B,
                                      graphs=b.n_graphs):
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
        return self._batch(B).rows()

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
        tr = self.tracer
        if tr is None:
            b.inputs(tokens, cache_len)
        else:
            with tr.span("graphed.inputs", "graphed"):
                b.inputs(tokens, cache_len)
        attend = (ops.decode_attention if m.impl == "kernel"
                  else ref.decode_attention_ref)
        L = len(b.k)
        for i in range(L):
            b.run(i)
            if tr is None:
                b.attend(attend, i, cache_len)
            else:
                with tr.span("decode_attention", "graphed", layer=i):
                    b.attend(attend, i, cache_len)
        b.run(L)
        return b.out[L]
