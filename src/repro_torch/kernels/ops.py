"""Dispatch of the port's kernels by the device of the tensors they get.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version in ``ref``.  Nothing else
selects the path: no environment variable, and no fallback when a kernel
fails to build or launch.  The kernels have no backward: on a CUDA tensor,
a call under grad mode with an input that requires grad raises (its
result would carry no gradient), so training runs the plain versions
(``Model(impl="plain")``).

A DTensor input (a model under a ``ShardingPolicy`` with a mesh) runs
through :func:`on_shards`: each wrapper takes its inputs to placements on
which its work is local (batch and query/KV heads for the attention
kernels; batch, SSM heads and head-dim rows for the SSD and its decode
step; rows or columns for the int8 GEMM; rows, and a per-head weight's
heads, for the norm), redistributing explicitly where
a sharding cannot be taken locally, and calls the kernel, or its plain
version on the CPU, on each rank's local shards.  The extension itself never sees a DTensor.

The attention follows the JAX package's sequence parallelism, as its GSPMD
lowering divides the work, and gathers neither the cache nor the queries:

* decode over a cache sharded on its sequence: on each mesh dim that
  shards the cache's positions, every rank computes its shard's share (the
  output over its valid positions and their log-sum-exp,
  :func:`decode_attention_partial`) and the ranks merge the shares with
  all-reduces (the max of the log-sum-exps, then the sums of the weights
  and of the weighted outputs): the flash-decode pattern;
* prefill with the queries sharded on their sequence (context mode): every
  rank computes its own query rows at their global positions against the
  whole K/V, which are gathered where they are not whole already.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import quant_matmul as _qmm
from repro_torch.kernels import ref
from repro_torch.kernels import rms_norm as _norm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_step as _step
from repro_torch.sharding.policy import is_dtensor, redistribute, seq_rank


def _sharded(*inputs) -> bool:
    return any(is_dtensor(t) for t in inputs)


def _plan(mesh, sizes: dict, candidates, skip=()) -> List[Optional[int]]:
    """Per mesh dim, the tensor dim the work splits on there, or None
    (replicated): the first of ``candidates`` (``(tensor, dims)`` pairs)
    sharded on that mesh dim over one of its ``dims``, where that dim's
    remaining size (``sizes``, divided as shards are taken) splits evenly
    over the mesh dim.  Mesh dims in ``skip`` are left None."""
    plan = []
    for i, n in enumerate(mesh.shape):
        dim = None if i in skip else next((
            x.placements[i].dim for x, dims in candidates
            if is_dtensor(x) and x.placements[i].is_shard()
            and x.placements[i].dim in dims
            and sizes[x.placements[i].dim] % n == 0), None)
        if dim is not None:
            sizes[dim] //= n
        plan.append(dim)
    return plan


def _placed(plan, dims: dict) -> tuple:
    """Placements of one tensor under a plan: ``Shard(dims[d])`` on each
    mesh dim that splits plan dim ``d`` (absent from ``dims``: replicated
    there)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[d]) if d is not None and dims.get(d) is not None
                 else Replicate() for d in plan)


def _seq_dims(mesh, x) -> Tuple[int, ...]:
    """The mesh dims of more than one rank that shard ``x``'s dim 1 (its
    sequence), when they split it evenly (else none: an uneven split is
    gathered)."""
    if not is_dtensor(x):
        return ()
    dims = tuple(i for i, p in enumerate(x.placements)
                 if p.is_shard() and p.dim == 1 and mesh.shape[i] > 1)
    n = math.prod(mesh.shape[i] for i in dims)
    return dims if x.shape[1] % n == 0 else ()


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local
    shard's gradient becomes a DTensor's local tensor, and a DTensor's
    views assume a contiguous one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def run_local(fn: Callable, mesh, args: Sequence, in_p: Sequence,
              out_p: Sequence, out_shapes: Sequence):
    """``fn`` on the local shards of ``args`` (each taken to its
    placements in ``in_p``, None for a non-tensor; a plain tensor counts
    as replicated), its outputs as DTensors of ``out_p`` and global
    ``out_shapes``: ``to_local`` and ``from_local``, both differentiable.
    An input replicated on a mesh dim over which the outputs are split
    (sharded, or pending a sum) gets its gradient there as a pending sum:
    each rank's local work sees only its part of the outputs."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    split = [any(not o[i].is_replicate() for o in out_p)
             for i in range(mesh.ndim)]
    local = []
    for a, p in zip(args, in_p):
        if p is None or a is None:
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        a = redistribute(a, p)
        if not a.requires_grad:
            local.append(a.to_local())
            continue
        grad_p = [Partial() if s and q.is_replicate() else q
                  for s, q in zip(split, a.placements)]
        local.append(_ContiguousGrad.apply(a.to_local(grad_placements=grad_p)))
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(
        DTensor.from_local(o.contiguous(), mesh, p, run_check=False,
                           shape=torch.Size(s), stride=_contiguous(s))
        for o, p, s in zip(outs, out_p, out_shapes))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def on_shards(fn: Callable, *args, **kwargs):
    """``fn`` (a wrapper of this module or its plain version in ``ref``)
    on the local shards of DTensor arguments; see the module docstring.
    Returns DTensors on the placements the work was split by."""
    name = getattr(fn, "__name__", "")
    kind = _KIND[name]
    mesh = next(a.device_mesh for a in args + tuple(kwargs.values())
                if is_dtensor(a))
    if kind in ("flash", "decode"):
        # batch, or heads where KV and H both divide (every local query
        # head keeps its kv head); q's sharding first, then k's.  The mesh
        # dims that shard the cache's positions (decode) or the queries'
        # rows (prefill) split the sequence instead.
        q, k, v = args[:3]
        x = k if kind == "decode" else q
        seq = _seq_dims(mesh, x)
        plan = _plan(mesh, {0: q.shape[0],
                            2: math.gcd(q.shape[2], k.shape[2])},
                     [(q, (0, 2)), (k, (0, 2))], skip=seq)
        p = _placed(plan, {0: 0, 2: 2})
        if not seq:
            return run_local(lambda *t: fn(*t, *args[3:], **kwargs), mesh,
                             (q, k, v), (p, p, p), (p,), (q.shape,))
        from torch.distributed.tensor import Shard
        on_seq = tuple(Shard(1) if i in seq else pl
                       for i, pl in enumerate(p))
        S_local = x.shape[1] // math.prod(mesh.shape[i] for i in seq)
        start = seq_rank(mesh, seq) * S_local
        if kind == "decode":
            return run_local(
                lambda *t: _merged_decode(name, mesh, seq, *t,
                                          _shard_len(args[3], start, S_local),
                                          **kwargs),
                mesh, (q, k, v), (p, on_seq, on_seq), (p,), (q.shape,))
        return run_local(
            lambda *t: fn(*t, *args[3:], q_offset=start, **kwargs), mesh,
            (q, k, v), (on_seq, p, p), (on_seq,), (q.shape,))
    if kind == "ssd":
        x, dt, A, Bm, Cm = args
        init = kwargs.pop("init_state", None)
        plan = _plan(mesh, {0: x.shape[0], 2: x.shape[2], 3: x.shape[3]},
                     [(x, (0, 2, 3))])
        B, nh, hd, ds = x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]
        in_p = (_placed(plan, {0: 0, 2: 2, 3: 3}),      # x
                _placed(plan, {0: 0, 2: 2}),            # dt
                _placed(plan, {2: 0}),                  # A
                _placed(plan, {0: 0}),                  # Bm
                _placed(plan, {0: 0}),                  # Cm
                _placed(plan, {0: 0, 2: 1, 3: 2}) if init is not None
                else None)                              # init_state
        out_p = (in_p[0], _placed(plan, {0: 0, 2: 1, 3: 2}))
        return run_local(
            lambda x, dt, A, Bm, Cm, s0: fn(x, dt, A, Bm, Cm, init_state=s0,
                                            **kwargs),
            mesh, (x, dt, A, Bm, Cm, init), in_p, out_p,
            (x.shape, (B, nh, hd, ds)))
    if kind == "norm":
        # rows (every dim but the last) and, for a per-head weight, its
        # heads alike: each rank normalises whole groups; the last dim
        # whole on each rank
        x, weight, eps = args
        z = kwargs.pop("z", None)
        lead = x.dim() - weight.dim()
        dims = tuple(range(x.dim() - 1))
        plan = _plan(mesh, dict(enumerate(x.shape)), [(x, dims), (z, dims)])
        xp = _placed(plan, {i: i for i in dims})
        wp = _placed(plan, {i: i - lead for i in dims if i >= lead})
        return run_local(lambda x, w, z: fn(x, w, eps, z=z, **kwargs), mesh,
                         (x, weight, z), (xp, wp, xp), (xp,), (x.shape,))
    if kind == "step":
        # the state's batch, heads and head-dim rows, as the state (else x)
        # is split; A, D, Bm and Cm whole on each rank.  ``out`` takes the
        # new state after the shards are joined.
        x, dt, A, Bm, Cm, D, state = args
        out = kwargs.pop("out", None)
        plan = _plan(mesh, {0: x.shape[0], 1: x.shape[1], 2: x.shape[2]},
                     [(state, (0, 1, 2)), (x, (0, 1, 2))])
        xp, heads = _placed(plan, {0: 0, 1: 1, 2: 2}), _placed(plan, {1: 0})
        rows = _placed(plan, {0: 0})
        y, new = run_local(lambda *t: fn(*t, **kwargs), mesh, args,
                           (xp, _placed(plan, {0: 0, 1: 1}), heads, rows,
                            rows, heads, xp), (xp, xp),
                           (x.shape, state.shape))
        if out is None:
            return y, new
        out.copy_(new)
        return y, out
    # quant: rows of x_q or columns of w_q
    x_q, w_q, x_scale, w_scale = args[:4]
    plan = _plan(mesh, {0: x_q.shape[0], 1: w_q.shape[1]},
                 [(x_q, (0,)), (w_q, (1,))])
    in_p = (_placed(plan, {0: 0}), _placed(plan, {1: 1}),
            _placed(plan, {0: 0}), _placed(plan, {1: 0}))
    return run_local(lambda *t: fn(*t, *args[4:], **kwargs), mesh,
                     (x_q, w_q, x_scale, w_scale), in_p,
                     (_placed(plan, {0: 0, 1: 1}),),
                     ((x_q.shape[0], w_q.shape[1]),))


def _shard_len(cache_len: int, start: int, S_local: int) -> int:
    """The valid positions of the cache shard that starts at ``start``."""
    return min(max(int(cache_len) - start, 0), S_local)


def _merged_decode(name: str, mesh, seq: Sequence[int], q: torch.Tensor,
                   k_shard: torch.Tensor, v_shard: torch.Tensor,
                   valid_len: int, *, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """A rank's decode output over a sequence-sharded cache: its shard's
    share (the kernel's, or the plain version's where ``name`` is the
    plain decode), merged over the mesh dims ``seq`` as the reference's
    lowering merges the softmax: an all-reduce max of the log-sum-exps,
    then one all-reduce sum of the weights and the weighted outputs
    (``ref.merge_partials`` on stacked shares), cast to q's dtype."""
    import torch.distributed._functional_collectives as funcol
    share = (decode_attention_partial if name == "decode_attention"
             else ref.decode_attention_partial_ref)
    o, lse = share(q, k_shard, v_shard, valid_len, scale=scale)
    m = lse
    for i in seq:
        m = funcol.all_reduce(m, "max", (mesh, i))
    w = ref.merge_weights(lse, m)
    hd = o.shape[-1]
    acc = torch.cat([o[:, 0] * w[..., None], w[..., None]], dim=-1)
    for i in seq:
        acc = funcol.all_reduce(acc, "sum", (mesh, i))
    out = acc[..., :hd] / torch.clamp_min(acc[..., hd:], 1e-30)
    return out[:, None].to(q.dtype)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {x.device}")


def _kernel_path(name: str, *inputs: Optional[torch.Tensor]) -> bool:
    """Whether ``name``'s call goes to its kernel (its first input is on
    the card); raises there if autograd would need the kernel's backward."""
    if not _on_cuda(inputs[0]):
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; train with Model(impl='plain')")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """[B,Sq,H,hd] x [B,Skv,KV,hd]^2 -> [B,Sq,H,hd] (GQA, un-repeated KV).

    ``q_offset`` (causal): the key position of q's first row, which sees
    the keys up to it (``None``: ``Skv - Sq``, the last row sees all).  The
    kernel takes K/V cut to their first ``q_offset + Sq`` positions (a view
    along the sequence: bases and strides stay), where its own offset
    ``Skv - Sq`` is ``q_offset``; the plain version masks the whole K/V."""
    if _sharded(q, k, v):
        return on_shards(flash_attention, q, k, v, causal=causal, scale=scale)
    if _kernel_path("flash_attention", q, k, v):
        if causal and q_offset is not None:
            end = int(q_offset) + q.shape[1]
            if not q.shape[1] <= end <= k.shape[1]:
                raise ValueError(f"flash_attention: q_offset {q_offset} "
                                 f"puts {q.shape[1]} rows past "
                                 f"{k.shape[1]} keys")
            k, v = k[:, :end], v[:, :end]
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """[B,1,H,hd] vs caches [B,S,KV,hd] over ``cache_len`` positions."""
    if _sharded(q, k_cache, v_cache):
        return on_shards(decode_attention, q, k_cache, v_cache, cache_len,
                         scale=scale)
    if _kernel_path("decode_attention", q, k_cache, v_cache):
        return _decode.decode_attention(q, k_cache, v_cache, cache_len,
                                        scale=scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    scale=scale)


def decode_attention_partial(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, valid_len: int, *,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cache shard's share of a decode step -> ``(o, lse)`` fp32
    (``ref.decode_attention_partial_ref``); ``valid_len`` 0..S_local."""
    if _kernel_path("decode_attention_partial", q, k_shard, v_shard):
        return _decode.decode_attention_partial(q, k_shard, v_shard,
                                                valid_len, scale=scale)
    return ref.decode_attention_partial_ref(q, k_shard, v_shard, valid_len,
                                            scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD over [B,S,nh,hd] -> (y, final state [B,nh,hd,ds]).
    ``chunk`` sets the plain version's chunk; the kernel walks fixed
    64-row chunks (the result is the same up to rounding)."""
    if _sharded(x, dt, A, Bm, Cm, init_state):
        return on_shards(ssd_scan, x, dt, A, Bm, Cm, chunk=chunk,
                         init_state=init_state)
    if _kernel_path("ssd_scan", x, dt, A, Bm, Cm, init_state):
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, init_state=init_state)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor, *, out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Mamba2 decode step: (y [B,nh,hd], the new state [B,nh,hd,ds])
    from x [B,nh,hd], dt [B,nh], A and D [nh], Bm and Cm [B,ds] and the
    state (``ref.ssd_step_ref``).  With ``out`` (which may be ``state``)
    the new state is written there; without it, into a new tensor."""
    if _sharded(x, dt, A, Bm, Cm, D, state):
        return on_shards(ssd_step, x, dt, A, Bm, Cm, D, state, out=out)
    if _kernel_path("ssd_step", x, dt, A, Bm, Cm, D, state):
        return _step.ssd_step(x, dt, A, Bm, Cm, D, state, out=out)
    return ref.ssd_step_ref(x, dt, A, Bm, Cm, D, state, out=out)


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor, *,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 [M,K] x int8 [K,N] -> ``out_dtype`` [M,N] with row/col scales."""
    if _sharded(x_q, w_q, x_scale, w_scale):
        return on_shards(quant_matmul, x_q, w_q, x_scale, w_scale,
                         out_dtype=out_dtype)
    if _kernel_path("quant_matmul", x_q, w_q, x_scale, w_scale):
        return _qmm.quant_matmul(x_q, w_q, x_scale, w_scale,
                                 out_dtype=out_dtype)
    return ref.quant_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
             z: Optional[torch.Tensor] = None,
             group: Optional[int] = None) -> torch.Tensor:
    """RMSNorm of x [..., d] over its last dim scaled by ``1 + weight``
    (x's trailing dims), or with a gate ``z`` (x's shape) of ``x *
    silu(z)`` over groups of ``group`` channels of the last dim
    (``ref.rms_norm_ref``).  On the card the kernel takes the rows as they
    are where they are 16-byte aligned, else a contiguous copy: rows of
    ``weight.numel()`` channels in groups of the last dim (a per-head
    ``weight`` [nh, hd] normalises each head's hd channels)."""
    if _sharded(x, weight, z):
        return on_shards(rms_norm, x, weight, eps, z=z, group=group)
    if not _kernel_path("rms_norm", x, weight, z):
        return ref.rms_norm_ref(x, weight, eps, z=z, group=group)
    d = weight.numel()
    g = group or x.shape[-1]

    def rows(t):
        r = t.reshape(-1, d)
        return r if _norm.rows_aligned(r) else r.contiguous()

    out = _norm.rms_norm(rows(x), weight.reshape(d), eps,
                         z=None if z is None else rows(z),
                         group=None if g == d else g)
    return out.view(x.shape)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation (plain PyTorch on either device, as the
    JAX package computes it outside any kernel)."""
    return ref.quantize_int8(x, axis)


def quant_linear(x: torch.Tensor, w_q: torch.Tensor,
                 w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation-quant linear: quantise x per row on the fly and
    run the int8 product.  x: [..., K]; w_q: [K, N] int8; w_scale: [N]."""
    shape = x.shape
    x_q, x_scale = ref.quantize_int8(x.reshape(-1, shape[-1]), axis=-1)
    out = quant_matmul(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32)
    return out.reshape(shape[:-1] + (w_q.shape[1],)).to(x.dtype)


# which placements each function's work is local on (``on_shards``)
_KIND = {f.__name__: kind for f, kind in (
    (flash_attention, "flash"), (ref.flash_attention_ref, "flash"),
    (decode_attention, "decode"), (ref.decode_attention_ref, "decode"),
    (ssd_scan, "ssd"), (ref.ssd_scan_ref, "ssd"),
    (ssd_step, "step"), (ref.ssd_step_ref, "step"),
    (rms_norm, "norm"), (ref.rms_norm_ref, "norm"),
    (quant_matmul, "quant"), (ref.quant_matmul_ref, "quant"))}
