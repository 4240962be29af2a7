"""Logical-axis sharding policy over a ``DeviceMesh`` and DTensor.

PyTorch counterpart of ``repro.sharding.policy``.  Model code never names
mesh axes directly; it pins tensors by *logical* axis names and the policy
maps those to mesh axes with divisibility-safe fallbacks (the reference's
rule table, copied):

* ``batch``     -> the data axes ('pod','data') when the global batch divides.
* ``qheads``    -> 'model' when H % tp == 0 (classic head TP) ...
* ``seq``       -> ... otherwise the sequence dim goes to 'model'
                  (context parallelism / megatron sequence parallelism).
* ``cache_seq`` -> 'model' (flash-decode).
* ``ff`` / ``experts`` / ``vocab`` / ``ssm_pdim`` -> 'model' when divisible.
* weight "storage" dims (``embed`` on matmul inputs) -> data axes when
  training (FSDP/ZeRO-3 storage).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (or anything with
``mesh_dim_names`` and ``shape``); the policy reads only its axis names and
extents, as the reference reads only ``axis_names`` and ``shape``.
``spec`` gives a tuple per tensor dim (:class:`PartitionSpec`, the port's
stand-in for JAX's), ``placements`` the DTensor placements of a spec, and
``pin`` redistributes a tensor to them, the counterpart of
``with_sharding_constraint``.  A policy with ``mesh=None`` is a no-op.

The storage-sharding threshold stays the reference's 12 GiB, which it
sized for a 16 GiB TPU v5e chip.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig

MeshAxes = Optional[Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names (in mesh order).  Equal to the tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: ``mesh_dim_names`` of a ``DeviceMesh``,
    ``axis_names`` of a stand-in like the reference tests' ``FakeMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> extent."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(t):
    """A DTensor's whole value on every rank (a collective where it is
    sharded); a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def redistribute(x, placements):
    """DTensor ``x`` on ``placements`` of its mesh (``x`` itself where it
    is there already).  A pending sum is reduced in place first, then the
    result is resharded: DTensor's one-step redistribute of a vocab-sharded
    lookup's masked sum to another dim's shard applies the mask to the
    wrong shape.  The local shard comes out contiguous (a shard cut from a
    replica is a strided view, and a DTensor's flatten and view need a
    contiguous one)."""
    from torch.distributed.tensor import Replicate
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    return x.redistribute(mesh, placements).contiguous()


def seq_rank(mesh, dims) -> int:
    """This rank's index over the mesh dims ``dims`` that shard one tensor
    dim, in placement order (the first dim the outermost, as DTensor cuts
    it); rank 0 of a ``fake`` group (the dry-run's) is index 0."""
    coord = mesh.get_coordinate()
    r = 0
    for i in dims:
        r = r * mesh.shape[i] + coord[i]
    return r


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


@dataclass
class ShardingPolicy:
    mesh: Any
    rules: Dict[str, MeshAxes] = field(default_factory=dict)
    attn_mode: str = "replicated"  # head_tp | context | replicated
    notes: Tuple[str, ...] = ()

    # -- mapping ---------------------------------------------------------
    def axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """Map logical dims to mesh axes, de-duplicating: a mesh axis may
        appear at most once per spec (first dim wins)."""
        used = set()
        out = []
        for l in logical:
            ax = self.axes(l)
            if ax is None:
                out.append(None)
                continue
            ax = tuple(a for a in ax if a not in used)
            used.update(ax)
            out.append(None if not ax else ax[0] if len(ax) == 1 else ax)
        return PartitionSpec(*out)

    def placements_of(self, spec) -> tuple:
        """DTensor placements of a spec: ``Shard(d)`` on each mesh dim
        of more than one rank that tensor dim ``d`` lists, ``Replicate()``
        elsewhere (as :meth:`pin_spec`, which honours an axis only where
        its extent is above 1).  A dim over two mesh axes must list them
        in mesh order (JAX's major-to-minor layout); the rule table makes
        no other."""
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(self.mesh)
        extent = mesh_shape(self.mesh)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            index = [names.index(a) for a in group]
            if index != sorted(index):
                raise ValueError(f"spec {spec}: dim {d} lists mesh axes "
                                 f"{group} out of mesh order {names}")
            for i in index:
                if extent[names[i]] > 1:
                    out[i] = Shard(d)
        return tuple(out)

    def placements(self, *logical: Optional[str]) -> tuple:
        """The DTensor placements of ``spec(*logical)`` on the mesh."""
        if self.mesh is None:
            raise ValueError("placements: the policy has no mesh")
        return self.placements_of(self.spec(*logical))

    def pin_spec(self, shape, *logical: Optional[str]) -> PartitionSpec:
        """The spec :meth:`pin` gives a tensor of ``shape``: an axis is
        honoured only where its extent is above 1 and divides the dim."""
        used = set()
        axes = []
        for dim, l in zip(shape, logical):
            ax = self.rules.get(l) if l is not None else None
            if ax:
                ax = tuple(a for a in ax if a not in used)
            if ax:
                size = math.prod(_axis_size(self.mesh, a) for a in ax)
                if size > 1 and dim % size == 0:
                    axes.append(ax[0] if len(ax) == 1 else ax)
                    used.update(ax)
                    continue
            axes.append(None)
        axes += [None] * (len(shape) - len(axes))
        return PartitionSpec(*axes)

    def pin(self, x, *logical: Optional[str]):
        """The sharding constraint of the reference's ``pin``: with a mesh,
        ``x`` as a DTensor on the placements of :meth:`pin_spec` (a plain
        tensor is taken as replicated on every rank); without one, ``x``
        itself (see :func:`redistribute`)."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate
        want = self.placements_of(self.pin_spec(tuple(x.shape), *logical))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * len(want), run_check=False)
        return redistribute(x, want)

    @property
    def tp(self) -> int:
        return _axis_size(self.mesh, "model") if self.mesh else 1

    @property
    def seq_shards(self) -> int:
        """How many ways the sequence dim is sharded (context mode)."""
        if self.mesh is None or not self.rules.get("seq"):
            return 1
        return math.prod(_axis_size(self.mesh, a) for a in self.rules["seq"])

    @property
    def data_parallel(self) -> int:
        if self.mesh is None:
            return 1
        names = axis_names(self.mesh)
        return math.prod(_axis_size(self.mesh, a)
                         for a in ("pod", "data") if a in names)


NULL_POLICY = ShardingPolicy(mesh=None)   # the no-op policy


def make_policy(
    arch: ArchConfig,
    shape: ShapeConfig,
    mesh,
    *,
    training: bool = False,
    fsdp: Optional[bool] = None,
) -> ShardingPolicy:
    """Derive the logical->mesh mapping for one (arch, shape, mesh) cell."""
    if mesh is None:
        return ShardingPolicy(mesh=None)

    fsdp = training if fsdp is None else fsdp
    notes = []
    names = axis_names(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    dp = math.prod(_axis_size(mesh, a) for a in data_axes) if data_axes else 1
    tp = _axis_size(mesh, "model")

    rules: Dict[str, MeshAxes] = {}

    # ---- batch ----------------------------------------------------------
    if data_axes and _divisible(shape.global_batch, dp):
        rules["batch"] = data_axes
    elif data_axes and len(data_axes) == 1 and _divisible(
            shape.global_batch, _axis_size(mesh, data_axes[0])):
        rules["batch"] = data_axes
    else:
        # batch=1 long-context decode: replicate batch, note the idle axis
        rules["batch"] = None
        if shape.global_batch < dp:
            notes.append(f"batch={shape.global_batch} < dp={dp}: data axes idle")

    # ---- attention ------------------------------------------------------
    # Prefill prefers CONTEXT parallelism for GQA archs whose KV heads are
    # narrow: gathering k/v per layer (2·S·kv·hd bytes) beats head-TP's
    # two activation all-reduces (2·2·S·d bytes) whenever 2·kv·hd < d.
    seq = shape.seq_len
    prefer_context = (
        shape.kind == "prefill" and arch.num_heads
        and _divisible(seq, tp)
        and 2 * arch.num_kv_heads * arch.head_dim < arch.d_model)
    if (arch.num_heads and _divisible(arch.num_heads, tp)
            and not prefer_context):
        attn_mode = "head_tp"
        rules["qheads"] = ("model",)
        rules["kvheads"] = ("model",) if _divisible(arch.num_kv_heads, tp) else None
        rules["seq"] = None
    elif _divisible(seq, tp):
        attn_mode = "context"
        rules["qheads"] = None
        rules["kvheads"] = None
        rules["seq"] = ("model",)
        if arch.num_heads:
            notes.append(
                f"H={arch.num_heads} % tp={tp} != 0: context-parallel attention")
    else:
        attn_mode = "replicated"
        rules["qheads"] = None
        rules["kvheads"] = None
        rules["seq"] = None
        notes.append("attention replicated over model axis")

    # decode-time KV cache: shard the sequence dim (flash-decode pattern)
    rules["cache_seq"] = ("model",) if _divisible(seq, tp) else None
    # In non-head_tp modes attention *weights* still need a model-axis
    # storage shard; hd is a pure storage dim there.
    if attn_mode != "head_tp" and arch.num_heads and _divisible(arch.head_dim, tp):
        rules["head_dim"] = ("model",)
    else:
        rules["head_dim"] = None

    # ---- mlp / vocab ----------------------------------------------------
    rules["ff"] = ("model",) if _divisible(arch.d_ff or 0, tp) else None
    rules["vocab"] = ("model",) if _divisible(arch.vocab_size, tp) else None
    if rules["vocab"] is None:
        notes.append(f"vocab={arch.vocab_size} % tp={tp} != 0: vocab replicated")

    # token groups for the MoE grouped dispatch: whatever axes shard the
    # (batch × seq-chunk) token space
    rules["token_groups"] = tuple(
        (data_axes or ()) + (("model",) if rules.get("seq") else ())) or None

    # ---- MoE ------------------------------------------------------------
    if arch.moe is not None:
        E = arch.moe.num_experts
        ff_tp = _divisible(arch.moe.d_ff_expert, tp)
        # Preference order maximizes weight sharding:
        #   EP over ('pod','data') + ff TP  >  EP over ('data',) + ff TP
        #   >  EP over 'model'  >  replicated experts + ff TP.
        ep_axes = None
        for cand in (data_axes, data_axes[-1:] if data_axes else None):
            if cand and _divisible(E, math.prod(_axis_size(mesh, a)
                                                for a in cand)):
                ep_axes = tuple(cand)
                break
        if ep_axes and ff_tp:
            rules["experts"] = ep_axes
            rules["expert_ff"] = ("model",)
            notes.append(f"E={E}: expert-parallel over {ep_axes}, "
                         "expert ff TP")
        elif _divisible(E, tp):
            rules["experts"] = ("model",)
            rules["expert_ff"] = None
        else:
            rules["experts"] = None
            rules["expert_ff"] = ("model",) if ff_tp else None
            notes.append(f"E={E}: experts replicated")
    rules["token_groups_data"] = data_axes or None

    # ---- SSM -------------------------------------------------------------
    if arch.ssm is not None:
        nh = arch.ssm.num_heads(arch.d_model)
        if _divisible(nh, tp):
            rules["ssm_heads"] = ("model",)
            rules["ssm_pdim"] = None
        elif _divisible(arch.ssm.head_dim, tp):
            rules["ssm_heads"] = None
            rules["ssm_pdim"] = ("model",)
            notes.append(f"ssm heads={nh} % tp={tp} != 0: shard head_dim")
        else:
            rules["ssm_heads"] = None
            rules["ssm_pdim"] = None
            notes.append("ssm replicated over model axis")
        rules["ssm_state"] = None

    # ---- weight storage (FSDP / ZeRO-3) ----------------------------------
    # Serving also storage-shards weights over the data axes when the
    # TP(+EP)-sharded copy plus the decode KV cache would not fit a 16 GiB
    # v5e (the reference's budget, kept).  EP-sharded expert weights don't
    # burden the TP quota.
    total_params, _ = arch.param_count()
    dense_params = total_params
    if arch.moe is not None and rules.get("experts"):
        ep = math.prod(_axis_size(mesh, a) for a in rules["experts"])
        ff_shard = tp if rules.get("expert_ff") else 1
        n_moe = arch.num_layers // arch.moe.moe_every
        expert_only = (arch.moe.num_experts * 3 * arch.d_model
                       * arch.moe.d_ff_expert) * n_moe
        dense_params = total_params - expert_only
        expert_gb = expert_only * 2 / (ep * ff_shard) / 2 ** 30
    else:
        expert_gb = 0.0
    weight_gb_per_chip = dense_params * 2 / max(tp, 1) / 2 ** 30 + expert_gb
    cache_gb = 0.0
    if shape.kind == "decode":
        from repro_torch.models.kvcache import cache_bytes
        shards = tp * (dp if _divisible(shape.global_batch, dp) else 1)
        cache_gb = cache_bytes(arch, shape.global_batch,
                               shape.seq_len) / shards / 2 ** 30
    if data_axes and _divisible(arch.d_model, dp) and (
            fsdp or weight_gb_per_chip + cache_gb > 12.0):
        rules["embed"] = data_axes
        if not fsdp:
            notes.append(
                f"weights {weight_gb_per_chip:.1f} + cache {cache_gb:.1f} "
                "GiB/chip under TP alone: storage-sharded over data axes "
                "(ZeRO-style)")
    else:
        rules["embed"] = None

    # expert weights' d_model dim: use whatever data axes the experts
    # themselves don't occupy (avoids a duplicate-axis spec).
    if arch.moe is not None:
        used = rules.get("experts") or ()
        free = tuple(a for a in (rules["embed"] or ()) if a not in used)
        rules["expert_embed"] = free or None

    rules["layers"] = None

    return ShardingPolicy(mesh=mesh, rules=rules, attn_mode=attn_mode,
                          notes=tuple(notes))
