"""Multi-pod dry-run of the port: build every (arch x shape x mesh) cell on
``meta`` tensors over a ``fake`` process group and count one step per rank.

PyTorch counterpart of ``repro.launch.dryrun``, with its function names and
record schema.  Where the reference lowers and compiles each cell on 512
forced host devices and reads XLA's analyses, the port runs the step
itself on ``meta`` tensors (shapes, no storage) under a ``DeviceMesh`` of a
``fake`` process group (collectives return at once, nothing moves) at the
mesh's world size: 256 ranks for ``pod``, 512 for ``multipod``.  The mesh is
built with ``device_type="cuda"`` although nothing touches a card: DTensor
picks its collectives by the mesh's device type (on a ``"cpu"`` mesh it
turns every all-to-all into an all-gather plus a chunk), and the count must
see the ones the card would run.  The model runs ``impl="plain"`` (the
kernel wrappers refuse ``meta``), as the reference lowers its jnp attention.

For each cell :class:`StepCounter`, a dispatch mode, yields per rank:

  * the pass/fail gate: a step that DTensor cannot shard raises;
  * FLOPs of ``torch.utils.flop_counter``'s registry over the rank's local
    ops (``FlopCounterMode`` would count the global op of a DTensor, and a
    plain mode would also count the op DTensor's sharding propagation runs
    on fake tensors: both are skipped);
  * bytes: inputs plus outputs of every aten op that is not a view, an
    upper bound before fusion as XLA's "bytes accessed" is;
  * collective bytes by kind under the reference's accounting: an
    all-gather at its result, an all-reduce at twice its operand,
    reduce-scatter and all-to-all at their operand;
  * memory under ``memory_analysis_dict``'s keys: arguments (the rank's
    local bytes of parameters, state, cache and batch), output, alias
    (outputs that are argument storages: the donated state and cache) and
    temp (the peak of the storages the step allocates, tracked with
    ``weakref.finalize``, less its outputs), so that arguments + temp +
    output - alias is the rank's peak;
  * with ``--comm-debug``, ``CommDebugMode``'s collective counts beside
    them;
  * the same FLOPs and bytes on the kernel path (``kernel_path``): the
    plain attention counted at the work of the kernel that
    ``impl="kernel"`` runs in its place (:func:`kernel_path`).

The port's layers are a Python loop, so the count covers every layer: the
record's ``extrapolation`` holds the direct count (``"method": "counted"``)
where the reference extrapolates an (L1, L2) pair because XLA counts a scan
body once; :func:`depth_pair` stays and the tests hold its linear estimate
to the direct count.  The reference's HLO parser has no counterpart.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all          # subprocess per cell
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# op -> (kind, what is counted) under the reference's accounting
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "result"),
    "_c10d_functional.all_gather_into_tensor_coalesced":
        ("all-gather", "result"),
    "_c10d_functional.all_reduce": ("all-reduce", "2x operand"),
    "_c10d_functional.all_reduce_": ("all-reduce", "2x operand"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "2x operand"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "operand"),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", "operand"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "operand"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "operand"),
    "_c10d_functional.broadcast": ("broadcast", "operand"),
}
_NOT_COUNTED = ("_c10d_functional.wait_tensor",)


def _tensors(tree, out=None) -> list:
    """The tensors in a tree of lists, tuples (named ones too) and dicts
    (faster than ``tree_leaves``: it runs once for every op counted)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _storage(t: torch.Tensor):
    return _local(t).untyped_storage()


def local_bytes(tree) -> int:
    """The rank's bytes of every tensor in ``tree`` (each storage once)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = _storage(t)
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class StepCounter(TorchDispatchMode):
    """Per-rank FLOPs, bytes, collectives and allocation peak of the ops
    run under it (module docstring).  A call on DTensors is left to
    DTensor (``NotImplemented``), which runs the local ops back through
    this mode; an op on or producing fake tensors is DTensor's sharding
    propagation and is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_bytes: Dict[str, float] = {}
        self.collective_counts: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}
        # inside a plain version that kernel_path counts as its kernel
        self.fused = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.kernel_flops += 0 if self.fused else n
        name = str(packet)
        if func.is_view or name in _NOT_COUNTED:
            return out
        n = _nbytes(ins) + _nbytes(outs)
        self.bytes += n
        self.kernel_bytes += 0 if self.fused else n
        if name in _COLLECTIVES:
            kind, rule = _COLLECTIVES[name]
            n = (_nbytes(outs) if rule == "result" else
                 2 * _nbytes(ins) if rule == "2x operand" else _nbytes(ins))
            self.collective_bytes[kind] = self.collective_bytes.get(
                kind, 0.0) + float(n)
            self.collective_counts[kind] = self.collective_counts.get(
                kind, 0) + 1
        owned = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in owned or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)


def _causal_pairs(Sq: int, Skv: int) -> int:
    """(query, key) pairs of a causal mask whose last query row sees all
    ``Skv`` keys (query i sees keys up to i + Skv - Sq)."""
    off = Skv - Sq
    if off >= 0:
        return Sq * off + Sq * (Sq + 1) // 2
    return sum(max(0, min(Skv, i + off + 1)) for i in range(Sq))


def _flash_work(out, q, k, v, *, causal: bool = True, scale=None):
    """(FLOPs, bytes) of the flash kernel on these (local) tensors: QK^T
    and PV over the pairs it computes, q, k and v read once and the
    output written once."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    pairs = _causal_pairs(Sq, Skv) if causal else Sq * Skv
    return 4 * B * H * hd * pairs, _nbytes((q, k, v, out))


def _decode_work(out, q, k_cache, v_cache, cache_len, *, scale=None):
    """(FLOPs, bytes) of the decode kernel: one query row against the
    first ``cache_len`` cache positions, which it alone reads."""
    B, S, _, hd = k_cache.shape
    L = min(int(cache_len), S)
    caches = _nbytes((k_cache, v_cache)) * L // S
    return 4 * B * q.shape[2] * hd * L, _nbytes((q, out)) + caches


_KERNEL_WORK = {"flash_attention_ref": _flash_work,
                "decode_attention_ref": _decode_work}


@contextlib.contextmanager
def kernel_path(counter: StepCounter):
    """Under it ``counter``'s ``kernel_flops`` and ``kernel_bytes`` count
    the plain attention (``ref.flash_attention_ref``,
    ``ref.decode_attention_ref``) at the work of the kernel that
    ``impl="kernel"`` launches in its place: not the plain version's fp32
    casts, its scores and the masked half it computes, but the kernel's
    pairs and I/O.  The SSD scan and the int8 GEMM keep their plain
    counts."""
    from repro_torch.kernels import ref
    plain = {name: getattr(ref, name) for name in _KERNEL_WORK}

    def fused(name):
        @functools.wraps(plain[name])
        def run(*args, **kwargs):
            counter.fused += 1
            try:
                out = plain[name](*args, **kwargs)
            finally:
                counter.fused -= 1
            local = [_local(a) if isinstance(a, torch.Tensor) else a
                     for a in args]
            flops, nbytes = _KERNEL_WORK[name](_local(out), *local, **kwargs)
            counter.kernel_flops += flops
            counter.kernel_bytes += nbytes
            return out
        return run

    for name in plain:
        setattr(ref, name, fused(name))
    try:
        yield
    finally:
        for name, fn in plain.items():
            setattr(ref, name, fn)


def memory_analysis_dict(args, out, peak_new: int) -> Dict[str, int]:
    """``memory_analysis()``'s keys for one rank: ``args`` and ``out`` are
    the step's arguments and outputs, ``peak_new`` the peak of the
    storages it allocated (:class:`StepCounter`)."""
    arguments = local_bytes(args)
    output = local_bytes(out)
    held = {_storage(t)._cdata for t in _tensors(args)}
    alias, seen = 0, set()
    for t in _tensors(out):
        st = _storage(t)
        if st._cdata in held and st._cdata not in seen:
            seen.add(st._cdata)
            alias += st.nbytes()
    peak = arguments + peak_new
    return {"argument_size_in_bytes": arguments,
            "output_size_in_bytes": output,
            "temp_size_in_bytes": max(peak - (arguments + output - alias), 0),
            "alias_size_in_bytes": alias,
            "peak_memory_in_bytes": peak}


def count_step(fn, args, comm_debug: bool = False) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under :class:`StepCounter` and return the
    rank's counts and memory; with ``comm_debug`` also under
    ``CommDebugMode``, whose collective counts (a cross-check of the
    counter's) come back as ``comm_debug_counts``.  That mode roughly
    doubles the time of a count.  ``kernel_path`` holds the FLOPs and
    bytes of the same step on the kernels (:func:`kernel_path`)."""
    from torch.distributed.tensor.debug import CommDebugMode
    comm = CommDebugMode() if comm_debug else contextlib.nullcontext()
    counter = StepCounter()
    with comm, counter, kernel_path(counter):
        out = fn(*args)
    got = {
        "flops": counter.flops, "bytes": counter.bytes,
        "kernel_path": {"flops": counter.kernel_flops,
                        "bytes": counter.kernel_bytes},
        "collectives": dict(counter.collective_bytes),
        "collective_counts": dict(counter.collective_counts),
        "memory": memory_analysis_dict(args, out, counter.peak),
    }
    if comm_debug:
        got["comm_debug_counts"] = {str(op): n for op, n in
                                    comm.get_comm_counts().items()}
    return got


# ---------------------------------------------------------------------------
def build_step(arch, shape, mesh, *, num_layers: Optional[int] = None,
               remat: Optional[str] = None,
               microbatches: Optional[int] = None,
               cache_len: Optional[int] = None):
    """Returns ``(fn, args, policy)``: ``fn(*args)`` runs the cell's step
    on ``meta`` tensors under ``make_policy(arch, shape, mesh)``.

    prefill: ``fn(params, tokens[, frontend_embeds])`` -> ``Model.prefill``;
    decode: ``fn(params, cache, cache_len, tokens)`` -> ``Model.decode_step``;
    train: ``fn(state, batch)`` -> ``make_train_step``'s step with
    ``remat="full"`` and 8 microbatches where the batch divides (the
    reference's settings).  ``params`` is the model's parameters, passed so
    that the arguments hold everything the step reads.  ``remat``,
    ``microbatches`` and ``cache_len`` replace those settings (the chip's
    cells run the train step as its train phase does)."""
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.model import Model
    from repro_torch.sharding.policy import make_policy
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    if num_layers is not None:
        arch = dataclasses.replace(arch, num_layers=num_layers)
    training = shape.kind == "train"
    policy = make_policy(arch, shape, mesh, training=training)
    if remat is None:
        remat = "full" if training else "none"
    model = Model(arch, device="meta", impl="plain", remat=remat,
                  policy=policy)
    ins = input_specs(arch, shape)

    if training:
        cfg = opt.AdamWConfig()
        if microbatches is None:
            microbatches = 8 if shape.global_batch % 8 == 0 else 1
        state = init_train_state(model, None, cfg)    # places the params
        step = make_train_step(model, cfg, microbatches=microbatches)
        return step, (state, ins), policy

    model.distribute()
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        def prefill(params, tokens, frontend_embeds=None):
            return model.prefill(tokens, frontend_embeds)
        args = [params, ins["tokens"]]
        if "frontend_embeds" in ins:
            args.append(ins["frontend_embeds"])
        return prefill, tuple(args), policy

    def serve_step(params, cache, cache_len, tokens):
        return model.decode_step(cache, cache_len, tokens)

    cache = model.init_cache(shape.global_batch, shape.seq_len)
    pos = ins["cache_len"] if cache_len is None else cache_len
    return serve_step, (params, cache, pos, ins["tokens"]), policy


def depth_pair(arch) -> Tuple[int, int]:
    """(L1, L2) for the scan-extrapolation, honoring family granularity."""
    if arch.family == "moe":
        g = arch.moe.moe_every
    elif arch.family == "hybrid":
        g = arch.hybrid.attn_every
    else:
        g = 1
    return g, 2 * g


def linear_estimate(at_L1: float, at_L2: float, L1: int, L2: int,
                    L: int) -> float:
    """The reference's depth extrapolation: per-layer delta x depth."""
    per = (at_L2 - at_L1) / (L2 - L1)
    return at_L1 + per * (L - L1)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks in this
    process (no processes, no collectives), destroyed on exit; a group
    already there is used as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_world_size(mesh_name: str) -> int:
    from repro_torch.launch.mesh import production_geometry
    num_pods, (a, b) = production_geometry()
    return a * b * (num_pods if mesh_name == "multipod" else 1)


def run_cell(arch_name: str, shape_name: str, mesh_name: str,
             out_path: Optional[str] = None,
             comm_debug: bool = False) -> Dict[str, Any]:
    from repro_torch.configs import applicable, get_arch, get_shape, \
        skip_reason
    from repro_torch.launch.mesh import make_production_mesh

    arch = get_arch(arch_name)
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "ok": False,
    }
    if not applicable(arch, shape):
        rec.update(ok=True, skipped=True, reason=skip_reason(arch, shape))
        return _finish(rec, out_path)

    try:
        with fake_world(mesh_world_size(mesh_name)):
            mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                        device_type="cuda")
            rec["chips"] = int(mesh.size())
            t0 = time.time()
            fn, args, policy = build_step(arch, shape, mesh)
            rec["build_s"] = round(time.time() - t0, 2)
            t0 = time.time()
            counted = count_step(fn, args, comm_debug)
            rec["count_s"] = round(time.time() - t0, 2)
        rec["memory"] = counted["memory"]
        rec["cost"] = {"flops": float(counted["flops"]),
                       "bytes": float(counted["bytes"])}
        rec["kernel_path"] = {k: float(v) for k, v in
                              counted["kernel_path"].items()}
        rec["collectives"] = counted["collectives"]
        rec["collective_counts"] = counted["collective_counts"]
        if comm_debug:
            rec["comm_debug_counts"] = counted["comm_debug_counts"]
        rec["policy_notes"] = list(policy.notes)
        rec["attn_mode"] = policy.attn_mode
        rec["ok"] = True
        rec["extrapolation"] = _extrapolate(arch, counted)
    except Exception as e:  # noqa: BLE001 — record and report
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _finish(rec, out_path)


def _extrapolate(arch, counted: Dict[str, Any]) -> Dict[str, Any]:
    """The record's full-depth terms: the direct count of every layer
    (the reference's (L1, L2) estimate is exact for a homogeneous stack
    and needed only because XLA counts a scan body once)."""
    L1, L2 = depth_pair(arch)
    coll = {k: float(v) for k, v in counted["collectives"].items()}
    return {"method": "counted", "L1": L1, "L2": L2,
            "true_layers": arch.num_layers,
            "est_flops": float(counted["flops"]),
            "est_bytes": float(counted["bytes"]),
            "est_collective_bytes": coll,
            "est_collective_total": sum(coll.values())}


def _finish(rec: Dict[str, Any], out_path: Optional[str]) -> Dict[str, Any]:
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    status = ("SKIP" if rec.get("skipped")
              else "OK" if rec["ok"] else "FAIL")
    print(f"[{status}] {rec['arch']} × {rec['shape']} × {rec['mesh']}"
          + (f"  ({rec.get('error', '')})" if not rec["ok"] else ""))
    return rec


# ---------------------------------------------------------------------------
def run_all(meshes, archs=None, shapes=None, jobs: int = 2):
    """Spawn one subprocess per cell (one fake group each; bounded
    memory)."""
    from repro_torch.configs import ARCHS, SHAPES
    archs = archs or list(ARCHS)
    shapes = shapes or list(SHAPES)
    cells = [(a, s, m) for m in meshes for a in archs for s in shapes]
    os.makedirs(RESULTS_DIR, exist_ok=True)
    procs: Dict[Any, Tuple[str, str, str]] = {}
    pending = list(cells)
    failures = []
    while pending or procs:
        while pending and len(procs) < jobs:
            a, s, m = pending.pop(0)
            out = os.path.join(RESULTS_DIR, f"{a}__{s}__{m}.json")
            if os.path.exists(out):
                with open(out) as f:
                    if json.load(f).get("ok"):
                        print(f"[cached] {a} × {s} × {m}")
                        continue
            p = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", a, "--shape", s, "--mesh", m, "--out", out],
                env={**os.environ, "PYTHONPATH": _pythonpath()})
            procs[p] = (a, s, m)
        done = [p for p in procs if p.poll() is not None]
        for p in done:
            a, s, m = procs.pop(p)
            out = os.path.join(RESULTS_DIR, f"{a}__{s}__{m}.json")
            ok = False
            if os.path.exists(out):
                with open(out) as f:
                    ok = json.load(f).get("ok", False)
            if not ok:
                failures.append((a, s, m))
        if procs:
            time.sleep(2.0)
    print(f"\n{len(cells) - len(failures)}/{len(cells)} cells OK")
    for f3 in failures:
        print("  FAIL:", *f3)
    return failures


def _pythonpath() -> str:
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    cur = os.environ.get("PYTHONPATH", "")
    return f"{src}:{cur}" if cur else src


def redo_extrapolation(arch_name: str, shape_name: str, mesh_name: str,
                       out_path: str):
    """Refresh a cached OK record's extrapolation block.  The block is the
    record's own direct count, so it is rebuilt from the record: nothing
    is counted again (the reference recompiles its (L1, L2) pair)."""
    from repro_torch.configs import get_arch
    with open(out_path) as f:
        rec = json.load(f)
    if not rec.get("ok") or rec.get("skipped"):
        return
    rec["extrapolation"] = _extrapolate(get_arch(arch_name), {
        "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes"],
        "collectives": rec["collectives"]})
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[EXT] {arch_name} × {shape_name} × {mesh_name}")


def run_all_ext(results_dir: str = RESULTS_DIR):
    """Refresh the extrapolation of every cached record."""
    import glob as _glob
    for path in sorted(_glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        redo_extrapolation(rec["arch"], rec["shape"], rec["mesh"], path)
    print("extrapolation refresh complete")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--all-ext", action="store_true")
    ap.add_argument("--redo-ext", action="store_true")
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--comm-debug", action="store_true",
                    help="also count under CommDebugMode (twice the time)")
    args = ap.parse_args()
    if args.all:
        fails = run_all(args.meshes.split(","), jobs=args.jobs)
        sys.exit(1 if fails else 0)
    if args.all_ext:
        run_all_ext()
        sys.exit(0)
    if args.redo_ext:
        redo_extrapolation(args.arch, args.shape, args.mesh, args.out)
        sys.exit(0)
    rec = run_cell(args.arch, args.shape, args.mesh, args.out,
                   comm_debug=args.comm_debug)
    sys.exit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
