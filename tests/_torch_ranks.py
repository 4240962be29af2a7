"""Rank bodies of the multi-rank tests of the port's sharding substrate.

The tests (``test_torch_sharding.py``, ``test_torch_elastic.py``) compute
the JAX package's results in their own process, write the port's inputs
to a work directory and spawn the ranks here: gloo processes on the CPU
that join one group through a ``FileStore`` in that directory (no port),
build a ``("data", "model")`` mesh, run the port under a policy and leave
rank 0's results in the directory for the test to hold against JAX.  This
module imports neither ``jax`` nor ``repro``, so a rank starts on torch
alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import Callable

import torch
import torch.distributed as dist

WORLD = 4
MESH = (("data", 2), ("model", 2))
TIMEOUT_S = 60           # the process group's, and the join's bound


def start(body: Callable, workdir: str, nprocs: int = WORLD):
    """Start ``body(rank, workdir)`` on ``nprocs`` spawned ranks joined in
    one gloo group; :func:`wait` joins them.  The group lives in the ranks
    alone: nothing of it is left in this process."""
    import torch.multiprocessing as mp
    return mp.start_processes(_rank, args=(nprocs, body, workdir),
                              nprocs=nprocs, join=False,
                              start_method="spawn")


def wait(ctx, timeout_s: float = TIMEOUT_S) -> None:
    """Join the ranks of :func:`start`; raises if one failed or they are
    still running after ``timeout_s`` (then they are killed)."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)


def _rank(rank: int, world: int, body: Callable, workdir: str) -> None:
    torch.set_num_threads(1)       # the suite runs beside other workers
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        body(rank, workdir)
    finally:
        dist.destroy_process_group()


def _mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(MESH, device_type="cpu")


def replaced(arch, fields: dict):
    """``arch`` with ``fields`` replaced; a dict value replaces fields of
    the nested config of that name (``{"moe": {"capacity_factor": x}}``)."""
    return dataclasses.replace(arch, **{
        k: dataclasses.replace(getattr(arch, k), **v) if isinstance(v, dict)
        else v for k, v in fields.items()})


def _arch(case: dict):
    """The case's reduced arch, with its ``replace`` fields."""
    from repro_torch.configs import ARCHS
    return replaced(ARCHS[case["arch"]].reduced(), case.get("replace", {}))


def _model(case: dict, policy):
    from repro_torch.models import Model
    m = Model(_arch(case), device="cpu", dtype=torch.float32, policy=policy,
              impl=case.get("impl", "kernel"))
    m.load_state_dict(case["weights"])
    return m


def _counts(mode) -> dict:
    return {str(op): n for op, n in mode.get_comm_counts().items()}


@contextlib.contextmanager
def no_dtensor_pad():
    """``torch.nn.functional.pad`` refuses a DTensor here, as DTensor in
    torch 2.11 does (a sharded dim or not): the SSM's causal conv must run
    on local shards."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor
    pad = F.pad

    def guarded(x, *args, **kwargs):
        if isinstance(x, DTensor):
            raise RuntimeError("F.pad of a DTensor")
        return pad(x, *args, **kwargs)

    F.pad = guarded
    try:
        yield
    finally:
        F.pad = pad


@contextlib.contextmanager
def counted(module, *names):
    """Calls of ``module``'s functions ``names`` counted in the dict it
    yields while the context lasts."""
    calls = dict.fromkeys(names, 0)
    saved = {n: getattr(module, n) for n in names}

    def wrap(n):
        def run(*args, **kwargs):
            calls[n] += 1
            return saved[n](*args, **kwargs)
        return run

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


@contextlib.contextmanager
def attention_calls():
    """The plain attention calls (the CPU path of the kernels) recorded
    while the context lasts, in the dict it yields: ``flash`` (query rows,
    keys, ``q_offset``), ``decode`` (cache positions) for a whole-cache
    decode, ``partial`` (shard positions, valid positions) for a shard's
    share of one."""
    import functools

    from repro_torch.kernels import ref
    calls = {"flash": [], "decode": [], "partial": []}
    saved = {n: getattr(ref, n) for n in (
        "flash_attention_ref", "decode_attention_ref",
        "decode_attention_partial_ref")}

    def record(name, what):
        @functools.wraps(saved[name])
        def run(*args, **kwargs):
            calls[what].append(
                (args[0].shape[1], args[1].shape[1], kwargs.get("q_offset"))
                if what == "flash" else
                (args[1].shape[1],) if what == "decode" else
                (args[1].shape[1], int(args[3])))
            return saved[name](*args, **kwargs)
        return run

    for name, what in (("flash_attention_ref", "flash"),
                       ("decode_attention_ref", "decode"),
                       ("decode_attention_partial_ref", "partial")):
        setattr(ref, name, record(name, what))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def _gather_shapes():
    """A ``CommDebugMode`` that also keeps the shape of each all-gather's
    local input (``gathered``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    class GatherSizes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.gathered = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if (out is not NotImplemented and "all_gather" in
                    str(getattr(func, "_overloadpacket", ""))):
                self.gathered.append(tuple(args[0].shape))
            return out

    return GatherSizes()


def _whole_state(state) -> dict:
    """An SSM layer state's fields whole, with their placements."""
    return {f: (t.full_tensor(), str(tuple(t.placements)))
            for f, t in state._asdict().items()}


def serve(rank: int, workdir: str) -> None:
    """Each case of ``serve_in.pt`` under its policy: full-sequence logits,
    the prefill's last logits and teacher-forced decode steps, greedy
    tokens through ``Engine.generate``, the attention mode, the
    collectives of one prefill and of the decode steps (with the shapes
    the decode steps all-gathered, and a layer's local cache shard's), and
    every rank's plain attention calls (:func:`attention_calls`)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models import ssm
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sharding.policy import make_policy
    mesh = _mesh()
    out = []
    for case in torch.load(os.path.join(workdir, "serve_in.pt")):
        B, S = case["tokens"].shape
        shape = ShapeConfig("t", case["seq_len"], B, case["kind"])
        m = _model(case, make_policy(_arch(case), shape, mesh))
        res = {"mode": m.policy.attn_mode, "rules": dict(m.policy.rules)}
        m.distribute()
        res["placed"] = all(isinstance(p, DTensor) for p in m.parameters())
        tokens = case["tokens"]
        prompt = tokens[:, :case["prompt"]]
        guard = no_dtensor_pad() if case.get("guard") else \
            contextlib.nullcontext()
        with guard, counted(ssm, "conv_and_tail", "_out_proj_local") as calls, \
                attention_calls() as attn:
            if case.get("forward"):
                res["forward"] = m(tokens).full_tensor()
            with CommDebugMode() as mode:
                logits, cache = m.prefill(prompt, max_seq=case["max_seq"])
            res["prefill_comms"] = _counts(mode)
            if "k" in cache:
                res["cache_shard"] = tuple(cache["k"][0].to_local().shape)
            if "ssm" in cache:
                res["prefill_ssm"] = [_whole_state(st) for st in cache["ssm"]]
            steps = [logits.full_tensor()]
            decode_mode, decoded = _gather_shapes(), []
            with decode_mode:
                for i in range(case["steps"]):
                    pos = case["prompt"] + i
                    logits, cache = m.decode_step(cache, pos,
                                                  tokens[:, pos:pos + 1])
                    decoded.append(logits)
            steps += [lg.full_tensor() for lg in decoded]
            res["decode_comms"] = _counts(decode_mode)
            res["decode_gathered"] = decode_mode.gathered
            if "ssm" in cache:
                res["decode_ssm"] = [_whole_state(st) for st in cache["ssm"]]
        res["ssm_calls"] = dict(calls)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, attn)
        res["attention_calls"] = every
        res["steps"] = steps
        if case.get("generate"):
            eng = Engine(m, EngineConfig(max_batch=B,
                                         max_seq=case["max_seq"]))
            res["decode_mode"] = eng.decode_mode
            res["generate"] = eng.generate(prompt.numpy(),
                                           max_new=case["generate"])
        out.append(res)
    if rank == 0:
        torch.save(out, os.path.join(workdir, "serve_out.pt"))


def train(rank: int, workdir: str) -> None:
    """``train_in.pt``'s model trained for ``steps`` steps under the
    training policy, its state gathered whole; then a checkpoint of that
    state (rank 0 writes it, unsharded), one more step straight on, and
    the same step from a fresh state restored onto the mesh with
    ``checkpoint.restore(placements=...)``."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.sharding.policy import make_policy
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt
    from repro_torch.training.compression import map_tree
    from repro_torch.training.train_step import (init_train_state,
                                                 load_state_tree,
                                                 make_train_step, state_tree,
                                                 train_state_placements)
    case = torch.load(os.path.join(workdir, "train_in.pt"))
    mesh = _mesh()
    arch = _arch(case)
    B, S = case["batch"], case["seq_len"]
    policy = make_policy(arch, ShapeConfig("t", S, B, "train"), mesh,
                         training=True)
    cfg = opt.AdamWConfig(**case["adamw"])
    dcfg = data_mod.for_arch(arch, S, B)

    def fresh():
        m = _model({**case, "impl": "plain"}, policy)
        return m, init_train_state(m, None, cfg)

    m, state = fresh()
    res = {"rules": dict(policy.rules),
           "embed_placements": [repr(p) for p in m.embed.placements]}
    step = make_train_step(m, cfg)
    losses, gnorms = [], []
    for i in range(case["steps"]):
        state, met = step(state, data_mod.batch_at_step(dcfg, i))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    res["losses"], res["gnorms"] = losses, gnorms
    tree = state_tree(m, state, device="cpu")
    # a copy: the tree's unstacked leaves are the live tensors, which the
    # next step updates in place
    res["tree"] = map_tree(lambda t: t.clone(), tree)
    ck = os.path.join(workdir, "ck")
    if rank == 0:
        ckpt.save(ck, case["steps"], tree)
    dist.barrier()
    _, met = step(state, data_mod.batch_at_step(dcfg, case["steps"]))
    res["next_loss"] = float(met["loss"])

    m2, state2 = fresh()
    restored, at = ckpt.restore(ck, state_tree(m2, state2, device="meta"),
                                placements=train_state_placements(m2, state2))
    res["restored_at"] = at
    res["restored_placed"] = str(restored["params"]["embed"].placements)
    load_state_tree(m2, state2, restored)
    step2 = make_train_step(m2, cfg)
    _, met = step2(state2, data_mod.batch_at_step(dcfg, case["steps"]))
    res["restored_loss"] = float(met["loss"])
    if rank == 0:
        torch.save(res, os.path.join(workdir, "train_out.pt"))


def halo(rank: int, workdir: str) -> None:
    """Each case of ``halo_in.pt``: the whole ``x`` distributed with its
    sequence dim sharded over the case's mesh dims, ``conv_and_tail`` on
    it, and the gradients of ``sum(out * g)``; a case whose shards are too
    short records the ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import ssm
    mesh = _mesh()
    out = []
    with no_dtensor_pad():
        for case in torch.load(os.path.join(workdir, "halo_in.pt")):
            places = [Shard(1) if on else Replicate() for on in case["seq_on"]]
            x = distribute_tensor(case["x"], mesh, places).requires_grad_()
            w = distribute_tensor(case["w"], mesh,
                                  [Replicate()] * mesh.ndim).requires_grad_()
            try:
                y, tail = ssm.conv_and_tail(x, w)
            except ValueError as e:
                out.append({"error": str(e)})
                continue
            g = distribute_tensor(case["g"], mesh, places)
            (y * g).sum().full_tensor().backward()
            out.append({"out": y.full_tensor(), "tail": tail.full_tensor(),
                        "out_placements": str(tuple(y.placements)),
                        "tail_placements": str(tuple(tail.placements)),
                        "x_grad": x.grad.full_tensor(),
                        "w_grad": w.grad.full_tensor()})
    if rank == 0:
        torch.save(out, os.path.join(workdir, "halo_out.pt"))


def train_cases(rank: int, workdir: str) -> None:
    """Each case of ``train_cases_in.pt`` under the training policy with
    ``F.pad`` refusing DTensors: ``steps`` steps (its ``compression``), the
    state gathered whole after them, the rules and parameter placements;
    with ``ckpt``, the tree saved (rank 0, unsharded), restored onto the
    mesh with placements into a fresh state, that state gathered, and one
    more step from each."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models import layers, ssm
    from repro_torch.sharding.policy import make_policy
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt
    from repro_torch.training.compression import map_tree
    from repro_torch.training.train_step import (init_train_state,
                                                 load_state_tree,
                                                 make_train_step, state_tree,
                                                 train_state_placements)
    mesh = _mesh()
    out = []
    for case in torch.load(os.path.join(workdir, "train_cases_in.pt")):
        arch = _arch(case)
        B, S = case["batch"], case["seq_len"]
        policy = make_policy(arch, ShapeConfig("t", S, B, "train"), mesh,
                             training=True)
        cfg = opt.AdamWConfig(**case["adamw"])
        dcfg = data_mod.for_arch(arch, S, B)

        def fresh():
            m = _model({**case, "impl": "plain"}, policy)
            st = init_train_state(m, None, cfg)
            return m, st, make_train_step(
                m, cfg, grad_compression=case.get("compression"))

        res = {"rules": dict(policy.rules), "mode": policy.attn_mode}
        with no_dtensor_pad(), counted(ssm, "conv_and_tail") as calls, \
                counted(layers._GradPlaced, "backward") as placed:
            m, state, step = fresh()
            res["placements"] = {n: str(tuple(p.placements))
                                 for n, p in m.named_parameters()}
            losses, gnorms = [], []
            for i in range(case["steps"]):
                state, met = step(state, data_mod.batch_at_step(dcfg, i))
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
            res["losses"], res["gnorms"] = losses, gnorms
            res["tree"] = map_tree(lambda t: t.clone(),
                                   state_tree(m, state, device="cpu"))
            if "err" in state:
                res["err_placements"] = {n: str(tuple(e.placements))
                                         for n, e in state["err"].items()}
            if case.get("ckpt"):
                ck = os.path.join(workdir, f"ck_{len(out)}")
                if rank == 0:
                    ckpt.save(ck, case["steps"], res["tree"])
                dist.barrier()
                batch = data_mod.batch_at_step(dcfg, case["steps"])
                state, met = step(state, batch)
                res["next_loss"] = float(met["loss"])
                res["next_tree"] = state_tree(m, state, device="cpu")
                m2, state2, step2 = fresh()
                restored, _ = ckpt.restore(
                    ck, state_tree(m2, {**state2, "err": state["err"]},
                                   device="meta"),
                    placements=train_state_placements(
                        m2, {**state2, "err": state["err"]}))
                res["restored_err_placed"] = str(
                    restored["err"]["embed"].placements)
                load_state_tree(m2, state2, restored)
                res["restored_tree"] = map_tree(
                    lambda t: t.clone(), state_tree(m2, state2, device="cpu"))
                state2, met = step2(state2, batch)
                res["restored_next_loss"] = float(met["loss"])
                res["restored_next_tree"] = state_tree(m2, state2,
                                                       device="cpu")
        if case.get("quant"):
            res["quant"] = _quantize_on_mesh(m, *case["quant"])
        res["conv_calls"] = calls["conv_and_tail"]
        res["grad_placed"] = placed["backward"]
        out.append(res)
    if rank == 0:
        torch.save(out, os.path.join(workdir, "train_cases_out.pt"))



def _quantize_on_mesh(model, grads: dict, errs: dict) -> tuple:
    """``compression.quantize_layers`` over each reference leaf's layers of
    ``grads`` and ``errs`` (per parameter name) distributed on the
    parameters' placements -> (dequantized, new err) gathered whole as the
    reference's trees."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.convert import leaf_groups, to_jax_params
    from repro_torch.training import compression as comp
    params = dict(model.named_parameters())

    def placed(t, n):
        return distribute_tensor(t, params[n].device_mesh,
                                 params[n].placements)

    deq, new = {}, {}
    for group in leaf_groups(model.arch, params):
        d, e = comp.quantize_layers([placed(grads[n], n) for n in group],
                                    [placed(errs[n], n) for n in group])
        deq.update((n, t.full_tensor()) for n, t in zip(group, d))
        new.update((n, t.full_tensor()) for n, t in zip(group, e))
    return (to_jax_params(model.arch, deq), to_jax_params(model.arch, new))
