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


def _arch(case: dict):
    """The case's reduced arch, with its ``replace`` fields."""
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[case["arch"]].reduced(),
                               **case.get("replace", {}))


def _model(case: dict, policy):
    from repro_torch.models import Model
    m = Model(_arch(case), device="cpu", dtype=torch.float32, policy=policy,
              impl=case.get("impl", "kernel"))
    m.load_state_dict(case["weights"])
    return m


def _counts(mode) -> dict:
    return {str(op): n for op, n in mode.get_comm_counts().items()}


def serve(rank: int, workdir: str) -> None:
    """Each case of ``serve_in.pt`` under its policy: full-sequence logits,
    the prefill's last logits and teacher-forced decode steps, greedy
    tokens through ``Engine.generate``, the attention mode and the
    collectives of one prefill."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.shapes import ShapeConfig
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
        if case.get("forward"):
            res["forward"] = m(tokens).full_tensor()
        with CommDebugMode() as mode:
            logits, cache = m.prefill(prompt, max_seq=case["max_seq"])
        res["prefill_comms"] = _counts(mode)
        steps = [logits.full_tensor()]
        for i in range(case["steps"]):
            pos = case["prompt"] + i
            logits, cache = m.decode_step(cache, pos, tokens[:, pos:pos + 1])
            steps.append(logits.full_tensor())
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
