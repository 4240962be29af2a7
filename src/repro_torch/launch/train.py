"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Runs a real training loop (reduced configs in fp32, full configs in bf16)
on CUDA devices, or on the CPU with ``--device cpu``, with
checkpoint/restart, deterministic data, and the remat / microbatch /
grad-compression knobs of the training substrate.  A copy of the JAX
package's ``launch/train.py`` with its flags and printed lines, plus
``--device``.  The model runs the plain attention and SSD
(``impl="plain"``), as the reference's trainer runs its jnp ones.

Under ``torchrun`` (``WORLD_SIZE`` > 1) each rank joins the default
process group (NCCL on ``cuda``, gloo on ``--device cpu``)::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch granite-3-2b --reduced --device cpu --model-parallel 2

With ``--model-parallel`` > 1 or more than one rank it builds
``training.elastic.make_elastic_mesh(model_parallel)`` and the training
policy of ``sharding.policy.make_policy`` for (arch, seq-len x
global-batch), as the reference does, and trains on DTensor parameters;
rank 0 prints and writes the checkpoints.  One rank with
``--model-parallel 1`` builds no mesh.
"""
import argparse
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduction of the arch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--remat", choices=["none", "full", "dots"],
                    default="none")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _say(line: str) -> None:
    """Print on rank 0 only."""
    if _rank() == 0:
        print(line, flush=True)


def _join_group(device) -> int:
    """Join the default process group from torchrun's environment when
    ``WORLD_SIZE`` > 1 (NCCL on cuda, gloo on the CPU; each rank on its
    ``LOCAL_RANK`` card); returns the world size."""
    import torch
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_world_size() if dist.is_initialized() else 1


def _save(ckpt, directory: str, step: int, model, state,
          prune: bool) -> None:
    """Every rank gathers the state (a collective); rank 0 writes it (and
    keeps the newest three with ``prune``)."""
    import torch.distributed as dist
    from repro_torch.training.train_step import state_tree
    tree = state_tree(model, state, device="cpu")
    if _rank() == 0:
        ckpt.save(directory, step, tree)
        if prune:
            ckpt.prune(directory, keep=3)
    if dist.is_initialized():
        dist.barrier()


def setup(args: argparse.Namespace):
    """(model, AdamW config, train state, first step, step function, data
    config) for ``args``, resumed from ``--ckpt-dir`` with ``--resume``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model, resolve_device
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (init_train_state,
                                                 load_state_tree,
                                                 make_train_step, state_tree,
                                                 train_state_placements)

    device = resolve_device(args.device)
    world = _join_group(device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()

    if args.model_parallel > world:
        raise RuntimeError(
            f"repro_torch.launch.train: {world} rank(s) cannot host "
            f"model_parallel={args.model_parallel} (a sharding slice of "
            f"{args.model_parallel} devices): start one rank per device "
            f"under torchrun")
    policy = None
    if args.model_parallel > 1 or world > 1:
        from repro_torch.configs.shapes import ShapeConfig
        from repro_torch.sharding.policy import make_policy
        from repro_torch.training.elastic import make_elastic_mesh
        mesh = make_elastic_mesh(args.model_parallel, device_type=device.type)
        shp = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
        policy = make_policy(arch, shp, mesh, training=True)

    model = Model(arch, device=device, impl="plain", remat=args.remat,
                  dtype=torch.float32 if args.reduced else torch.bfloat16,
                  policy=policy)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                           total_steps=args.steps)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), ocfg)
    start = 0
    if args.resume and args.ckpt_dir:
        try:
            tree, start = ckpt.restore(
                args.ckpt_dir, state_tree(model, state, device="meta"),
                placements=train_state_placements(model, state))
            load_state_tree(model, state, tree)
            del tree
            _say(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    step_fn = make_train_step(
        model, ocfg, microbatches=args.microbatches,
        grad_compression=None if args.grad_compression == "none"
        else args.grad_compression)
    dcfg = data_mod.for_arch(arch, args.seq_len, args.global_batch)
    return model, ocfg, state, start, step_fn, dcfg


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data as data_mod

    model, _, state, start, step_fn, dcfg = setup(args)
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, data_mod.batch_at_step(dcfg, step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            _say(f"step {step:5d}  loss {loss:7.4f}  "
                 f"gnorm {float(metrics['grad_norm']):8.3f}  "
                 f"lr {float(metrics['lr']):.2e}  {dt:6.1f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(ckpt, args.ckpt_dir, step + 1, model, state, prune=True)
    if args.ckpt_dir:
        _save(ckpt, args.ckpt_dir, args.steps, model, state, prune=False)
    _say("done.")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
