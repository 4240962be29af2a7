"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Runs a real training loop (reduced configs in fp32, full configs in bf16)
on one CUDA device, or on the CPU with ``--device cpu``, with
checkpoint/restart, deterministic data, and the remat / microbatch /
grad-compression knobs of the training substrate.  A copy of the JAX
package's ``launch/train.py`` with its flags and printed lines, plus
``--device``.  The model runs the plain attention and SSD
(``impl="plain"``), as the reference's trainer runs its jnp ones.  One
device only: ``--model-parallel`` > 1, or more than one visible card,
waits for the sharding slice and raises.
"""
import argparse
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
                                                 make_train_step, state_tree)

    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.model_parallel > 1 or cards > 1:
        raise RuntimeError(
            f"repro_torch.launch.train runs on one device; model_parallel="
            f"{args.model_parallel} on {cards} visible cards needs the "
            f"sharding slice of the port (sharding/policy.py, "
            f"launch/mesh.py, training/elastic.py), not yet ported")
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()

    model = Model(arch, device=device, impl="plain", remat=args.remat,
                  dtype=torch.float32 if args.reduced else torch.bfloat16)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                           total_steps=args.steps)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), ocfg)
    start = 0
    if args.resume and args.ckpt_dir:
        try:
            tree, start = ckpt.restore(
                args.ckpt_dir, state_tree(model, state, device="meta"))
            load_state_tree(model, state, tree)
            del tree
            print(f"resumed from step {start}")
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
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data as data_mod
    from repro_torch.training.train_step import state_tree

    model, _, state, start, step_fn, dcfg = setup(args)
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, data_mod.batch_at_step(dcfg, step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {step:5d}  loss {loss:7.4f}  "
                  f"gnorm {float(metrics['grad_norm']):8.3f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:6.1f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1,
                      state_tree(model, state, device="cpu"))
            ckpt.prune(args.ckpt_dir, keep=3)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  state_tree(model, state, device="cpu"))
    print("done.")


if __name__ == "__main__":
    main()
