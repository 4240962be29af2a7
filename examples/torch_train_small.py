"""Train a small mamba2-family LM end-to-end on the PyTorch port with the
full training substrate: deterministic data, AdamW, microbatched grad
accumulation, checkpointing, and a mid-run restart that resumes
bit-exactly.

    PYTHONPATH=src python examples/torch_train_small.py [--device cpu]

The twin of ``examples/train_small.py`` on ``repro_torch`` alone.  It
trains on ``--device`` (``cuda`` by default; raises without a card), on
the plain SSD, as the reference trains on its jnp one.
"""
import argparse
import math
import shutil
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.models import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import (init_train_state,
                                             load_state_tree,
                                             make_train_step, state_tree)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=60)
args = ap.parse_args()

STEPS = args.steps
arch = get_arch("mamba2-130m").reduced()
model = Model(arch, device=args.device, impl="plain", dtype=torch.float32)
ocfg = opt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=STEPS)
dcfg = data_mod.for_arch(arch, seq_len=64, global_batch=8)
step_fn = make_train_step(model, ocfg, microbatches=2)


def fresh_state():
    return init_train_state(
        model, torch.Generator(device=model.device).manual_seed(0), ocfg)


state = fresh_state()
ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_small_")

print(f"training {arch.name} "
      f"({arch.param_count()[0]/1e6:.2f}M params) for {STEPS} steps "
      f"on {model.device}")
for step in range(STEPS):
    state, metrics = step_fn(state, data_mod.batch_at_step(dcfg, step))
    if step % 10 == 0:
        print(f"  step {step:3d}  loss {float(metrics['loss']):.4f}")
    if step == STEPS // 2:
        ckpt.save(ckpt_dir, step + 1, state_tree(model, state, device="cpu"))
        print(f"  checkpointed at step {step + 1} → simulating a crash...")
        state = None  # drop everything
        state = fresh_state()
        tree, resumed = ckpt.restore(ckpt_dir, state_tree(model, state,
                                                          device="meta"))
        load_state_tree(model, state, tree)
        print(f"  restarted from step {resumed}")

shutil.rmtree(ckpt_dir, ignore_errors=True)
print(f"final loss {float(metrics['loss']):.4f} "
      f"(started ≈ ln(V) = {math.log(arch.vocab_size):.2f})")
