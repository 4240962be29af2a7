"""Quickstart on the PyTorch port: register a compound inference system,
solve the MILP, place the segments on the pod, serve one demand bin on the
cluster runtime, then serve one batch of the plan's first variant on a
real engine.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch`` alone.  The
engine runs on ``--device`` (``cuda`` by default; raises without a card).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import Planner, register
from repro_torch.core.apps import get_app
from repro_torch.core.placement import Placer
from repro_torch.models import Model
from repro_torch.runtime import (ClusterRuntime, FailureEvent, Scenario,
                                 SimBackend)
from repro_torch.serving.engine import Engine, EngineConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="the engine's device: cuda (default) or cpu")
args = ap.parse_args()

# 1. register the compound system (validates the DAG + variants, builds
#    the offline L/H profile table — paper §3.1)
graph = get_app("traffic_analysis")
reg = register(graph)
print(f"registered {graph.name!r}: tasks={list(graph.tasks)}, "
      f"paths={graph.paths}, SLO={graph.slo_latency_ms:.0f}ms / "
      f"{graph.slo_accuracy:.0%} of A_max")

# 2. solve for a 60 rps demand on a 64-chip slice of the pod (Eq. 1-14)
planner = Planner(graph, reg.profiler, s_avail=64,
                  max_tuples_per_task=40, bb_nodes=6, bb_time_s=2.0)
cfg = planner.plan(60.0)
assert cfg is not None, "no feasible configuration"
print(f"\nconfiguration ({cfg.slices} chips):")
for tup, m in cfg.instances():
    print(f"  {m}x {tup.task:14s} {tup.variant:20s} seg={tup.segment:8s} "
          f"b={tup.batch:<3d} L={tup.latency_ms:6.1f}ms "
          f"H={tup.throughput:7.1f}rps")
print(f"worst path latency: {cfg.worst_path_latency():.0f}ms "
      f"(SLO {graph.slo_latency_ms:.0f}ms)")
print(f"exact A_obj: {cfg.exact_a_obj():.4f} (SLO {graph.slo_accuracy})")

# 3. bin-pack the segments onto the pod
placer = Placer(num_pods=1)
segs = [tup.segment for tup, m in cfg.instances() for _ in range(m)]
placements = placer.pack(segs)
print(f"\nplaced {len(placements)} instances; "
      f"pod utilization {placer.utilization():.0%}")

# 4. serve one demand bin on the cluster runtime (paper §3.3 batching +
#    early drop), on the simulated backend
scenario = Scenario.poisson(60.0, duration_s=12.0, warmup_s=3.0)
metrics = ClusterRuntime(graph, cfg, SimBackend(), seed=0).run(scenario)
print(f"\nserved 12s @ 60rps: {metrics.completions} completions, "
      f"violations {metrics.violation_rate:.2%}, p99 {metrics.p99_ms:.0f}ms, "
      f"realized accuracy {metrics.realized_a_obj(graph):.4f}")

# 5. same workload, now with a mid-run instance failure injected — the
#    shared task-level queues absorb the lost capacity
faulty = scenario.with_failures(FailureEvent(at_s=6.0, count=1))
m2 = ClusterRuntime(graph, cfg, SimBackend(), seed=0).run(faulty)
print(f"with mid-run failure: {m2.completions} completions, "
      f"violations {m2.violation_rate:.2%}")

# 6. one batch of the plan's first variant through the port's Engine on
#    --device (reduced widths, random weights from a seed)
tup, _ = next(iter(cfg.instances()))
arch = get_arch(graph.tasks[tup.task].variant(tup.variant).arch).reduced()
model = Model(arch, device=args.device, dtype=torch.float32).init(
    torch.Generator(device=args.device).manual_seed(0))
eng = Engine(model, EngineConfig(max_batch=4, max_seq=64))
prompts = np.random.default_rng(0).integers(0, arch.vocab_size, (4, 16))
eng.generate(prompts.astype(np.int32), max_new=2)          # warm-up
if model.device.type == "cuda":
    torch.cuda.synchronize()
t0 = time.monotonic()
out = eng.generate(prompts.astype(np.int32), max_new=8)
if model.device.type == "cuda":
    torch.cuda.synchronize()
print(f"\nengine on {model.device}: {arch.name} ({tup.variant}) generated "
      f"{out.shape[0]}x{out.shape[1]} tokens in "
      f"{(time.monotonic() - t0) * 1e3:.1f}ms")
