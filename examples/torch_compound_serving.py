"""End-to-end compound serving with REAL model execution on the PyTorch
port: a depth-2 task chain — classify → caption — planned by the MILP and
served through the ``Scenario`` / ``ClusterRuntime`` / ``EngineBackend``
stack, so the same control plane that drives the simulations drives real
reduced LMs (the port's ``serving.Engine`` instances) here.

    PYTHONPATH=src python examples/torch_compound_serving.py [--device cpu]

The twin of ``examples/compound_serving.py`` on ``repro_torch`` alone.  The
engines run on ``--device`` (``cuda`` by default; raises without a card).
"""
import argparse
import time

from repro_torch.core.milp import Planner
from repro_torch.core.registry import register
from repro_torch.core.taskgraph import Task, TaskGraph, Variant
from repro_torch.runtime import ClusterRuntime, EngineBackend, Scenario

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="the engines' device: cuda (default) or cpu")
args = ap.parse_args()

# --- the compound app: classify feeds caption ------------------------------
graph = TaskGraph(
    name="classify_caption",
    tasks={
        "classify": Task("classify", (
            Variant("granite-3-2b", "granite-3-2b", accuracy=0.823,
                    seq_len=64, gen_len=4),
            Variant("gemma-2b", "gemma-2b", accuracy=0.786,
                    seq_len=64, gen_len=4),
        )),
        "caption": Task("caption", (
            Variant("gemma-2b", "gemma-2b", accuracy=0.801,
                    seq_len=64, gen_len=8),
        )),
    },
    edges=[("classify", "caption")],
    slo_latency_ms=2000.0,
    slo_accuracy=0.90,
)
reg = register(graph)          # validates + profiles (closed-form roofline)

# --- plan: the MILP picks variants, slices and batch sizes -----------------
planner = Planner(graph, reg.profiler, s_avail=16,
                  max_tuples_per_task=32, bb_nodes=4, bb_time_s=1.0)
DEMAND_RPS = 4.0
cfg = planner.plan(DEMAND_RPS)
assert cfg is not None, "no feasible deployment at this demand"
print(f"planned {cfg.slices} slices for {DEMAND_RPS:g} rps:")
for tup, m in cfg.instances():
    print(f"  {tup.task:9s} {tup.variant:14s} on {tup.segment:8s} "
          f"batch={tup.batch:<3d} x{m}")

# --- serve: real engines behind the shared cluster event loop --------------
backend = EngineBackend(max_batch=4, max_seq=64, prompt_len=8, max_new=4,
                        device=args.device)
runtime = ClusterRuntime(graph, cfg, backend, seed=0)
# host wall-clock stands in for the planned service time, so give the
# deadlines generous slack
scenario = Scenario.poisson(DEMAND_RPS, duration_s=6.0, warmup_s=1.0,
                            slo_scale=10.0)

t0 = time.monotonic()
m = runtime.run(scenario)
dt = time.monotonic() - t0

print(f"\nserved {m.completions} compound requests in {dt:.1f}s wall "
      f"({m.completions / max(dt, 1e-9):.1f} rps end-to-end) on "
      f"{args.device}, p99={m.p99_ms:.0f}ms, drops={m.dropped}, "
      f"violation_rate={m.violation_rate * 100:.1f}%")
for (task, variant), n in sorted(m.traffic.items()):
    print(f"  {task:9s} {variant:14s} served {n}")
