"""Serving launcher: register a compound app, solve the MILP, place the
segments, and run either the discrete-event cluster simulation (default)
or an in-process engine demo on reduced models.

    python -m repro_torch.launch.serve --app traffic_analysis --demand 100
    python -m repro_torch.launch.serve --app social_media --trace --bins 24

A copy of the JAX package's ``launch/serve.py``.
"""
import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="traffic_analysis",
                    choices=["social_media", "traffic_analysis",
                             "ar_assistant"])
    ap.add_argument("--demand", type=float, default=50.0)
    ap.add_argument("--s-avail", type=int, default=256)
    ap.add_argument("--features", default="A+S+T",
                    help="subset of A,S,T — e.g. 'A+T' (Loki-equivalent)")
    ap.add_argument("--trace", action="store_true",
                    help="run a diurnal trace through the controller")
    ap.add_argument("--bins", type=int, default=12)
    ap.add_argument("--sim-seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro_torch.core import Controller, register
    from repro_torch.core.apps import get_app
    from repro_torch.core.baselines import ANALYTICAL_BASELINES
    from repro_torch.core.milp import FeatureSet
    from repro_torch.core.trace import diurnal_trace

    graph = get_app(args.app)
    reg = register(graph)
    fs = ANALYTICAL_BASELINES.get(
        args.features, ANALYTICAL_BASELINES["A+S+T"])
    stale = 40.0 if args.app == "ar_assistant" else 20.0
    ctl = Controller(graph, reg.profiler, args.s_avail, features=fs,
                     staleness_ms=stale,
                     planner_kwargs=dict(max_tuples_per_task=48,
                                         bb_nodes=8, bb_time_s=2.0))

    if args.trace:
        peak = ctl.max_serviceable_demand() * 0.9
        trace = diurnal_trace(seed=args.seed,
                              bins=args.bins).scaled_to_max(peak)
        print(f"# {args.app} [{fs.label}] peak={peak:.0f} rps, "
              f"{args.bins} bins")
        for i, R in enumerate(trace.rps):
            rep = ctl.step(i, float(R), sim_seconds=args.sim_seconds,
                           seed=args.seed + i)
            print(f"bin {i:3d}  R={R:8.1f}  slices={rep.slices_used:4d}"
                  f"  viol={rep.violation_rate*100:6.2f}%"
                  f"  accdrop={rep.accuracy_drop_pct:5.1f}%"
                  f"  milp={rep.milp_ms:6.0f}ms"
                  f"  replan={int(rep.replanned)}")
        return

    rep = ctl.step(0, args.demand, sim_seconds=args.sim_seconds,
                   seed=args.seed)
    placements = ctl.place()
    print(json.dumps({
        "app": args.app, "features": fs.label, "demand_rps": args.demand,
        "slices_used": rep.slices_used,
        "violation_rate_pct": round(rep.violation_rate * 100, 3),
        "accuracy_drop_pct": round(rep.accuracy_drop_pct, 2),
        "p99_ms": round(rep.p99_ms, 1),
        "milp_ms": round(rep.milp_ms, 1),
        "instances_placed": len(placements or []),
    }, indent=1))
    if placements:
        for pl in placements[:10]:
            print(f"  pod {pl.pod}: ({pl.row:2d},{pl.col:2d}) "
                  f"{pl.rows}x{pl.cols}  {pl.segment}")


if __name__ == "__main__":
    main()
