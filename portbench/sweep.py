"""The sweep that fixes a gateway cell's rate: the cell run at several
open-loop rates, each planned anew, in one process.

    python3 portbench/sweep.py --workload <cell> --seconds <s> --seed <n> --rates 2 3 4 5 6

For each rate it prints the attainment within the deadline, e2e p50/p90
from the due time, roots dropped or refused, and the backlog: roots sent
and not yet answered at a quarter, half, three quarters and the end of the
arrivals.  The knee is the highest rate at which at least 99 % of roots
meet the deadline and the backlog does not grow; the cell runs at four
fifths of it (its traffic file's ``rate``).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def backlog(requests, seconds: float) -> list:
    """Roots due and not yet answered at each quarter of the arrivals."""
    out = []
    for q in (0.25, 0.5, 0.75, 1.0):
        t = q * seconds
        out.append(sum(1 for r in requests if r["due"] <= t and (
            math.isnan(r["latency_ms"]) or r["due"] + r["latency_ms"] / 1e3 > t)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="deadline to plan and serve at instead of the "
                         "configuration's")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness

    for rate in args.rates:
        run = harness.prepare(ROOT, args.workload, args.seed, args.seconds,
                              False, args.device, time.perf_counter())
        run.traffic = dict(run.traffic, rate=rate)
        if args.slo_ms is not None:
            run.config = dict(run.config, slo_latency_ms=args.slo_ms)
        try:
            harness.execute(run)
        except RuntimeError as e:      # no plan at this rate
            print(json.dumps({"rate": rate, "error": str(e)}), flush=True)
            continue
        ok = [r["latency_ms"] for r in run.requests if r["outcome"] == "ok"]
        line = {
            "rate": rate, "plan": run.notes.get("plan"),
            "sent": len(run.requests),
            "attainment_pct": 100.0 * sum(r["met"] for r in run.requests)
            / max(len(run.requests), 1),
            "p50_ms": harness.percentile(ok, 50.0),
            "p90_ms": harness.reader(ROOT, "e2e_p90_ms")(run),
            "dropped": sum(r["outcome"] == "dropped" for r in run.requests),
            "refused": sum(r["outcome"] == "refused" for r in run.requests),
            "backlog": backlog(run.requests, args.seconds),
            "loop_blocked_s": sum(h["end"] - h["start"] for h in run.hops),
            "service_ms": {t: 1e3 * sum(h["end"] - h["start"] for h in hs)
                           / len(hs) for t in {h["task"] for h in run.hops}
                           for hs in [[h for h in run.hops
                                       if h["task"] == t]]},
            "batches": {t: sum(h["B"] for h in hs) / len(hs)
                        for t in {h["task"] for h in run.hops}
                        for hs in [[h for h in run.hops if h["task"] == t]]},
            "drops": run.counters.get("drops"),
            "window_s": run.window_s, "setup_s": run.setup_s,
            "errors": run.errors,
            "checks": {c.name: c.value for c in run.checks}}
        print(json.dumps(line), flush=True)
        del run
    print(json.dumps({"seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
