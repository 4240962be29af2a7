"""Readings that set the limits of ``correct``: the program's numbers and
the fp8 control's on many seeds, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds 1 2 3 ...

For each seed it runs the cell as ``run.py`` does (set-up, window,
judgement) with the control put in the program's place for the
judgement: the plain reference with every product's operands rounded to
fp8 e4m3, read at the same rows, its first token judged by the cell's
limits.  Prints one JSON line a seed (``correct``, which the control must
make false, the control's numbers and the program's own) and, last, each
number's largest program reading and smallest control reading.  Needs the
card; the benchmark's own runs never run the control.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness

    worst: dict = {}
    least: dict = {}
    for seed in args.seeds:
        run = harness.prepare(ROOT, args.workload, seed, args.seconds, False,
                              args.device, time.perf_counter())
        run.control = True
        harness.execute(run)
        program = {k.partition(".")[2]: v for k, v in run.notes.items()
                   if k.startswith("program.")}
        line = {"seed": seed, "correct": harness.judged_correct(run),
                "errors": run.errors,
                "control": {c.name: c.value for c in run.checks},
                "program": program, "attempted": run.attempted,
                "setup_s": run.setup_s}
        print(json.dumps(line), flush=True)
        for k, v in program.items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in line["control"].items():
            least[k] = min(least.get(k, v), v)
        del run
    print(json.dumps({"program_max": worst, "control_min": least,
                      "seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
