"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (``BENCHMARK.json`` names
them), sets the system up, measures for ``--seconds``, checks the
outputs against the plain float32 reference and prints one JSON line as
the last line of standard output.  Exits non-zero, printing no result,
without a CUDA card (or fewer than the cell asks for), or if JAX or the
JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    # the script's own folder is not a package root: its modules are
    # imported as ``portbench.*`` only
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    # the kernels' nvcc builds already live inside the checkout
    # (build/repro_torch_kernels); keep any other cache there too
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    from portbench import harness

    spec = harness.load_spec(ROOT)
    cell = next((w for w in spec["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = harness.prepare(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START)
    harness.execute(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"]}
    out = harness.result(run, spec, info)
    harness.report_checks(run)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
