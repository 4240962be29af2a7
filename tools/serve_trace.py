"""Run one offline benchmark cell with the serving engine's own tracer on.

    python3 tools/serve_trace.py --workload qwen2-7b.decode-heavy --seed <n> \\
        --seconds 50 --trace <0|1> [--export <path>]

The benchmark's offline cells (``portbench/drivers/offline.py``) build their
``Engine`` without a tracer.  This runs the same code (the same weights,
traffic, warm-up, window, profiled batch and correctness check) with the
``Engine`` given an ``obs.Tracer`` before its first call, so the graph
captures of set-up are recorded; the interpreter's collector is traced from
the window's start, and with ``--trace 1`` the program's spans join the
harness's as the host ranges that name the profiled batch's idle gaps.

The last line of standard output is the benchmark's result line with a
``program`` object added: :func:`readings` of the engine's spans over the
window's batches (the profiled one left out, as the harness's readers do),
each batch's row, ``dropped`` and the batches' walls.  ``--export`` writes
the spans as Chrome-trace JSON; ``--profile-batch`` profiles another batch
than the window's second (a run's first batches are often slower).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# room for every span of a 50 s window of the decode-heavy cell
# (≈ 30 a decode step) several times over
MAX_EVENTS = 1_000_000


def readings(spans, batches) -> dict:
    """The engine's spans read over the window's batches: ``batches`` are the
    offline cell's batch records, the i-th served by the i-th
    ``batcher.pump`` span; a record marked ``traced`` (the profiled batch)
    is left out.

    * ``engine.first_token_ms``: median of the batches' ``first_token_ms``;
    * ``engine.token_gap_ms`` / ``engine.token_gap_p99_ms``: median and
      nearest-rank 99th percentile of all their ``token_gaps_ms``;
    * ``graphed.capture_s``: the ``graphed.capture`` spans' wall, set-up;
    * ``host.gc_pause_ms``: the ``gc`` spans' wall inside a batch, a batch
      (each row splits its batch's by the collector's generation);
    * ``host.offcpu_pct``: over the batches' ``engine.decode_step`` spans,
      wall less ``cpu_s`` over wall."""
    from portbench.harness import percentile

    kids: dict = {}
    paused: dict = {}
    for i, s in enumerate(spans):
        kids.setdefault(s.parent, []).append(i)
        if s.cat == "gc":
            paused.setdefault(s.root_id, [0.0] * 3)[s.args["generation"]] \
                += s.end_s - s.start_s
    pumps = [i for i in kids.get(None, ()) if spans[i].name == "batcher.pump"]
    rows, firsts, gaps = [], [], []
    gc_s = wall = cpu = 0.0
    for b, p in zip(batches, pumps):
        if b["traced"]:
            continue
        g_i = next(i for i in kids[p] if spans[i].name == "engine.generate")
        gen = spans[g_i]
        steps = [spans[i] for i in kids.get(g_i, ())
                 if spans[i].name == "engine.decode_step"]
        by_gen = paused.get(spans[p].root_id, [0.0] * 3)
        pause = sum(by_gen)
        w = sum(s.end_s - s.start_s for s in steps)
        c = sum(s.args["cpu_s"] for s in steps)
        g = gen.args["token_gaps_ms"]
        firsts.append(gen.args["first_token_ms"])
        gaps += g
        gc_s, wall, cpu = gc_s + pause, wall + w, cpu + c
        rows.append({"wall_s": b["end"] - b["start"],
                     "first_token_ms": gen.args["first_token_ms"],
                     "gap_median_ms": statistics.median(g) if g else None,
                     "gap_max_ms": max(g) if g else None,
                     "gc_ms_by_generation": [1e3 * x for x in by_gen],
                     "step_ms": 1e3 * w / len(steps) if steps else None,
                     "step_cpu_ms": 1e3 * c / len(steps) if steps else None,
                     "offcpu_pct": 100.0 * (w - c) / w if w else None})
    capture = [s.end_s - s.start_s for s in spans
               if s.name == "graphed.capture"]
    return {
        "engine.first_token_ms": statistics.median(firsts) if firsts else None,
        "engine.token_gap_ms": statistics.median(gaps) if gaps else None,
        "engine.token_gap_p99_ms": percentile(gaps, 99.0),
        "graphed.capture_s": sum(capture) if capture else None,
        "host.gc_pause_ms": 1e3 * gc_s / len(rows) if rows else None,
        "host.offcpu_pct": 100.0 * (wall - cpu) / wall if wall else None,
        "n_gaps": len(gaps), "batches": rows}


@contextlib.contextmanager
def traced_engine(tracer):
    """While open, the offline cell's ``Engine`` is built with ``tracer``
    and its profiled stretch's gaps are named by the program's spans too."""
    import repro_torch.serving as serving
    from portbench.trace import DeviceTrace

    engine, reduce = serving.Engine, DeviceTrace._reduce

    class Traced(engine):
        def __init__(self, model, cfg):
            super().__init__(model, cfg, tracer=tracer)

    def named(self, events, t0, t1):
        self._host = self._host + [
            (round(s.start_s * 1e9), round(s.end_s * 1e9), s.name)
            for s in tracer.spans
            if s.end_s * 1e9 > t0 and s.start_s * 1e9 < t1]
        reduce(self, events, t0, t1)

    serving.Engine, DeviceTrace._reduce = Traced, named
    try:
        yield
    finally:
        serving.Engine, DeviceTrace._reduce = engine, reduce


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             profile_batch: Optional[int] = None):
    """One run of an offline cell with the engine traced: (run, the
    benchmark's result line with ``program`` added, the tracer).
    ``profile_batch`` profiles that batch of the window in place of the
    benchmark's own choice."""
    from portbench import harness
    from portbench.drivers import offline
    from repro_torch.obs import Tracer

    run = harness.prepare(root, workload, seed, seconds, trace, device,
                          t_start)
    tracer = Tracer(max_events=MAX_EVENTS)
    done = run.setup_done

    def setup_done():
        done()
        tracer.trace_gc()

    run.setup_done = setup_done
    chosen = offline.TRACED_BATCH
    if profile_batch is not None:
        offline.TRACED_BATCH = profile_batch
    try:
        with traced_engine(tracer):
            harness.execute(run)
    finally:
        tracer.close()
        offline.TRACED_BATCH = chosen
    out = harness.result(run, harness.load_spec(root),
                         {"platform": device, "kind": device, "count": 1})
    out["program"] = dict(readings(tracer.spans, run.batches),
                          dropped=tracer.dropped,
                          batch_wall_s=[[b["end"] - b["start"], b["traced"]]
                                        for b in run.batches])
    return run, out, tracer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile-batch", type=int,
                    help="profile this batch of the window (default: the "
                         "benchmark's, batch 1)")
    ap.add_argument("--export", help="write the spans as Chrome-trace JSON")
    args = ap.parse_args(argv)
    # as portbench/run.py: the script's own folder is no package root
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    from portbench import harness
    run, out, tracer = run_cell(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_START,
                                args.profile_batch)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    out["device"]["kind"] = torch.cuda.get_device_name(0)
    harness.report_checks(run)
    if args.export:
        tracer.export(args.export)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
