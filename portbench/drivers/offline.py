"""Offline batches of one model: ``Batcher.pump`` -> ``Engine.generate``.

The queue is kept at least twice ``max_batch`` deep, so every batch is
full and the batcher launches at once; a batch pads its prompts on the
left to its longest.  The window runs from the first batch's start to the
end of the batch in flight when ``--seconds`` have passed: no batch is
cut.  The traced run also times ``Engine.prefill`` (synchronised on both
sides) and profiles one whole batch, the second of the window; the
profiler's start and teardown are taken out of the window, and the
host-clock per-layer metrics leave the profiled batch out.

``correct``: every request of the window came back with its
``new_tokens`` tokens, and over a sample drawn from the seed (the longest
prompt always in it) each served token's reference logit lies within the
limit of the reference's best, the reference running over exactly the
rows the program ran (its left padding included).
"""
from __future__ import annotations

import math
import sys
import time

import numpy as np

from portbench import load
from portbench.trace import DeviceTrace, span

TRACED_BATCH = 1
SAMPLE = 4


def _instrument(engine, log: list, sync, tr) -> None:
    """The traced run's spans around the engine's calls: ``prefill``
    synchronised on both sides and timed, each decode step named."""
    prefill, step = engine.prefill, engine.decode_step

    def timed_prefill(tokens):
        sync()
        t0 = time.perf_counter()
        with span(tr, "prefill"):
            out = prefill(tokens)
        sync()
        log.append((t0, time.perf_counter()))
        return out

    def named_step(*args):
        with span(tr, "decode_step"):
            return step(*args)

    engine.prefill, engine.decode_step = timed_prefill, named_step


def run(run) -> None:
    from repro_torch.serving import Batcher, Engine, EngineConfig, ServeRequest

    cfg, traffic = run.config, run.traffic
    serving = cfg["serving"]
    new = traffic["new_tokens"]
    fam = run.family(cfg)
    model = fam.build(cfg, run.seed, run.device)
    engine = Engine(model, EngineConfig(max_batch=serving["max_batch"],
                                        max_seq=serving["max_seq"]))
    queue = load.OfflineQueue(traffic, run.seed, cfg["vocab_size"])
    B = serving["max_batch"]
    # warm-up: one whole batch at the cell's largest shape (B x the longest
    # prompt, every new token): builds the kernels, captures the graphed
    # decode, and meets every cache length and the card's steady clocks
    # before the window
    longest = int(queue.pool.max())
    warm = np.stack([queue.prompt(i, longest, stream=6) for i in range(B)])
    engine.generate(warm, max_new=new)
    tr = DeviceTrace(run.on_cuda) if run.trace else None
    if tr is not None:
        tr.prime()
    run.setup_done()

    prefills: list = []
    if run.trace:
        _instrument(engine, prefills, run.sync, tr)
    batcher = Batcher(engine, timeout_ms=0.0, max_new=new)
    run.device_trace = tr
    served = []
    k = 0
    # the profiler's own teardown (reading back its events) is taken out
    # of the window: it is neither the program's time nor a batch's
    paused = 0.0
    t0 = time.perf_counter()
    while True:
        while len(batcher.queue) < 2 * B:
            batcher.submit(ServeRequest(k, queue.next(), math.inf, 0.0))
            k += 1
        i = len(run.batches)
        traced = i == TRACED_BATCH and tr is not None
        if traced:
            t_start = time.perf_counter()
            tr.start()
            paused += time.perf_counter() - t_start
        tb = time.perf_counter() - paused
        n_prefill = len(prefills)
        with span(tr, "pump"):
            done = batcher.pump()
        t_end = time.perf_counter()
        te = t_end - paused
        if traced:
            t_stop = time.perf_counter()
            tr.stop()
            paused += time.perf_counter() - t_stop
        S = max(len(r.prompt) for r in done)
        lens = [len(r.prompt) for r in done]
        rec = {"start": tb, "end": te, "B": len(done), "S": S,
               "prompt_lens": lens, "new": new, "traced": traced,
               "flops": sum(fam.sequence_flops(cfg, n, new) for n in lens)}
        if len(prefills) > n_prefill:
            rec["prefill_s"] = prefills[-1][1] - prefills[-1][0]
            rec["decode_s"] = t_end - prefills[-1][1]
        if traced:
            run.traced_work = fam.kernel_work(cfg, len(done), S, new)
        run.batches.append(rec)
        print(f"batch {i}: B {len(done)} S {S} wall {te - tb:.4f} s"
              + (f" prefill {rec['prefill_s']:.4f} s" if "prefill_s" in rec
                 else ""), file=sys.stderr, flush=True)
        served.extend((r, S) for r in done)
        if te - t0 >= run.seconds:
            break
    run.window_s = run.batches[-1]["end"] - t0
    # the model's work over its wall, the profiled batch left out
    timed = [b for b in run.batches if not b["traced"]]
    run.model_flops = sum(b["flops"] for b in timed)
    run.model_s = sum(b["end"] - b["start"] for b in timed)
    run.read_peak()
    run.attempted = len(served)
    for r, _ in served:
        ok = (r.result is not None and len(r.result) == new
              and int(np.min(r.result)) >= 0
              and int(np.max(r.result)) < cfg["vocab_size"])
        run.failed += 0 if ok else 1
        run.requests.append({"id": r.req_id, "ok": ok})
    if run.failed:
        run.fail(f"{run.failed} of {run.attempted} requests came back "
                 f"without their {new} tokens")

    # the program's state goes before the reference runs
    cases = _sample(served, run.seed, new)
    del batcher, engine, model, served, warm
    run.free()
    if not cases:
        run.fail("no finished request to compare")
        return
    got = run.judge_served("logit_gap", cfg, run.seed, cases)
    run.notes["compared_tokens"] = got["tokens"]


def _sample(served, seed: int, new: int) -> list:
    """The longest request and ``SAMPLE - 1`` others drawn from the seed,
    each as the rows its batch ran: its prompt left-padded with token 0 to
    the batch's length, and its served tokens."""
    good = [(r, S) for r, S in served
            if r.result is not None and len(r.result) == new]
    if not good:
        return []
    first = max(range(len(good)), key=lambda i: len(good[i][0].prompt))
    rest = [i for i in range(len(good)) if i != first]
    pick = [first] + [int(i) for i in load.rng_for(seed, 3).choice(
        rest, size=min(SAMPLE - 1, len(rest)), replace=False)]
    cases = []
    for i in pick:
        r, S = good[i]
        row = np.zeros(S, np.int64)
        row[S - len(r.prompt):] = r.prompt
        cases.append({"prompt": row, "served": np.asarray(r.result, np.int64)})
    return cases
