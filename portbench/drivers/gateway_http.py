"""A compound app served over HTTP: open-loop roots into the port's
``GatewayHTTPServer`` -> ``AsyncGateway``, each hop served by the port's
``Engine.generate`` at its variant's own lengths.

Set-up plans the deployment with the port's ``Planner`` at the mix's rate
(``h100_cluster(1)``, the unfitted ``H100_SXM``, the configuration's
batches and budgets), builds one engine a model, warms every batch size
the plan can launch and starts the server on loopback.  The window sends
the mix's arrivals from a client thread of its own, each timed from the
moment it was due to the end of its HTTP response, and waits for every
root to resolve.  The traced run records the gateway's spans (an
``Instrumentation`` with a ``Tracer``) and profiles the last
``trace_s`` seconds of the arrivals.

``correct``: every root resolved (ok, dropped or refused) and none is
left in the gateway; every ``ok`` root's hops fanned out as its edges'
factors allow and its leaf count is what the gateway reported; and over a
sample of each model's hops drawn from the seed, each served token's
reference logit lies within the limit of the reference's best.
"""
from __future__ import annotations

import asyncio
import math
import sys
import time
from collections import Counter, defaultdict
from typing import Dict, List

import numpy as np

from portbench import load
from portbench.trace import DeviceTrace, span

HOST = "127.0.0.1"
SAMPLE_TOKENS = 128          # served tokens compared per model, at least


def build_graph(app: dict):
    """The app's ``TaskGraph`` as the configuration file states it."""
    from repro_torch.core.taskgraph import Task, TaskGraph, Variant
    tasks = {name: Task(name, tuple(Variant(**v) for v in vs))
             for name, vs in app["tasks"].items()}
    mult = {(m["task"], m["variant"], m["next"]): float(m["factor"])
            for m in app["mult"]}
    return TaskGraph(name=app["app"], tasks=tasks,
                     edges=[tuple(e) for e in app["edges"]], mult=mult,
                     slo_latency_ms=app["slo_latency_ms"],
                     slo_accuracy=app["slo_accuracy"],
                     path_fractions={tuple(k.split(">")): v for k, v in
                                     app["path_fractions"].items()})


def plan(app: dict, graph, rate: float):
    """The port's plan of ``graph`` at ``rate`` on one H100."""
    from repro_torch.core.milp import Planner
    from repro_torch.core.profiler import Profiler
    from repro_torch.hwspec import h100_cluster
    p = app["planner"]
    cluster = h100_cluster(1)
    prof = Profiler(graph, cluster=cluster, batches=tuple(p["batches"]))
    cfg = Planner(graph, prof, s_avail=cluster.total_units,
                  max_tuples_per_task=p["max_tuples_per_task"],
                  bb_nodes=p["bb_nodes"], bb_time_s=p["bb_time_s"]).plan(rate)
    if cfg is None:
        raise RuntimeError(f"the planner finds no plan for {graph.name} at "
                           f"{rate} rps on one H100")
    return cfg


def hop_prompt(seed: int, req_id: int, length: int, vocab: int) -> np.ndarray:
    return load.rng_for(seed, 4, req_id).integers(
        0, vocab, size=length, dtype=np.int64).astype(np.int32)


def arch_seed(seed: int, index: int) -> int:
    return int(seed) * 7919 + index + 1


class HopBackend:
    """The gateway's ``ExecutionBackend``: one ``Engine.generate`` a batch
    at the variant's own prompt and output lengths, on prompts made from
    the seed and each hop's id; the synchronised wall is the service time.
    Every hop is recorded for the metrics and the judgement."""

    def __init__(self, graph, engines: Dict, vocab: Dict, seed: int, sync,
                 trace=None):
        self.graph, self.engines, self.vocab = graph, engines, vocab
        self.seed, self.sync, self.trace = seed, sync, trace
        self.hops: List[dict] = []

    def bind(self, graph, config, app: str = "") -> None:
        pass

    def on_capacity_change(self, servers) -> None:
        pass

    def service_s(self, server, batch, now_s, rng) -> float:
        v = self.graph.tasks[server.tup.task].variant(server.tup.variant)
        eng = self.engines[v.arch]
        prompts = np.stack([hop_prompt(self.seed, r.req_id, v.seq_len,
                                       self.vocab[v.arch]) for r in batch])
        self.sync()
        t0 = time.perf_counter()
        with span(self.trace, "hop"):
            out = eng.generate(prompts, max_new=v.gen_len)
        self.sync()
        t1 = time.perf_counter()
        self.hops.append({
            "start": t0, "end": t1, "task": server.tup.task,
            "variant": v.name, "arch": v.arch, "B": len(batch), "S": v.seq_len,
            "new": v.gen_len, "req_ids": [r.req_id for r in batch],
            "root_ids": [r.root_id for r in batch], "out": out})
        return t1 - t0


def run(run) -> None:
    from repro_torch.gateway.core import AsyncGateway
    from repro_torch.gateway.server import GatewayHTTPServer
    from repro_torch.obs import Instrumentation, Tracer
    from repro_torch.serving import Engine, EngineConfig

    app, traffic = run.config, run.traffic
    graph = build_graph(app)
    deployment = plan(app, graph, traffic["rate"])
    archs = sorted({graph.tasks[t.task].variant(t.variant).arch
                    for t, _ in deployment.instances()})
    engines, cfgs = {}, {}
    for i, a in enumerate(archs):
        cfgs[a] = app["models"][a]
        m = run.family(cfgs[a]).build(cfgs[a], arch_seed(run.seed, i),
                                      run.device)
        engines[a] = Engine(m, EngineConfig(
            max_batch=app["engine"]["max_batch"],
            max_seq=cfgs[a]["serving_max_seq"]))
    # warm-up: every batch size up to each planned instance's at its
    # variant's lengths (the first call also captures the graphed decode)
    for tup, _ in deployment.instances():
        v = graph.tasks[tup.task].variant(tup.variant)
        for b in range(1, tup.batch + 1):
            engines[v.arch].generate(np.zeros((b, v.seq_len), np.int32),
                                     max_new=v.gen_len)
    tr = DeviceTrace(run.on_cuda) if run.trace else None
    if tr is not None:
        tr.prime()
    run.device_trace = tr
    hooks = Instrumentation(tracer=Tracer() if run.trace else None)
    backend = HopBackend(graph, engines, {a: cfgs[a]["vocab_size"]
                                          for a in archs}, run.seed, run.sync,
                         tr)
    gw = AsyncGateway({graph.name: (graph, deployment)}, backend,
                      seed=run.seed, hooks=hooks)
    offsets = load.arrival_offsets(traffic["rate"], run.seconds, run.seed)
    run.notes["plan"] = [(t.task, t.variant, t.batch, t.segment, m)
                         for t, m in deployment.instances()]

    async def serve():
        srv = GatewayHTTPServer(gw, hooks, HOST, 0)
        await srv.start()
        client = load.OpenLoop(HOST, srv.port, f"/v1/{graph.name}/submit",
                               offsets, traffic["drain_s"])
        run.setup_done()
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        if tr is not None:
            at = max(run.seconds - traffic["trace_s"], 0.0)
            loop.call_later(at, tr.start)
            loop.call_later(run.seconds, tr.stop)
        client.start(t0)
        while not client.done():
            await asyncio.sleep(0.02)
        run.notes["inflight_roots"] = gw.stats()["inflight_roots"]
        await srv.stop()
        return client, t0

    client, t0 = asyncio.run(serve())
    client.join(1.0)
    if tr is not None:
        tr.stop()           # a no-op where the loop stopped it
    run.read_peak()
    _account(run, client, t0, app, backend, cfgs)
    if tr is not None:
        run.spans = list(hooks.tracer.spans)
    late = client.lateness_ms()
    print(f"client lateness: p50 {late['p50']:.3f} ms, max "
          f"{late['max']:.3f} ms over {len(client.sent)} sends",
          file=sys.stderr)
    run.notes["lateness_ms"] = late
    # the gateway's drop reasons, for the sweep's report
    run.counters["drops"] = {r: n for (_, r), n in
                             getattr(hooks, "_dropped", {}).items()}
    print("roots: " + ", ".join(f"{k} {v}" for k, v in sorted(Counter(
        str(r["outcome"]) for r in run.requests).items())), file=sys.stderr)

    cases = _sample(backend.hops, run.seed, cfgs)
    del gw, backend, engines, hooks
    run.free()
    for i, a in enumerate(archs):
        if not cases[a]:
            run.fail(f"no {a} hop to compare")
            continue
        run.judge_served(f"logit_gap.{a}", cfgs[a], arch_seed(run.seed, i),
                         cases[a])


def _account(run, client, t0, app, backend, cfgs) -> None:
    deadline_ms = app["slo_latency_ms"]
    ends = [s.end for s in client.sent if not math.isnan(s.end)]
    run.window_s = (max(ends) if ends else time.perf_counter()) - t0
    unresolved = 0
    ok_roots = {}
    for s in client.sent:
        outcome = (s.body or {}).get("status") if s.status == 200 else (
            "refused" if s.status == 429 else None)
        if outcome not in ("ok", "dropped", "refused"):
            unresolved += 1
        lat = s.latency_ms
        met = outcome == "ok" and lat <= deadline_ms
        run.requests.append({"due": s.due - t0, "latency_ms": lat,
                             "outcome": outcome, "met": met,
                             "deadline_ms": deadline_ms})
        if outcome == "ok":
            ok_roots[s.body["root_id"]] = s.body
    run.attempted = len(client.sent)
    run.failed = sum(1 for r in run.requests if r["outcome"] != "ok")
    if unresolved:
        run.fail(f"{unresolved} of {run.attempted} roots never resolved")
    if run.notes.get("inflight_roots"):
        run.fail(f"{run.notes['inflight_roots']} roots left in the gateway")
    # fan-out: per ok root, the hops of each task the backend served and
    # the variant its entry hop ran
    served, entry_variant = defaultdict(Counter), {}
    for h in backend.hops:
        for root in h["root_ids"]:
            served[root][h["task"]] += 1
            entry_variant.setdefault(root, h["variant"])
    # the factors as the configuration states them (a missing edge is 1),
    # not as the program computes them
    factor = {(m["task"], m["variant"], m["next"]): float(m["factor"])
              for m in app["mult"]}
    nexts = {t: [b for a, b in app["edges"] if a == t] for t in app["tasks"]}
    leaves = [t for t in app["tasks"] if not nexts[t]]
    entry = next(t for t in app["tasks"]
                 if all(b != t for _, b in app["edges"]))
    bad = 0
    for root, body in ok_roots.items():
        got = served.get(root, Counter())
        if got[entry] != 1:
            bad += 1
            continue
        fans = [math.floor(f) <= got[t2] <= math.ceil(f)
                for t2 in nexts[entry]
                for f in [factor.get((entry, entry_variant[root], t2), 1.0)]]
        if not all(fans) or sum(got[t] for t in leaves) != body.get(
                "completions"):
            bad += 1
    if bad:
        run.fail(f"{bad} ok roots whose hops did not fan out as the "
                 f"graph's factors allow")
    run.counters["ok_roots"] = len(ok_roots)
    in_window = [h for h in backend.hops if h["start"] >= t0]
    run.model_flops = sum(
        h["B"] * run.family(cfgs[h["arch"]]).sequence_flops(
            cfgs[h["arch"]], h["S"], h["new"])
        for h in in_window)
    run.model_s = run.window_s
    run.hops = [dict({k: h[k] for k in ("task", "arch", "B", "S", "new")},
                     start=h["start"] - t0, end=h["end"] - t0)
                for h in in_window]


def _sample(hops, seed: int, cfgs: Dict) -> Dict[str, list]:
    """Per model, requests of its hops drawn from the seed until they hold
    at least ``SAMPLE_TOKENS`` served tokens: each its prompt (made again
    from the seed and its id) and its served tokens."""
    rng = load.rng_for(seed, 5)
    out = {}
    for a, cfg in cfgs.items():
        rows = [(h, j) for h in hops if h["arch"] == a
                for j in range(h["B"])]
        order = rng.permutation(len(rows)) if rows else []
        cases, tokens = [], 0
        for i in order:
            if tokens >= SAMPLE_TOKENS:
                break
            h, j = rows[int(i)]
            cases.append({"prompt": hop_prompt(seed, h["req_ids"][j], h["S"],
                                               cfg["vocab_size"]),
                          "served": np.asarray(h["out"][j], np.int64)})
            tokens += h["new"]
        out[a] = cases
    return out
