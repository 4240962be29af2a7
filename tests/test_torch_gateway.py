"""The port's serving front door (``repro_torch.gateway``) against the JAX
package's ``repro.gateway``.

Both packages plan social_media and traffic_analysis at 30 rps on 64
slices with a node budget that binds (``bb_time_s`` far above what a plan
takes), so CPU load cannot change a plan.  Then:

* the gateways' constructor state is equal;
* both gateways' state machines run one script under a shared fake clock:
  ``now`` reads the script's clock, dispatchers are not started (the script
  runs their early-drop scan and launch at every event), and ``_serve`` is
  replaced by a recorder whose batches the script completes in end-time
  order by the steps ``_serve`` runs after its sleep.  The script covers
  quotas, ladder admission rejects, early drops, retry-on-drop and
  fan-out, with ``SimBackend`` services drawn from the same seed; the
  outcomes, event streams, queues, servers, exposition text, trace and
  audit log must be equal;
* the scenarios of ``tests/test_gateway.py`` run against the port with
  the same invariants;
* each package's HTTP client talks to the other's server;
* ``LoadReport`` over the same outcomes, and ``open_loop``'s arrival
  schedule from one seed, are equal;
* ``chip_smoke.phase_gateway`` is rehearsed on reduced CPU engines.

Async tests run through ``asyncio.run``: no pytest-asyncio in the image.
"""
import asyncio
import dataclasses
import heapq
import itertools
import json
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import gateway as jgw  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core.apps import get_app  # noqa: E402
from repro.core.milp import Planner  # noqa: E402
from repro.core.profiler import Profiler  # noqa: E402
from repro.gateway import loadgen as jloadgen  # noqa: E402
from repro.runtime.backend import SimBackend  # noqa: E402

from repro_torch import gateway as pgw  # noqa: E402
from repro_torch import obs as pobs  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch.core import apps as papps  # noqa: E402
from repro_torch.core.dispatch import QueuedRequest  # noqa: E402
from repro_torch.core.milp import Planner as PPlanner  # noqa: E402
from repro_torch.core.profiler import Profiler as PProfiler  # noqa: E402
from repro_torch.gateway import loadgen as ploadgen  # noqa: E402
from repro_torch.runtime.backend import SimBackend as PSimBackend  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
APPS = ("social_media", "traffic_analysis")
# The node budget binds: bb_time_s is a ceiling no plan here reaches.
KW = dict(max_tuples_per_task=32, bb_nodes=4, bb_time_s=120.0)
JAX = types.SimpleNamespace(gw=jgw, obs=jobs, Sim=SimBackend)
PORT = types.SimpleNamespace(gw=pgw, obs=pobs, Sim=PSimBackend)
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (its HTTP helpers; the phase rehearsal)

_fetch, _dechunk = chip_smoke._fetch, chip_smoke._dechunk


def _with_small_batches(cfg, small):
    """``cfg`` plus ``small``'s instances of the tasks where ``small``
    batches fewer requests: a plan whose tasks serve on two batch sizes (no
    plan here has one), so that a short queue goes to the smaller batch."""
    counts, tuples = dict(cfg.counts), dict(cfg.tuples)
    for t, m in small.instances():
        if all(t.batch < u.batch for u, _ in cfg.instances()
               if u.task == t.task):
            counts[t.key] = counts.get(t.key, 0) + m
            tuples[t.key] = t
    return dataclasses.replace(cfg, counts=counts, tuples=tuples)


@pytest.fixture(scope="module")
def planned():
    """{"jax": apps, "port": apps}, each ``{app: (graph, plan)}``, and
    under "jax_mixed" and "port_mixed" the same with social_media's plan
    at 30 rps joined by its 10 rps plan's smaller batches."""
    out = {"jax": {}, "port": {}}
    for name in APPS:
        g, pg = get_app(name), papps.get_app(name)
        cfg = Planner(g, Profiler(g), s_avail=64, **KW).plan(30.0)
        pcfg = PPlanner(pg, PProfiler(pg), s_avail=64, **KW).plan(30.0)
        assert cfg is not None and pcfg is not None
        out["jax"][name], out["port"][name] = (g, cfg), (pg, pcfg)
    for key, P, Pr in (("jax", Planner, Profiler),
                       ("port", PPlanner, PProfiler)):
        g, cfg = out[key]["social_media"]
        small = P(g, Pr(g), s_avail=64, **KW).plan(10.0)
        out[f"{key}_mixed"] = dict(out[key], social_media=(
            g, _with_small_batches(cfg, small)))
    return out


def _queues(gw) -> dict:
    return {qt: [dataclasses.astuple(r) for r in q]
            for qt, q in gw.queues.items()}


def _servers(gw) -> list:
    return [(s.tup.key, s.idx, s.app, s.busy_until, s.served, s.retire_at,
             s.degraded) for s in gw.servers]


def test_constructor_state_matches_jax(planned):
    for quotas in (None, {"traffic_analysis": 2.0}):
        gws = [pkg.gw.AsyncGateway(planned[k], seed=0, quotas=quotas,
                                   quota_burst=3.0)
               for k, pkg in (("jax", JAX), ("port", PORT))]
        want, got = gws
        assert _servers(got) == _servers(want)
        assert {qt: [s.idx for s in ss] for qt, ss in got.by_task.items()} \
            == {qt: [s.idx for s in ss] for qt, ss in want.by_task.items()}
        assert _queues(got) == _queues(want)
        assert got._timeout == want._timeout
        assert got._fastest == want._fastest
        assert {a: dataclasses.astuple(b) for a, b in got._quota.items()} \
            == {a: dataclasses.astuple(b) for a, b in want._quota.items()}
        assert got.stats().keys() == want.stats().keys()
        assert len(got.servers) > 3 and set(got._wake) == set(got.queues)


# ---------------------------------------------------------------------------
# the state machine under a fake clock
# ---------------------------------------------------------------------------
SCRIPT_SEED = 7
SCRIPT_S = 6.0
SCRIPT_RPS = {"social_media": 34.0, "traffic_analysis": 22.0}
BURST_AT_S, BURST_N = 2.0, 120      # social_media arrivals before a dispatch
POLL_S = 0.004                      # the dispatchers' timer, at its coarsest


def _script():
    """(t, app, n) arrival events: Poisson per app, and one burst."""
    rng = np.random.default_rng(SCRIPT_SEED)
    events = [(BURST_AT_S, "social_media", BURST_N)]
    for app, rate in SCRIPT_RPS.items():
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= SCRIPT_S:
                break
            events.append((t, app, 1))
    return sorted(events)


def _drive(pkg, apps) -> dict:
    """Run the script through one package's gateway; returns what the
    parity test compares."""
    hooks = pkg.obs.Instrumentation(tracer=pkg.obs.Tracer(),
                                    slo=pkg.obs.SloPlane(),
                                    audit=pkg.obs.AuditLog())
    clock, launched = [0.0], set()
    inflight, seq = [], itertools.count()

    async def run():
        gw = pkg.gw.AsyncGateway(apps, pkg.Sim(), seed=3, hooks=hooks,
                                 quotas={"traffic_analysis": 15.0},
                                 quota_burst=4.0, retry_drops=True)
        gw.now = lambda: clock[0]

        def record(srv, qt, batch, service):
            if qt.endswith("::caption"):
                launched.add(srv.tup.batch)
            heapq.heappush(inflight, (clock[0] + service, next(seq), srv,
                                      qt, batch))
            return asyncio.sleep(0)
        gw._serve = record
        roots, rejects, snaps = [], [], []

        def dispatch():
            for qt in gw.queues:
                gw._drop_scan(qt, clock[0])
                gw._try_launch(qt, clock[0])

        def complete(end, srv, qt, batch):       # _serve after its sleep
            clock[0] = end
            srv.busy_until = end
            for req in batch:
                gw._complete_hop(req, srv, end)
            gw._wake[qt].set()

        events = _script()
        polls = (k * POLL_S for k in itertools.count(1))
        t_poll = next(polls)
        while events or inflight or any(gw.queues.values()):
            t_next = min(events[0][0] if events else np.inf,
                         inflight[0][0] if inflight else np.inf)
            if t_poll < t_next:
                clock[0] = t_poll
                t_poll = next(polls)
            elif inflight and inflight[0][0] == t_next:
                end, _, srv, qt, batch = heapq.heappop(inflight)
                complete(end, srv, qt, batch)
            else:
                t, app, n = events.pop(0)
                clock[0] = t
                for _ in range(n):
                    try:
                        roots.append(await gw.submit(app))
                    except pkg.gw.AdmissionRejected as e:
                        rejects.append((t, e.app, e.reason))
            dispatch()
            await asyncio.sleep(0)        # the recorders' tasks finish
            if len(snaps) < 200 or not events:
                snaps.append((clock[0], _queues(gw), _servers(gw)))
        streams = []
        for gr in roots:
            evs = []
            while not gr.events.empty():
                evs.append(gr.events.get_nowait())
            streams.append(evs)
        return {"outcomes": [gr.outcome for gr in roots],
                "by_task": {qt: sorted({s.tup.batch for s in ss})
                            for qt, ss in gw.by_task.items()},
                "launched_batches": sorted(launched),
                "streams": streams, "rejects": rejects, "snaps": snaps,
                "left": len(gw._roots), "stats": gw.stats(),
                "retried": sorted(gw._retried)}

    out = asyncio.run(run())
    out.update(exposition=hooks.registry.render(),
               trace=hooks.tracer.chrome_trace(),
               audit=[e.to_dict() for e in hooks.audit.events],
               alerts=hooks.slo.alerts_json(SCRIPT_S))
    return out


@pytest.fixture(scope="module")
def script_runs(planned):
    return (_drive(JAX, planned["jax_mixed"]),
            _drive(PORT, planned["port_mixed"]))


def test_fake_clock_drive_matches_jax(script_runs):
    want, got = script_runs
    for key in ("outcomes", "streams", "rejects", "left", "stats",
                "retried", "trace", "audit", "alerts"):
        assert got[key] == want[key], key
    assert len(got["snaps"]) == len(want["snaps"])
    for i, (g, w) in enumerate(zip(got["snaps"], want["snaps"])):
        assert g == w, i
    assert got["exposition"] == want["exposition"]


def test_fake_clock_drive_covers_every_door_and_queue_rule(script_runs):
    """The script reaches each rule it is meant to compare: quota and
    ladder refusals, early drops, retries (paid off and final), fan-out,
    and every accepted root resolves."""
    _, got = script_runs
    reasons = {r for _, _, r in got["rejects"]}
    assert reasons == {"quota", "admission"}
    status = [o["status"] for o in got["outcomes"]]
    assert None not in status and got["left"] == 0
    assert status.count("ok") > 50 and status.count("dropped") > 5
    assert sum(o["retries"] for o in got["outcomes"]) > 0
    assert sum(o["retry_ok"] for o in got["outcomes"]) > 0
    assert any(o["status"] == "dropped" and o["retries"]
               for o in got["outcomes"])
    # a short queue launched on the smaller of two batch sizes
    caption = {b for qt, ss in got["by_task"].items() for b in ss
               if qt.endswith("::caption")}
    assert len(caption) == 2 and min(caption) in got["launched_batches"]
    fanned = [o for o, s in zip(got["outcomes"], got["streams"])
              if o["app"] == "traffic_analysis"
              and sum(e["event"] == "hop" for e in s) > 3]
    assert fanned
    parsed = pobs.parse_exposition(got["exposition"])
    drops = {dict(k)["reason"] for k in parsed["jigsaw_drops_total"]}
    assert drops >= {"quota", "admission"} and drops & {"stale", "deadline"}


# ---------------------------------------------------------------------------
# tests/test_gateway.py's scenarios, against the port
# ---------------------------------------------------------------------------
def test_gateway_end_to_end_two_apps(planned):
    apps = planned["port"]
    hooks = pobs.Instrumentation(tracer=pobs.Tracer())

    async def drive():
        gw = pgw.AsyncGateway(apps, seed=0, hooks=hooks, time_scale=0.2)
        await gw.start()
        try:
            report = await pgw.open_loop(
                pgw.direct_submitter(gw),
                {"social_media": 8.0, "traffic_analysis": 8.0},
                duration_s=3.0, seed=1, time_scale=gw.time_scale)
        finally:
            await gw.stop()
        return gw, report

    gw, report = asyncio.run(drive())
    d = report.to_dict()
    tot = d["total"]
    assert tot["submitted"] > 10
    assert tot["ok"] + tot["dropped"] + tot["rejected"] == tot["submitted"]
    assert tot["errors"] == 0
    assert tot["ok"] > 0 and tot["attainment"] > 0.5
    assert not gw._roots, "no request may leak in the root table"
    parsed = pobs.parse_exposition(hooks.registry.render())
    arrivals = parsed["jigsaw_arrivals_total"]
    for app in apps:
        st = d["apps"][app]
        assert arrivals.get((("app", app),), 0) == \
            st["submitted"] - st["rejected"]
    comp = sum(parsed.get("jigsaw_completions_total", {}).values())
    assert tot["ok"] <= comp <= tot["ok"] + tot["dropped"]
    assert pobs.validate_chrome_trace(hooks.tracer.chrome_trace())
    for rid in range(tot["submitted"]):
        hops = hooks.tracer.spans_for_root(rid, cat="hop")
        if hops:
            assert len(hooks.tracer.spans_for_root(rid, "queue")) == \
                len(hops)
            assert len(hooks.tracer.spans_for_root(rid, "service")) == \
                len(hops)
            break
    else:
        pytest.fail("no root produced hop spans")


def test_gateway_admission_rejects_on_full_queue(planned):
    apps = planned["port"]
    hooks = pobs.Instrumentation()

    async def drive():
        gw = pgw.AsyncGateway(apps, seed=0, hooks=hooks, time_scale=1.0)
        app = "social_media"
        qt = f"{app}::{apps[app][0].entry}"
        now = gw.now()
        gw.queues[qt].extend(
            QueuedRequest(10_000 + i, 10_000 + i, qt, now, now + 10.0)
            for i in range(10_000))
        with pytest.raises(pgw.AdmissionRejected) as ei:
            await gw.submit(app)
        assert ei.value.reason == "admission"
        gr = await gw.submit("traffic_analysis")
        assert gr.root_id >= 0

    asyncio.run(drive())
    parsed = pobs.parse_exposition(hooks.registry.render())
    assert parsed["jigsaw_admission_rejects_total"][
        (("app", "social_media"),)] == 1
    assert parsed["jigsaw_drops_total"][
        (("app", "social_media"), ("reason", "admission"))] == 1


def test_gateway_quota_rejects_over_contracted_rate(planned):
    apps = planned["port"]
    hooks = pobs.Instrumentation()

    async def drive():
        gw = pgw.AsyncGateway(apps, seed=0, hooks=hooks, time_scale=1.0,
                              quotas={"social_media": 0.01}, quota_burst=2.0)
        await gw.submit("social_media")
        await gw.submit("social_media")
        with pytest.raises(pgw.AdmissionRejected) as ei:
            await gw.submit("social_media")
        assert ei.value.reason == "quota"
        gr = await gw.submit("traffic_analysis")
        assert gr.root_id >= 0

    asyncio.run(drive())
    parsed = pobs.parse_exposition(hooks.registry.render())
    assert parsed["jigsaw_admission_rejects_total"][
        (("app", "social_media"),)] == 1
    assert parsed["jigsaw_drops_total"][
        (("app", "social_media"), ("reason", "quota"))] == 1


def test_gateway_quota_unknown_app_fails_loud(planned):
    with pytest.raises(ValueError, match="quota for unknown app"):
        pgw.AsyncGateway(planned["port"], seed=0, quotas={"nope": 1.0})


def test_gateway_retry_on_drop(planned):
    apps = planned["port"]
    hooks = pobs.Instrumentation()

    async def drive():
        gw = pgw.AsyncGateway(apps, seed=0, hooks=hooks, time_scale=1.0,
                              retry_drops=True)
        app = "social_media"
        g, _ = apps[app]
        qt = f"{app}::{g.entry}"

        gr = await gw.submit(app)
        req = gw.queues[qt].pop()
        retry = gw._drop(req, qt, "staleness", gw.now())
        assert retry is not None and retry.req_id == req.req_id
        assert gr.retries == 1 and gr.dropped == 0
        assert not gr.done.is_set()

        final = gw._drop(retry, qt, "staleness", gw.now())
        assert final is None
        assert gr.dropped == 1 and gr.done.is_set()
        assert gr.outcome["status"] == "dropped"
        assert gr.outcome["retries"] == 1 and gr.outcome["retry_ok"] == 0

        gr2 = await gw.submit(app)
        req2 = gw.queues[qt].pop()
        retry2 = gw._drop(req2, qt, "staleness", gw.now())
        assert retry2 is not None and gr2.retries == 1
        leaf = next(t for t in g.tasks if not g.successors(t))
        srv = gw.by_task[f"{app}::{leaf}"][0]
        gw._complete_hop(retry2, srv, gw.now())
        assert gr2.retry_ok == 1 and gr2.done.is_set()
        assert gr2.outcome["status"] == "ok"
        assert gr2.outcome["retry_ok"] == 1

        gr3 = await gw.submit(app)
        req3 = gw.queues[qt].pop()
        dead = gw._drop(req3, qt, "deadline", req3.deadline + 1.0)
        assert dead is None and gr3.outcome["status"] == "dropped"
        assert gr3.retries == 0

    asyncio.run(drive())
    parsed = pobs.parse_exposition(hooks.registry.render())
    assert parsed["jigsaw_gateway_retries_total"][
        (("app", "social_media"),)] == 2
    assert parsed["jigsaw_gateway_retry_success_total"][
        (("app", "social_media"),)] == 1
    assert parsed["jigsaw_drops_total"][
        (("app", "social_media"), ("reason", "staleness"))] == 1
    assert parsed["jigsaw_drops_total"][
        (("app", "social_media"), ("reason", "deadline"))] == 1


def test_gateway_unknown_app_fails_loud(planned):
    async def drive():
        gw = pgw.AsyncGateway(planned["port"], seed=0)
        with pytest.raises(KeyError, match="unknown app"):
            await gw.submit("nope")

    asyncio.run(drive())


def test_http_server_smoke(planned):
    """Every route of the port's server over real sockets."""
    apps = planned["port"]
    hooks = pobs.Instrumentation(tracer=pobs.Tracer(), slo=pobs.SloPlane(),
                                 audit=pobs.AuditLog())

    async def drive():
        gw = pgw.AsyncGateway(apps, seed=0, hooks=hooks, time_scale=0.2)
        srv = pgw.GatewayHTTPServer(gw, hooks, port=0)
        await srv.start()
        try:
            port = srv.port
            status, _, body = await _fetch(port, "GET", "/healthz")
            assert status == 200
            assert set(json.loads(body)["apps"]) == set(apps)

            out = await pgw.http_submitter(f"http://127.0.0.1:{port}")(
                "social_media")
            assert out["status"] in ("ok", "dropped")
            assert out["event"] == "done"

            status, head, payload = await _fetch(
                port, "POST", "/v1/social_media/submit?stream=1")
            assert status == 200 and b"chunked" in head.lower()
            lines = [json.loads(ln) for ln in _dechunk(payload).strip()
                     .split(b"\n")]
            assert lines[-1]["event"] == "done"
            assert all(ln["event"] in ("hop", "drop", "done")
                       for ln in lines)

            status, _, body = await _fetch(port, "GET", "/metrics")
            assert status == 200
            parsed = pobs.parse_exposition(body.decode())
            assert sum(parsed["jigsaw_arrivals_total"].values()) >= 2

            status, _, body = await _fetch(port, "GET", "/trace")
            assert status == 200
            pobs.validate_chrome_trace(json.loads(body))

            status, _, body = await _fetch(port, "GET", "/alerts")
            assert status == 200
            alerts = json.loads(body)
            assert {r["name"] for r in alerts["rules"]} >= {
                "latency_fast_burn", "latency_slow_burn"}
            assert isinstance(alerts["alerts"], list)

            status, head, body = await _fetch(port, "GET", "/audit")
            assert status == 200 and b"ndjson" in head.lower()
            for ln in body.decode().splitlines():
                assert {"seq", "t_s", "kind"} <= set(json.loads(ln))
            for query in ("explain=0", "app=social_media&t0=0&t1=1e9",
                          "kind=violation&root_id=0"):
                status, head, _ = await _fetch(port, "GET",
                                               f"/audit?{query}")
                assert status == 200 and b"ndjson" in head.lower()

            status, _, _ = await _fetch(port, "GET", "/no/such/route")
            assert status == 404
            status, _, _ = await _fetch(port, "POST", "/v1/nope/submit")
            assert status == 404
            status, _, _ = await _fetch(port, "GET",
                                        "/v1/social_media/submit")
            assert status == 405
        finally:
            await srv.stop()

    asyncio.run(drive())


# ---------------------------------------------------------------------------
# wire compatibility: each package's client against the other's server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_http_clients_and_servers_interoperate(planned, client, server):
    cli = {"jax": JAX, "port": PORT}[client]
    srvp = {"jax": JAX, "port": PORT}[server]
    hooks = srvp.obs.Instrumentation(tracer=srvp.obs.Tracer())

    async def drive():
        gw = srvp.gw.AsyncGateway(planned[server], seed=0, hooks=hooks,
                                  time_scale=0.2,
                                  quotas={"traffic_analysis": 0.01},
                                  quota_burst=1.0)
        srv = srvp.gw.GatewayHTTPServer(gw, hooks, port=0)
        await srv.start()
        try:
            submit = cli.gw.http_submitter(f"http://127.0.0.1:{srv.port}")
            ok = await submit("social_media")
            assert ok["event"] == "done" and ok["status"] in ("ok",
                                                              "dropped")
            assert (await submit("traffic_analysis"))["event"] == "done"
            assert await submit("traffic_analysis") == {
                "status": "rejected", "reason": "quota"}
            assert await submit("nope") == {"status": "error", "http": 404}
            report = await cli.gw.open_loop(
                submit, {"social_media": 10.0}, duration_s=1.0, seed=2,
                time_scale=gw.time_scale)
        finally:
            await srv.stop()
        return gw, report.to_dict()["total"]

    gw, tot = asyncio.run(drive())
    assert tot["submitted"] > 3 and tot["errors"] == 0
    assert tot["ok"] + tot["dropped"] + tot["rejected"] == tot["submitted"]
    assert not gw._roots


# ---------------------------------------------------------------------------
# the load generator's accounting and schedule
# ---------------------------------------------------------------------------
OUTCOMES = [
    {"status": "ok", "latency_ms": 120.5, "deadline_met": True},
    {"status": "ok", "latency_ms": 900.0, "deadline_met": False,
     "retries": 1, "retry_ok": 1},
    {"status": "ok", "latency_ms": 80.25, "deadline_met": True},
    {"status": "dropped", "retries": 2, "retry_ok": 0},
    {"status": "rejected", "reason": "quota"},
    {"status": "rejected", "reason": "admission"},
    {"status": "error", "http": 500},
    {},
]


def test_load_report_matches_jax():
    reports = []
    for lg in (jloadgen, ploadgen):
        per = {"a": lg._AppStats(), "b": lg._AppStats(), "c": lg._AppStats()}
        for i, out in enumerate(OUTCOMES * 3):
            st = per["a" if i % 3 else "b"]
            st.submitted += 1
            lg._account(st, out)
        reports.append([lg.LoadReport(w, per).to_dict()
                        for w in (2.5, 0.0)])
    assert reports[1] == reports[0]
    tot = reports[1][0]["total"]
    assert tot["submitted"] == 24 and tot["ok"] == 9
    assert tot["errors"] == 6 and tot["retried"] == 9
    assert tot["p50_ms"] == 120.5 and tot["p99_ms"] == 900.0
    assert reports[1][0]["apps"]["c"]["attainment"] == 0.0


def _schedule(lg, seed: int, rate: float, duration: float, monkeypatch):
    """The submit times of ``open_loop`` on one app, on a fake clock that
    each of its sleeps advances."""
    clock = [0.0]
    real = asyncio

    class FakeAsyncio:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        async def sleep(delay):
            await real.sleep(0)           # the submits already due start
            clock[0] += delay

    monkeypatch.setattr(lg, "time",
                        types.SimpleNamespace(monotonic=lambda: clock[0]))
    monkeypatch.setattr(lg, "asyncio", FakeAsyncio())
    seen = []

    async def submit(app):
        seen.append((app, clock[0]))
        return {"status": "ok", "latency_ms": 1.0, "deadline_met": True}

    report = real.run(lg.open_loop(submit, {"social_media": rate},
                                   duration, seed=seed, time_scale=0.5))
    return seen, report.to_dict()


def test_open_loop_schedule_matches_jax(monkeypatch):
    want = _schedule(jloadgen, 11, 6.0, 5.0, monkeypatch)
    got = _schedule(ploadgen, 11, 6.0, 5.0, monkeypatch)
    assert got == want
    rng = np.random.default_rng(11)
    t, times = 0.0, []
    while True:
        t += float(rng.exponential(1.0 / 6.0))
        if t >= 5.0:
            break
        times.append(t * 0.5)
    assert [c for _, c in got[0]] == pytest.approx(times, abs=1e-12)
    assert got[1]["total"]["submitted"] == len(times) > 10


# ---------------------------------------------------------------------------
# chip_smoke.py's gateway phase, rehearsed on the CPU
# ---------------------------------------------------------------------------
# The control rehearsal's calibration (tests/test_torch_controller.py): one
# card plans social_media at the compound rate with it.
REHEARSAL_FIT = dict(flops_efficiency=0.40, hbm_efficiency=0.26)
REHEARSAL_S = 2.5


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke`` and the plan phase's hand-over, built on the CPU:
    reduced engines, the fitted H100 spec above, deadline scale 4, and the
    plan the port's planner makes for one such card."""
    from repro_torch.hwspec import H100_SXM
    graph = papps.get_app(chip_smoke.COMPOUND_APP)
    backend = prt.EngineBackend(reduced=True, device="cpu", max_batch=8,
                                max_seq=32, prompt_len=8,
                                max_new=chip_smoke.SERVE_NEW)
    backend.bind(graph, None)
    for arch in chip_smoke._archs(graph):
        backend._engine_for(arch)
    fitted = dataclasses.replace(H100_SXM, **REHEARSAL_FIT)
    _, cfg, placed, _, _ = chip_smoke._plan_on(
        graph, fitted, 1, chip_smoke.COMPOUND_RPS, 4.0)
    assert cfg is not None and placed is not None
    return chip_smoke, {"backend": backend, "graph": graph, "cfg": cfg,
                        "slo_scale": 4.0, "fitted": fitted}


def _counting(mod, plain):
    def launch(*args, **kw):
        mod.launches += 1
        return plain(*args, **kw)
    return launch


@pytest.mark.parametrize("fault,fails_on", [
    (None, None),
    ("lost_arrival_hook", "counters"),
    ("uncounted_decode", "launches")])
def test_chip_smoke_gateway_phase_rehearsal(smoke, monkeypatch, fault,
                                            fails_on, capsys):
    chip_smoke, planned = smoke
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref
    monkeypatch.setattr(chip_smoke, "GATEWAY_S", REHEARSAL_S)
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(fmod, "flash_attention",
                        _counting(fmod, ref.flash_attention_ref))
    decode = _counting(dmod, ref.decode_attention_ref)
    if fault == "uncounted_decode":
        calls = []

        def decode(*args, **kw):         # noqa: F811 — one call uncounted
            calls.append(1)
            if len(calls) != 5:
                dmod.launches += 1
            return ref.decode_attention_ref(*args, **kw)
    monkeypatch.setattr(dmod, "decode_attention", decode)
    if fault == "lost_arrival_hook":
        orig = pobs.Instrumentation.on_arrival
        seen = []

        def lossy(self, *args, **kw):
            seen.append(1)
            if len(seen) != 2:
                orig(self, *args, **kw)
        monkeypatch.setattr(pobs.Instrumentation, "on_arrival", lossy)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **kw: 0)
    card = {"nvidia_smi": "cpu rehearsal"}
    if fails_on is not None:
        with pytest.raises(AssertionError, match=f"gateway: .*{fails_on}"):
            chip_smoke.phase_gateway(torch, card, 0, planned)
        return
    launches = chip_smoke.phase_gateway(torch, card, 0, planned)
    assert set(launches) <= set(chip_smoke._archs(planned["graph"]))
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"phase": "gateway"'))
    out = json.loads(line)
    assert out["failures"] == []
    tot = out["load"]["total"]
    assert tot["submitted"] > 3 and tot["errors"] == 0
    assert tot["ok"] + tot["dropped"] + tot["rejected"] == tot["submitted"]
    assert out["health"]["inflight_roots"] == 0
    assert out["stream"][-1]["event"] == "done"
    assert out["loop_blocked_s"]["calls"] == sum(out["service_calls"]
                                                 .values())
    assert len(out["dispatches"]) == out["loop_blocked_s"]["calls"]
    assert all(d["done_s"] >= d["start_s"] + d["service_s"] - 1e-6
               for d in out["dispatches"])
