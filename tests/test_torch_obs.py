"""The port's observability plane (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

The hook stream of a chaos storm on the JAX runtime (arrivals, dispatches,
completions, drops, dead units, ladder moves, spikes, emergency re-plans,
transitions), with re-plan and gateway calls added, is replayed into an
``Instrumentation`` of each package: the exposition text, the structured
snapshot, the Chrome trace, the audit log and the SLO plane's ledgers and
alerts must be equal.  The storm then runs on each package's own runtime,
monitor and SLO plane (the reference's in both of its event loops), with
the ledgers, alerts and
``SimMetrics`` equal.
"""
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.core.apps import get_app  # noqa: E402
from repro.core.frontend import Frontend  # noqa: E402
from repro.core.milp import Planner  # noqa: E402
from repro.core.profiler import Profiler  # noqa: E402
from repro.hwspec import chaos_cluster  # noqa: E402
from repro.reconfig import TransitionPlanner  # noqa: E402

from repro_torch import chaos as pchaos  # noqa: E402
from repro_torch import obs as pobs  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch.core import apps as papps  # noqa: E402
from repro_torch.core.frontend import Frontend as PFrontend  # noqa: E402
from repro_torch.core.milp import Planner as PPlanner  # noqa: E402
from repro_torch.core.profiler import Profiler as PProfiler  # noqa: E402
from repro_torch.hwspec import chaos_cluster as pchaos_cluster  # noqa: E402
from repro_torch.reconfig import TransitionPlanner as PTransitionPlanner  # noqa: E402
from repro_torch.runtime.metrics import diff_metrics  # noqa: E402

KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=120.0)


class _Recorder:
    """Hooks that record every ``on_*`` call in order."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def record(*args, **kw):
            self.calls.append((name, args, kw))
        return record


def _storm(mod, chaos, F, Pl, Pr, TP, cluster, graph, hooks, *,
           loop=None, slo_monitor=None):
    """social_media planned for 30 rps on the chaos cluster, driven at 40
    rps for 12 s with rack r0 killed at 3 s, an emergency re-planner and
    a degradation ladder attached, in package ``mod``; ``loop`` holds the
    reference's choice of event loop (the port has one)."""
    prof = Pr(graph, cluster=cluster)
    cfg = Pl(graph, prof, s_avail=cluster.total_units, **KW).plan(30.0)
    mon = chaos.EmergencyReplanner(
        F(graph), planner=Pl(graph, prof, s_avail=cluster.total_units,
                             stickiness=0.05, **KW),
        reconfig=TP(cluster, graph), planned_for_rps=30.0, hooks=hooks)
    monitor = mon if slo_monitor is None else slo_monitor(mon)
    rt = mod.ClusterRuntime(graph, cfg, mod.SimBackend(), seed=0,
                            cluster=cluster, monitor=monitor,
                            ladder=chaos.DegradationLadder(profiler=prof),
                            hooks=hooks, **(loop or {}))
    storm = mod.Scenario.poisson(40.0, duration_s=12.0,
                                 warmup_s=1.0).with_chaos(
        mod.DomainFailureEvent(at_s=3.0, domain="r0"))
    return rt.run(storm), mon


@pytest.fixture(scope="module")
def stream():
    """The hook calls of the JAX storm, with re-plan and gateway calls."""
    import repro.chaos as jchaos
    rec = _Recorder()
    m, mon = _storm(jrt, jchaos, Frontend, Planner, Profiler,
                    TransitionPlanner, chaos_cluster(),
                    get_app("social_media"), rec)
    assert mon.replans >= 1 and m.dropped > 0
    calls = list(rec.calls)
    calls += [("on_replan", (0.125, True), dict(now=12.0, app="",
                                                trigger="frontend",
                                                demand_rps=31.5)),
              ("on_replan", (0.0625, False), dict(now=300.0)),
              ("on_admission_reject", ("", "queue_full", 12.5), {}),
              ("on_retry", ("", 12.6), dict(root_id=7)),
              ("on_retry_success", ("", 12.9), dict(root_id=7))]
    kinds = {c[0] for c in calls}
    assert {"on_arrival", "on_dispatch", "on_complete", "on_drop",
            "on_dead_units", "on_ladder_level", "on_spike",
            "on_emergency_replan", "on_transition"} <= kinds
    return calls


def _replayed(obs, calls):
    hooks = obs.Instrumentation(tracer=obs.Tracer(), slo=obs.SloPlane(),
                                audit=obs.AuditLog(maxlen=1 << 15))
    for name, args, kw in calls:
        getattr(hooks, name)(*args, **kw)
    return hooks


def test_replayed_hooks_export_the_same(stream):
    want, got = _replayed(jobs, stream), _replayed(pobs, stream)
    text = got.registry.render()
    assert text == want.registry.render()
    assert "jigsaw_transitions_total" in text
    assert ([tuple(s) for s in got.registry.snapshot()]
            == [tuple(s) for s in want.registry.snapshot()])
    assert got.tracer.chrome_trace() == want.tracer.chrome_trace()
    assert pobs.validate_chrome_trace(got.tracer.chrome_trace())
    assert ([e.to_dict() for e in got.audit.events]
            == [e.to_dict() for e in want.audit.events])
    assert got.audit.to_ndjson() == want.audit.to_ndjson()
    rid = next(e.root_id for e in want.audit.events
               if e.kind == "violation" and e.root_id is not None)
    assert ([e.to_dict() for e in got.audit.explain(rid)]
            == [e.to_dict() for e in want.audit.explain(rid)])
    assert got.slo.alerts_json() == want.slo.alerts_json()
    for led in ("latency", "accuracy"):
        g, w = getattr(got.slo, led), getattr(want.slo, led)
        assert g.apps() == w.apps()
        for app in w.apps():
            assert g.totals(app) == w.totals(app)
            for window in (0.5, 2.0, 6.0):
                assert (g.window_counts(app, window, 8.0)
                        == w.window_counts(app, window, 8.0))
    assert got.slo.first_fired == want.slo.first_fired
    assert pobs.parse_exposition(text) == jobs.parse_exposition(text)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_storm_slo_plane_matches_jax(fast):
    """Each package's runtime, emergency monitor, ladder and SLO plane
    (evaluated on the monitor cadence by an ``SloMonitor``) through the
    same storm: equal ``SimMetrics``, ledgers, alerts and audit log."""
    import repro.chaos as jchaos
    out = []
    for (mod, chaos, obs, F, Pl, Pr, TP, cluster, graph) in (
            (jrt, jchaos, jobs, Frontend, Planner, Profiler,
             TransitionPlanner, chaos_cluster(), get_app("social_media")),
            (prt, pchaos, pobs, PFrontend, PPlanner, PProfiler,
             PTransitionPlanner, pchaos_cluster(),
             papps.get_app("social_media"))):
        hooks = obs.Instrumentation(slo=obs.SloPlane(), audit=obs.AuditLog())
        m, mon = _storm(mod, chaos, F, Pl, Pr, TP, cluster, graph, hooks,
                        loop={"fast": fast} if mod is jrt else None,
                        slo_monitor=lambda inner: obs.SloMonitor(
                            hooks.slo, interval_s=0.5, inner=inner))
        out.append((m, mon, hooks))
    (wm, wmon, wh), (gm, gmon, gh) = out
    assert not diff_metrics(wm, gm)
    assert (gmon.replans, gmon.spikes) == (wmon.replans, wmon.spikes)
    assert gh.slo.alerts_json() == wh.slo.alerts_json()
    assert gh.slo.first_fired == wh.slo.first_fired
    assert ([e.to_dict() for e in gh.audit.events]
            == [e.to_dict() for e in wh.audit.events])
    assert gh.registry.render() == wh.registry.render()
    assert gh.slo.first_fired, "the storm must fire a burn-rate alert"


def _registry(obs):
    r = obs.MetricsRegistry()
    c = r.counter("t_requests_total", "reqs", ("app", "reason"))
    c.inc(3, "social", "deadline")
    c.inc(2.5, "traffic", 'we"ird\\lab\nel')
    r.gauge("t_depth", "depth").set(7)
    h = r.histogram("t_lat", "lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return r


def test_registry_primitives_match_jax():
    want, got = _registry(jobs), _registry(pobs)
    assert got.render() == want.render()
    assert ([tuple(s) for s in got.snapshot()]
            == [tuple(s) for s in want.snapshot()])
    for obs in (jobs, pobs):
        r = obs.MetricsRegistry()
        c = r.counter("t_total", "h", ("app",))
        with pytest.raises(ValueError):
            c.inc(-1, "a")
        with pytest.raises(ValueError):
            c.inc(1, "a", "b")
        with pytest.raises(ValueError):
            r.gauge("t_total", "h", ("app",))
        assert r.counter("t_total", "h", ("app",)) is c


def test_tracer_and_audit_primitives_match_jax():
    out = []
    for obs in (jobs, pobs):
        tr = obs.Tracer(max_events=4, sample_every=2)
        for i in range(10):
            if tr.enabled_for(i):
                tr.record("t", "hop", 0.0, 1.0 + i, "app", root_id=i)
        log = obs.AuditLog(maxlen=3)
        for i in range(5):
            log.record("violation", float(i), app="a", root_id=i, n=i)
        back = obs.AuditLog.from_ndjson(log.to_ndjson())
        out.append((tr.chrome_trace(), tr.dropped,
                    [e.to_dict() for e in log.query(app="a")],
                    [e.to_dict() for e in back.events],
                    [r.to_dict() for r in obs.sre_rules(2.0)]))
    assert out[1] == out[0]
