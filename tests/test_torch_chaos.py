"""The port's chaos plane (``repro_torch.chaos``) against the JAX
package's ``repro.chaos``.

Every pinned case of ``tests/chaos_pins.json`` (read, never written)
derives the same ``FuzzCase`` from its seed in both packages and gives
the same ``run_case`` result as on both of the reference's event loops;
``fuzz`` and the ``--update-pins`` CLI write the same pins.  On a
domain-failure storm the port's runtime, carrying the port's emergency
re-planner, degradation ladder and hooks, gives ``SimMetrics`` field-exact
to the JAX runtime carrying the JAX ones on either of its loops, and the
failure detector, the ladder and the monitor end in the same state.  The
fuzzer's planners, and every other here, bind by their node budget: the
reference's 3 s wall-clock budget is raised to 120 s in both packages for
these tests.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro import chaos as jchaos  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.chaos import fuzz as jfuzz  # noqa: E402
from repro.core.apps import get_app  # noqa: E402
from repro.core.frontend import Frontend  # noqa: E402
from repro.core.milp import Planner  # noqa: E402
from repro.core.profiler import Profiler  # noqa: E402
from repro.hwspec import chaos_cluster  # noqa: E402
from repro.reconfig import TransitionPlanner  # noqa: E402

from repro_torch import chaos as pchaos  # noqa: E402
from repro_torch import obs as pobs  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch.chaos import fuzz as pfuzz  # noqa: E402
from repro_torch.core import apps as papps  # noqa: E402
from repro_torch.core.frontend import Frontend as PFrontend  # noqa: E402
from repro_torch.core.milp import Planner as PPlanner  # noqa: E402
from repro_torch.core.profiler import Profiler as PProfiler  # noqa: E402
from repro_torch.hwspec import chaos_cluster as pchaos_cluster  # noqa: E402
from repro_torch.reconfig import TransitionPlanner as PTransitionPlanner  # noqa: E402
from repro_torch.runtime.metrics import diff_metrics  # noqa: E402

PINS = os.path.join(os.path.dirname(__file__), "chaos_pins.json")
KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=120.0)


@pytest.fixture(scope="module")
def fuzzers():
    """Both fuzz modules with a fresh harness whose planner binds by its
    node budget (restored after the module)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jfuzz, pfuzz):
            mp.setattr(mod, "PLAN_KW", dict(mod.PLAN_KW, bb_time_s=120.0))
            mp.setattr(mod, "_FLEET", None)
            mp.setattr(mod, "_PLAN_CACHE", {})
        yield jfuzz, pfuzz


def _result(r) -> tuple:
    return (r.case.seed, r.case.case_id, r.violation_rate, r.completions,
            r.dropped, r.planned, r.breaking)


@pytest.fixture(scope="module")
def pins():
    with open(PINS) as f:
        return json.load(f)


def test_cases_derive_alike():
    for seed in range(40):
        want, got = jfuzz.case_from_seed(seed), pfuzz.case_from_seed(seed)
        assert (got.seed, got.shape, got.rate_rps, got.events) == (
            want.seed, want.shape, want.rate_rps, want.events)
        assert got.case_id == want.case_id
    assert pfuzz.DEFAULT_THRESHOLD == jfuzz.DEFAULT_THRESHOLD
    assert (pfuzz.RATES, pfuzz.DURATION_S, pfuzz.WARMUP_S) == (
        jfuzz.RATES, jfuzz.DURATION_S, jfuzz.WARMUP_S)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_pinned_corpus_matches_jax(fuzzers, pins, fast):
    jf, pf = fuzzers
    assert len(pins["cases"]) >= 3
    breaking = 0
    for cid, meta in sorted(pins["cases"].items()):
        case = pf.case_from_seed(meta["seed"])
        assert case.case_id == cid, "pin drifted from its seed"
        want = jf.run_case(jf.case_from_seed(meta["seed"]),
                           pins["threshold"], fast=fast)
        got = pf.run_case(case, pins["threshold"])
        assert _result(got) == _result(want), cid
        breaking += got.breaking
    assert breaking >= 3


def test_fuzz_cli_writes_the_same_pins(fuzzers, tmp_path, capsys):
    jf, pf = fuzzers
    assert ([_result(r) for r in pf.fuzz(4, 3)]
            == [_result(r) for r in jf.fuzz(4, 3)])
    out = {}
    for name, mod in (("jax", jf), ("port", pf)):
        path = tmp_path / f"{name}.json"
        assert mod.main(["--budget", "4", "--seed", "3", "--pins",
                         str(path), "--update-pins"]) == 0
        out[name] = (path.read_text(), capsys.readouterr().out.replace(
            str(path), "PINS"))
    assert out["port"] == out["jax"]
    assert pf.load_pins(str(tmp_path / "none.json")) == jf.load_pins(
        str(tmp_path / "none.json"))


def _storm(pkg: str, fast: bool = True):
    """social_media planned for 30 rps on the chaos cluster, driven at 40
    rps for 12 s with rack r0 killed at 3 s, carrying an emergency
    re-planner, a degradation ladder and hooks of package ``pkg``; the
    detector observes the finished run.  ``fast`` picks the reference's
    event loop; the port has one."""
    if pkg == "jax":
        mod, chaos, obs = jrt, jchaos, jobs
        F, Pl, Pr, TP = Frontend, Planner, Profiler, TransitionPlanner
        cluster, graph = chaos_cluster(), get_app("social_media")
    else:
        mod, chaos, obs = prt, pchaos, pobs
        F, Pl, Pr, TP = PFrontend, PPlanner, PProfiler, PTransitionPlanner
        cluster, graph = pchaos_cluster(), papps.get_app("social_media")
    prof = Pr(graph, cluster=cluster)
    cfg = Pl(graph, prof, s_avail=cluster.total_units, **KW).plan(30.0)
    hooks = obs.Instrumentation(tracer=obs.Tracer(), audit=obs.AuditLog())
    mon = chaos.EmergencyReplanner(
        F(graph), planner=Pl(graph, prof, s_avail=cluster.total_units,
                             stickiness=0.05, **KW),
        reconfig=TP(cluster, graph), planned_for_rps=30.0, hooks=hooks)
    ladder = chaos.DegradationLadder(profiler=prof)
    loop = {"fast": fast} if pkg == "jax" else {}
    rt = mod.ClusterRuntime(graph, cfg, mod.SimBackend(), seed=0,
                            cluster=cluster, monitor=mon, ladder=ladder,
                            hooks=hooks, **loop)
    m = rt.run(mod.Scenario.poisson(40.0, duration_s=12.0,
                                    warmup_s=1.0).with_chaos(
        mod.DomainFailureEvent(at_s=3.0, domain="r0")))
    det = chaos.FailureDetector()
    det.observe(rt)
    return m, rt, mon, ladder, det, hooks


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_domain_failure_storm_matches_jax(fast):
    wm, wrt, wmon, wlad, wdet, wh = _storm("jax", fast)
    gm, grt, gmon, glad, gdet, gh = _storm("port")
    assert not diff_metrics(wm, gm)
    assert gm.by_domain["r0"].total_requests > 0
    assert grt.dead_units() == wrt.dead_units() == {"v5e": 4, "spot": 7}
    assert gdet.dead_units() == wdet.dead_units()
    assert (gmon.replans, gmon.spikes) == (wmon.replans, wmon.spikes)
    assert gmon.replans >= 1
    assert (glad.level, sorted(glad._orig)) == (wlad.level, sorted(wlad._orig))
    assert ([(s.idx, s.tup.key, s.retire_at, s.degraded)
             for s in grt.servers]
            == [(s.idx, s.tup.key, s.retire_at, s.degraded)
                for s in wrt.servers])
    assert gh.registry.render() == wh.registry.render()
    assert gh.tracer.chrome_trace() == wh.tracer.chrome_trace()
    assert ([e.to_dict() for e in gh.audit.events]
            == [e.to_dict() for e in wh.audit.events])


def test_detector_accumulates_and_forgets_like_jax():
    runs = []
    for pkg in ("jax", "port"):
        _, rt, _, _, det, _ = _storm(pkg, True)
        det.observe(rt)
        seen = [det.dead_units(), det.bins_observed]
        det.forget("spot")
        seen.append(det.dead_units())
        det.forget()
        seen.append(det.dead_units())
        runs.append(seen)
    assert runs[1] == runs[0]
    assert runs[1][0] == {"v5e": 8, "spot": 14}


def test_ladder_rungs_match_jax():
    """The ladder's gate / escalate / relax sequence, hold-downs included,
    on each package's runtime, gives the same verdicts, levels and
    downshifted tuples."""
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            mod, chaos, Pl, Pr = jrt, jchaos, Planner, Profiler
            cluster, graph = chaos_cluster(), get_app("social_media")
        else:
            mod, chaos, Pl, Pr = prt, pchaos, PPlanner, PProfiler
            cluster, graph = pchaos_cluster(), papps.get_app("social_media")
        prof = Pr(graph, cluster=cluster)
        cfg = Pl(graph, prof, s_avail=cluster.total_units, **KW).plan(15.0)
        ladder = chaos.DegradationLadder(profiler=prof, escalate_step=2,
                                         escalate_hold_s=1.0,
                                         relax_hold_s=2.0)
        rt = mod.ClusterRuntime(graph, cfg, mod.SimBackend(), seed=0,
                                cluster=cluster, ladder=ladder)
        rows = []
        for t, op in ((10.0, "esc"), (10.5, "esc"), (11.5, "esc"),
                      (12.0, "rel"), (13.6, "rel"), (14.0, "esc"),
                      (16.1, "rel"), (18.5, "rel"), (21.0, "rel")):
            (ladder.escalate if op == "esc" else ladder.relax)(rt, t)
            rows.append((ladder.level, sorted(
                (s.idx, s.tup.key) for s in rt.servers if s.degraded)))
        rt.queues[graph.entry].extend(range(10_000))
        rows.append(ladder.gate(rt, graph.entry, 0.0))
        out.append(rows)
    assert out[1] == out[0]
    assert max(r[0] for r in out[1][:-1]) == 3
