"""The port's control loop (``repro_torch.core.controller``) against the
JAX package's, and a CPU rehearsal of ``chip_smoke.py``'s control phase.

Each loop runs the same bins in both packages: the verify skill's bin
loop (social_media over an eight-bin diurnal trace), the same app on the
chaos cluster with the whole chaos plane attached (staged transitions, a
failure detector, the emergency monitor, the degradation ladder, hooks and
SLO-driven re-planning), and a two-app ``MultiAppController``.  Their bin
reports must be equal field by field except ``milp_ms`` (host time of the
solve), and so must the hooks' exports except what holds host time: the
``replan_latency_seconds`` histogram's buckets and sum and the audit log's
``solve_ms``.  Every planner binds by its node budget (``bb_time_s`` far
above what a plan takes), so CPU load cannot change a plan.

The rehearsal runs ``chip_smoke.phase_control`` on reduced engines on the
CPU, with the kernel wrappers replaced by counting plain versions, and
holds that each of its checks fires: a staged transition charged to a
second bin, one hook call dropped, and a detector that reports the wrong
dead units must each fail the phase.
"""
import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.chaos import DegradationLadder, EmergencyReplanner  # noqa: E402
from repro.chaos import FailureDetector  # noqa: E402
from repro.core.apps import get_app  # noqa: E402
from repro.core.controller import Controller, MultiAppController  # noqa: E402
from repro.core.frontend import Frontend  # noqa: E402
from repro.core.milp import Planner  # noqa: E402
from repro.core.profiler import Profiler  # noqa: E402
from repro.core.trace import diurnal_trace  # noqa: E402
from repro.hwspec import chaos_cluster  # noqa: E402
from repro.obs import AuditLog, Instrumentation, SloPlane, Tracer  # noqa: E402
from repro.reconfig import TransitionPlanner  # noqa: E402

from repro_torch import chaos as pchaos  # noqa: E402
from repro_torch import obs as pobs  # noqa: E402
from repro_torch import reconfig as preconfig  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch.core import apps as papps  # noqa: E402
from repro_torch.core import controller as pcontroller  # noqa: E402
from repro_torch.core.frontend import Frontend as PFrontend  # noqa: E402
from repro_torch.core.milp import Planner as PPlanner  # noqa: E402
from repro_torch.core.profiler import Profiler as PProfiler  # noqa: E402
from repro_torch.hwspec import chaos_cluster as pchaos_cluster  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
# The node budget binds: bb_time_s is a ceiling no plan here reaches.
KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=120.0)
SKILL_KW = dict(max_tuples_per_task=32, bb_nodes=4, bb_time_s=120.0)
HOST_TIME_FAMILY = "jigsaw_replan_latency_seconds"


def _report(rep) -> dict:
    """A bin report as a dict without its host-time field(s)."""
    d = dataclasses.asdict(rep)
    d.pop("milp_ms")
    return d


def _exposition(hooks) -> list:
    """The registry's text without the host-time histogram's buckets and
    sum (its ``_count``, the number of re-plans, stays)."""
    return [line for line in hooks.registry.render().splitlines()
            if not (line.startswith(HOST_TIME_FAMILY)
                    and not line.startswith(HOST_TIME_FAMILY + "_count"))]


def _audit(hooks) -> list:
    """The audit events without the re-plans' host-time ``solve_ms``."""
    out = []
    for e in hooks.audit.events:
        d = e.to_dict()
        d.get("detail", {}).pop("solve_ms", None)
        out.append(d)
    return out


def test_skill_bin_loop_matches_jax():
    """The verify skill's loop: social_media, s_avail=64, eight diurnal
    bins scaled to 120 rps, four simulated seconds each."""
    rps = diurnal_trace(seed=2, bins=8).scaled_to_max(120.0).rps
    g, pg = get_app("social_media"), papps.get_app("social_media")
    ctl = Controller(g, Profiler(g), s_avail=64, planner_kwargs=SKILL_KW)
    pctl = pcontroller.Controller(pg, PProfiler(pg), s_avail=64,
                                  planner_kwargs=SKILL_KW)
    replans = 0
    for i, r in enumerate(rps):
        want = ctl.step(i, float(r), sim_seconds=4.0, seed=i)
        got = pctl.step(i, float(r), sim_seconds=4.0, seed=i)
        assert type(got).__name__ == "BinReport"
        assert _report(got) == _report(want), i
        replans += got.replanned
    assert 2 <= replans < len(rps)
    assert len(pctl.milp_times_ms) == len(ctl.milp_times_ms)
    assert pctl.planner.dead_units == ctl.planner.dead_units
    assert pctl._fbar == ctl._fbar


def _chaos_controller(pkg: str):
    """social_media on the chaos cluster with the chaos plane attached,
    built from one package's modules; returns the controller and its
    hooks, detector, monitor and ladder."""
    if pkg == "jax":
        C, Pl, Pr, F, TP = (Controller, Planner, Profiler, Frontend,
                            TransitionPlanner)
        cluster, g = chaos_cluster(), get_app("social_media")
        I, T, S, A = Instrumentation, Tracer, SloPlane, AuditLog
        D, E, L = FailureDetector, EmergencyReplanner, DegradationLadder
    else:
        C, Pl, Pr, F, TP = (pcontroller.Controller, PPlanner, PProfiler,
                            PFrontend, preconfig.TransitionPlanner)
        cluster, g = pchaos_cluster(), papps.get_app("social_media")
        I, T, S, A = (pobs.Instrumentation, pobs.Tracer, pobs.SloPlane,
                      pobs.AuditLog)
        D, E, L = (pchaos.FailureDetector, pchaos.EmergencyReplanner,
                   pchaos.DegradationLadder)
    prof = Pr(g, cluster=cluster)
    hooks = I(tracer=T(), slo=S(), audit=A())
    det, lad = D(), L(profiler=prof)
    mon = E(F(g), planner=Pl(g, prof, s_avail=cluster.total_units,
                             stickiness=0.05, **KW),
            reconfig=TP(cluster, g), hooks=hooks)
    ctl = C(g, prof, s_avail=cluster.total_units,
            planner_kwargs=dict(KW, stickiness=0.25),
            reconfig=TP(cluster, g), detector=det, monitor=mon, ladder=lad,
            hooks=hooks, slo_replan=True)
    return ctl, hooks, det, mon, lad


CHAOS_BINS = (15.0, 30.0, 30.0, 22.0, 40.0)
CHAOS_FAIL_BIN = 2


def _chaos_scenario(mod, i: int, rps: float):
    sc = mod.Scenario.poisson(rps, duration_s=6.0, warmup_s=1.0)
    if i == CHAOS_FAIL_BIN:
        sc = sc.with_chaos(mod.DomainFailureEvent(at_s=2.0, domain="r0"))
    return sc


@pytest.fixture(scope="module")
def chaos_runs():
    """Both packages' chaos-plane controllers through the same bins:
    their reports, the detector's units, the monitor's replans and the
    ladder's level after each bin, and the controllers and hooks."""
    import repro.runtime as jrt
    out = {}
    for pkg, mod in (("jax", jrt), ("port", prt)):
        ctl, hooks, det, mon, lad = _chaos_controller(pkg)
        rows = []
        for i, r in enumerate(CHAOS_BINS):
            rep = ctl.step(i, r, scenario=_chaos_scenario(mod, i, r),
                           seed=i)
            rows.append((_report(rep), det.dead_units(), mon.replans,
                         mon.spikes, lad.level))
        out[pkg] = (rows, ctl, hooks)
    return out


def test_chaos_loop_reports_match_jax(chaos_runs):
    want, wctl, _ = chaos_runs["jax"]
    got, gctl, _ = chaos_runs["port"]
    assert got == want
    assert gctl.planner.dead_units == wctl.planner.dead_units
    assert gctl._config.counts == wctl._config.counts
    reports = [r[0] for r in got]
    # the loop exercised what it claims to: a staged transition, the
    # domain failure's dead units reaching the next bin, a re-plan
    assert any(r["transition_actions"] > 0 for r in reports)
    assert got[CHAOS_FAIL_BIN][1] and reports[CHAOS_FAIL_BIN + 1]["replanned"]
    assert sum(r["replanned"] for r in reports) >= 2


def test_chaos_loop_hooks_match_jax(chaos_runs):
    """The shared hooks' exports after the whole loop: registry text and
    snapshot (host-time histogram aside), Chrome trace, audit events and
    the SLO plane's alerts."""
    _, _, want = chaos_runs["jax"]
    _, _, got = chaos_runs["port"]
    assert _exposition(got) == _exposition(want)
    snap = [s for s in got.registry.snapshot()
            if not s[0].startswith(HOST_TIME_FAMILY + "_sum")]
    wsnap = [s for s in want.registry.snapshot()
             if not s[0].startswith(HOST_TIME_FAMILY + "_sum")]
    assert [tuple(s) for s in snap] == [tuple(s) for s in wsnap]
    assert got.tracer.chrome_trace() == want.tracer.chrome_trace()
    assert _audit(got) == _audit(want)
    assert got.slo.alerts_json() == want.slo.alerts_json()
    kinds = {e.kind for e in got.audit.events}
    assert {"replan", "dead_units", "violation"} <= kinds


def test_multi_app_controller_matches_jax():
    names = ("social_media", "traffic_analysis")
    bins = ({"social_media": 30.0, "traffic_analysis": 10.0},
            {"social_media": 45.0, "traffic_analysis": 10.0},
            {"social_media": 45.0, "traffic_analysis": 20.0})
    runs = {}
    for pkg in ("jax", "port"):
        C = MultiAppController if pkg == "jax" \
            else pcontroller.MultiAppController
        ga = get_app if pkg == "jax" else papps.get_app
        P = Profiler if pkg == "jax" else PProfiler
        graphs = {n: ga(n) for n in names}
        ctl = C(graphs, {n: P(g) for n, g in graphs.items()}, s_avail=64,
                planner_kwargs=SKILL_KW)
        reps = []
        for i, d in enumerate(bins):
            rep = ctl.step(i, d, sim_seconds=4.0, seed=i)
            assert type(rep).__name__ == "MultiBinReport"
            reps.append(_report(rep))
        runs[pkg] = (reps, ctl._fbar)
    assert runs["port"] == runs["jax"]
    assert sum(r["replanned"] for r in runs["port"][0]) >= 2


class _Roots:
    """Hooks that file each root's leaf outcomes under its id."""

    def __init__(self):
        self.outcomes = {}

    def on_drop(self, app, task, reason, n, now, root_id=-1):
        self.outcomes[root_id] = self.outcomes.get(root_id, 0) + n

    def on_complete(self, app, root_id, latency_ms, missed, now):
        self.outcomes[root_id] = self.outcomes.get(root_id, 0) + 1

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **kw: None
        raise AttributeError(name)


def test_port_controller_on_engine_backend_accounts_every_root():
    """Two bins of the port's Controller serving on the port's
    EngineBackend (reduced archs, CPU): in each, every root arrival ends
    completed or dropped at each of its leaves and the queues drain."""
    g = papps.get_app("social_media")
    leaves = len(g.paths)
    hooks = _Roots()
    backend = prt.EngineBackend(max_batch=2, max_seq=16, prompt_len=4,
                                max_new=2, device="cpu")
    ctl = pcontroller.Controller(g, PProfiler(g), s_avail=64,
                                 planner_kwargs=SKILL_KW,
                                 backend_factory=lambda: backend,
                                 hooks=hooks)
    runtimes = []
    make = ctl.make_runtime

    def kept(**kw):
        runtimes.append(make(**kw))
        return runtimes[-1]
    ctl.make_runtime = kept
    for i, r in enumerate((2.0, 3.0)):
        hooks.outcomes = {}
        rep = ctl.step(i, r, seed=i, scenario=prt.Scenario.poisson(
            r, duration_s=3.0, warmup_s=0.0))
        rt = runtimes[-1]
        roots = set(rt._root_t)
        assert roots and set(hooks.outcomes) == roots
        assert all(n == leaves for n in hooks.outcomes.values())
        assert rep.completions > 0
        assert sum(len(q) for q in rt.queues.values()) == 0
    assert ctl.backend is backend
    assert set(backend._engines) <= {"gemma-2b", "granite-3-2b", "qwen2-7b"}


# ---------------------------------------------------------------------------
# chip_smoke.py's control phase, rehearsed on the CPU
# ---------------------------------------------------------------------------
# A calibration at which one card's plan changes at 3 rps, so the trace's
# peak stays at the compound rate (a calibration without a change below
# about 24 rps raises the peak, and the rehearsal would serve for minutes).
REHEARSAL_FIT = dict(flops_efficiency=0.40, hbm_efficiency=0.26)


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke`` and the plan phase's hand-over, built on the CPU:
    reduced engines, the fitted H100 spec above, scale 4, a pinned H2D
    rate read on an H100."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.hwspec import H100_SXM
    graph = papps.get_app(chip_smoke.COMPOUND_APP)
    backend = prt.EngineBackend(reduced=True, device="cpu", max_batch=8,
                                max_seq=32, prompt_len=8,
                                max_new=chip_smoke.SERVE_NEW)
    backend.bind(graph, None)
    for arch in chip_smoke._archs(graph):
        backend._engine_for(arch)
    planned = {"backend": backend, "graph": graph, "slo_scale": 4.0,
               "fitted": dataclasses.replace(H100_SXM, **REHEARSAL_FIT),
               "h2d_bytes_per_s": 46.15e9}
    return chip_smoke, planned


def _counting(mod, plain):
    def launch(*args, **kw):
        mod.launches += 1
        return plain(*args, **kw)
    return launch


def _mutate(monkeypatch, fault: str):
    if fault == "transition_charged_twice":
        orig = pcontroller.Controller.make_runtime
        last = {}

        def sticky(self, *, seed=0, time_base_s=0.0, transition=None):
            tr = last.get("tr")
            if transition is not None:
                last["tr"] = transition
            elif tr is not None and tr.target[""].counts == \
                    self._config.counts:
                transition = tr
            return orig(self, seed=seed, time_base_s=time_base_s,
                        transition=transition)
        monkeypatch.setattr(pcontroller.Controller, "make_runtime", sticky)
    elif fault == "dropped_hook_call":
        orig = pobs.Instrumentation.on_complete
        seen = []

        def lossy(self, *args, **kw):
            seen.append(1)
            if len(seen) != 3:
                orig(self, *args, **kw)
        monkeypatch.setattr(pobs.Instrumentation, "on_complete", lossy)
    elif fault == "wrong_dead_units":
        orig = pchaos.FailureDetector.observe

        def wrong(self, runtime):
            for pool in runtime.dead_units():
                self._units[pool] = self._units.get(pool, 0) + 1
            return orig(self, runtime)
        monkeypatch.setattr(pchaos.FailureDetector, "observe", wrong)


@pytest.mark.parametrize("fault,fails_on", [
    (None, None),
    ("transition_charged_twice", "charged"),
    ("dropped_hook_call", "instrumentation"),
    ("wrong_dead_units", "detection")])
def test_chip_smoke_control_phase_rehearsal(smoke, monkeypatch, fault,
                                            fails_on, capsys):
    chip_smoke, planned = smoke
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(fmod, "flash_attention",
                        _counting(fmod, ref.flash_attention_ref))
    monkeypatch.setattr(dmod, "decode_attention",
                        _counting(dmod, ref.decode_attention_ref))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **kw: 0)
    _mutate(monkeypatch, fault)
    card = {"nvidia_smi": "cpu rehearsal"}
    if fails_on is None:
        launches = chip_smoke.phase_control(torch, card, 0, planned)
        assert set(launches) <= set(chip_smoke._archs(planned["graph"]))
        line = capsys.readouterr().out
        assert '"phase": "control"' in line and '"failures": []' in line
        return
    with pytest.raises(AssertionError, match=f"control: .*{fails_on}"):
        chip_smoke.phase_control(torch, card, 0, planned)
