"""The port's own control plane against the JAX package's.

``repro_torch.runtime.ClusterRuntime`` (with its copies of ``core`` and the
names it reads of ``hwspec``) must give ``SimMetrics`` field-exact to
``repro.runtime.ClusterRuntime`` on the same graph, plan, scenario and
seed, in both event loops: the same completions, drops and drop reasons,
the same latency list in the same order, the same per-app and per-domain
ledgers.  The copied app graphs are held field by field against the
originals, and the port's ``EngineBackend`` drives the port's runtime on
the reduced configs on the CPU.

Each runtime gets the plan of its own package's planner on its own
package's cluster, once per module, with a node budget that binds long
before the wall-clock one (``bb_time_s`` is far above what the plans take,
so CPU load cannot change them); the port's plan is held field by field
against the JAX planner's.
"""
import dataclasses

import numpy as np

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import apps as jax_apps  # noqa: E402
from repro.core.milp import Planner  # noqa: E402
from repro.core.profiler import Profiler  # noqa: E402
from repro.hwspec import chaos_cluster  # noqa: E402
from repro import runtime as jrt  # noqa: E402

from repro_torch.core import apps as port_apps  # noqa: E402
from repro_torch.core.milp import Planner as PortPlanner  # noqa: E402
from repro_torch.core.milp import PlanConfig, TupleVar  # noqa: E402
from repro_torch.core.profiler import Profiler as PortProfiler  # noqa: E402
from repro_torch.hwspec import chaos_cluster as port_chaos_cluster  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch.runtime.metrics import diff_metrics  # noqa: E402

# The node budget binds: bb_time_s is a ceiling the plans never reach.
PLAN_KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=120.0)
SCENARIOS = ("poisson", "burst", "failures_capacity", "domain_failure",
             "preemption")


def _port_plan(graph, cfg) -> PlanConfig:
    """The JAX plan ``cfg`` as the port's PlanConfig over ``graph``."""
    return PlanConfig(
        graph=graph, counts=dict(cfg.counts),
        tuples={k: TupleVar(**dataclasses.asdict(t))
                for k, t in cfg.tuples.items()},
        demand=dict(cfg.demand),
        pool_budgets=(None if cfg.pool_budgets is None
                      else dict(cfg.pool_budgets)))


def _plans(name: str, rps: float, cluster=None, pcluster=None):
    """``name`` planned for ``rps`` by the JAX planner and by the port's,
    each on its own package's graph, profiler and cluster."""
    graph, pgraph = jax_apps.get_app(name), port_apps.get_app(name)
    kw = {} if cluster is None else dict(cluster=cluster)
    pkw = {} if pcluster is None else dict(cluster=pcluster)
    jprof, pprof = Profiler(graph, **kw), PortProfiler(pgraph, **pkw)
    cfg = Planner(graph, jprof, s_avail=jprof.cluster.total_units,
                  **PLAN_KW).plan(rps)
    pcfg = PortPlanner(pgraph, pprof, s_avail=pprof.cluster.total_units,
                       **PLAN_KW).plan(rps)
    assert cfg is not None and pcfg is not None
    return (graph, cfg), (pgraph, pcfg)


@pytest.fixture(scope="module")
def fleet():
    """social_media on the chaos cluster (two racks, a spot pool), planned
    for 15 rps: the JAX package's cluster and plan for its runtime, the
    port's for the port's."""
    cluster, pcluster = chaos_cluster(), port_chaos_cluster()
    return (cluster, pcluster), *_plans("social_media", 15.0, cluster,
                                        pcluster)


def _scenario(mod, name: str):
    """The scenario ``name`` built from runtime package ``mod``."""
    base = mod.Scenario.poisson(12.0, duration_s=8.0, warmup_s=1.0)
    if name == "poisson":
        return base
    if name == "burst":
        return mod.Scenario.burst(6.0, 24.0, duration_s=6.0, warmup_s=1.0)
    if name == "failures_capacity":
        return (base.with_failures(
            mod.FailureEvent(at_s=2.0, task="classify", count=1))
            .with_capacity(
                mod.CapacityEvent(at_s=3.0, task="classify", delta=2),
                mod.CapacityEvent(at_s=6.0, task="classify", delta=-1)))
    if name == "domain_failure":
        return base.with_chaos(mod.DomainFailureEvent(at_s=2.5, domain="r0"))
    if name == "preemption":
        return base.with_chaos(mod.PreemptionEvent(at_s=2.0, pool="spot",
                                                   notice_s=1.5))
    raise KeyError(name)


def _assert_same(want, got, what: str):
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    d = diff_metrics(want, got)
    assert not d, (f"{what}: the port's runtime diverged ({len(d)} fields):"
                   "\n" + "\n".join(d[:20]))
    assert got.completions > 0, f"{what}: degenerate scenario"


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_cluster_runtime_matches_jax(fleet, name, fast):
    (cluster, pcluster), (graph, cfg), (pgraph, pcfg) = fleet
    want = jrt.ClusterRuntime(graph, cfg, jrt.SimBackend(), seed=0,
                              cluster=cluster, fast=fast).run(
        _scenario(jrt, name))
    got = prt.ClusterRuntime(pgraph, pcfg, prt.SimBackend(), seed=0,
                             cluster=pcluster, fast=fast).run(
        _scenario(prt, name))
    _assert_same(want, got, f"{name} ({'fast' if fast else 'legacy'})")
    if name == "domain_failure":
        assert "r0" in got.by_domain
    if name == "preemption":
        assert got.dropped + got.completions > 0


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_multi_app_matches_jax(fast):
    apps, papps = {}, {}
    for name in ("social_media", "traffic_analysis"):
        apps[name], papps[name] = _plans(name, 20.0)
    want = jrt.ClusterRuntime.multi(apps, jrt.SimBackend(), seed=1,
                                    fast=fast).run(jrt.Scenario.multi(
        {n: jrt.PoissonArrivals(15.0) for n in apps},
        duration_s=6.0, warmup_s=1.0))
    got = prt.ClusterRuntime.multi(papps, prt.SimBackend(), seed=1,
                                   fast=fast).run(prt.Scenario.multi(
        {n: prt.PoissonArrivals(15.0) for n in papps},
        duration_s=6.0, warmup_s=1.0))
    _assert_same(want, got, "multi-app")
    assert set(got.by_app) == set(apps)
    for name, (pg, _) in papps.items():
        assert (got.by_app[name].realized_a_obj(pg)
                == want.by_app[name].realized_a_obj(apps[name][0]))


@pytest.mark.parametrize("name", sorted(jax_apps.APPS))
def test_apps_are_copies(name):
    """Every app graph of the port equals the original field by field,
    derived fields (paths, entry, path fractions) included."""
    want, got = jax_apps.get_app(name), port_apps.get_app(name)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "tasks":
            assert list(g) == list(w)
            for t in w:
                assert dataclasses.asdict(g[t]) == dataclasses.asdict(w[t])
        else:
            assert g == w, f.name
    assert got.paths == want.paths and got.entry == want.entry


def test_plan_config_matches_jax(fleet):
    """The port's planner gives the JAX planner's plan, field by field,
    and the copied PlanConfig derives the same slices, latencies,
    throughputs and exact accuracy objective as the original."""
    (cluster, _), (graph, cfg), (pgraph, pcfg) = fleet
    want = _port_plan(pgraph, cfg)
    assert pcfg.counts == want.counts
    assert pcfg.tuples == want.tuples
    assert pcfg.demand == want.demand
    assert pcfg.pool_budgets == want.pool_budgets
    assert pcfg.slices == cfg.slices
    assert pcfg.pool_slices() == cfg.pool_slices()
    assert pcfg.worst_path_latency() == cfg.worst_path_latency()
    assert pcfg.exact_a_obj() == cfg.exact_a_obj()
    for t in graph.tasks:
        assert pcfg.task_throughput(t) == cfg.task_throughput(t)
        assert (pcfg.task_effective_accuracy(t)
                == cfg.task_effective_accuracy(t))
    assert (pcfg.feasible(graph.slo_latency_ms, 0.5, cluster.total_units)
            == cfg.feasible(graph.slo_latency_ms, 0.5, cluster.total_units))
    assert ([(dataclasses.asdict(t), m) for t, m in pcfg.instances()]
            == [(dataclasses.asdict(t), m) for t, m in cfg.instances()])


def test_pool_and_domain_names_are_checked(fleet):
    (_, cluster), (graph, cfg), (pgraph, pcfg) = fleet
    from repro_torch.hwspec import (DEFAULT_POOL, validate_domain_names,
                                    validate_pool_names)
    from repro.hwspec import DEFAULT_POOL as JAX_DEFAULT_POOL
    assert DEFAULT_POOL == JAX_DEFAULT_POOL
    validate_pool_names(None, [DEFAULT_POOL], "test")
    validate_pool_names(cluster, [p.name for p in cluster.pools], "test")
    with pytest.raises(ValueError, match="unknown pools"):
        validate_pool_names(cluster, ["nope"], "test")
    with pytest.raises(ValueError, match="unknown failure domains"):
        validate_domain_names(cluster, ["r9"], "test")
    rt = prt.ClusterRuntime(pgraph, pcfg, prt.SimBackend(), cluster=cluster)
    with pytest.raises(ValueError, match="unknown failure domains"):
        rt.run(prt.Scenario.poisson(5.0, duration_s=2.0).with_chaos(
            prt.DomainFailureEvent(at_s=1.0, domain="r9")))


def test_engine_backend_drives_port_runtime():
    """The port's EngineBackend (CPU, reduced archs) under the port's own
    runtime: every arrival is accounted for, one engine per arch served."""
    g = port_apps.get_app("social_media")
    counts, tuples = {}, {}
    for task, variant, lat in (("ingest", "gemma-2b", 150.0),
                               ("classify", "granite-3-2b", 150.0),
                               ("caption", "qwen2-7b", 300.0)):
        key = (task, variant, "1x1s1", 2)
        tuples[key] = TupleVar(task, variant, "1x1s1", 2, latency_ms=lat,
                               throughput=10.0, cost=1,
                               accuracy=g.tasks[task].variant(variant)
                               .accuracy)
        counts[key] = 1
    cfg = PlanConfig(graph=g, counts=counts, tuples=tuples,
                     demand={t: 2.0 for t in g.tasks})
    be = prt.EngineBackend(max_batch=2, max_seq=16, prompt_len=4,
                           max_new=2, device="cpu")
    assert isinstance(be, prt.ExecutionBackend)
    assert isinstance(be, jrt.ExecutionBackend)   # fits the reference too
    scn = prt.Scenario.poisson(2.0, duration_s=3.0, warmup_s=0.0)
    m = prt.ClusterRuntime(g, cfg, be, seed=5).run(scn)
    assert isinstance(m, prt.SimMetrics)
    assert m.completions > 0
    assert set(be._engines) == {"gemma-2b", "granite-3-2b", "qwen2-7b"}
    assert 0.0 <= m.violation_rate <= 1.0
    assert 0.0 < m.realized_a_obj(g) <= 1.0 + 1e-9


@pytest.mark.parametrize("pool,n", [("h100", 1), ("mig", 3), ("v5e", 2),
                                    ("spot", 4)])
def test_engine_backend_time_scales(monkeypatch, pool, n):
    """``time_scale`` and ``pool_time_scale`` scale the measured wall as
    the reference's ``EngineBackend.scale_for`` does: a mapped pool by its
    own scale, an unmapped one by ``time_scale``, times the launches a
    batch of ``n`` needs.  The clock is stubbed, so the wall is exact."""
    from types import SimpleNamespace
    from repro_torch.runtime import backend as port_backend

    g = port_apps.get_app("social_media")
    scales = {"h100": 4.0, "mig": 0.25}
    wall = 0.125
    ticks = iter([10.0, 10.0 + wall, 20.0, 20.0 + wall])
    monkeypatch.setattr(port_backend, "time",
                        SimpleNamespace(monotonic=lambda: next(ticks)))
    be = prt.EngineBackend(max_batch=2, max_seq=16, prompt_len=4, max_new=2,
                           device="cpu", time_scale=2.5,
                           pool_time_scale=scales)
    plain = prt.EngineBackend(max_batch=2, max_seq=16, prompt_len=4,
                              max_new=2, device="cpu")
    ref = jrt.EngineBackend(max_batch=2, time_scale=2.5,
                            pool_time_scale=scales)
    for b in (be, plain):
        b.bind(g, None)
    plain._engines = be._engines      # one engine build for both
    v = g.tasks["ingest"].variant("gemma-2b")
    server = SimpleNamespace(app="", tup=TupleVar(
        "ingest", v.name, "1x1s1", 2, latency_ms=1.0, throughput=1.0,
        cost=1, accuracy=v.accuracy, pool=pool))
    launches = -(-n // 2)
    rng = np.random.default_rng(0)
    got = be.service_s(server, [None] * n, 0.0, rng)
    assert be.scale_for(pool) == ref.scale_for(pool)
    assert got == wall * launches * ref.scale_for(pool)
    assert plain.service_s(server, [None] * n, 0.0, rng) == wall * launches
    assert plain.scale_for(pool) == 1.0
