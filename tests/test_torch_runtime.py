"""The port's own control plane against the JAX package's.

``repro_torch.runtime.ClusterRuntime`` (with its copies of ``core`` and the
names it reads of ``hwspec``) must give ``SimMetrics`` field-exact to
``repro.runtime.ClusterRuntime`` on the same graph, plan, scenario and
seed, in both event loops: the same completions, drops and drop reasons,
the same latency list in the same order, the same per-app and per-domain
ledgers.  The copied app graphs are held field by field against the
originals, and the port's ``EngineBackend`` drives the port's runtime on
the reduced configs on the CPU.

Plans come from the JAX planner once per module, with a node budget that
binds long before the wall-clock one (``bb_time_s`` is far above what the
plans take, so CPU load cannot change them); both runtimes get the same
plan, converted field by field into the port's ``PlanConfig``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import apps as jax_apps  # noqa: E402
from repro.core.milp import Planner  # noqa: E402
from repro.core.profiler import Profiler  # noqa: E402
from repro.hwspec import chaos_cluster  # noqa: E402
from repro import runtime as jrt  # noqa: E402

from repro_torch.core import apps as port_apps  # noqa: E402
from repro_torch.core.milp import PlanConfig, TupleVar  # noqa: E402
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


@pytest.fixture(scope="module")
def fleet():
    """social_media on the JAX chaos cluster (two racks, a spot pool),
    planned for 15 rps; the cluster is handed to both runtimes as it is
    (the port's runtime reads it duck-typed)."""
    cluster = chaos_cluster()
    graph = jax_apps.get_app("social_media")
    planner = Planner(graph, Profiler(graph, cluster=cluster),
                      s_avail=cluster.total_units, **PLAN_KW)
    cfg = planner.plan(15.0)
    assert cfg is not None
    pgraph = port_apps.get_app("social_media")
    return cluster, (graph, cfg), (pgraph, _port_plan(pgraph, cfg))


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
    cluster, (graph, cfg), (pgraph, pcfg) = fleet
    want = jrt.ClusterRuntime(graph, cfg, jrt.SimBackend(), seed=0,
                              cluster=cluster, fast=fast).run(
        _scenario(jrt, name))
    got = prt.ClusterRuntime(pgraph, pcfg, prt.SimBackend(), seed=0,
                             cluster=cluster, fast=fast).run(
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
        g = jax_apps.get_app(name)
        cfg = Planner(g, Profiler(g), s_avail=64, **PLAN_KW).plan(20.0)
        assert cfg is not None
        apps[name] = (g, cfg)
        pg = port_apps.get_app(name)
        papps[name] = (pg, _port_plan(pg, cfg))
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
    """The copied PlanConfig derives the same slices, latencies,
    throughputs and exact accuracy objective as the original."""
    cluster, (graph, cfg), (_, pcfg) = fleet
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
    cluster, (graph, cfg), (pgraph, pcfg) = fleet
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
