"""The port's live reconfiguration (``repro_torch.reconfig``) against the
JAX package's ``repro.reconfig``.

For the same incumbent and target, ``TransitionPlanner.plan``,
``plan_joint`` and the ``atomic`` policy must give the same actions (kind,
app, tuple, count, ``ready_s``, ``retire_s``, ``carved``), the same
makespan, repartitioned and blocked pools and audit detail, on the chaos
cluster (the planners' own plans at two demands) and on one MIG-carved
H100 (the port's ``h100_cluster(1)``; the JAX package is handed the same
pool as its own types, since it has no H100 preset).  The port's runtime
then executes the port's transition plans, at its constructor and as a
``TransitionEvent`` mid-run, field-exact against the JAX runtime on the
JAX plans, in both of the JAX runtime's event loops.  Planners bind by
their node budget.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import hwspec as jhw  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.core.apps import get_app  # noqa: E402
from repro.core.milp import JointPlan, Planner  # noqa: E402
from repro.core.profiler import Profiler  # noqa: E402
from repro.hwspec.partition import MigProfile  # noqa: E402
from repro.reconfig import TransitionPlanner  # noqa: E402

from repro_torch import hwspec as phw  # noqa: E402
from repro_torch import runtime as prt  # noqa: E402
from repro_torch.core import apps as papps  # noqa: E402
from repro_torch.core import milp as pmilp  # noqa: E402
from repro_torch.core.profiler import Profiler as PProfiler  # noqa: E402
from repro_torch.reconfig import TransitionPlanner as PTransitionPlanner  # noqa: E402
from repro_torch.runtime.metrics import diff_metrics  # noqa: E402

KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=120.0)


def _jax_h100(devices: int = 1):
    """The port's ``h100_cluster`` rebuilt from the JAX package's types."""
    (pool,) = phw.h100_cluster(devices).pools
    dev = jhw.DeviceSpec(**{f.name: getattr(pool.device, f.name)
                            for f in dataclasses.fields(jhw.DeviceSpec)})
    scheme = jhw.MigScheme(**{
        f.name: (tuple(MigProfile(**dataclasses.asdict(p))
                       for p in pool.scheme.profiles)
                 if f.name == "profiles" else getattr(pool.scheme, f.name))
        for f in dataclasses.fields(jhw.MigScheme) if f.init})
    return jhw.ClusterSpec(pools=(jhw.Pool(pool.name, dev, pool.count,
                                           scheme),))


def _port_cfg(graph, cfg):
    """A JAX PlanConfig as the port's, over the port's ``graph``."""
    return pmilp.PlanConfig(
        graph=graph, counts=dict(cfg.counts),
        tuples={k: pmilp.TupleVar(**dataclasses.asdict(t))
                for k, t in cfg.tuples.items()},
        demand=dict(cfg.demand),
        pool_budgets=(None if cfg.pool_budgets is None
                      else dict(cfg.pool_budgets)))


def _actions(tr) -> dict:
    def rows(acts):
        return [(a.kind, a.app, a.tup.key, a.count, a.ready_s, a.retire_s,
                 a.carved, dataclasses.asdict(a.tup)) for a in acts]
    return {"keeps": rows(tr.keeps), "drains": rows(tr.drains),
            "loads": rows(tr.loads), "makespan_s": tr.makespan_s,
            "n_actions": tr.n_actions, "is_empty": tr.is_empty,
            "repartition_pools": sorted(tr.repartition_pools),
            "blocked_pools": sorted(tr.blocked_pools),
            "audit": tr.audit_detail(),
            "target": {app: sorted(c.counts.items())
                       for app, c in tr.target.items()}}


@pytest.fixture(scope="module")
def chaos_plans():
    """social_media planned at 10 and 40 rps on the chaos cluster by each
    package's planner; the port's plans equal the JAX ones."""
    cluster, pcluster = jhw.chaos_cluster(), phw.chaos_cluster()
    g, pg = get_app("social_media"), papps.get_app("social_media")
    pl = Planner(g, Profiler(g, cluster=cluster),
                 s_avail=cluster.total_units, **KW)
    ppl = pmilp.Planner(pg, PProfiler(pg, cluster=pcluster),
                        s_avail=pcluster.total_units, **KW)
    lo, hi = pl.plan(10.0), pl.plan(40.0)
    plo, phi = ppl.plan(10.0), ppl.plan(40.0)
    assert lo.counts != hi.counts
    assert (plo.counts, phi.counts) == (lo.counts, hi.counts)
    return (cluster, g, lo, hi), (pcluster, pg, plo, phi)


def _h100_cfg(mod, graph, rows):
    """A plan on one H100 from (task, variant, slice, batch, count,
    latency_ms, throughput, g-units) rows, in package ``mod``'s types."""
    counts, tuples = {}, {}
    for task, var, seg, batch, m, lat, thr, cost in rows:
        tup = mod.TupleVar(task, var, seg, batch, latency_ms=lat,
                           throughput=thr, cost=cost,
                           accuracy=graph.tasks[task].variant(var).accuracy,
                           pool="h100", streams=int(seg[-1]))
        counts[tup.key], tuples[tup.key] = m, tup
    return mod.PlanConfig(graph=graph, counts=counts, tuples=tuples,
                          demand={t: 4.0 for t in graph.tasks})


H100_OLD = (("ingest", "gemma-2b", "1g.20gb.s1", 1, 1, 21.55, 46.0, 1),
            ("classify", "granite-3-2b", "1g.20gb.s2", 8, 1, 383.0, 40.0, 1),
            ("caption", "gemma-2b", "1g.20gb.s4", 8, 1, 1226.1, 26.0, 1))
H100_NEW = (("ingest", "gemma-2b", "1g.20gb.s1", 1, 1, 21.55, 46.0, 1),
            ("classify", "granite-3-2b", "2g.20gb.s2", 8, 1, 250.0, 61.0, 2),
            ("caption", "gemma-2b", "1g.20gb.s4", 8, 2, 1226.1, 26.0, 1),
            ("caption", "qwen2-7b-int8", "3g.40gb.s1", 1, 1, 900.0, 2.0,
             3))


@pytest.fixture(scope="module")
def h100_plans():
    g, pg = get_app("social_media"), papps.get_app("social_media")
    import repro.core.milp as jmilp
    return ((_jax_h100(), g, _h100_cfg(jmilp, g, H100_OLD),
             _h100_cfg(jmilp, g, H100_NEW)),
            (phw.h100_cluster(1), pg, _h100_cfg(pmilp, pg, H100_OLD),
             _h100_cfg(pmilp, pg, H100_NEW)))


CASES = [("staged", {}), ("atomic", {}), ("staged", {"delay_scale": 0.0}),
         ("staged", {"drain_grace_s": 0.75})]


@pytest.mark.parametrize("policy,extra", CASES,
                         ids=["staged", "atomic", "instant", "grace"])
@pytest.mark.parametrize("where", ["chaos", "h100"])
def test_transition_plans_match_jax(chaos_plans, h100_plans, where, policy,
                                    extra):
    (cl, g, lo, hi), (pcl, pg, plo, phi) = (
        chaos_plans if where == "chaos" else h100_plans)
    tp = TransitionPlanner(cl, g, policy=policy, **extra)
    ptp = PTransitionPlanner(pcl, pg, policy=policy, **extra)
    for a, b in ((lo, hi), (hi, lo), (None, hi), (hi, hi)):
        pa = None if a is None else (plo if a is lo else phi)
        pb = plo if b is lo else phi
        assert _actions(ptp.plan(pa, pb)) == _actions(tp.plan(a, b))
    dead = {pcl.pools[0].name: 2}
    assert (_actions(ptp.plan(plo, phi, dead_units=dead))
            == _actions(tp.plan(lo, hi, dead_units=dead)))
    for tup in list(phi.tuples.values())[:4]:
        assert ptp.weight_load_s("", tup) == tp.weight_load_s(
            "", hi.tuples[tup.key])
    if where == "h100" and policy == "staged" and not extra:
        tr = ptp.plan(plo, phi)
        assert tr.loads and any(a.carved for a in tr.loads)
        assert tr.makespan_s > 0.0


def test_joint_transition_matches_jax():
    """``plan_joint`` over two apps, one of them removed by the target
    (its whole fleet drains), and one resized."""
    g1 = _one_task_graph()
    pg1 = _one_task_graph(port=True)
    cluster, pcluster = jhw.tight_hetero_cluster(), phw.tight_hetero_cluster()

    def cfg(mod, graph, seg, count, pool="v5e", cost=1):
        tup = mod.TupleVar("t", "v", seg, 4, 200.0, 20.0, cost, 0.9, pool,
                           streams=1)
        return mod.PlanConfig(graph, {tup.key: count}, {tup.key: tup},
                              {"t": count * 20.0})

    import repro.core.milp as jmilp
    want = TransitionPlanner(cluster, {"a": g1, "b": g1}).plan_joint(
        JointPlan({"a": cfg(jmilp, g1, "1x1s1", 1),
                   "b": cfg(jmilp, g1, "1x1s2", 2)}, {"v5e": 8}, {}),
        JointPlan({"a": cfg(jmilp, g1, "1x2s1", 2, cost=2)}, {"v5e": 8},
                  {}))
    got = PTransitionPlanner(pcluster, {"a": pg1, "b": pg1}).plan_joint(
        pmilp.JointPlan({"a": cfg(pmilp, pg1, "1x1s1", 1),
                         "b": cfg(pmilp, pg1, "1x1s2", 2)}, {"v5e": 8}, {}),
        pmilp.JointPlan({"a": cfg(pmilp, pg1, "1x2s1", 2, cost=2)},
                        {"v5e": 8}, {}))
    assert _actions(got) == _actions(want)
    assert sum(a.count for a in got.drains if a.app == "b") == 2
    assert "b" not in got.target


def _one_task_graph(port: bool = False):
    """A one-task graph whose variant runs gemma-2b."""
    if port:
        from repro_torch.core.taskgraph import Task, TaskGraph, Variant
    else:
        from repro.core.taskgraph import Task, TaskGraph, Variant
    return TaskGraph(name="single", tasks={"t": Task("t", (
        Variant("v", "gemma-2b", accuracy=0.9),))}, edges=[],
        slo_latency_ms=20_000.0, slo_accuracy=0.5)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
@pytest.mark.parametrize("how", ["constructor", "event"])
def test_runtime_executes_transitions_like_jax(chaos_plans, fast, how):
    """The port's runtime runs the port's staged transition (at t=0 on a
    fresh fleet, or as a TransitionEvent on a running one) field-exact
    against the JAX runtime running the JAX plan on the loop that ``fast``
    names, with the transition window's own ledger."""
    (cl, g, lo, hi), (pcl, pg, plo, phi) = chaos_plans
    tr = TransitionPlanner(cl, g).plan(lo, hi)
    ptr = PTransitionPlanner(pcl, pg).plan(plo, phi)
    runs = []
    for mod, graph, a, b, plan, cluster in ((jrt, g, lo, hi, tr, cl),
                                            (prt, pg, plo, phi, ptr, pcl)):
        sc = mod.Scenario.step_change(10.0, 40.0, duration_s=10.0,
                                      warmup_s=0.0, switch_frac=0.4)
        loop = {"fast": fast} if mod is jrt else {}     # the port has one
        if how == "constructor":
            rt = mod.ClusterRuntime(graph, b, mod.SimBackend(), seed=2,
                                    cluster=cluster, transition=plan,
                                    **loop)
        else:
            rt = mod.ClusterRuntime(graph, a, mod.SimBackend(), seed=2,
                                    cluster=cluster, **loop)
            sc = sc.with_transitions(mod.TransitionEvent(at_s=4.0,
                                                         plan=plan))
        runs.append((rt.run(sc), rt))
    (want, wrt), (got, grt) = runs
    assert not diff_metrics(want, got)
    assert got.window is not None and got.window.total_requests > 0
    assert got.transition_window_s == pytest.approx(ptr.makespan_s)
    assert ([(s.idx, s.tup.key, s.retire_at) for s in grt.servers]
            == [(s.idx, s.tup.key, s.retire_at) for s in wrt.servers])


def test_wrong_target_fails_loud_like_jax(chaos_plans):
    (cl, g, lo, hi), (pcl, pg, plo, phi) = chaos_plans
    tr = TransitionPlanner(cl, g).plan(lo, hi)
    ptr = PTransitionPlanner(pcl, pg).plan(plo, phi)
    with pytest.raises(ValueError, match="transition") as want:
        jrt.ClusterRuntime(g, lo, jrt.SimBackend(), transition=tr)
    with pytest.raises(ValueError, match="transition") as got:
        prt.ClusterRuntime(pg, plo, prt.SimBackend(), transition=ptr)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="policy"):
        PTransitionPlanner(pcl, pg, policy="instant")


def test_sticky_planner_matches_jax(chaos_plans):
    """The switching-cost-aware MILP (``stickiness``) plans from the
    incumbent as the JAX package's does."""
    (cl, g, lo, _), (pcl, pg, plo, _) = chaos_plans
    want = Planner(g, Profiler(g, cluster=cl), s_avail=cl.total_units,
                   stickiness=2.0, **KW).plan(60.0, incumbent=lo)
    got = pmilp.Planner(pg, PProfiler(pg, cluster=pcl),
                        s_avail=pcl.total_units, stickiness=2.0,
                        **KW).plan(60.0, incumbent=plo)
    assert got.counts == want.counts
    assert got.exact_a_obj() == want.exact_a_obj()
    assert _port_cfg(pg, want).tuples == got.tuples
