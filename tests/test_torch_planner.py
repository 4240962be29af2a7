"""The port's planning chain against the JAX package's.

Profiler, solvers, planner, placement, registration and the ``Simulator``
shim of ``repro_torch.core`` are copies of the JAX package's, so on the
same inputs they must give the same results exactly, not within a
tolerance: the profile tables key for key and entry for entry, the LP and
MILP solutions bit for bit, the plans (counts, tuples, objective and solve
counters) of every app under every feature ablation and of a joint
multi-app solve, the placements, the registration verdicts and the
simulated ``SimMetrics``.  The plans are bound by their node budget;
``bb_time_s`` is far above what they take, so CPU load cannot change them.
"""
import dataclasses
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import hwspec as jhw  # noqa: E402
from repro.core import apps as japps  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import milp as jmilp  # noqa: E402
from repro.core import placement as jplace  # noqa: E402
from repro.core import profiler as jprof  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.solver import branch_bound as jbb  # noqa: E402
from repro.core.solver import simplex as jsx  # noqa: E402
from repro.core.taskgraph import Task as JTask  # noqa: E402
from repro.core.taskgraph import TaskGraph as JGraph  # noqa: E402
from repro.core.taskgraph import Variant as JVariant  # noqa: E402
from repro.sharding import segments as jseg  # noqa: E402

from repro_torch import hwspec as phw  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import apps as papps  # noqa: E402
from repro_torch.core import baselines as pbase  # noqa: E402
from repro_torch.core import milp as pmilp  # noqa: E402
from repro_torch.core import placement as pplace  # noqa: E402
from repro_torch.core import profiler as pprof  # noqa: E402
from repro_torch.core import registry as preg  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core.solver import branch_bound as pbb  # noqa: E402
from repro_torch.core.solver import simplex as psx  # noqa: E402
from repro_torch.core.taskgraph import Task as PTask  # noqa: E402
from repro_torch.core.taskgraph import TaskGraph as PGraph  # noqa: E402
from repro_torch.core.taskgraph import Variant as PVariant  # noqa: E402
from repro_torch.runtime.metrics import diff_metrics  # noqa: E402

APPS = sorted(japps.APPS)
# The node budget binds: bb_time_s is a ceiling the plans never reach.
PLAN_KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=120.0)
DEMAND = {"social_media": 20.0, "traffic_analysis": 20.0,
          "ar_assistant": 8.0}
CLUSTERS = ("default_cluster", "hetero_cluster")


@pytest.fixture(scope="module")
def profilers():
    """(JAX profiler, port profiler) per (app, cluster preset)."""
    out = {}
    for app, cl in itertools.product(APPS, CLUSTERS):
        out[app, cl] = (
            jprof.Profiler(japps.get_app(app), cluster=getattr(jhw, cl)()),
            pprof.Profiler(papps.get_app(app), cluster=getattr(phw, cl)()))
    return out


def _table(prof):
    return {k: dataclasses.asdict(e) for k, e in prof.table.items()}


def _plan_fields(planner, cfg):
    """Everything a plan says, and its objective as the planner prices it
    (β Σ price·cost·m − α·exact A_obj, paper Eq. 14)."""
    if cfg is None:
        return None
    prices = planner.cluster.prices()
    cost = sum(prices[t.pool] * t.cost * m for t, m in cfg.instances())
    return dict(counts=dict(cfg.counts),
                tuples={k: dataclasses.asdict(t)
                        for k, t in cfg.tuples.items()},
                demand=dict(cfg.demand), pool_budgets=cfg.pool_budgets,
                slices=cfg.slices, pool_slices=cfg.pool_slices(),
                a_obj=cfg.exact_a_obj(),
                worst_path_ms=cfg.worst_path_latency(),
                objective=planner.beta * cost
                - planner.alpha * cfg.exact_a_obj())


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("app", APPS)
def test_profile_tables_equal(profilers, app, cluster):
    """The whole table, key for key and entry for entry, exact."""
    jp, pp = profilers[app, cluster]
    want, got = _table(jp), _table(pp)
    assert list(got) == list(want)
    assert got == want
    assert pp.cluster_implicit == jp.cluster_implicit
    for k in list(want)[::97]:
        assert pp.pool_of(k[2]) == jp.pool_of(k[2])
        assert (pp.get(*k).throughput_per_chip
                == jp.get(*k).throughput_per_chip)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_request_model_equal(arch):
    """FLOP and byte counts of every arch the port has, and the profile of
    one instance on an H100 MIG slice and on a v5e rectangle."""
    from repro.configs import ARCHS as JARCHS
    ja, pa = JARCHS[arch], ARCHS[arch]
    for b, s, g in ((1, 128, 0), (8, 256, 16), (4, 512, 48)):
        assert (pprof.request_flops(pa, "bf16", b, s, g)
                == jprof.request_flops(ja, "bf16", b, s, g))
        for q in ("bf16", "int8"):
            assert (pprof.request_bytes(pa, q, b, s + g)
                    == jprof.request_bytes(ja, q, b, s + g))
    jv, pv = JVariant(arch, arch, 0.9), PVariant(arch, arch, 0.9)
    # the H100 pool given to both profilers (the JAX package has no preset)
    jpool = jhw.Pool("h100", jhw.DeviceSpec(**dataclasses.asdict(
        phw.H100_SXM)), 1, jhw.MigScheme(profiles=tuple(
            jhw.partition.MigProfile(**dataclasses.asdict(p))
            for p in phw.H100_MIG_PROFILES)))
    ppool = phw.h100_cluster(1).pools[0]
    for b in (1, 8):
        for name in ("1g.20gb.s1", "3g.40gb.s2", "7g.80gb.s1"):
            want = jprof.Profiler(JGraph("g", {"t": JTask("t", (jv,))}, []),
                                  table={(None,): None}).profile_one(
                jv, jpool.scheme.slice(name), b, pool=jpool)
            got = pprof.Profiler(PGraph("g", {"t": PTask("t", (pv,))}, []),
                                 table={(None,): None}).profile_one(
                pv, ppool.scheme.slice(name), b, pool=ppool)
            assert ((None if got is None else dataclasses.asdict(got))
                    == (None if want is None else dataclasses.asdict(want)))


def test_observe_refines_equally(profilers):
    jp0, pp0 = profilers["social_media", "default_cluster"]
    jp = jprof.Profiler(jp0.graph, table=dict(jp0.table))
    pp = pprof.Profiler(pp0.graph, table=dict(pp0.table))
    keys = list(jp.table)[:: max(1, len(jp.table) // 25)]
    for i, k in enumerate(keys):
        for ms in (10.0 + i, 250.0, 3.5):
            jp.observe(k, ms)
            pp.observe(k, ms)
    jp.observe(("nope", "v", "s", 1), 1.0)
    pp.observe(("nope", "v", "s", 1), 1.0)
    assert _table(pp) == _table(jp)


# ---------------------------------------------------------------------------
# solvers: the instances of tests/test_solver.py
# ---------------------------------------------------------------------------
def _lp_result(r):
    return (r.status, r.objective, None if r.x is None else r.x.tolist(),
            r.iterations, r.warm_used)


def _milp_result(r):
    return (r.status, r.objective, None if r.x is None else r.x.tolist(),
            r.nodes, r.gap, r.best_bound, r.lp_warm, r.lp_cold,
            r.root_warm)


def _lp_instance(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ub":
        A = rng.normal(size=(5, 3))
        return dict(c=rng.normal(size=3), A_ub=A,
                    b_ub=rng.uniform(0.5, 2.0, size=5))
    if kind == "bounded":
        A = rng.normal(size=(4, 4))
        b = rng.uniform(0.5, 2.0, size=4)
        c = rng.normal(size=4)
        lo = rng.uniform(0.0, 0.3, 4)
        return dict(c=c, A_ub=A, b_ub=b, lo=lo,
                    ub=lo + rng.uniform(0.2, 2.0, 4))
    if kind == "beale":
        return dict(c=np.array([-0.75, 150.0, -0.02, 6.0]),
                    A_ub=np.array([[0.25, -60.0, -1.0 / 25.0, 9.0],
                                   [0.5, -90.0, -1.0 / 50.0, 3.0],
                                   [0.0, 0.0, 1.0, 0.0]]),
                    b_ub=np.array([0.0, 0.0, 1.0]))
    if kind == "degenerate":
        return dict(c=np.array([-1.0, -1.0]),
                    A_ub=np.vstack([[1.0, 1.0]] * 6 + [[1.0, 0.0],
                                                        [0.0, 1.0]]),
                    b_ub=np.array([1.0] * 6 + [1.0, 1.0]))
    if kind == "equality":
        return dict(c=np.array([1.0, 2.0, 3.0]),
                    A_eq=np.array([[1.0, 1.0, 1.0]]), b_eq=np.array([1.0]),
                    ub=np.array([0.5, np.inf, np.inf]))
    if kind == "infeasible":
        return dict(c=np.array([1.0]), A_ub=np.array([[1.0], [-1.0]]),
                    b_ub=np.array([1.0, -2.0]))
    if kind == "unbounded":
        return dict(c=np.array([-1.0]), A_ub=np.array([[-1.0]]),
                    b_ub=np.array([0.0]))
    raise KeyError(kind)


LP_CASES = ([("ub", s) for s in range(12)]
            + [("bounded", s) for s in range(12)]
            + [(k, 0) for k in ("beale", "degenerate", "equality",
                                "infeasible", "unbounded")])


@pytest.mark.parametrize("kind,seed", LP_CASES)
def test_solve_lp_equal(kind, seed):
    inst = _lp_instance(kind, seed)
    assert (_lp_result(psx.solve_lp(**inst))
            == _lp_result(jsx.solve_lp(**inst)))


@pytest.mark.parametrize("seed", range(8))
def test_warm_started_simplex_equal(seed):
    """Bound tightening, a new rhs and a new objective re-solved from the
    parent basis (the B&B and re-planning paths), with the counters."""
    rng = np.random.default_rng(seed)
    n, m = 6, 5
    A = rng.uniform(-0.5, 1.0, size=(m, n))
    b = rng.uniform(1.0, 4.0, size=m)
    c = rng.normal(size=n)
    hi = rng.uniform(1.0, 5.0, n)
    j = int(rng.integers(0, n))
    b2 = b * rng.uniform(0.9, 1.1, m)
    c2 = c + rng.normal(scale=2.0, size=n)
    out = []
    for sx in (jsx, psx):
        s = sx.BoundedSimplex(c, A, b)
        r0 = s.solve(np.zeros(n), hi)
        res = [_lp_result(r0)]
        if r0.status == "optimal":
            hi2 = hi.copy()
            hi2[j] = np.floor(r0.x[j])
            res.append(_lp_result(s.solve(np.zeros(n), hi2, warm=r0.basis)))
            res.append(_lp_result(s.solve(np.zeros(n), hi, b=b2,
                                          warm=r0.basis)))
            res.append(_lp_result(s.solve(np.zeros(n), hi, c=c2,
                                          warm=r0.basis)))
        out.append((res, dataclasses.asdict(s.stats)))
    assert out[1] == out[0]


def _milp_instance(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "brute":
        A = rng.uniform(0, 1, size=(4, 4))
        return (rng.normal(size=4), A, rng.uniform(1, 4, size=4),
                np.full(4, 4.0), np.ones(4, bool), 3000)
    if kind == "cap":
        A = rng.uniform(0.1, 1.0, size=(6, 8))
        return (-rng.uniform(0.5, 1.5, size=8), A,
                rng.uniform(2.0, 4.0, size=6), np.full(8, 6.0),
                np.ones(8, bool), 3)
    if kind == "integral":
        A = rng.uniform(0, 1, (6, 6))
        return (rng.normal(size=6), A, rng.uniform(2, 5, 6),
                np.full(6, 10.0), np.ones(6, bool), 500)
    if kind == "mixed":
        return (np.array([-1.0, -1.0]), np.array([[1.0, 0.0], [0.0, 1.0]]),
                np.array([1.5, 2.5]), np.array([np.inf, np.inf]),
                np.array([False, True]), 50)
    raise KeyError(kind)


MILP_CASES = ([("brute", s) for s in range(10)]
              + [("cap", s) for s in (3, 4, 5)]
              + [("integral", s) for s in (7, 8)] + [("mixed", 0)])


@pytest.mark.parametrize("kind,seed", MILP_CASES)
def test_solve_milp_equal(kind, seed):
    c, A, b, ub, mask, nodes = _milp_instance(kind, seed)
    want = jbb.solve_milp(c, A, b, None, None, ub, mask, max_nodes=nodes,
                          time_limit_s=120.0)
    got = pbb.solve_milp(c, A, b, None, None, ub, mask, max_nodes=nodes,
                         time_limit_s=120.0)
    assert _milp_result(got) == _milp_result(want)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ablation", list(jbase.ANALYTICAL_BASELINES))
@pytest.mark.parametrize("app", APPS)
def test_planner_equal_under_every_ablation(profilers, app, ablation):
    """The same plan and objective for every app under each of the eight
    feature ablations (paper Table 1), and the same solve counters."""
    jp, pp = profilers[app, "default_cluster"]
    jfs = jbase.ANALYTICAL_BASELINES[ablation]
    pfs = pbase.ANALYTICAL_BASELINES[ablation]
    assert dataclasses.asdict(pfs) == dataclasses.asdict(jfs)
    assert pfs.label == jfs.label
    s_avail = jp.cluster.total_units
    jpl = jmilp.Planner(jp.graph, jp, s_avail=s_avail, features=jfs,
                        **PLAN_KW)
    ppl = pmilp.Planner(pp.graph, pp, s_avail=s_avail, features=pfs,
                        **PLAN_KW)
    for demand in (DEMAND[app], 1.3 * DEMAND[app]):   # the second warm
        want = _plan_fields(jpl, jpl.plan(demand))
        got = _plan_fields(ppl, ppl.plan(demand))
        assert got == want
        assert got is not None or ablation == "Unopt"
    assert dataclasses.asdict(ppl.stats) == dataclasses.asdict(jpl.stats)


def test_baseline_tables_equal():
    for name in ("ANALYTICAL_BASELINES", "EMPIRICAL_BASELINES"):
        want, got = getattr(jbase, name), getattr(pbase, name)
        assert list(got) == list(want)
        assert ({k: dataclasses.asdict(v) for k, v in got.items()}
                == {k: dataclasses.asdict(v) for k, v in want.items()})
    assert pbase.PRIOR_WORK_EQUIV == jbase.PRIOR_WORK_EQUIV


@pytest.mark.parametrize("app", APPS)
def test_planner_equal_on_two_pools(profilers, app):
    """Per-pool capacity rows and prices (the heterogeneous cluster), a
    sticky re-plan against the incumbent, and the infeasible answer."""
    jp, pp = profilers[app, "hetero_cluster"]
    s_avail = jp.cluster.total_units
    jpl = jmilp.Planner(jp.graph, jp, s_avail=s_avail, stickiness=0.5,
                        **PLAN_KW)
    ppl = pmilp.Planner(pp.graph, pp, s_avail=s_avail, stickiness=0.5,
                        **PLAN_KW)
    jc, pc = jpl.plan(DEMAND[app]), ppl.plan(DEMAND[app])
    assert _plan_fields(ppl, pc) == _plan_fields(jpl, jc)
    assert (_plan_fields(ppl, ppl.plan(2 * DEMAND[app], incumbent=pc))
            == _plan_fields(jpl, jpl.plan(2 * DEMAND[app], incumbent=jc)))
    assert ppl.plan(1e7) is None and jpl.plan(1e7) is None
    assert dataclasses.asdict(ppl.stats) == dataclasses.asdict(jpl.stats)


def test_joint_planner_equal():
    """Two apps in one solve on one shared two-pool cluster."""
    names = ("social_media", "traffic_analysis")
    out = []
    for apps_mod, prof_mod, milp_mod, hw in ((japps, jprof, jmilp, jhw),
                                             (papps, pprof, pmilp, phw)):
        cluster = hw.hetero_cluster()
        specs = [milp_mod.AppSpec(n, apps_mod.get_app(n),
                                  prof_mod.Profiler(apps_mod.get_app(n),
                                                    cluster=cluster))
                 for n in names]
        jp = milp_mod.JointPlanner(specs, s_avail=cluster.total_units,
                                   **PLAN_KW)
        res = []
        for demands in ({"social_media": 15.0, "traffic_analysis": 10.0},
                        {"social_media": 25.0}):
            plan = jp.plan_joint(demands)
            assert plan is not None
            res.append(dict(
                apps={n: _plan_fields(jp, c) for n, c in plan.plans.items()},
                pool_budgets=plan.pool_budgets, demand=plan.demand,
                slices=plan.slices, pool_slices=plan.pool_slices()))
        out.append((res, dataclasses.asdict(jp.stats)))
    assert out[1] == out[0]


def test_pruning_helpers_equal(profilers):
    jp, pp = profilers["traffic_analysis", "default_cluster"]
    jpl = jmilp.Planner(jp.graph, jp, s_avail=512, **PLAN_KW)
    ppl = pmilp.Planner(pp.graph, pp, s_avail=512, **PLAN_KW)
    for task in jp.graph.tasks:
        jt, pt = jpl._admissible(task), ppl._admissible(task)
        assert ([dataclasses.asdict(t) for t in pt]
                == [dataclasses.asdict(t) for t in jt])
        jconv = [jmilp.TupleVar(**dataclasses.asdict(t)) for t in pt]
        assert ([dataclasses.asdict(t) for t in pmilp._pareto_prune(pt)]
                == [dataclasses.asdict(t) for t in jmilp._pareto_prune(
                    jconv)])
        assert (pmilp._nondominated_mask(pt)
                == jmilp._nondominated_mask(jconv))
    for d in (0.0, 0.3, 1.0, 7.7, 1234.5):
        assert pmilp._quantize_up(d) == jmilp._quantize_up(d)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def _placements(pls):
    return None if pls is None else [dataclasses.asdict(p) for p in pls]


@pytest.mark.parametrize("cluster", CLUSTERS + ("tight_hetero_cluster",))
def test_plan_placements_equal(profilers, cluster):
    """Each pool of a plan packed by its own packer (the rectangle packer
    on the torus, the MIG packer on the A100s), dead hosts included."""
    app = "traffic_analysis"
    if (app, cluster) in profilers:
        jp, pp = profilers[app, cluster]
    else:
        jp = jprof.Profiler(japps.get_app(app),
                            cluster=getattr(jhw, cluster)())
        pp = pprof.Profiler(papps.get_app(app),
                            cluster=getattr(phw, cluster)())
    s_avail = jp.cluster.total_units
    cfg = pmilp.Planner(pp.graph, pp, s_avail=s_avail, **PLAN_KW).plan(
        DEMAND[app])
    assert cfg is not None
    for jpool, ppool in zip(jp.cluster.pools, pp.cluster.pools):
        segs = [t.segment for t, m in cfg.instances() if t.pool == ppool.name
                for _ in range(m)]
        mig = isinstance(ppool.scheme, phw.MigScheme)
        for dead in (None, [0] if mig else [(0, 0, 0)]):
            jpk = jplace.make_placer(jpool, dead)
            ppk = pplace.make_placer(ppool, dead)
            assert type(ppk).__name__ == type(jpk).__name__
            assert _placements(ppk.pack(list(segs))) == _placements(
                jpk.pack(list(segs)))
            assert ppk.utilization() == jpk.utilization()


@pytest.mark.parametrize("seed", range(6))
def test_random_mixes_placed_equally(seed):
    """Random slice mixes on both packers and ``pack_config``."""
    rng = np.random.default_rng(seed)
    names = [f"{h}x{w}s{int(rng.integers(1, 5))}"
             for h, w in (jseg.SEGMENT_SHAPES[int(c)] for c in rng.choice(
                 sorted(jseg.SEGMENT_SHAPES), size=int(rng.integers(1, 40))))]
    dead = [(0, int(rng.integers(0, 16)), int(rng.integers(0, 16)))]
    assert (_placements(pplace.pack_config(names, 1, dead))
            == _placements(jplace.pack_config(names, 1, dead)))
    jpk, ppk = jplace.Placer(num_pods=2), pplace.Placer(num_pods=2)
    assert _placements(ppk.pack(names)) == _placements(jpk.pack(names))
    assert (ppk.chips_used, ppk.pods_used, ppk.utilization()) == (
        jpk.chips_used, jpk.pods_used, jpk.utilization())
    mig = [p.name for p in jhw.partition.A100_MIG_PROFILES]
    mix = [f"{mig[int(i)]}.s1"
           for i in rng.integers(0, len(mig), size=int(rng.integers(1, 12)))]
    jm = jplace.MigSlicePacker(3, jhw.MigScheme(), dead_hosts=[1])
    pm = pplace.MigSlicePacker(3, phw.MigScheme(), dead_hosts=[1])
    assert _placements(pm.pack(mix)) == _placements(jm.pack(mix))
    assert pm.g_used == jm.g_used


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------
def _graph(mod, case):
    Task, TaskGraph, Variant = mod

    def V(name="v", arch="gemma-2b", acc=0.9):
        return Variant(name, arch, accuracy=acc)

    if case == "unknown_arch":
        return TaskGraph("g", {"a": Task("a", (Variant(
            "v", "not-an-arch", accuracy=0.9),))}, [])
    if case == "no_variants":
        return TaskGraph("g", {"a": Task("a", ())}, [])
    if case == "duplicate_variants":
        return TaskGraph("g", {"a": Task("a", (V(), V()))}, [])
    g = TaskGraph("g", {"a": Task("a", (V(),)), "b": Task("b", (V(),))},
                  [("a", "b")])
    if case == "bad_mult_edge":
        g.mult[("b", "v", "a")] = 2.0
    elif case == "mult_unknown_task":
        g.mult[("a", "v", "zz")] = 2.0
    elif case == "bad_latency_slo":
        g.slo_latency_ms = 0.0
    elif case == "bad_accuracy_slo":
        g.slo_accuracy = 1.5
    elif case == "moe_arch":
        g = TaskGraph("g", {"a": Task("a", (V("v", "llama4-scout-17b-a16e"),
                                            ))}, [])
    return g


REG_CASES = ("ok", "unknown_arch", "no_variants", "duplicate_variants",
             "bad_mult_edge", "mult_unknown_task", "bad_latency_slo",
             "bad_accuracy_slo", "moe_arch")


def _register(reg_mod, graph):
    try:
        r = reg_mod.register(graph)
    except reg_mod.RegistrationError as e:
        return "refused", str(e)
    return "accepted", r.name, _table(r.profiler)


@pytest.mark.parametrize("case", REG_CASES)
def test_register_equal(case):
    """Verdicts, whole refusal messages (the known-arch list included) and
    the accepted graphs' profiler tables equal; an MoE arch registers in
    both (the registry checks no family)."""
    want = _register(jreg, _graph((JTask, JGraph, JVariant), case))
    got = _register(preg, _graph((PTask, PGraph, PVariant), case))
    assert got == want
    assert got[0] == ("accepted" if case in ("ok", "moe_arch")
                      else "refused")


@pytest.mark.parametrize("app", APPS)
def test_register_apps_equal(app):
    jr = jreg.register(japps.get_app(app), profile=False)
    pr = preg.register(papps.get_app(app), profile=False)
    assert pr.name == jr.name == app
    assert list(pr.profiler.table) == list(jr.profiler.table)


# ---------------------------------------------------------------------------
# simulator shim
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("app", APPS)
def test_simulator_metrics_equal(profilers, app):
    """``Simulator`` over the port's runtime: the same ``SimMetrics`` at
    the planned demand, after an instance failure and under overload."""
    jp, pp = profilers[app, "default_cluster"]
    s_avail = jp.cluster.total_units
    jc = jmilp.Planner(jp.graph, jp, s_avail=s_avail, **PLAN_KW).plan(
        DEMAND[app])
    pc = pmilp.Planner(pp.graph, pp, s_avail=s_avail, **PLAN_KW).plan(
        DEMAND[app])
    for rps, fail in ((DEMAND[app], ()), (DEMAND[app], (0,)),
                      (3 * DEMAND[app], ())):
        js = jsim.Simulator(jp.graph, jc, seed=3)
        ps = psim.Simulator(pp.graph, pc, seed=3)
        assert len(ps.servers) == len(js.servers)
        assert sorted(ps.by_task) == sorted(js.by_task)
        if fail:
            js.fail_instances(list(fail))
            ps.fail_instances(list(fail))
        want = js.run(rps, duration_s=6.0, warmup_s=1.0)
        got = ps.run(rps, duration_s=6.0, warmup_s=1.0)
        d = diff_metrics(want, got)
        assert not d, "\n".join(d[:20])
        assert got.total_requests > 0
