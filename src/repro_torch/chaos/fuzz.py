"""Seeded chaos fuzzer (DESIGN.md §13): search the arrival × failure
space for SLO-breaking scenarios and regression-pin them.

Every case is derived deterministically from one integer seed — arrival
shape and rate, domain-failure times, preemption notices, and the
runtime's service-time randomness all flow from it — so a breaking case
reproduces bit-for-bit and can be pinned as a deterministic test
(``tests/chaos_pins.json``, asserted by ``tests/test_chaos.py``; the
port's copy is held to the same pins by ``tests/test_torch_chaos.py``).

Cases run the UNPROTECTED baseline (plan once at the nominal rate, no
detector / emergency monitor / ladder): the fuzzer's job is to find
chaos schedules the static plan cannot survive — the torture inputs the
closed-loop machinery is then benchmarked against
(``benchmarks/bench_chaos.py``).  "Breaking" means the run's
fan-weighted violation rate exceeds ``threshold``.

CLI (CI's fuzz-smoke step)::

    python -m repro_torch.chaos.fuzz --budget 24 --threshold 0.1 \
        --pins tests/chaos_pins.json --fail-on-new

exits non-zero when any breaking case id is NOT already pinned (a new
breaking scenario must be pinned — or the regression fixed — before
merge); ``--update-pins`` rewrites the pins file instead.

A copy of the JAX package's ``chaos/fuzz.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.hwspec import chaos_cluster
from repro_torch.runtime.scenario import (DomainFailureEvent, PreemptionEvent,
                                    Scenario)

# fixed fuzz-harness knobs: short runs keep CI's smoke budget cheap
RATES = (10, 15, 20, 25)        # nominal rps choices (quantized: plan cache)
DURATION_S = 8.0
WARMUP_S = 1.0
DEFAULT_THRESHOLD = 0.1         # violation rate that counts as SLO-breaking
PLAN_KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=3.0)


@dataclass(frozen=True)
class FuzzCase:
    """One deterministic chaos scenario, fully derived from ``seed``."""
    seed: int
    shape: str                  # "poisson" | "burst"
    rate_rps: int               # nominal (planned-for) rate
    events: Tuple[Tuple, ...]   # ("domain", at_s, name) |
                                # ("preempt", at_s, pool, notice_s, frac)

    @property
    def case_id(self) -> str:
        evs = []
        for e in self.events:
            if e[0] == "domain":
                evs.append(f"dom:{e[2]}@{e[1]:.1f}")
            else:
                evs.append(f"pre:{e[2]}@{e[1]:.1f}n{e[3]:.1f}f{e[4]:.2f}")
        return f"s{self.seed}:{self.shape}{self.rate_rps}:" + "+".join(evs)

    def chaos_events(self):
        out = []
        for e in self.events:
            if e[0] == "domain":
                out.append(DomainFailureEvent(at_s=e[1], domain=e[2]))
            else:
                out.append(PreemptionEvent(at_s=e[1], pool=e[2],
                                           notice_s=e[3], fraction=e[4]))
        return out

    def scenario(self) -> Scenario:
        if self.shape == "burst":
            sc = Scenario.burst(self.rate_rps * 0.5, self.rate_rps * 1.5,
                                duration_s=DURATION_S, warmup_s=WARMUP_S)
        else:
            sc = Scenario.poisson(float(self.rate_rps),
                                  duration_s=DURATION_S, warmup_s=WARMUP_S)
        return sc.with_chaos(*self.chaos_events())


@dataclass
class FuzzResult:
    case: FuzzCase
    violation_rate: float
    completions: int
    dropped: int
    planned: bool               # False: nominal rate infeasible, not run

    @property
    def breaking(self) -> bool:
        return self.planned and self.violation_rate > self._threshold

    _threshold: float = DEFAULT_THRESHOLD


def case_from_seed(seed: int) -> FuzzCase:
    """Derive one chaos case from a seed (pure function of ``seed``)."""
    rng = np.random.default_rng(seed)
    cluster = chaos_cluster()
    shape = "burst" if rng.random() < 0.4 else "poisson"
    rate = int(RATES[rng.integers(0, len(RATES))])
    events: List[Tuple] = []
    for _ in range(int(1 + rng.integers(0, 2))):
        at = float(np.round(WARMUP_S + 0.5 + rng.random()
                            * (DURATION_S * 0.6), 1))
        if rng.random() < 0.5:
            dom = cluster.domain_names[int(rng.integers(
                0, len(cluster.domain_names)))]
            events.append(("domain", at, dom))
        else:
            pool = cluster.pools[int(rng.integers(
                0, len(cluster.pools)))].name
            notice = float(np.round(0.5 + rng.random() * 1.5, 1))
            frac = float(np.round(0.5 + rng.random() * 0.5, 2))
            events.append(("preempt", at, pool, notice, frac))
    return FuzzCase(seed, shape, rate, tuple(events))


# ---------------------------------------------------------------------------
_PLAN_CACHE: Dict[int, Optional[object]] = {}
_FLEET = None


def _fleet():
    """Lazy shared harness (graph / cluster / profiler / planner) — the
    planner's matrix caches amortize across the whole budget."""
    global _FLEET
    if _FLEET is None:
        from repro_torch.core.apps import get_app
        from repro_torch.core.milp import Planner
        from repro_torch.core.profiler import Profiler
        cluster = chaos_cluster()
        graph = get_app("social_media")
        prof = Profiler(graph, cluster=cluster)
        planner = Planner(graph, prof, s_avail=cluster.total_units,
                          **PLAN_KW)
        _FLEET = (graph, cluster, prof, planner)
    return _FLEET


def run_case(case: FuzzCase,
             threshold: float = DEFAULT_THRESHOLD) -> FuzzResult:
    """Run one case on the unprotected baseline, deterministically.  The
    pinned corpus must break as it does on both of the reference's event
    loops (``tests/test_torch_chaos.py`` parametrizes over them)."""
    from repro_torch.runtime import ClusterRuntime, SimBackend
    graph, cluster, _, planner = _fleet()
    if case.rate_rps not in _PLAN_CACHE:
        planner.dead_units = {}
        _PLAN_CACHE[case.rate_rps] = planner.plan(float(case.rate_rps))
    cfg = _PLAN_CACHE[case.rate_rps]
    if cfg is None:
        return FuzzResult(case, 0.0, 0, 0, planned=False,
                          _threshold=threshold)
    rt = ClusterRuntime(graph, cfg, SimBackend(), seed=case.seed,
                        cluster=cluster)
    m = rt.run(case.scenario())
    return FuzzResult(case, m.violation_rate, m.completions, m.dropped,
                      planned=True, _threshold=threshold)


def fuzz(budget: int, seed0: int = 0,
         threshold: float = DEFAULT_THRESHOLD) -> List[FuzzResult]:
    """Run ``budget`` consecutive seeds; deterministic for a fixed
    (budget, seed0, threshold)."""
    return [run_case(case_from_seed(s), threshold)
            for s in range(seed0, seed0 + budget)]


# ---------------------------------------------------------------------------
def load_pins(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {"threshold": DEFAULT_THRESHOLD, "cases": {}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD)
    ap.add_argument("--pins", default="tests/chaos_pins.json")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 on any breaking case not already pinned")
    ap.add_argument("--update-pins", action="store_true",
                    help="rewrite the pins file with this run's findings")
    a = ap.parse_args(argv)

    results = fuzz(a.budget, a.seed, a.threshold)
    breaking = [r for r in results if r.breaking]
    for r in results:
        flag = "BREAK" if r.breaking else ("skip " if not r.planned
                                           else "ok   ")
        print(f"{flag} vrate={r.violation_rate:.3f} "
              f"done={r.completions:5d} drop={r.dropped:5d}  "
              f"{r.case.case_id}")
    print(f"{len(breaking)}/{len(results)} SLO-breaking "
          f"(threshold {a.threshold:g})")

    pins = load_pins(a.pins)
    if a.update_pins:
        pins = {"threshold": a.threshold, "budget": a.budget,
                "seed0": a.seed,
                "cases": {r.case.case_id: {
                    "seed": r.case.seed,
                    "violation_rate": round(r.violation_rate, 4)}
                    for r in breaking}}
        with open(a.pins, "w") as f:
            json.dump(pins, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"pinned {len(breaking)} cases -> {a.pins}")
        return 0
    if a.fail_on_new:
        new = [r.case.case_id for r in breaking
               if r.case.case_id not in pins.get("cases", {})]
        if new:
            print("NEW SLO-breaking cases (pin them or fix the "
                  "regression):", file=sys.stderr)
            for cid in new:
                print(f"  {cid}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
