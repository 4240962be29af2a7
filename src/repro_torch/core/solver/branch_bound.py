"""Best-first branch & bound over the LP relaxation (revised simplex).

Branches on the most-fractional integer variable.  Each node carries its
parent's optimal basis and passes its ``lo``/``hi`` **natively** to the
bounded-variable simplex — a child LP is the parent basis plus one bound
tightening, so it re-solves with a handful of dual-simplex pivots instead
of a from-scratch phase 1.  Node bounds come from the LP; incumbents from
caller-supplied rounding ``repair`` (the MILP layer passes its
exact-semantics greedy repair).  Node/time caps keep the controller's
solve inside the paper's 2-20 s envelope.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.solver.simplex import BasisState, BoundedSimplex

INT_TOL = 1e-6


@dataclass
class MILPResult:
    status: str                 # "optimal" | "feasible" | "infeasible" | "cap"
    x: Optional[np.ndarray]
    objective: float
    nodes: int
    gap: float                  # (incumbent - best_bound) / (|incumbent|+1)
    best_bound: float = np.nan  # proven lower bound when the search stops
    root_basis: Optional[BasisState] = None   # warm start for the next solve
    lp_warm: int = 0            # node LPs that reused a parent/caller basis
    lp_cold: int = 0            # node LPs solved from scratch (phase 1)
    root_warm: bool = False     # root LP reused the caller's warm basis


def solve_milp(
    c: np.ndarray,
    A_ub: Optional[np.ndarray],
    b_ub: Optional[np.ndarray],
    A_eq: Optional[np.ndarray],
    b_eq: Optional[np.ndarray],
    ub: np.ndarray,
    int_mask: np.ndarray,
    *,
    repair: Optional[Callable[[np.ndarray], Optional[np.ndarray]]] = None,
    max_nodes: int = 400,
    time_limit_s: float = 20.0,
    gap_tol: float = 1e-3,
    solver: Optional[BoundedSimplex] = None,
    warm_basis: Optional[BasisState] = None,
    warm_incumbent: Optional[np.ndarray] = None,
) -> MILPResult:
    """min c@x, integer on int_mask. `repair` maps a fractional LP point to
    an integer-feasible point (or None); its result seeds/updates the
    incumbent.

    ``solver`` lets the caller reuse a cached :class:`BoundedSimplex`
    (constraint matrix built once across re-plans); ``warm_basis`` seeds
    the root LP from a previous solve of the same matrix and
    ``warm_incumbent`` seeds the incumbent (both used by the controller's
    bin-to-bin warm start)."""
    n = c.size
    t0 = time.monotonic()

    if solver is None:
        solver = BoundedSimplex(c, A_ub, b_ub, A_eq, b_eq)
        b_full = c_full = None
    else:
        # refresh rhs AND objective in case the cached matrix is re-used
        # at a new demand / a new sticky incumbent — the solver keeps the
        # last solve's cvec, so a reused solver must always be handed the
        # current c or a stale objective would leak across re-plans
        b_full = np.concatenate([
            np.asarray(b_ub, float).ravel() if b_ub is not None else
            np.zeros(0),
            np.asarray(b_eq, float).ravel() if b_eq is not None else
            np.zeros(0)])
        c_full = np.asarray(c, float)

    lp_warm = lp_cold = 0

    def count(res):
        nonlocal lp_warm, lp_cold
        if res.warm_used:
            lp_warm += 1
        else:
            lp_cold += 1

    lo0 = np.zeros(n)
    hi0 = ub.astype(float).copy()
    root = solver.solve(lo0, hi0, b=b_full, c=c_full, warm=warm_basis)
    count(root)
    if root.status == "infeasible":
        return MILPResult("infeasible", None, np.inf, 1, np.inf,
                          best_bound=np.inf, lp_warm=lp_warm, lp_cold=lp_cold)
    if root.status != "optimal":
        return MILPResult("cap", None, np.nan, 1, np.inf,
                          lp_warm=lp_warm, lp_cold=lp_cold)
    root_basis = root.basis
    root_warm = bool(root.warm_used)

    best_x: Optional[np.ndarray] = None
    best_obj = np.inf

    def try_incumbent(x):
        nonlocal best_x, best_obj
        if x is None:
            return
        x = np.asarray(x, float)
        val = float(c @ x)
        if val < best_obj - 1e-12:
            if _is_feasible(x, A_ub, b_ub, A_eq, b_eq, ub, int_mask):
                best_obj = val
                best_x = x.copy()

    try_incumbent(warm_incumbent)
    if repair is not None:
        try_incumbent(repair(root.x))

    counter = itertools.count()
    Node = Tuple[float, int, np.ndarray, np.ndarray, Optional[BasisState]]
    heap: List[Node] = []
    heapq.heappush(heap, (root.objective, next(counter), lo0, hi0,
                          root.basis))
    nodes = 0
    proven = False
    dropped_bound = np.inf   # tightest bound among subtrees lost to
                             # numeric trouble (maxiter/singular node LPs)

    while heap and nodes < max_nodes:
        if time.monotonic() - t0 > time_limit_s:
            break
        if heap[0][0] >= best_obj - 1e-9:
            proven = True   # best-first: nothing better remains anywhere
            break
        bound, _, lo, hi, pbasis = heapq.heappop(heap)
        res = solver.solve(lo, hi, warm=pbasis)
        count(res)
        nodes += 1
        if res.status not in ("optimal", "infeasible"):
            # subtree dropped unproven: its parent bound stays a valid
            # lower bound on whatever it contained
            dropped_bound = min(dropped_bound, bound)
            continue
        if res.status != "optimal" or res.objective >= best_obj - 1e-9:
            continue
        x = res.x
        frac = np.where(int_mask, np.abs(x - np.round(x)), 0.0)
        j = int(np.argmax(frac))
        if frac[j] <= INT_TOL:
            try_incumbent(np.where(int_mask, np.round(x), x))
            continue
        if repair is not None:
            try_incumbent(repair(x))
        # down branch
        hi_d = hi.copy()
        hi_d[j] = np.floor(x[j])
        heapq.heappush(heap, (res.objective, next(counter), lo, hi_d,
                              res.basis))
        # up branch
        lo_u = lo.copy()
        lo_u[j] = np.ceil(x[j])
        heapq.heappush(heap, (res.objective, next(counter), lo_u, hi,
                              res.basis))

    # the true remaining bound is the heap minimum (the loop may have
    # stopped on the node/time cap without popping it), further capped by
    # any subtree dropped on a numeric failure
    if (proven or not heap) and not np.isfinite(dropped_bound):
        best_bound = best_obj if best_x is not None else np.inf
        exhausted = True
    else:
        remaining = heap[0][0] if heap else np.inf
        best_bound = min(remaining, dropped_bound, best_obj)
        exhausted = False

    if best_x is None:
        unexplored = bool(heap) or np.isfinite(dropped_bound)
        return MILPResult("cap" if unexplored else "infeasible",
                          None, np.inf, nodes, np.inf,
                          best_bound=best_bound, root_basis=root_basis,
                          lp_warm=lp_warm, lp_cold=lp_cold,
                          root_warm=root_warm)
    gap = max(0.0, best_obj - best_bound) / (abs(best_obj) + 1.0)
    status = "optimal" if (exhausted or gap <= gap_tol) else "feasible"
    return MILPResult(status, best_x, best_obj, nodes, gap,
                      best_bound=best_bound, root_basis=root_basis,
                      lp_warm=lp_warm, lp_cold=lp_cold, root_warm=root_warm)


def _is_feasible(x, A_ub, b_ub, A_eq, b_eq, ub, int_mask, tol=1e-6) -> bool:
    if (x < -tol).any() or (x > ub + tol).any():
        return False
    if int_mask.any() and np.abs(x[int_mask] - np.round(x[int_mask])).max() > tol:
        return False
    if A_ub is not None and len(A_ub) and (A_ub @ x > b_ub + 1e-6).any():
        return False
    if A_eq is not None and len(A_eq) and np.abs(A_eq @ x - b_eq).max() > 1e-6:
        return False
    return True
