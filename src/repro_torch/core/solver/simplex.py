"""Bounded-variable revised simplex (numpy). No external solver deps.

Solves::

    min  c @ x
    s.t. A_ub @ x <= b_ub
         A_eq @ x == b_eq
         lo <= x <= hi     (lo defaults to 0, hi to +inf)

Design (see DESIGN.md, "Solver"):

* Variable bounds are handled **implicitly** in the ratio test — they never
  become constraint rows, so the basis stays ``m x m`` where ``m`` counts
  only the real constraints.  Nonbasic variables rest at their lower or
  upper bound ("bound flips" move a variable between its own bounds with no
  basis change).
* The basis inverse is maintained by product-form (eta) updates and
  **refactorized** from scratch every ``REFACTOR_EVERY`` pivots or on
  numerical trouble.
* Pricing is Dantzig (most-negative reduced cost) with a Bland's-rule
  fallback after a degeneracy stall (anti-cycling).
* A **dual simplex** restores primal feasibility after bound tightenings or
  rhs changes while the basis stays dual feasible — this is the warm-start
  path used by branch & bound (child node = parent basis + one bound
  change) and by the controller's bin-to-bin re-planning.

The module exposes two layers:

* :func:`solve_lp` — one-shot functional API (backwards compatible with the
  old dense-tableau signature; ``lo`` and ``warm`` are new).
* :class:`BoundedSimplex` — a reusable solver bound to one constraint
  matrix; callers re-solve under different variable bounds / rhs with
  warm-start bases (:class:`BasisState`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

try:                                    # sparse pricing (optional)
    from scipy import sparse as _sp
except Exception:                       # pragma: no cover - scipy is baked in
    _sp = None

EPS = 1e-9
FEAS_TOL = 1e-7          # primal feasibility tolerance
DUAL_TOL = 1e-7          # dual feasibility (reduced cost) tolerance
PIVOT_TOL = 1e-8         # smallest acceptable pivot magnitude
REFACTOR_EVERY = 100     # eta updates between basis refactorizations
STALL_LIMIT = 50         # degenerate steps before switching to Bland

AT_LOWER = 0
AT_UPPER = 1
BASIC = 2


@dataclass
class BasisState:
    """A warm-startable snapshot: which column is basic in each row, and on
    which bound every nonbasic column rests.  ``binv`` optionally carries
    the basis-inverse snapshot so a warm install costs a memcpy instead of
    an O(m^3) refactorization; ``updates`` is the eta-update count behind
    it (installs past REFACTOR_EVERY refactorize instead, bounding drift)."""
    basic: np.ndarray        # (m,) int   — column basic in row i
    vstat: np.ndarray        # (ntot,) i8 — AT_LOWER | AT_UPPER | BASIC
    binv: Optional[np.ndarray] = None
    updates: int = 0

    def copy(self) -> "BasisState":
        return BasisState(self.basic.copy(), self.vstat.copy(),
                          None if self.binv is None else self.binv.copy(),
                          self.updates)


@dataclass
class LPResult:
    status: str              # "optimal" | "infeasible" | "unbounded" | "maxiter"
    x: Optional[np.ndarray]
    objective: float
    basis: Optional[BasisState] = None
    iterations: int = 0
    warm_used: bool = False


@dataclass
class SimplexStats:
    """Cumulative counters over a :class:`BoundedSimplex` lifetime."""
    solves: int = 0
    warm_solves: int = 0
    cold_solves: int = 0
    warm_fallbacks: int = 0      # warm attempt failed -> cold re-solve
    primal_iterations: int = 0
    dual_iterations: int = 0
    refactorizations: int = 0


class BoundedSimplex:
    """Revised simplex over one fixed constraint matrix.

    The equality ("computational") form is built once::

        [A_ub I 0][x s a]' = b     (one slack column per <= row)
        [A_eq 0 I]

    Artificial columns ``a`` exist only to bootstrap phase 1; outside a cold
    start they are fixed at 0.  Re-solves vary only the structural bounds
    ``lo/hi`` and (optionally) the rhs ``b`` — exactly the degrees of
    freedom branch & bound and bin-to-bin re-planning exercise.
    """

    def __init__(self, c, A_ub=None, b_ub=None, A_eq=None, b_eq=None):
        c = np.asarray(c, float)
        self.n = n = c.size
        A_ub = (np.asarray(A_ub, float).reshape(-1, n)
                if A_ub is not None and len(A_ub) else np.zeros((0, n)))
        b_ub = (np.asarray(b_ub, float).ravel()
                if b_ub is not None and np.size(b_ub) else np.zeros(0))
        A_eq = (np.asarray(A_eq, float).reshape(-1, n)
                if A_eq is not None and len(A_eq) else np.zeros((0, n)))
        b_eq = (np.asarray(b_eq, float).ravel()
                if b_eq is not None and np.size(b_eq) else np.zeros(0))
        m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
        self.m = m = m_ub + m_eq
        self.m_ub = m_ub
        self.ntot = n + m_ub + m          # structural | slack | artificial
        self.A = np.zeros((m, self.ntot))
        self.A[:m_ub, :n] = A_ub
        self.A[m_ub:, :n] = A_eq
        self.A[:m_ub, n:n + m_ub] = np.eye(m_ub)
        self.A[:, n + m_ub:] = np.eye(m)
        self.b = np.concatenate([b_ub, b_eq])
        self.cvec = np.zeros(self.ntot)
        self.cvec[:n] = c
        # constraint matrices are sparse in practice (a handful of nonzeros
        # per row); pricing via CSR of A^T turns the O(m*ntot) reduced-cost
        # pass into O(nnz)
        if _sp is not None and m > 0:
            self._A_csr = _sp.csr_matrix(self.A)
            self._At_csr = _sp.csr_matrix(self.A.T)
        else:
            self._A_csr = self._At_csr = None
        self.stats = SimplexStats()
        # mutable per-solve state
        self.lo = np.zeros(self.ntot)
        self.hi = np.full(self.ntot, np.inf)
        self.basic = np.arange(m) + n + m_ub   # artificial basis
        self.vstat = np.full(self.ntot, AT_LOWER, np.int8)
        self.vstat[self.basic] = BASIC
        self.Binv = np.eye(m)
        self.xval = np.zeros(self.ntot)
        self._updates = 0

    # ------------------------------------------------------------------
    # basis / state maintenance
    # ------------------------------------------------------------------
    def _refactor(self) -> bool:
        """Recompute Binv from the basic columns. False if singular."""
        try:
            self.Binv = np.linalg.inv(self.A[:, self.basic])
        except np.linalg.LinAlgError:
            return False
        if not np.isfinite(self.Binv).all():
            return False
        self._updates = 0
        self.stats.refactorizations += 1
        return True

    def _set_nonbasic_values(self):
        nb_lo = self.vstat == AT_LOWER
        nb_hi = self.vstat == AT_UPPER
        self.xval[nb_lo] = self.lo[nb_lo]
        self.xval[nb_hi] = self.hi[nb_hi]

    def _compute_basics(self):
        """x_B = Binv (b - N x_N); nonbasic values must already be set."""
        self.xval[self.basic] = 0.0
        Ax = (self._A_csr @ self.xval if self._A_csr is not None
              else self.A @ self.xval)
        self.xval[self.basic] = self.Binv @ (self.b - Ax)

    def _update_binv(self, r: int, w: np.ndarray):
        """Product-form update after the column with tableau column w
        becomes basic in row r."""
        piv_row = self.Binv[r] / w[r]
        self.Binv -= np.outer(w, piv_row)
        self.Binv[r] = piv_row
        self._updates += 1
        if self._updates >= REFACTOR_EVERY:
            self._refactor()
            self._compute_basics()

    def _reduced_costs(self, cost: np.ndarray) -> np.ndarray:
        y = cost[self.basic] @ self.Binv
        if self._At_csr is not None:
            return cost - self._At_csr @ y
        return cost - y @ self.A

    def _row(self, r: int) -> np.ndarray:
        """Tableau row r over all columns: Binv[r] @ A."""
        if self._At_csr is not None:
            return self._At_csr @ self.Binv[r]
        return self.Binv[r] @ self.A

    # ------------------------------------------------------------------
    # primal simplex
    # ------------------------------------------------------------------
    def _primal(self, cost: np.ndarray, max_iter: int) -> str:
        """Assumes primal feasibility; returns "optimal" | "unbounded" |
        "maxiter" | "singular"."""
        stall = 0
        free = self.hi - self.lo > EPS          # fixed vars never enter
        for _ in range(max_iter):
            self.stats.primal_iterations += 1
            d = self._reduced_costs(cost)
            score = np.where((self.vstat == AT_LOWER) & free, -d,
                             np.where((self.vstat == AT_UPPER) & free, d,
                                      -np.inf))
            if stall > STALL_LIMIT:             # Bland: first eligible index
                elig = np.where(score > DUAL_TOL)[0]
                if elig.size == 0:
                    return "optimal"
                q = int(elig[0])
            else:
                q = int(np.argmax(score))
                if score[q] <= DUAL_TOL:
                    return "optimal"
            sigma = 1.0 if self.vstat[q] == AT_LOWER else -1.0
            w = self.Binv @ self.A[:, q]
            # ratio test over basic bounds + the entering var's own span
            xb = self.xval[self.basic]
            ws = sigma * w
            lob, hib = self.lo[self.basic], self.hi[self.basic]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_dec = np.where(ws > PIVOT_TOL, (xb - lob) / ws, np.inf)
                t_inc = np.where(ws < -PIVOT_TOL, (hib - xb) / (-ws), np.inf)
            t_basic = np.minimum(t_dec, t_inc)
            t_basic = np.where(np.isnan(t_basic), np.inf, t_basic)
            r = int(np.argmin(t_basic))
            t = t_basic[r]
            span = self.hi[q] - self.lo[q]
            flip = span < t
            t_step = span if flip else t
            if not np.isfinite(t_step):
                return "unbounded"
            t_step = max(t_step, 0.0)
            stall = stall + 1 if t_step < EPS else 0
            # move
            self.xval[self.basic] = xb - sigma * t_step * w
            if flip:
                self.vstat[q] = AT_UPPER if sigma > 0 else AT_LOWER
                self.xval[q] = (self.hi[q] if sigma > 0 else self.lo[q])
                continue
            self.xval[q] = self.xval[q] + sigma * t_step
            if abs(w[r]) < PIVOT_TOL:
                if not self._refactor():
                    return "singular"
                self._compute_basics()
                continue
            leave = self.basic[r]
            # leaving variable lands exactly on the bound it hit
            if t_dec[r] <= t_inc[r]:
                self.vstat[leave] = AT_LOWER
                self.xval[leave] = self.lo[leave]
            else:
                self.vstat[leave] = AT_UPPER
                self.xval[leave] = self.hi[leave]
            self.vstat[q] = BASIC
            self.basic[r] = q
            self._update_binv(r, w)
        return "maxiter"

    # ------------------------------------------------------------------
    # dual simplex
    # ------------------------------------------------------------------
    def _dual(self, cost: np.ndarray, max_iter: int) -> str:
        """Assumes dual feasibility; drives out primal bound violations.
        Returns "feasible" | "infeasible" | "maxiter" | "singular"."""
        free = self.hi - self.lo > EPS
        for _ in range(max_iter):
            self.stats.dual_iterations += 1
            xb = self.xval[self.basic]
            below = self.lo[self.basic] - xb
            above = xb - self.hi[self.basic]
            viol = np.maximum(below, above)
            r = int(np.argmax(viol))
            if viol[r] <= FEAS_TOL:
                return "feasible"
            is_below = below[r] >= above[r]
            rho = self._row(r)
            d = self._reduced_costs(cost)
            if is_below:   # x_Br must increase: dx_Br/dx_j = -rho_j
                elig = ((self.vstat == AT_LOWER) & free & (rho < -PIVOT_TOL)) \
                    | ((self.vstat == AT_UPPER) & free & (rho > PIVOT_TOL))
            else:
                elig = ((self.vstat == AT_LOWER) & free & (rho > PIVOT_TOL)) \
                    | ((self.vstat == AT_UPPER) & free & (rho < -PIVOT_TOL))
            if not elig.any():
                return "infeasible"
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(elig, np.abs(d) / np.abs(rho), np.inf)
            rmin = ratio.min()
            # among near-ties pick the largest |pivot| for stability
            near = elig & (ratio <= rmin + DUAL_TOL)
            cand = np.where(near)[0]
            q = int(cand[np.argmax(np.abs(rho[cand]))])
            w = self.Binv @ self.A[:, q]
            if abs(w[r]) < PIVOT_TOL:
                if not self._refactor():
                    return "singular"
                self._compute_basics()
                continue
            leave = self.basic[r]
            target = self.lo[leave] if is_below else self.hi[leave]
            delta = (xb[r] - target) / w[r]
            self.xval[self.basic] = xb - delta * w
            self.xval[q] = self.xval[q] + delta
            self.vstat[leave] = AT_LOWER if is_below else AT_UPPER
            self.xval[leave] = target
            self.vstat[q] = BASIC
            self.basic[r] = q
            self._update_binv(r, w)
        return "maxiter"

    # ------------------------------------------------------------------
    # cold start: phase 1 with signed artificials
    # ------------------------------------------------------------------
    def _cold_start(self, max_iter: int) -> str:
        n, m_ub, m = self.n, self.m_ub, self.m
        art = np.arange(m) + n + m_ub
        slack = np.arange(m_ub) + n
        # nonbasic structural/slack at their nearest finite bound
        self.vstat[:] = AT_LOWER
        fin_lo = np.isfinite(self.lo)
        self.vstat[~fin_lo & np.isfinite(self.hi)] = AT_UPPER
        self.vstat[art] = BASIC
        self._set_nonbasic_values()
        self.xval[~np.isfinite(self.xval)] = 0.0   # free vars (none today)
        self.xval[slack] = 0.0
        struct = self.xval[:n + m_ub]
        Ax = (self._A_csr[:, :n + m_ub] @ struct if self._A_csr is not None
              else self.A[:, :n + m_ub] @ struct)
        resid = self.b - Ax
        # crash basis: slacks cover their own (<=) rows wherever the
        # residual is already feasible; artificials only where it is not
        # (and on equality rows).  Both are unit columns, so Binv stays I.
        use_slack = np.zeros(m, bool)
        use_slack[:m_ub] = resid[:m_ub] >= 0.0
        self.basic = np.where(use_slack, np.concatenate(
            [slack, np.zeros(m - m_ub, int)]), art)
        self.vstat[art] = AT_LOWER
        self.vstat[self.basic] = BASIC
        self.Binv = np.eye(m)
        self._updates = 0
        self.xval[art] = 0.0
        self.xval[self.basic] = resid
        need_art = ~use_slack
        # signed phase-1 cost: minimize sum |artificial| on the used rows
        neg = resid < 0
        self.lo[art] = np.where(need_art & neg, -np.inf, 0.0)
        self.hi[art] = np.where(need_art & ~neg, np.inf, 0.0)
        cost1 = np.zeros(self.ntot)
        cost1[art[need_art]] = np.where(neg[need_art], -1.0, 1.0)
        status = self._primal(cost1, max_iter)
        if status in ("maxiter", "singular"):
            return status
        p1 = float(cost1 @ self.xval)
        if p1 > 1e-6:
            return "infeasible"
        # pin artificials to zero; pivot basic ones out where possible
        self.lo[art] = 0.0
        self.hi[art] = 0.0
        for r in range(m):
            j = self.basic[r]
            if j < n + m_ub:
                continue
            rho = self.Binv[r] @ self.A[:, :n + m_ub]
            cand = np.where((self.vstat[:n + m_ub] != BASIC)
                            & (np.abs(rho) > PIVOT_TOL))[0]
            if cand.size == 0:
                continue   # redundant row: artificial stays basic at 0
            q = int(cand[np.argmax(np.abs(rho[cand]))])
            w = self.Binv @ self.A[:, q]
            self.vstat[j] = AT_LOWER
            self.xval[j] = 0.0
            self.vstat[q] = BASIC
            self.basic[r] = q
            self._update_binv(r, w)
        self._compute_basics()
        return "ok"

    # ------------------------------------------------------------------
    # public solve
    # ------------------------------------------------------------------
    def solve(self, lo=None, hi=None, b=None, c=None,
              warm: Optional[BasisState] = None,
              max_iter: int = 20000) -> LPResult:
        """Solve under structural bounds ``lo/hi`` (and optional rhs ``b``
        and objective ``c``), warm-starting from ``warm`` when given.

        A per-solve ``c`` replaces the structural objective installed at
        construction — like the ``b`` override, it lets one cached
        matrix/factorization serve a family of solves whose objective
        drifts (the planner's stickiness penalty follows the incumbent).
        ``_try_warm`` restores dual feasibility against the CURRENT
        ``cvec`` via bound flips, so a warm basis taken under the old
        objective still prices out correctly under the new one."""
        n, m_ub = self.n, self.m_ub
        self.lo[:n] = 0.0 if lo is None else np.asarray(lo, float)
        self.hi[:n] = np.inf if hi is None else np.asarray(hi, float)
        self.lo[n:n + m_ub] = 0.0
        self.hi[n:n + m_ub] = np.inf
        self.lo[n + m_ub:] = 0.0
        self.hi[n + m_ub:] = 0.0
        if b is not None:
            self.b = np.asarray(b, float).copy()
        if c is not None:
            self.cvec[:n] = np.asarray(c, float)
        self.stats.solves += 1
        self._iters0 = (self.stats.primal_iterations
                        + self.stats.dual_iterations)
        if (self.lo[:n] > self.hi[:n] + EPS).any():
            return LPResult("infeasible", None, np.inf)

        warm_used = False
        if warm is not None and warm.basic.size == self.m \
                and warm.vstat.size == self.ntot:
            warm_used = self._try_warm(warm)
        if warm_used:
            self.stats.warm_solves += 1
            status = self._dual(self.cvec, max_iter)
            if status == "feasible":
                status = self._primal(self.cvec, max_iter)
                if status == "optimal":
                    return self._finish(max_iter, warm_used=True)
                if status == "unbounded":
                    return LPResult("unbounded", None, -np.inf,
                                    warm_used=True)
            elif status == "infeasible":
                return LPResult("infeasible", None, np.inf, warm_used=True)
            # numeric trouble / maxiter on the warm path: re-solve cold
            self.stats.warm_fallbacks += 1

        self.stats.cold_solves += 1
        status = self._cold_start(max_iter)
        if status == "infeasible":
            return LPResult("infeasible", None, np.inf)
        if status in ("maxiter", "singular"):
            return LPResult("maxiter", None, np.nan)
        status = self._primal(self.cvec, max_iter)
        if status == "unbounded":
            return LPResult("unbounded", None, -np.inf)
        if status in ("maxiter", "singular"):
            return LPResult("maxiter", None, np.nan)
        return self._finish(max_iter, warm_used=False)

    # ------------------------------------------------------------------
    def _try_warm(self, warm: BasisState) -> bool:
        """Install a previous basis under the current bounds.  Restores
        dual feasibility by bound flips where possible."""
        if np.array_equal(warm.basic, self.basic):
            # B&B siblings: the solver often still holds exactly this basis
            # (the parent's final factorization) — skip the O(m^3) refactor
            self.vstat = warm.vstat.copy()
        elif (warm.binv is not None and warm.binv.shape == (self.m, self.m)
                and warm.updates < REFACTOR_EVERY):
            self.basic = warm.basic.copy()
            self.vstat = warm.vstat.copy()
            self.Binv = warm.binv.copy()
            self._updates = warm.updates
        else:
            self.basic = warm.basic.copy()
            self.vstat = warm.vstat.copy()
            if not self._refactor():
                return False
        # statuses must be consistent with the (possibly moved) bounds
        nb = self.vstat != BASIC
        at_up = nb & (self.vstat == AT_UPPER) & ~np.isfinite(self.hi)
        self.vstat[at_up] = AT_LOWER
        fixed = nb & (self.hi - self.lo <= EPS)
        self.vstat[fixed & np.isfinite(self.lo)] = AT_LOWER
        # restore dual feasibility via bound flips (finite bounds only);
        # fixed columns (lo==hi: artificials, B&B-pinned vars) can never
        # enter, so their reduced-cost sign is irrelevant
        free = self.hi - self.lo > EPS
        d = self._reduced_costs(self.cvec)
        flip_up = (self.vstat == AT_LOWER) & (d < -DUAL_TOL) \
            & np.isfinite(self.hi) & free
        flip_dn = (self.vstat == AT_UPPER) & (d > DUAL_TOL) \
            & np.isfinite(self.lo) & free
        self.vstat[flip_up] = AT_UPPER
        self.vstat[flip_dn] = AT_LOWER
        bad_lo = (self.vstat == AT_LOWER) & (d < -DUAL_TOL) & free
        bad_hi = (self.vstat == AT_UPPER) & (d > DUAL_TOL) & free
        if bad_lo.any() or bad_hi.any():
            return False      # can't restore dual feasibility cheaply
        self._set_nonbasic_values()
        self._compute_basics()
        if not np.isfinite(self.xval).all():
            return False
        return True

    # ------------------------------------------------------------------
    def _finish(self, max_iter: int, warm_used: bool) -> LPResult:
        # snap basics that sit within tolerance of a bound exactly onto it
        xb = self.xval[self.basic]
        lob, hib = self.lo[self.basic], self.hi[self.basic]
        xb = np.where((xb < lob) & (lob - xb < 1e-6), lob, xb)
        xb = np.where((xb > hib) & (xb - hib < 1e-6), hib, xb)
        self.xval[self.basic] = xb
        x = self.xval[:self.n].copy()
        obj = float(self.cvec[:self.n] @ x)
        basis = BasisState(self.basic.copy(), self.vstat.copy(),
                           self.Binv.copy(), self._updates)
        iters = (self.stats.primal_iterations + self.stats.dual_iterations
                 - getattr(self, "_iters0", 0))
        return LPResult("optimal", x, obj, basis=basis,
                        iterations=iters, warm_used=warm_used)


# ---------------------------------------------------------------------------
def solve_lp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, ub=None,
             max_iter: int = 20000, lo=None,
             warm: Optional[BasisState] = None) -> LPResult:
    """One-shot bounded-variable LP solve (backwards-compatible API).

    ``ub``/``lo`` are per-variable bounds (default ``[0, +inf)``)."""
    c = np.asarray(c, float)
    n = c.size
    has_rows = ((A_ub is not None and len(A_ub) > 0)
                or (A_eq is not None and len(A_eq) > 0))
    lo_v = np.zeros(n) if lo is None else np.asarray(lo, float)
    hi_v = np.full(n, np.inf) if ub is None else np.asarray(ub, float)
    if not has_rows:
        # box-constrained: each var independently at its cheaper bound
        x = np.where(c >= 0, lo_v, hi_v)
        if not np.isfinite(x).all():
            return LPResult("unbounded", None, -np.inf)
        return LPResult("optimal", x, float(c @ x))
    solver = BoundedSimplex(c, A_ub, b_ub, A_eq, b_eq)
    return solver.solve(lo_v, hi_v, warm=warm, max_iter=max_iter)
