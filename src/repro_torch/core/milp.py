"""Exact reference solvers for the hybrid-cloud scheduling problem.

Host code (numpy and scipy's HiGHS): the MILP is the bound the batched
engine is measured against, not part of it, so nothing here runs on the
GPU. The module follows the JAX package's ``core/milp.py`` line for line,
so both hand HiGHS the same problem.

* :func:`solve_milp` — the appendix MILP (Eqns. 2-16) built verbatim and
  handed to scipy's HiGHS branch-and-cut (the paper used Gurobi). Used for
  the Fig.-3 "optimal vs greedy" comparison at small job counts. Placement
  is provider- **and segment-** indexed: binary ``g_{j,k,p,s}`` puts
  (job, stage) on public provider p billed in price segment s of the
  provider's :class:`.cost.PriceTrace` (static providers have one
  segment, recovering the provider-indexed ``g_{j,k,p}`` model, which reduces
  to the paper's e/(1-e) formulation for one provider). Big-M window rows
  tie a chosen segment to the stage's start time — relaxed by the
  provider's upload latency, since the simulator locks the segment at the
  *offload epoch* (before upload), so the constraint never cuts a
  schedule the greedy engines could execute and the optimum stays a true
  lower bound. Provider-dependent *edge* transfer latencies enter the
  precedence rows through the portfolio's fastest multiplier, and
  cross-provider cascade egress is not charged (both relaxations — the
  bound only loosens); sink downloads are (provider, segment)-exact.
* :func:`johnson_makespan` — exact F2||Cmax makespan (Johnson's rule) for
  2-stage/1-replica all-private instances; a simulator ground truth.
* :func:`knapsack_lower_bound` — the appendix "special case": with one
  stage the problem reduces to multiple knapsacks of size C_max.

All three solvers model the **failure-free** problem. Under a
:class:`.faults.FaultModel` the simulators bill retries, lost partial
work and private fallbacks that no MILP variable accounts for, so the
MILP optimum is a *lower bound* on the faulty engines' cost whose gap
grows with the failure rate and outage coverage — compare against
fault-free runs (``faults=None``) for the Fig.-3 optimality check.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from .coldstart import as_pool_trace
from .cost import CostModel, LAMBDA_COST, ProviderPortfolio, as_portfolio
from .dag import AppDAG


@dataclasses.dataclass
class MilpResult:
    status: int                 # scipy milp status (0 = optimal)
    feasible: bool
    cost_usd: float             # public-cloud cost of the incumbent
    e: np.ndarray               # [J, M] 1 = private, 0 = public
    s: np.ndarray               # [J, M] start times
    mip_gap: float
    objective_bound: float      # best provable lower bound on public cost
    provider: Optional[np.ndarray] = None  # [J, M] -1 private, else index
    segment: Optional[np.ndarray] = None   # [J, M] -1 private, else price segment


def solve_milp(
    dag: AppDAG,
    P_private: np.ndarray,
    P_public: np.ndarray,
    c_max: float,
    upload: Optional[np.ndarray] = None,
    download: Optional[np.ndarray] = None,
    cost_model: CostModel = LAMBDA_COST,
    include_sink_download: bool = True,
    time_limit_s: float = 120.0,
    mip_rel_gap: float = 1e-3,
    portfolio: Optional[ProviderPortfolio] = None,
    concurrency=None,
    coldstart=None,
    pool_trace=None,
) -> MilpResult:
    """Build and solve the appendix MILP, provider- and segment-indexed.

    Decision vars: start times s_{k,j}; e_{k,j} (1=private); placement
    g_{k,j,p,s} (1 = public on provider p billed in price segment s, with
    e + sum_{p,s} g = 1); replica assignment x^i_{k,j}; pair orders
    y^r_{k,j}; transfer indicators u_{k,j}, d_{k,j}. Objective (2),
    portfolio form: minimize the billed public cost
    sum g_{k,j,p,s} * H[p,s,j,k]. Segment windows are big-M rows relaxed
    by the provider's upload latency (the simulator locks the segment at
    the offload epoch, i.e. before upload), so the bound stays valid for
    every executable schedule; a static portfolio has one segment per
    provider and the rows vanish.

    Load-dependent latency (``concurrency``/``coldstart``/``pool_trace``,
    the :mod:`.coldstart` configs of the simulators) is accepted for API
    symmetry but **relaxed away**: the MILP models every public provider
    as uncapped (no FIFO queueing delay) and every replica as always
    warm (no warm-up penalty) — both effects only *add* time and billed
    cost to an executable schedule, so dropping them keeps the optimum a
    valid lower bound, with a gap that grows with congestion. A
    ``pool_trace`` provisions the pod at the trace's per-stage *maximum*
    for the whole horizon (strictly more private capacity than any
    executable schedule ever has), the same relaxation direction.
    """
    ptr = as_pool_trace(pool_trace)
    if ptr is not None:
        dag = dag.with_replicas(
            ptr.materialize(dag.num_stages).max(axis=0))
    del concurrency, coldstart  # relaxed away (see docstring)
    P_priv = np.asarray(P_private, dtype=np.float64)
    P_pub = np.asarray(P_public, dtype=np.float64)
    J, M = P_priv.shape
    U = np.zeros((J, M)) if upload is None else np.asarray(upload, dtype=np.float64)
    D = np.zeros((J, M)) if download is None else np.asarray(download, dtype=np.float64)
    pf = as_portfolio(portfolio, cost_model)
    nP = pf.num_providers
    nS = pf.num_segments
    sink_mask = dag.is_sink if include_sink_download else None
    H_ps = pf.np_stage_costs_seg(P_pub, dag.mem_mb,
                                 D if include_sink_download else None,
                                 sink_mask)                    # [P, S, J, M]
    feas = pf.feasible_mask(dag.mem_mb,
                            require=~dag.must_private_mask)    # [P, M]
    lat = pf.latency_mults_seg()                               # [P, S]
    edges = pf.segment_edges()                                 # [P, S]
    seg_lo = edges                                             # [P, S]
    seg_hi = np.concatenate([edges[:, 1:],
                             np.full((nP, 1), np.inf)], axis=1)
    # provider-dependent transfer latency on DAG edges would need
    # provider-indexed u/d indicators; the fastest multiplier keeps those
    # rows a relaxation (never over-constrains), so the optimum stays a
    # valid lower bound for every placement. Exact for one provider.
    min_lat = float(lat.min())
    repl = dag.replicas
    Q = float(c_max + P_priv.sum() + float(lat.max()) * P_pub.sum()
              + U.sum() + D.sum() + 1.0)
    BIG = float(max(dag.stages[k].replicas for k in range(M)) + M + J + 1)

    # ---- variable layout ------------------------------------------------
    idx = 0
    def _block(n):
        nonlocal idx
        lo = idx
        idx += n
        return lo
    s0 = _block(J * M)
    e0 = _block(J * M)
    g0 = _block(J * M * nP * nS)
    x_index: Dict[Tuple[int, int, int], int] = {}
    for k in range(M):
        for j in range(J):
            for i in range(int(repl[k])):
                x_index[(j, k, i)] = _block(1)
    y_index: Dict[Tuple[int, int, int], int] = {}
    for k in range(M):
        for j in range(J):
            for r in range(j + 1, J):
                y_index[(j, r, k)] = _block(1)
    u0 = _block(J * M)
    d0 = _block(J * M)
    n_var = idx
    def S(j, k):
        return s0 + j * M + k

    def E(j, k):
        return e0 + j * M + k

    def G(j, k, p, s):
        return g0 + ((j * M + k) * nP + p) * nS + s

    def Uv(j, k):
        return u0 + j * M + k

    def Dv(j, k):
        return d0 + j * M + k

    rows: List[Dict[int, float]] = []
    lbs: List[float] = []
    ubs: List[float] = []
    def _con(coef: Dict[int, float], lo: float, hi: float):
        rows.append(coef)
        lbs.append(lo)
        ubs.append(hi)

    sinks = set(dag.sinks())
    sources = set(dag.sources())
    for j in range(J):
        for k in range(M):
            # placement partition: e + sum_{p,s} g = 1
            coef = {E(j, k): 1.0}
            for p in range(nP):
                for s in range(nS):
                    coef[G(j, k, p, s)] = 1.0
            _con(coef, 1.0, 1.0)
            # (3) deadline: s + Ppriv*e + sum_{p,s} (latmult_ps*Ppub
            #     [+ latmult_ps*Ddl at sinks]) * g_ps <= Cmax
            is_sink_dl = include_sink_download and k in sinks
            coef = {S(j, k): 1.0, E(j, k): P_priv[j, k]}
            for p in range(nP):
                for s in range(nS):
                    dur = lat[p, s] * P_pub[j, k]
                    if is_sink_dl:
                        dur += lat[p, s] * D[j, k]
                    coef[G(j, k, p, s)] = dur
            _con(coef, -np.inf, c_max)
            # (5) sum_i x = e
            coef = {E(j, k): -1.0}
            for i in range(int(repl[k])):
                coef[x_index[(j, k, i)]] = 1.0
            _con(coef, 0.0, 0.0)
            # source upload: batch input lives in private storage, so a
            # public source start waits for its provider's upload
            if k in sources:
                coef = {S(j, k): 1.0}
                for p in range(nP):
                    for s in range(nS):
                        coef[G(j, k, p, s)] = -lat[p, s] * U[j, k]
                _con(coef, 0.0, np.inf)
            # segment windows: g_{j,k,p,s} = 1 pins the *offload epoch*
            # (= start minus upload) inside segment s. Lower: the start
            # can be no earlier than the segment's opening (s_jk >= lo*g,
            # vacuous for lo <= 0). Upper: the epoch precedes the next
            # breakpoint, so s_jk <= hi + latmult*U + Q*(1 - g) — the
            # upload slack keeps every executable schedule feasible
            # (a relaxation; both rows vanish for 1-segment providers).
            # Segments ending at hi < 0 lie entirely in the past — no
            # epoch (>= 0) can land there, so g is fixed to 0 below
            # instead of emitting a row whose big-M could not cover |hi|.
            for p in range(nP):
                for s in range(nS):
                    lo, hi = seg_lo[p, s], seg_hi[p, s]
                    if np.isfinite(lo) and lo > 0.0:
                        _con({S(j, k): 1.0, G(j, k, p, s): -lo},
                             0.0, np.inf)
                    if np.isfinite(hi) and hi >= 0.0:
                        _con({S(j, k): 1.0, G(j, k, p, s): Q},
                             -np.inf, hi + lat[p, s] * U[j, k] + Q)
    # (4) precedence + transfer latencies along edges
    for j in range(J):
        for (p, q) in dag.edges:
            coef = {S(j, q): 1.0, S(j, p): -1.0,
                    E(j, p): -P_priv[j, p],
                    Uv(j, p): -min_lat * U[j, p],
                    Dv(j, p): -min_lat * D[j, p]}
            for pi in range(nP):
                for s in range(nS):
                    coef[G(j, p, pi, s)] = -lat[pi, s] * P_pub[j, p]
            _con(coef, 0.0, np.inf)
    # (6),(7) replica sequencing
    for k in range(M):
        for j in range(J):
            for r in range(j + 1, J):
                y = y_index[(j, r, k)]
                for i in range(int(repl[k])):
                    xj = x_index[(j, k, i)]
                    xr = x_index[(r, k, i)]
                    _con({S(j, k): 1.0, S(r, k): -1.0, y: Q, xj: -Q, xr: -Q},
                         P_priv[r, k] - 2 * Q, np.inf)
                    _con({S(r, k): 1.0, S(j, k): -1.0, y: -Q, xj: -Q, xr: -Q},
                         P_priv[j, k] - 3 * Q, np.inf)
    # (8)-(11) transfer indicators via X_p = deg_p*e_p - sum_succ e_q
    for j in range(J):
        for p in range(M):
            succ = dag.successors(p)
            if not succ:
                # sink download handled in (3); no upload var needed
                _con({Uv(j, p): 1.0}, 0.0, 0.0)
                _con({Dv(j, p): 1.0, E(j, p): 1.0}, 1.0, 1.0)  # d = 1-e at sinks
                continue
            xcoef = {E(j, p): float(len(succ))}
            for q in succ:
                xcoef[E(j, q)] = xcoef.get(E(j, q), 0.0) - 1.0
            # (8): X - BIG*u >= 0.001 - BIG   (9): X - BIG*u <= 0
            c8 = dict(xcoef)
            c8[Uv(j, p)] = c8.get(Uv(j, p), 0.0) - BIG
            _con(c8, 0.001 - BIG, np.inf)
            c9 = dict(xcoef)
            c9[Uv(j, p)] = c9.get(Uv(j, p), 0.0) - BIG
            _con(c9, -np.inf, 0.0)
            # (10): X + BIG*d <= BIG - 0.001  (11): X + BIG*d >= 0
            c10 = dict(xcoef)
            c10[Dv(j, p)] = c10.get(Dv(j, p), 0.0) + BIG
            _con(c10, -np.inf, BIG - 0.001)
            c11 = dict(xcoef)
            c11[Dv(j, p)] = c11.get(Dv(j, p), 0.0) + BIG
            _con(c11, 0.0, np.inf)
    # (12) privacy pins + provider feasibility (memory caps; padded
    # segments — ``+inf`` opening edge — and segments that end before
    # t=0 — no offload epoch can land in the past — can never activate)
    lb = np.zeros(n_var)
    ub = np.ones(n_var)
    ub[s0:s0 + J * M] = np.inf  # s >= 0 free above
    for j in range(J):
        for k in range(M):
            if dag.stages[k].must_private:
                lb[E(j, k)] = 1.0
            for p in range(nP):
                for s in range(nS):
                    if not feas[p, k] or seg_lo[p, s] == np.inf \
                            or seg_hi[p, s] < 0.0:
                        ub[G(j, k, p, s)] = 0.0

    # objective (2), portfolio form: minimize the billed public cost
    # sum g * H[p,s] (== maximizing the saved cost over any fixed provider)
    c = np.zeros(n_var)
    for j in range(J):
        for k in range(M):
            for p in range(nP):
                for s in range(nS):
                    c[G(j, k, p, s)] = H_ps[p, s, j, k]

    A = sp.lil_matrix((len(rows), n_var))
    for r, coef in enumerate(rows):
        for v, val in coef.items():
            A[r, v] = val
    integrality = np.ones(n_var)
    integrality[s0:s0 + J * M] = 0  # start times continuous

    res = milp(
        c=c,
        constraints=LinearConstraint(A.tocsr(), np.asarray(lbs), np.asarray(ubs)),
        integrality=integrality,
        bounds=Bounds(lb, ub),
        options={"time_limit": time_limit_s, "mip_rel_gap": mip_rel_gap,
                 "presolve": True},
    )
    if res.x is None:
        return MilpResult(status=int(res.status), feasible=False,
                          cost_usd=float("inf"), e=np.zeros((J, M)),
                          s=np.zeros((J, M)), mip_gap=float("inf"),
                          objective_bound=0.0,
                          provider=np.full((J, M), -1, dtype=np.int64),
                          segment=np.full((J, M), -1, dtype=np.int64))
    x = np.asarray(res.x)
    e = np.rint(x[e0:e0 + J * M].reshape(J, M))
    s = x[s0:s0 + J * M].reshape(J, M)
    g = np.rint(x[g0:g0 + J * M * nP * nS].reshape(J, M, nP, nS))
    flat = np.argmax(g.reshape(J, M, nP * nS), axis=2)
    provider = np.where(e > 0.5, -1, flat // nS).astype(np.int64)
    segment = np.where(e > 0.5, -1, flat % nS).astype(np.int64)
    cost = float((g * np.moveaxis(H_ps, (0, 1), (2, 3))).sum())
    # a dual bound of exactly 0.0 is a legitimate proof state (public cost
    # >= 0 always holds) — only fall back to the incumbent when HiGHS
    # reports no bound at all
    bound = getattr(res, "mip_dual_bound", None)
    return MilpResult(
        status=int(res.status), feasible=True, cost_usd=cost,
        e=e, s=s, mip_gap=float(getattr(res, "mip_gap", 0.0) or 0.0),
        objective_bound=float(res.fun if bound is None else bound),
        provider=provider, segment=segment)


def johnson_makespan(P: np.ndarray) -> float:
    """Optimal F2||Cmax makespan via Johnson's rule. ``P``: [J, 2]."""
    P = np.asarray(P, dtype=np.float64)
    first = sorted((j for j in range(P.shape[0]) if P[j, 0] <= P[j, 1]),
                   key=lambda j: P[j, 0])
    last = sorted((j for j in range(P.shape[0]) if P[j, 0] > P[j, 1]),
                  key=lambda j: -P[j, 1])
    t1 = t2 = 0.0
    for j in first + last:
        t1 += P[j, 0]
        t2 = max(t2, t1) + P[j, 1]
    return t2


def knapsack_lower_bound(P_private: np.ndarray, H: np.ndarray, c_max: float,
                         replicas: int) -> float:
    """Appendix special case (single stage == multiple knapsacks): an
    *upper* bound on savable cost via the fractional LP relaxation (greedy
    by H/P density), hence a *lower* bound on the optimal public cost."""
    P = np.asarray(P_private, dtype=np.float64).ravel()
    h = np.asarray(H, dtype=np.float64).ravel()
    cap = replicas * c_max
    order = np.argsort(-h / np.maximum(P, 1e-12))
    saved = 0.0
    for j in order:
        take = min(1.0, max(0.0, (cap) / P[j]))
        saved += take * h[j]
        cap -= take * P[j]
        if cap <= 0:
            break
    return float(h.sum() - saved)
