"""The exact bounds of the port (``repro_torch.core.milp``) against the
reference's, and against the port's greedy engines.

Each MILP case builds the same instance for both packages and solves it
with each. A recorder wrapped around ``scipy.optimize.milp`` in each
module (it calls through) holds the problems equal first: the objective,
the constraint matrix entry for entry as sparse COO, the row bounds, the
variable bounds, the integrality vector and the options. Then the
solutions: status, feasibility, placements, providers, segments and start
times equal, cost and dual bound ``isclose``. Every instance is small
enough that HiGHS proves optimality well inside its time limit, so the
incumbent does not depend on the machine's speed. The reference suites'
own assertions (``tests/test_milp.py``, ``tests/test_pricetrace.py``) then
run on the port's solution against the port's DES and vector engine (on
the CPU).
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
from repro_torch.core import convert
from repro_torch.core import milp as pmilp
from tests.test_torch_harness import reference


@pytest.fixture(scope="module")
def ref():
    return reference()


def _rmilp():
    import repro.core.milp as rmilp

    return rmilp


def _port_dag(dag):
    return convert.dag_from_fields(dataclasses.asdict(dag))


def _port_pf(pf):
    return convert.portfolio_from_fields(dataclasses.asdict(pf))


def _recorder(fn, calls):
    def rec(**kw):
        calls.append(kw)
        return fn(**kw)
    return rec


def _assert_same_problem(a, b):
    np.testing.assert_array_equal(a["c"], b["c"])
    ca, cb = a["constraints"], b["constraints"]
    A, B = ca.A.tocoo(), cb.A.tocoo()
    assert A.shape == B.shape
    for fld in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(A, fld), getattr(B, fld),
                                      err_msg=f"A.{fld}")
    np.testing.assert_array_equal(ca.lb, cb.lb)
    np.testing.assert_array_equal(ca.ub, cb.ub)
    np.testing.assert_array_equal(a["bounds"].lb, b["bounds"].lb)
    np.testing.assert_array_equal(a["bounds"].ub, b["bounds"].ub)
    np.testing.assert_array_equal(a["integrality"], b["integrality"])
    assert a["options"] == b["options"]


def solve_both(monkeypatch, dag, args, portfolio=None, **kw):
    """``solve_milp`` of the reference and of the port on one instance
    (reference objects in, the port's twins built from their fields):
    the problems handed to HiGHS equal, the solutions equal. Returns the
    port's result."""
    rmilp = _rmilp()
    calls_r, calls_p = [], []
    monkeypatch.setattr(rmilp, "milp", _recorder(rmilp.milp, calls_r))
    monkeypatch.setattr(pmilp, "milp", _recorder(pmilp.milp, calls_p))
    want = rmilp.solve_milp(dag, *args, portfolio=portfolio, **kw)
    got = pc.solve_milp(_port_dag(dag), *args,
                        portfolio=None if portfolio is None
                        else _port_pf(portfolio), **kw)
    assert len(calls_r) == len(calls_p) == 1
    _assert_same_problem(calls_p[0], calls_r[0])
    assert got.status == want.status
    assert got.feasible == want.feasible
    for fld in ("e", "s", "provider", "segment"):
        np.testing.assert_array_equal(getattr(got, fld), getattr(want, fld),
                                      err_msg=fld)
    assert np.isclose(got.cost_usd, want.cost_usd, rtol=1e-12, atol=0) \
        or got.cost_usd == want.cost_usd
    assert np.isclose(got.objective_bound, want.objective_bound,
                      rtol=1e-12, atol=0)
    if got.feasible:
        assert got.status == 0, "HiGHS must prove optimality in time"
    return got


def _instance(rng, dag, J):
    P_priv = rng.uniform(1.0, 4.0, (J, dag.num_stages))
    P_pub = P_priv * rng.uniform(0.4, 0.8, (J, dag.num_stages))
    U = np.full_like(P_priv, 0.1)
    D = np.full_like(P_priv, 0.1)
    return P_priv, P_pub, U, D


def test_milp_beats_or_matches_greedy(ref, monkeypatch, rng):
    dag = ref.core.matrix_app(replicas=2)
    J = 6
    P_priv, P_pub, U, D = _instance(rng, dag, J)
    c_max = float(P_priv.sum() / 3.0)
    m = solve_both(monkeypatch, dag, (P_priv, P_pub, c_max, U, D),
                   time_limit_s=30)
    assert m.feasible
    pred = dict(P_private=P_priv, P_public=P_pub, upload=U, download=D)
    for order in ("spt", "hcf"):
        g = pc.simulate(_port_dag(dag), pred, c_max=c_max, order=order)
        assert m.cost_usd <= g.cost_usd + 1e-9
        assert g.met_deadline


def test_milp_all_private_when_loose(ref, monkeypatch, rng):
    dag = ref.core.matrix_app(replicas=2)
    P_priv, P_pub, U, D = _instance(rng, dag, 4)
    m = solve_both(monkeypatch, dag, (P_priv, P_pub), c_max=1e4,
                   time_limit_s=20)
    assert m.feasible
    assert m.cost_usd == pytest.approx(0.0, abs=1e-12)
    assert m.e.all()


def test_milp_infeasible_when_impossible(ref, monkeypatch, rng):
    dag = ref.core.matrix_app(replicas=1)
    P_priv, P_pub, U, D = _instance(rng, dag, 4)
    m = solve_both(monkeypatch, dag, (P_priv, P_pub), c_max=1e-3,
                   upload=U, download=D, time_limit_s=20)
    assert not m.feasible
    assert m.cost_usd == float("inf")
    assert (m.provider == -1).all() and (m.segment == -1).all()


def test_milp_respects_precedence(ref, monkeypatch, rng):
    dag = ref.core.video_app(replicas=1)
    J = 3
    P_priv, P_pub, U, D = _instance(rng, dag, J)
    c_max = float(P_priv.sum() / 1.5)
    m = solve_both(monkeypatch, dag, (P_priv, P_pub, c_max),
                   time_limit_s=60, include_sink_download=False)
    assert m.feasible
    for j in range(J):
        for (p, q) in dag.edges:
            dur_p = P_priv[j, p] if m.e[j, p] else P_pub[j, p]
            assert m.s[j, q] >= m.s[j, p] + dur_p - 1e-6


def test_johnson_is_optimal_lower_bound(ref):
    """The port's DES all-private makespan >= Johnson's optimal F2||Cmax,
    and the port's Johnson equals the reference's."""
    dag = pc.matrix_app(replicas=1)
    for seed in range(5):
        r = np.random.default_rng(seed)
        P = r.uniform(0.5, 4.0, (8, 2))
        pred = dict(P_private=P, P_public=P)
        res = pc.simulate_all_private(dag, pred)
        got = pc.johnson_makespan(P)
        assert got == ref.core.johnson_makespan(P)
        assert res.makespan >= got - 1e-9


def test_johnson_known_case(ref):
    P = np.array([[3.0, 2.0], [1.0, 4.0]])
    assert pc.johnson_makespan(P) == pytest.approx(7.0)
    assert pc.johnson_makespan(P) == ref.core.johnson_makespan(P)


def test_knapsack_bound(ref, rng):
    P = rng.uniform(1, 3, 10)
    H = rng.uniform(0.1, 1.0, 10)
    lb = pc.knapsack_lower_bound(P, H, c_max=5.0, replicas=2)
    assert lb == ref.core.knapsack_lower_bound(P, H, c_max=5.0, replicas=2)
    assert 0 <= lb <= H.sum()


def test_milp_deep_past_breakpoint_stays_feasible(ref, monkeypatch):
    """A segment lying entirely before t=0 is excluded by bounds, not by a
    window row: feasible, and equal to the identical static portfolio."""
    dag = ref.core.matrix_app(replicas=2)
    rng = np.random.default_rng(3)
    P_priv = rng.uniform(1.0, 4.0, (2, 2))
    P_pub = P_priv * 0.6
    c_max = 30.0
    base = ref.core.demo_portfolio(1)
    past = ref.core.ProviderPortfolio(tuple(
        p.with_trace(ref.core.PriceTrace(
            usd_per_gb_ms=(p.usd_per_gb_ms,) * 2,
            egress_usd_per_gb=(p.egress_usd_per_gb,) * 2,
            latency_mult=(p.latency_mult,) * 2,
            breakpoints=(-1e6,))) for p in base.providers))
    m0 = solve_both(monkeypatch, dag, (P_priv, P_pub, c_max), portfolio=base,
                    time_limit_s=20)
    m1 = solve_both(monkeypatch, dag, (P_priv, P_pub, c_max), portfolio=past,
                    time_limit_s=20)
    assert m0.feasible and m1.feasible
    assert m1.cost_usd == pytest.approx(m0.cost_usd, rel=1e-9, abs=1e-12)
    assert (m1.segment[m1.provider >= 0] == 1).all()


def test_milp_lower_bounds_greedy_on_spot_portfolio(ref, monkeypatch, rng):
    dag = ref.core.matrix_app(replicas=2)
    Jm = 5
    P_priv = rng.uniform(1.0, 4.0, (Jm, 2))
    P_pub = P_priv * rng.uniform(0.4, 0.8, (Jm, 2))
    U = np.full_like(P_priv, 0.1)
    D = np.full_like(P_priv, 0.1)
    c_max = float(P_priv.sum() / 5.0)
    rpf = ref.core.spot_portfolio(3, 4, horizon_s=c_max * 1.2)
    m = solve_both(monkeypatch, dag, (P_priv, P_pub, c_max, U, D),
                   portfolio=rpf, time_limit_s=60)
    assert m.feasible
    assert m.segment is not None and m.segment.max() >= 0
    pf = _port_pf(rpf)
    edges = pf.segment_edges()
    for j in range(Jm):
        for k in range(dag.num_stages):
            p, s = m.provider[j, k], m.segment[j, k]
            if p < 0:
                continue
            lo = edges[p, s]
            hi = edges[p, s + 1] if s + 1 < edges.shape[1] else np.inf
            up = pf.latency_mults_seg()[p, s] * U[j, k]
            assert m.s[j, k] >= min(lo, 0.0) - 1e-9
            assert m.s[j, k] <= hi + up + 1e-9
    pred = dict(P_private=P_priv, P_public=P_pub, upload=U, download=D)
    pdag = _port_dag(dag)
    for order in ("spt", "hcf"):
        for engine in ("des", "vector"):
            g = pc.simulate(pdag, pred, c_max=c_max, order=order,
                            portfolio=pf, engine=engine, device="cpu")
            assert m.cost_usd <= g.cost_usd + 1e-9
