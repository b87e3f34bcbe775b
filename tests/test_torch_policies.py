"""The policy harness of the port (``repro_torch.serving.policies``)
against the reference's, policies x engines.

The same request stream (the reference suite's: 48 requests, prompts in
[64, 2048), 16-256 new tokens, ``elastic_portfolio(3)``) goes through the
port's ``HybridServingScheduler`` on the CPU (``device="cpu"``: every
adaptive sweep runs the plain version of ``acd_evict``) and the
reference's, both latency models built with the reference's peak rates so
the predictions are the same numbers. The contract:

* the extracted policies reproduce the pre-refactor ``serve_online``
  body's ``simulate`` calls bit for bit in each engine, as in the
  reference's ``tests/test_policies.py``;
* against the reference, the DES field for field and the vector engine
  bit for bit, except a time the reference's XLA CPU build fuses into a
  multiply-add under a release stream with ``egress_lookahead`` (ROADMAP
  Queue 3 item 13): there the port equals its DES exactly and the
  reference to a relative 1e-14 (``assert_bitwise_or_des``);
* ``compare_policies`` (six policies x a fault axis, one sweep) the same,
  result by result, its attainment, offload and abandonment means equal
  to the DES's, and the Fig.-4 ordering of the reference suite.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core.arrivals import (MMPPArrivals, PoissonArrivals,
                                       resolve_release)
from repro_torch.core.faults import RetryPolicy
from repro_torch.core.simulator import simulate
from repro_torch.serving import (CostAnalysisPlacement, HybridServingScheduler,
                                 NoahSharedQueue, PolicyReport, PrivateOnly,
                                 PublicOnly, RandomFeasible,
                                 ServingLatencyModel, SkedulixGreedy,
                                 elastic_portfolio, policy_from_mode)
from repro_torch.serving import policies as ppol
from tests.test_torch_harness import (assert_bitwise, assert_bitwise_or_des,
                                      assert_parity, held_online, reference,
                                      twin)

POLICY_NAMES = ["skedulix", "private", "public", "random", "noah",
                "costanalysis"]
#: the result fields of one serve_online run the reference suite pins
RUN_FIELDS = ("makespan", "cost_usd", "public_mask", "completion", "start",
              "end", "provider", "replica", "segment", "attempts", "failed",
              "abandoned")


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def rhyb(ref):
    from repro.serving import hybrid

    return hybrid


@pytest.fixture(scope="module")
def sched(ref):
    """The port's scheduler on the CPU, its latency model at the
    reference's peak rates."""
    from repro.launch.roofline import HBM_BW, PEAK_FLOPS

    cfg = get_config("llama3-8b")
    return HybridServingScheduler(
        cfg, latency_model=ServingLatencyModel(cfg, peak_flops=PEAK_FLOPS,
                                               hbm_bw=HBM_BW),
        portfolio=elastic_portfolio(3), device="cpu")


@pytest.fixture(scope="module")
def rsched(ref, rhyb):
    return rhyb.HybridServingScheduler(ref.configs.get_config("llama3-8b"),
                                       portfolio=rhyb.elastic_portfolio(3))


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(0)
    J = 48
    return rng.integers(64, 2048, J), rng.integers(16, 256, J)


def pre_refactor_serve(sched, plen, ntok, arrivals, sla_s, replan_every_s,
                       engine, mode="hybrid", init_offload=False,
                       faults=None, retry=None):
    """The reference suite's verbatim pre-refactor serve_online body, on
    the port's ``simulate``."""
    pred, act = sched._pred_act(plen, ntok, seed=1, use_ridge=False)
    J = len(plen)
    release = resolve_release(arrivals, J, 0.0)
    if release is None:
        release = np.zeros(J)
    if replan_every_s > 0.0:
        admitted = np.ceil(release / replan_every_s) * replan_every_s
    else:
        admitted = release.copy()
    kw = dict(order="spt", cost_model=sched.cost_model,
              portfolio=sched.portfolio, arrivals=admitted, engine=engine,
              faults=faults, retry=retry, replica_slowdown=None,
              chunk_jobs=None, egress_lookahead=True, concurrency=None,
              coldstart=None, pool_trace=None, device="cpu")
    if mode == "hybrid":
        return simulate(sched.dag, pred, act, c_max=sla_s,
                        init_phase=bool(init_offload),
                        init_window=float(replan_every_s)
                        if init_offload else None, **kw)
    if mode == "private":
        return simulate(sched.dag, pred, act, c_max=sla_s,
                        init_phase=False, adaptive=False, **kw)
    blocked = dict(pred)
    blocked["P_private"] = np.full_like(pred["P_private"], 1e12)
    res = simulate(sched.dag, blocked, act, c_max=0.0,
                   adaptive=False, **kw)
    return dataclasses.replace(res, deadline=sla_s)


def assert_bit_exact(res, want):
    assert_bitwise(res, want, fields=RUN_FIELDS)
    assert res.deadline == want.deadline


SCENARIOS = [
    # (arrivals, faults, retry, init_offload)
    (PoissonArrivals(rate=8.0, seed=7), None, None, False),
    (PoissonArrivals(rate=8.0, seed=7), None, None, True),
    (MMPPArrivals(rates=(2.0, 24.0), dwell=(6.0, 3.0), seed=11),
     0.3, RetryPolicy(max_attempts=3), False),
]


@pytest.mark.parametrize("engine", ["des", "vector"])
@pytest.mark.parametrize("scenario", range(len(SCENARIOS)))
def test_skedulix_bit_exact(sched, rsched, stream, engine, scenario):
    """SkedulixGreedy (and the legacy ``mode="hybrid"``) reproduce the
    pre-refactor calls bit for bit, and the reference's serve_online."""
    plen, ntok = stream
    arr, faults, retry, init_off = SCENARIOS[scenario]
    want = pre_refactor_serve(sched, plen, ntok, arr, sla_s=4.0,
                              replan_every_s=0.5, engine=engine,
                              mode="hybrid", init_offload=init_off,
                              faults=faults, retry=retry)
    rep = held_online(sched, rsched, plen, ntok, arr, engine,
                      policy=SkedulixGreedy(init_offload=init_off),
                      sla_s=4.0, replan_every_s=0.5, use_ridge=False,
                      faults=faults, retry=retry)
    assert_bit_exact(rep.result, want)
    legacy = sched.serve_online(
        plen, ntok, arr, sla_s=4.0, replan_every_s=0.5, use_ridge=False,
        engine=engine, faults=faults, retry=retry, mode="hybrid",
        init_offload=init_off)
    assert_bit_exact(legacy.result, want)


@pytest.mark.parametrize("engine", ["des", "vector"])
@pytest.mark.parametrize("mode,policy", [
    ("private", PrivateOnly()), ("public", PublicOnly())])
def test_brackets_bit_exact(sched, rsched, stream, engine, mode,
                            policy):
    plen, ntok = stream
    arr = PoissonArrivals(rate=8.0, seed=7)
    want = pre_refactor_serve(sched, plen, ntok, arr, sla_s=4.0,
                              replan_every_s=0.5, engine=engine, mode=mode)
    rep = held_online(sched, rsched, plen, ntok, arr, engine,
                      policy=policy, sla_s=4.0, replan_every_s=0.5,
                      use_ridge=False)
    assert_bit_exact(rep.result, want)


def _compare(s, plen, ntok, engine, arrivals, retry):
    return s.compare_policies(
        plen, ntok, POLICY_NAMES, sla_s=4.0, arrivals=arrivals,
        replan_every_s=0.5, use_ridge=False, engine=engine,
        faults=[None, 0.3], retry=retry)


@pytest.fixture(scope="module")
def reports(ref, sched, rsched, stream):
    """The Fig.-4 comparison on the port's engine and DES and on the
    reference's vector engine."""
    plen, ntok = stream
    arr, retry = PoissonArrivals(rate=8.0, seed=7), RetryPolicy(
        max_attempts=3)
    port = _compare(sched, plen, ntok, "vector", arr, retry)
    policy_s = ppol._LAST_POLICY_STATS["policy_s"]
    des = _compare(sched, plen, ntok, "des", arr, retry)
    want = _compare(rsched, plen, ntok, "vector", twin(arr), twin(retry))
    return port, des, want, policy_s


def test_compare_policies_matches_reference_and_des(reports):
    port, des, want, _ = reports
    assert port.policies == want.policies == tuple(POLICY_NAMES)
    np.testing.assert_array_equal(port.release, want.release)
    for i, name in enumerate(port.policies):
        assert_parity(port.results[i], des.results[i], where=name)
        assert_bitwise_or_des(port.results[i], want.results[i],
                              des.results[i], where=name)
        np.testing.assert_array_equal(port.results[i].deadline,
                                      want.results[i].deadline)
    for fld in ("sla", "offload_frac", "abandoned_frac"):
        np.testing.assert_array_equal(getattr(port, fld), getattr(des, fld),
                                      err_msg=fld)
    np.testing.assert_array_equal(port.cost_usd,
                                  np.stack([r.cost_usd
                                            for r in port.results]))


def test_hybrid_cost_fraction_at_matched_attainment(reports):
    port = reports[0]
    hyb, pub = port["skedulix"], port["public"]
    assert hyb["cost_usd"] <= 0.5 * pub["cost_usd"]
    assert hyb["sla"] >= pub["sla"] - 0.05


def test_private_public_bracket_hybrids(reports):
    port = reports[0]
    pub, priv = port["public"], port["private"]
    assert priv["cost_usd"] == 0.0
    for name in ("skedulix", "noah", "costanalysis", "random"):
        row = port[name]
        assert pub["cost_usd"] >= row["cost_usd"] - 1e-12
        assert priv["sla"] <= row["sla"] + 1e-9


def test_report_shape(reports):
    report, _, want, policy_s = reports
    assert isinstance(report, PolicyReport)
    n = len(report.policies)
    assert report.cost_usd.shape == report.sla.shape \
        == report.makespan.shape == (n, 2)
    assert len(report.results) == n
    assert report.plan_s == policy_s >= 0.0
    assert "skedulix" in report.table()
    assert report.table().splitlines()[0] == want.table().splitlines()[0]
    with pytest.raises(KeyError):
        report["nope"]


def test_engines_agree(reports):
    port, des, _, _ = reports
    np.testing.assert_allclose(des.cost_usd, port.cost_usd, rtol=1e-9)
    np.testing.assert_allclose(des.sla, port.sla, rtol=1e-9)
    np.testing.assert_allclose(des.makespan, port.makespan, rtol=1e-9)


def test_random_feasible_is_seeded_and_partial(sched, rsched, stream):
    plen, ntok = stream
    arr = PoissonArrivals(rate=8.0, seed=7)
    kw = dict(sla_s=4.0, replan_every_s=0.5, use_ridge=False)
    a = held_online(sched, rsched, plen, ntok, arr, "vector",
                    policy=RandomFeasible(seed=3), **kw)
    b = sched.serve_online(plen, ntok, arr, engine="vector",
                           policy=RandomFeasible(seed=3), **kw)
    assert a.result.cost_usd == b.result.cost_usd
    assert 0.0 < a.result.offload_fraction < 1.0


def test_noah_spills_under_overload_only(sched, rsched, stream):
    plen, ntok = stream
    calm = held_online(sched, rsched, plen, ntok,
                       PoissonArrivals(rate=1.0, seed=7), "vector",
                       policy=NoahSharedQueue(), sla_s=30.0,
                       replan_every_s=0.5, use_ridge=False)
    burst = held_online(sched, rsched, plen, ntok,
                        MMPPArrivals(rates=(2.0, 24.0), dwell=(6.0, 3.0),
                                     seed=11), "des",
                        policy=NoahSharedQueue(), sla_s=2.5,
                        replan_every_s=0.25, use_ridge=False)
    assert calm.result.offload_fraction == 0.0
    assert burst.result.offload_fraction > 0.0


def test_costanalysis_budget_knob(sched, rsched, stream):
    plen, ntok = stream
    arr = MMPPArrivals(rates=(2.0, 24.0), dwell=(6.0, 3.0), seed=11)
    kw = dict(sla_s=2.5, replan_every_s=0.25, use_ridge=False)
    frugal = held_online(sched, rsched, plen, ntok, arr, "des",
                         policy=CostAnalysisPlacement(budget_frac=1e-6),
                         **kw)
    lavish = held_online(sched, rsched, plen, ntok, arr, "vector",
                         policy=CostAnalysisPlacement(budget_frac=1e6), **kw)
    assert frugal.result.offload_fraction == 0.0
    assert (lavish.result.offload_fraction
            >= frugal.result.offload_fraction)
    assert lavish.result.cost_usd >= frugal.result.cost_usd


def test_registry_and_validation(sched, stream):
    with pytest.raises(ValueError, match="unknown policy"):
        policy_from_mode("nope")
    with pytest.raises(ValueError, match="p_offload"):
        RandomFeasible(p_offload=1.5)
    with pytest.raises(ValueError, match="headroom"):
        NoahSharedQueue(headroom=0.0)
    with pytest.raises(ValueError, match="budget_frac"):
        CostAnalysisPlacement(budget_frac=-1.0)
    plen, ntok = stream
    with pytest.raises(ValueError, match="duplicate policy names"):
        sched.compare_policies(plen, ntok,
                               [SkedulixGreedy(), SkedulixGreedy()],
                               sla_s=4.0)
    assert sorted(ppol.POLICIES) == ["costanalysis", "hybrid", "noah",
                                     "private", "public", "random",
                                     "skedulix"]


def test_compare_policies_default_device_needs_a_gpu(sched, stream):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    plen, ntok = stream
    pred, act = sched._pred_act(plen, ntok, seed=1, use_ridge=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppol.compare_policies(["skedulix"], sched.dag, pred, act, sla_s=4.0)
    des = ppol.compare_policies(["skedulix"], sched.dag, pred, act,
                                sla_s=4.0, engine="des")
    assert des.cost_usd.shape == (1, 1)
