"""``SkedulixScheduler`` end to end: the port's service against the
reference's on the same DAG, portfolio and predictions."""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
from repro_torch.core import convert
from tests.test_torch_harness import (assert_bitwise, grid_for, reference,
                                      workload)

J = 16


@pytest.fixture(scope="module")
def ref():
    return reference()


def _schedulers(ref, name, portfolio):
    dag_r = ref.serving_dag() if name == "llm_serve" else ref.core.APPS[name]
    dag_p = convert.dag_from_fields(dataclasses.asdict(dag_r))
    pf_r = ref.cost.demo_portfolio(3) if portfolio else None
    pf_p = (convert.portfolio_from_fields(dataclasses.asdict(pf_r))
            if portfolio else None)
    return (ref.scheduler.SkedulixScheduler(dag_r, portfolio=pf_r),
            pc.SkedulixScheduler(dag_p, portfolio=pf_p), dag_r)


@pytest.mark.parametrize("name,portfolio", [("video", False),
                                            ("llm_serve", True)])
def test_schedule_sweep_matches_reference(ref, name, portfolio):
    s_r, s_p, dag = _schedulers(ref, name, portfolio)
    pred, act = workload(dag, J, 4)
    kw = dict(c_max_grid=grid_for(dag, pred), orders=("spt", "hcf"))
    want = s_r.schedule_sweep(pred=pred, act=act, engine_impl="pallas",
                              **kw)
    got = s_p.schedule_sweep(pred=pred, act=act, device="cpu", **kw)
    assert_bitwise(got, want)
    des = s_p.schedule_sweep(pred=pred, act=act, engine="des", **kw)
    np.testing.assert_array_equal(got.public_mask, des.public_mask)
    np.testing.assert_allclose(got.cost_usd, des.cost_usd, rtol=1e-12)


def test_schedule_and_baselines_match_reference(ref):
    s_r, s_p, dag = _schedulers(ref, "image", True)
    pred, act = workload(dag, J, 5)
    c = grid_for(dag, pred)[1]
    for order in ("spt", "hcf"):
        want = s_r.schedule(c, pred=pred, act=act, order=order)
        got = s_p.schedule(c, pred=pred, act=act, order=order)
        assert_bitwise(got.result, want.result)
        assert got.summary() == want.summary()
        vec = s_p.schedule(c, pred=pred, act=act, order=order,
                           engine="vector", device="cpu")
        np.testing.assert_array_equal(vec.result.public_mask,
                                      want.result.public_mask)
    assert_bitwise(s_p.baseline_all_public(pred, act),
                   s_r.baseline_all_public(pred, act))
    assert_bitwise(s_p.baseline_all_private(pred, act),
                   s_r.baseline_all_private(pred, act))


def test_unported_inputs_raise():
    sched = pc.SkedulixScheduler(pc.APPS["matrix"])
    with pytest.raises(NotImplementedError, match="pred="):
        sched.schedule_sweep((10.0,), base_features=np.ones((4, 3)))
    with pytest.raises(NotImplementedError, match="workload"):
        sched.schedule(10.0, workload="azure:day=tue,scale=100")
    pred, act = workload(pc.APPS["matrix"], J, 0)
    with pytest.raises(NotImplementedError, match="faults"):
        sched.schedule_sweep((10.0,), pred=pred, device="cpu", faults=0.1)
