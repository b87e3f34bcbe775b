"""The port's DES (``engine="des"``) against the reference DES, exactly.

The DES is copied numpy code, so every result field must match bit for
bit on the same seeded inputs: the three canonical applications and the
serving DAG, both priority orders, tight and loose deadlines, the engine
flags, a provider portfolio with price traces, a release stream and a
straggler injection.
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
from repro_torch.core import convert, cost as pcost
from tests.test_torch_harness import (FIELDS, assert_bitwise, grid_for,
                                      reference, workload)

J = 24


@pytest.fixture(scope="module")
def ref():
    return reference()


def _pair(ref, name):
    if name == "llm_serve":
        d = ref.serving_dag()
        return d, convert.dag_from_fields(dataclasses.asdict(d))
    return ref.core.APPS[name], pc.APPS[name]


@pytest.mark.parametrize("order", ["spt", "hcf"])
@pytest.mark.parametrize("name", ["image", "matrix", "video", "llm_serve"])
def test_des_matches_reference(ref, name, order):
    dag_r, dag_p = _pair(ref, name)
    pred, act = workload(dag_r, J, 3)
    for c in grid_for(dag_r, pred):
        want = ref.simulator.simulate(dag_r, pred, act, c_max=c, order=order)
        got = pc.simulate(dag_p, pred, act, c_max=c, order=order)
        assert_bitwise(got, want, where=f"{name} {order} c={c:.3f}")
        assert got.release is None and want.release is None


@pytest.mark.parametrize("flags", [
    dict(include_transfers=False, adaptive=False),
    dict(init_phase=False),
    dict(adaptive=False)], ids=["no_transfers", "no_init", "no_adaptive"])
def test_des_flag_variants(ref, flags):
    pred, act = workload(ref.core.APPS["video"], J, 2)
    c = grid_for(ref.core.APPS["video"], pred)[1]
    want = ref.simulator.simulate(ref.core.APPS["video"], pred, act,
                                  c_max=c, **flags)
    got = pc.simulate(pc.APPS["video"], pred, act, c_max=c, **flags)
    assert_bitwise(got, want)


def test_des_portfolio_traces_release_and_stragglers(ref):
    pf_r = ref.cost.spot_portfolio(3, num_segments=4, horizon_s=20.0)
    pf_p = convert.portfolio_from_fields(dataclasses.asdict(pf_r))
    assert pf_p == pcost.spot_portfolio(3, num_segments=4, horizon_s=20.0)
    pred, act = workload(ref.core.APPS["image"], J, 5)
    rel = np.sort(np.random.default_rng(5).uniform(0.0, 6.0, J))
    kw = dict(c_max=grid_for(ref.core.APPS["image"], pred)[1], order="hcf",
              arrivals=rel, replica_slowdown={(0, 1): 2.5, (2, 0): 1.7})
    want = ref.simulator.simulate(ref.core.APPS["image"], pred, act,
                                  portfolio=pf_r, **kw)
    got = pc.simulate(pc.APPS["image"], pred, act, portfolio=pf_p, **kw)
    assert_bitwise(got, want)
    np.testing.assert_array_equal(got.release, want.release)
    assert (got.provider >= 0).any()


def test_des_fault_recovery(ref):
    """The fault layer is copied with the DES (the engine rejects it)."""
    pred, act = workload(ref.core.APPS["matrix"], J, 6)
    kw = dict(c_max=grid_for(ref.core.APPS["matrix"], pred)[0])
    want = ref.simulator.simulate(ref.core.APPS["matrix"], pred, act,
                                  faults=0.3, **kw)
    got = pc.simulate(pc.APPS["matrix"], pred, act, faults=0.3, **kw)
    assert_bitwise(got, want, fields=FIELDS)
    assert want.failed.sum() > 0
