"""The port's copied core modules give the reference's values.

Priority keys, the initialization offload (numpy and the torch
counterpart), the ACD sweep and provider selection, the segment-indexed
cost matrices, ``CostModel``, release streams, and the ``convert`` round
trips that carry the reference's configuration objects across.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as pc
from repro_torch.core import convert, cost as pcost, greedy as pgreedy
from repro_torch.core import priority as pprio
from tests.test_torch_harness import reference


@pytest.fixture(scope="module")
def ref():
    return reference()


def _PH(seed, J=40, M=4):
    rng = np.random.default_rng(seed)
    P = rng.lognormal(0.0, 0.6, (J, M))
    H = rng.uniform(1e-6, 1e-4, (J, M))
    H[:5] = H[5:10]  # ties in the keys
    return P, H


@pytest.mark.parametrize("order", ["spt", "hcf"])
@pytest.mark.parametrize("stage", [None, 0, 2])
def test_priority_keys_identical(ref, order, stage):
    P, H = _PH(0)
    np.testing.assert_array_equal(pprio.ORDERS[order](P, H, stage),
                                  ref.priority.ORDERS[order](P, H, stage))
    keys = pprio.ORDERS[order](P, H, stage)
    ids = np.arange(P.shape[0])
    np.testing.assert_array_equal(pprio.sort_queue(ids, keys),
                                  ref.priority.sort_queue(ids, keys))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_init_offload_numpy_and_torch(ref, seed):
    rng = np.random.default_rng(seed)
    B, J = 6, 50
    C = rng.lognormal(0.0, 0.7, (B, J))
    keys = np.round(rng.uniform(0, 5, (B, J)), 1)  # ties: stable order
    cap = np.sum(C, axis=1) * rng.uniform(0.2, 0.9, B)
    want = np.stack([ref.greedy.init_offload(C[b], keys[b], cap[b])
                     for b in range(B)])
    got_np = np.stack([pgreedy.init_offload(C[b], keys[b], cap[b])
                       for b in range(B)])
    got_t = pgreedy.init_offload_torch(torch.from_numpy(C),
                                       torch.from_numpy(keys),
                                       torch.from_numpy(cap)).numpy()
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t, want)
    with ref.jax.enable_x64(True):
        import jax.numpy as jnp
        jx = np.stack([np.asarray(ref.greedy.init_offload_jax(
            jnp.asarray(C[b]), jnp.asarray(keys[b]), cap[b]))
            for b in range(B)])
    np.testing.assert_array_equal(got_t, jx)
    assert want.any() and not want.all()


def test_init_offload_torch_capacity_edge():
    """A prefix landing exactly on the capacity is kept (the 1e-12 slack),
    with the sum associated left to right as the DES sums."""
    C = torch.tensor([[0.1, 0.2, 0.3, 0.4]], dtype=torch.float64)
    keys = torch.tensor([[0.0, 1.0, 2.0, 3.0]], dtype=torch.float64)
    cap = float(np.cumsum([0.1, 0.2, 0.3])[-1])
    got = pgreedy.init_offload_torch(C, keys, cap)
    assert got.tolist() == [[False, False, False, True]]


@pytest.mark.parametrize("masked", [False, True])
def test_acd_sweep_torch_matches_numpy(ref, masked):
    rng = np.random.default_rng(4)
    P = rng.lognormal(0.0, 0.5, 30)
    rem = rng.lognormal(0.0, 0.5, 30)
    want = ref.greedy.acd_sweep(P, rem, 3.0, 40.0, 2)
    np.testing.assert_array_equal(pgreedy.acd_sweep(P, rem, 3.0, 40.0, 2),
                                  want)
    mask = rng.random(30) < 0.7 if masked else None
    got = pgreedy.acd_sweep_torch(torch.from_numpy(P), torch.from_numpy(rem),
                                  3.0, 40.0, 2,
                                  None if mask is None
                                  else torch.from_numpy(mask)).numpy()
    if mask is None:
        np.testing.assert_allclose(got, want, rtol=1e-13)
    else:
        Pm = np.where(mask, P, 0.0)
        wm = ref.greedy.acd_sweep(Pm, rem, 3.0, 40.0, 2)
        np.testing.assert_allclose(got[mask], wm[mask], rtol=1e-13)
        assert np.isinf(got[~mask]).all()


def test_select_provider_first_index_ties(ref):
    sel = np.array([[1.0, np.inf, 2.0, 0.5],
                    [1.0, 3.0, 2.0, 0.5],
                    [0.5, 3.0, 2.0, 0.5]])
    want = ref.greedy.select_provider(sel)
    np.testing.assert_array_equal(pgreedy.select_provider(sel), want)
    np.testing.assert_array_equal(
        pgreedy.select_provider_torch(torch.from_numpy(sel)).numpy(), want)
    assert want.tolist() == [2, 1, 0, 0]


def _portfolios(mod):
    return {"single": mod.as_portfolio(None, mod.LAMBDA_COST),
            "demo3": mod.demo_portfolio(3),
            "spot3": mod.spot_portfolio(3, num_segments=4, horizon_s=20.0),
            "diurnal2": mod.diurnal_portfolio(2)}


@pytest.mark.parametrize("name", ["single", "demo3", "spot3", "diurnal2"])
def test_segment_cost_matrices_identical(ref, name):
    rng = np.random.default_rng(8)
    J, M = 12, 4
    Pp = rng.lognormal(0.0, 0.5, (J, M))
    down = rng.uniform(0.05, 0.3, (J, M))
    mem = np.array([512.0, 1024.0, 3008.0, 2048.0])
    sink = np.array([False, False, False, True])
    req = np.array([True, True, False, True])
    pf_r = _portfolios(ref.cost)[name]
    pf_p = _portfolios(pcost)[name]
    S = pf_r.num_segments + 1
    np.testing.assert_array_equal(
        pf_p.np_selection_costs_seg(Pp, mem, down, sink, require=req,
                                    num_segments=S),
        pf_r.np_selection_costs_seg(Pp, mem, down, sink, require=req,
                                    num_segments=S))
    np.testing.assert_array_equal(
        pf_p.np_stage_costs_seg(Pp, mem, down, sink, num_segments=S),
        pf_r.np_stage_costs_seg(Pp, mem, down, sink, num_segments=S))
    for fn in ("segment_edges", "latency_mults_seg", "egress_seg"):
        np.testing.assert_array_equal(getattr(pf_p, fn)(S),
                                      getattr(pf_r, fn)(S))


def test_cost_model_numpy_call(ref):
    t = np.array([0.0, -3.0, 1.0, 99.9, 100.0, 100.1, 2500.0])
    mem = np.array([128.0, 512.0, 1024.0, 3008.0, 1024.0, 640.0, 2048.0])
    for cm_r, cm_p in ((ref.cost.LAMBDA_COST, pcost.LAMBDA_COST),
                       (ref.cost.CostModel(1.0, 2e-8, 0.0),
                        pcost.CostModel(1.0, 2e-8, 0.0))):
        want = cm_r.np_cost(t, mem)
        np.testing.assert_array_equal(cm_p(t, mem), want)
        np.testing.assert_array_equal(cm_p.np_cost(t, mem), want)
        with ref.jax.enable_x64(True):
            np.testing.assert_array_equal(np.asarray(cm_r(t, mem)), want)
    assert pcost.lambda_cost(50.0, 1024.0) == ref.cost.LAMBDA_COST.np_cost(
        50.0, 1024.0)


@pytest.mark.parametrize("arrivals", [
    None, "batch", "poisson:4.0", "poisson:2.0:3", "mmpp:6,0.5:2,4:1",
    "trace:0,0.5,0.5,2,3,3,3,7,8,9", "array"])
def test_resolve_release_identical(ref, arrivals):
    if arrivals == "array":
        arrivals = np.linspace(1.0, 4.0, 10)
    want = ref.arrivals.resolve_release(arrivals, 10, 1.0)
    got = pc.resolve_release(arrivals, 10, 1.0)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def test_resolve_release_rejects_like_reference(ref):
    for bad in (np.zeros(3), np.array([0.5] * 10)):
        with pytest.raises(ValueError):
            ref.arrivals.resolve_release(bad, 10, 1.0)
        with pytest.raises(ValueError):
            pc.resolve_release(bad, 10, 1.0)


def _ref_dags(ref):
    pinned = ref.dag.AppDAG(
        "pinned", (ref.dag.Stage("a", 2),
                   ref.dag.Stage("b", 2, must_private=True),
                   ref.dag.Stage("c", 2)), ((0, 1), (1, 2)))
    return [*ref.core.APPS.values(), ref.serving_dag(), pinned]


def test_dag_round_trip(ref):
    for d in _ref_dags(ref):
        p = convert.dag_from_fields(dataclasses.asdict(d))
        assert isinstance(p, pc.AppDAG)
        assert p.name == d.name and p.edges == d.edges
        assert [dataclasses.astuple(s) for s in p.stages] == \
            [dataclasses.astuple(s) for s in d.stages]
        assert p.topo_order() == d.topo_order()
        np.testing.assert_array_equal(p.descendant_masks, d.descendant_masks)
        np.testing.assert_array_equal(p.replicas, d.replicas)
        # port -> fields -> port is the identity
        assert convert.dag_from_fields(dataclasses.asdict(p)) == p
    for name, d in ref.core.APPS.items():
        assert convert.dag_from_fields(dataclasses.asdict(d)) == pc.APPS[name]


@pytest.mark.parametrize("name", ["single", "demo3", "spot3", "diurnal2"])
def test_portfolio_round_trip(ref, name):
    pf_r = _portfolios(ref.cost)[name]
    pf_p = convert.portfolio_from_fields(dataclasses.asdict(pf_r))
    assert pf_p == _portfolios(pcost)[name]
    assert convert.portfolio_from_fields(dataclasses.asdict(pf_p)) == pf_p
    # lists (as read back from JSON) work as well as tuples
    import json
    assert convert.portfolio_from_fields(
        json.loads(json.dumps(dataclasses.asdict(pf_r)))) == pf_p


def test_cost_model_round_trip(ref):
    cm = ref.cost.CostModel(quantum_ms=1.0, usd_per_gb_ms=3e-8,
                            min_quantums=2.0)
    got = convert.cost_model_from_fields(dataclasses.asdict(cm))
    assert got == pcost.CostModel(1.0, 3e-8, 2.0)
    assert convert.cost_model_from_fields(
        dataclasses.asdict(ref.cost.LAMBDA_COST)) == pcost.LAMBDA_COST
