"""The port's batched engine (``device="cpu"``) against the reference's.

One seeded grid goes through the reference's ``sweep_scenarios`` with
``engine_impl="pallas"`` (the kernel structure the port follows, Pallas in
interpret mode) and ``"loop"`` (the one-event-per-iteration twin), and
through the port's ``sweep_scenarios`` on the CPU, where the engine runs
the plain version of ``acd_evict``. The parity contract:

* against the reference vector engine, every field bit for bit —
  placement, replica, provider, segment and public masks, start and end,
  completion, and ``cost_usd`` and makespan too;
* against the DES, placements, replicas, providers, segments and times
  exactly, cost and makespan to ``isclose`` (the DES sums the bill in
  another order, one ulp apart at most).

The one exception is the straggler axis: the reference's XLA CPU build
fuses ``clock + duration * speed`` into one multiply-add when a replica's
speed factor is not 1, which the DES does not; the port follows the DES
there, and holds the reference engine to a relative 1e-14.

Cases: the three canonical applications, the serving DAG and a
privacy-pinned DAG, seeds 0 and 1, both orders, three deadlines; a latency
draw batch, a tied release stream, replica and straggler axes; a
3-provider portfolio with a price-trace axis; and the flag variants.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as pc
from repro_torch.core import convert, vectorsim as pvs
from tests.test_torch_harness import (assert_bitwise, assert_parity,
                                      grid_for, reference, workload)

J = 17
IMPLS = ("pallas", "loop")
DAGS = ("image", "matrix", "video", "llm_serve", "pinned")


@pytest.fixture(scope="module")
def ref():
    return reference()


def _dag_pair(ref, name):
    if name == "llm_serve":
        d = ref.serving_dag()
    elif name == "pinned":
        d = ref.dag.AppDAG(
            "pinned", (ref.dag.Stage("a", 2),
                       ref.dag.Stage("b", 2, must_private=True),
                       ref.dag.Stage("c", 2)), ((0, 1), (1, 2)))
    else:
        d = ref.core.APPS[name]
    return d, convert.dag_from_fields(dataclasses.asdict(d))


def _task(dag, pred, act, **kw):
    t = dict(dag=dag, pred=pred, act=act,
             c_max_grid=grid_for(dag, pred), orders=("spt", "hcf"))
    t.update(kw)
    return t


def _main_tasks(ref, side):
    """(key, task) pairs of the main sweep for one package (side 0 = the
    reference's objects, 1 = the port's)."""
    out = []
    for name in DAGS:
        dag = _dag_pair(ref, name)[side]
        for seed in (0, 1):
            pred, act = workload(dag, J, seed)
            out.append(((name, seed), _task(dag, pred, act)))
    dag = _dag_pair(ref, "image")[side]
    rng = np.random.default_rng(5)
    pred, _ = workload(dag, J, 5)
    act = {k: v[None] * rng.lognormal(0, 0.1, (3,) + v.shape)
           for k, v in pred.items()}
    out.append((("draws", 5), _task(dag, pred, act,
                                    c_max_grid=grid_for(dag, pred,
                                                        (0.4, 0.9)))))
    dag = _dag_pair(ref, "video")[side]
    pred, act = workload(dag, J, 7)
    rel = np.round(np.random.default_rng(7).uniform(0.0, 6.0, J) * 2) / 2
    out.append((("release", 7), _task(dag, pred, act, arrivals=rel)))
    pred, act = workload(dag, J, 9)
    out.append((("replicas", 9), _task(
        dag, pred, act, c_max_grid=grid_for(dag, pred, (0.4, 0.9)),
        orders=("spt",),
        replicas=[[1, 2, 3, 1], [2, 2, 2, 2], [4, 1, 1, 4]],
        replica_speeds=[None, {(k, 0): 2.5 for k in range(4)},
                        np.full((4, 2), 1.5)])))
    return out


@pytest.fixture(scope="module")
def main_sweep(ref):
    keys = [k for k, _ in _main_tasks(ref, 0)]
    outs = {impl: ref.vectorsim.sweep_scenarios(
        [t for _, t in _main_tasks(ref, 0)], engine_impl=impl)
        for impl in IMPLS}
    port_tasks = [t for _, t in _main_tasks(ref, 1)]
    port = pc.sweep_scenarios(port_tasks, device="cpu")
    des = pc.sweep_scenarios(port_tasks, engine="des")
    return {k: dict(port=port[i], des=des[i],
                    **{impl: outs[impl][i] for impl in IMPLS})
            for i, k in enumerate(keys)}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", DAGS)
def test_engine_matches_reference_engine(main_sweep, name, seed, impl):
    r = main_sweep[(name, seed)]
    assert r["port"].num_scenarios == 6
    assert_bitwise(r["port"], r[impl], where=f"{name}/{seed}/{impl}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", DAGS)
def test_engine_matches_des(main_sweep, name, seed):
    r = main_sweep[(name, seed)]
    assert_parity(r["port"], r["des"], where=f"{name}/{seed}")


@pytest.mark.parametrize("case", ["draws", "release", "replicas"])
def test_scenario_axes_match_reference(main_sweep, case):
    key = {"draws": ("draws", 5), "release": ("release", 7),
           "replicas": ("replicas", 9)}[case]
    r = main_sweep[key]
    for impl in IMPLS:
        if case == "replicas":
            _assert_straggler_grid(r["port"], r[impl], impl)
        else:
            assert_bitwise(r["port"], r[impl], where=f"{case}/{impl}")
    assert_parity(r["port"], r["des"], where=case)
    for fld in ("batch_idx", "c_max", "replicas", "trace_idx"):
        np.testing.assert_array_equal(getattr(r["port"], fld),
                                      getattr(r["pallas"], fld))
    assert r["port"].orders == r["pallas"].orders
    if case == "release":
        np.testing.assert_array_equal(r["port"].release, r["pallas"].release)
    if case == "replicas":
        assert r["port"].num_scenarios == 2 * 3 * 3
        # stragglers bind: their scenarios differ from the healthy ones
        assert not np.allclose(r["port"].makespan[0::3],
                               r["port"].makespan[1::3])


def _assert_straggler_grid(port, want, impl):
    """Healthy scenarios (every third: speed axis entry 0) bit for bit.

    Under a straggler factor the reference's XLA CPU build contracts most
    ``clock + duration * speed`` updates into fused multiply-adds, while
    the port and the DES round the product first (the port's times equal
    the DES's exactly, see ``assert_parity``). There the discrete fields
    stay exact and the times agree to the last bit or two.
    """
    healthy = np.arange(port.num_scenarios) % 3 == 0

    class Sub:
        def __init__(self, res, sel):
            self.res, self.sel = res, sel

        def __getattr__(self, name):
            return np.asarray(getattr(self.res, name))[self.sel]

    assert_bitwise(Sub(port, healthy), Sub(want, healthy),
                   where=f"replicas/{impl} healthy")
    assert_bitwise(port, want, where=f"replicas/{impl}",
                   fields=("public_mask", "provider", "replica", "segment",
                           "n_offloaded_stages", "n_init_offloaded_jobs",
                           "per_stage_offloads"))
    for fld in ("start", "end", "completion", "makespan", "cost_usd"):
        np.testing.assert_allclose(getattr(port, fld), getattr(want, fld),
                                   rtol=1e-14, atol=0,
                                   err_msg=f"replicas/{impl} {fld}")


def test_portfolio_and_price_traces_match_reference(ref):
    pf_r = ref.cost.demo_portfolio(3)
    spot_r = ref.cost.spot_portfolio(3, num_segments=4, horizon_s=20.0)
    pf_p = convert.portfolio_from_fields(dataclasses.asdict(pf_r))
    spot_p = convert.portfolio_from_fields(dataclasses.asdict(spot_r))

    def tasks(side, spot):
        out = []
        for name, seed in (("video", 0), ("image", 1), ("llm_serve", 2)):
            dag = _dag_pair(ref, name)[side]
            pred, act = workload(dag, J, seed)
            out.append(_task(dag, pred, act, price_traces=[None, spot]))
        return out

    want = {impl: ref.vectorsim.sweep_scenarios(
        tasks(0, spot_r), portfolio=pf_r, engine_impl=impl)
        for impl in IMPLS}
    got = pc.sweep_scenarios(tasks(1, spot_p), portfolio=pf_p, device="cpu")
    des = pc.sweep_scenarios(tasks(1, spot_p), portfolio=pf_p, engine="des")
    for i in range(3):
        for impl in IMPLS:
            assert_bitwise(got[i], want[impl][i], where=f"task {i} {impl}")
        assert_parity(got[i], des[i], where=f"task {i}")
        np.testing.assert_array_equal(got[i].trace_idx,
                                      want["pallas"][i].trace_idx)
    used = np.concatenate([g.provider.ravel() for g in got])
    assert len(set(used[used >= 0].tolist())) >= 2
    segs = np.concatenate([g.segment.ravel() for g in got])
    assert (segs > 0).any()


@pytest.mark.parametrize("flags", [
    dict(include_transfers=False, adaptive=False),
    dict(init_phase=False),
    dict(adaptive=False)], ids=["no_transfers", "no_init", "no_adaptive"])
def test_flag_variants_match_reference(ref, flags):
    dag_r, dag_p = _dag_pair(ref, "video")
    pred, act = workload(dag_r, J, 2)
    kw = dict(c_max_grid=grid_for(dag_r, pred), orders=("spt", "hcf"),
              **flags)
    got = pc.simulate_scenarios(dag_p, pred, act, device="cpu", **kw)
    # the loop twin is held on the main grid; one compile per variant here
    want = ref.vectorsim.simulate_scenarios(dag_r, pred, act,
                                            engine_impl="pallas", **kw)
    assert_bitwise(got, want)
    des = pc.simulate_scenarios(dag_p, pred, act, engine="des", **kw)
    assert_parity(got, des)


def test_provider_ties_take_the_first_index(ref):
    """Two identical providers tie in every placement argmin: the first
    index wins in both engines."""
    prov = ref.cost.Provider("twin", egress_usd_per_gb=0.05)
    pf_r = ref.cost.ProviderPortfolio((prov, prov))
    pf_p = convert.portfolio_from_fields(dataclasses.asdict(pf_r))
    dag_r, dag_p = _dag_pair(ref, "video")
    pred, act = workload(dag_r, J, 4)
    kw = dict(c_max_grid=grid_for(dag_r, pred), orders=("spt", "hcf"))
    want = ref.vectorsim.simulate_scenarios(dag_r, pred, act, portfolio=pf_r,
                                            engine_impl="pallas", **kw)
    got = pc.simulate_scenarios(dag_p, pred, act, portfolio=pf_p,
                                device="cpu", **kw)
    assert_bitwise(got, want)
    assert got.public_mask.any()
    assert set(np.unique(got.provider).tolist()) == {-1, 0}


def test_simulate_vector_routes_through_engine(ref):
    dag_r, dag_p = _dag_pair(ref, "matrix")
    pred, act = workload(dag_r, J, 3)
    c = grid_for(dag_r, pred)[0]
    got = pc.simulate(dag_p, pred, act, c_max=c, engine="vector",
                      device="cpu")
    want = ref.simulator.simulate(dag_r, pred, act, c_max=c,
                                  engine="vector")
    assert_bitwise(got, want)
    v = pc.simulate_scenarios(dag_p, pred, act, c_max_grid=(c,),
                              device="cpu")
    assert v.scenario(0).cost_usd == got.cost_usd


def test_empty_job_axis():
    pred = dict(P_private=np.zeros((0, 3)), P_public=np.zeros((0, 3)))
    out = pc.simulate_scenarios(pc.APPS["image"], pred, device="cpu",
                                c_max_grid=(5.0, 9.0))
    assert out.num_scenarios == 2 and out.public_mask.shape == (2, 0, 3)
    assert (out.makespan == 0).all() and (out.cost_usd == 0).all()


UNPORTED = {
    "faults": dict(faults=0.2),
    "concurrency": dict(concurrency=2),
    "coldstart": dict(coldstart=0.5),
    "pool_trace": dict(pool_trace=object()),
    "chunk_jobs": dict(chunk_jobs=8),
    "workload": dict(workload="azure:day=tue,scale=100"),
    "egress_lookahead": dict(egress_lookahead=True),
    "init_window": dict(init_window=1.0),
    "offload_mask": dict(offload_mask=np.zeros(J, dtype=bool)),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise(name):
    dag = pc.APPS["video"]
    pred, act = workload(dag, J, 0)
    if name == "workload":
        pred = act = None
    with pytest.raises(NotImplementedError, match=name):
        pc.simulate_scenarios(dag, pred, act, device="cpu",
                              **UNPORTED[name])


@pytest.mark.parametrize("key", ["init_phase", "adaptive", "offload_mask",
                                 "faults"])
def test_unported_task_keys_raise(key):
    dag = pc.APPS["matrix"]
    pred, act = workload(dag, J, 0)
    task = dict(dag=dag, pred=pred, act=act, **{key: False})
    with pytest.raises(NotImplementedError, match=key):
        pc.sweep_scenarios([task], device="cpu")
    with pytest.raises(NotImplementedError, match="chunk_jobs"):
        pc.sweep_scenarios([dict(dag=dag, pred=pred)], device="cpu",
                           chunk_jobs=4)


def test_bad_arguments_raise():
    dag = pc.APPS["matrix"]
    pred, act = workload(dag, 4, 0)
    with pytest.raises(ValueError, match="t0 >= 0"):
        pc.simulate_scenarios(dag, pred, act, t0=-1.0, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        pc.simulate_scenarios(dag, pred, act, engine="warp", device="cpu")
    with pytest.raises(ValueError, match="engine_impl"):
        pc.simulate_scenarios(dag, pred, act, engine_impl="scan",
                              device="cpu")
    with pytest.raises(ValueError, match=r"act\['P_public'\]"):
        pc.simulate_scenarios(dag, pred,
                              dict(act, P_public=act["P_public"][:3]),
                              device="cpu")


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    dag = pc.APPS["matrix"]
    pred, act = workload(dag, 4, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.simulate_scenarios(dag, pred, act)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.simulate(dag, pred, act, engine="vector")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pvs.resolve_device()
    assert pvs.resolve_device("cpu") == torch.device("cpu")


def test_trip_counts_are_recorded():
    dag = pc.APPS["video"]
    pred, act = workload(dag, J, 1)
    pc.simulate_scenarios(dag, pred, act, device="cpu",
                          c_max_grid=grid_for(dag, pred))
    trips = pvs._LAST_RUN_STATS["trips"]
    assert len(trips) == 1 and len(trips[0]) == dag.num_stages
    assert all(0 < n <= 4 * J + 16 for n in trips[0])


@pytest.mark.gpu
def test_cuda_engine_matches_cpu_on_every_axis():
    """The engine on the card equals the engine on the CPU field for field
    (the kernel, gathers, one-hot products and sorts on CUDA included) on
    a grid with every ported axis: several DAGs, a 3-provider portfolio
    with a price-trace axis, replica and straggler axes, a tied release
    stream and a latency-draw batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.core import cost as pcost
    from repro_torch.kernels import ops

    tasks = []
    for name, seed in (("image", 0), ("matrix", 1), ("video", 2)):
        dag = pc.APPS[name]
        pred, act = workload(dag, 64, seed)
        tasks.append(_task(dag, pred, act, price_traces=[
            None, pcost.spot_portfolio(3, num_segments=4, horizon_s=40.0)]))
    dag = pc.APPS["video"]
    pred, act = workload(dag, 64, 3)
    tasks.append(_task(
        dag, pred, act,
        arrivals=np.round(np.random.default_rng(3).uniform(0, 9, 64)) / 2,
        replicas=[[1, 2, 3, 1], [4, 1, 1, 4]],
        replica_speeds=[None, {(k, 0): 2.5 for k in range(4)}]))
    act_b = {k: v[None] * np.random.default_rng(4).lognormal(
        0, 0.1, (2,) + v.shape) for k, v in pred.items()}
    tasks.append(_task(dag, pred, act_b))
    kw = dict(portfolio=pcost.demo_portfolio(3))
    before = ops.acd_evict.launches
    got = pc.sweep_scenarios(tasks, device="cuda", **kw)
    assert ops.acd_evict.launches > before
    want = pc.sweep_scenarios(tasks, device="cpu", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_bitwise(g, w, where=f"task {i}")
