"""The engine's scenario axes in the port: ``egress_lookahead``,
``init_window``, ``offload_mask`` and per-task ``init_phase``/``adaptive``.

Seeded grids go through the port's engine on the CPU (``device="cpu"``:
the plain versions of ``acd_evict`` and, under caps, ``fifo_dispatch``),
the reference's engine with ``engine_impl="pallas"`` and ``"loop"``, and
the port's DES. Against the reference every field is equal bit for bit,
but for a time its XLA CPU build computes through a fused multiply-add
(seen here: a public stage's start under a release stream, a queue wait
under caps with the lookahead term), which the DES rounds first: there the
port equals the DES exactly and the reference to a relative 1e-14
(``assert_bitwise_or_des``). Against the DES the parity contract holds
(times exact, cost and makespan to a relative 1e-12). A sweep mixing
per-task flags equals each task run alone, and the reference's
validation errors are the port's.
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
from repro_torch.core import convert
from tests.test_torch_harness import (assert_bitwise,
                                      assert_bitwise_or_des, assert_parity,
                                      grid_for, reference, workload)

J = 13
IMPLS = ("pallas", "loop")


@pytest.fixture(scope="module")
def ref():
    return reference()


def _dag_pair(ref, name):
    d = ref.core.APPS[name]
    return d, convert.dag_from_fields(dataclasses.asdict(d))


def _portfolio_pair(ref, n):
    pf = ref.cost.demo_portfolio(n)
    return pf, convert.portfolio_from_fields(dataclasses.asdict(pf))


def _release(J, seed=1, horizon=6.0):
    return np.sort(np.random.default_rng(seed).uniform(0.0, horizon, J))


#: option sets of one axis each (plus the congested lookahead, which runs
#: the capped chain with the lookahead term in its selection keys)
AXES = {
    "egress_lookahead": dict(egress_lookahead=True),
    "init_window": dict(init_window=2.0, arrivals="RELEASE"),
    "offload_mask": dict(offload_mask="MASK"),
    "offload_mask_stream": dict(offload_mask="MASK", arrivals="RELEASE"),
    "lookahead_congested": dict(egress_lookahead=True, concurrency=2,
                                coldstart="CS", arrivals="RELEASE"),
}


def _kw(ref, cfg, side):
    out = {}
    for k, v in cfg.items():
        if v == "RELEASE":
            v = _release(J)
        elif v == "MASK":
            v = np.arange(J) % 3 == 0
        elif v == "CS":
            cs = ref.core.ColdStartModel(warm_up_s=0.5, keep_alive_s=1.0,
                                         scale_to_zero=True)
            v = cs if side == 0 else convert.coldstart_from_fields(
                dataclasses.asdict(cs))
        out[k] = v
    return out


@pytest.mark.parametrize("axis", sorted(AXES))
@pytest.mark.parametrize("name", ["video", "image"])
def test_axis_matches_reference_and_des(ref, axis, name):
    dag_r, dag_p = _dag_pair(ref, name)
    pred, act = workload(dag_r, J, 0)
    pf_r, pf_p = _portfolio_pair(ref, 3)
    call = dict(c_max_grid=grid_for(dag_r, pred, (0.3, 0.8)),
                orders=("spt", "hcf"))
    got = pc.simulate_scenarios(dag_p, pred, act, portfolio=pf_p,
                                device="cpu", **call,
                                **_kw(ref, AXES[axis], 1))
    des = pc.simulate_scenarios(dag_p, pred, act, portfolio=pf_p,
                                engine="des", **call,
                                **_kw(ref, AXES[axis], 1))
    for impl in IMPLS if name == "video" else IMPLS[:1]:
        want = ref.vectorsim.simulate_scenarios(
            dag_r, pred, act, portfolio=pf_r, engine_impl=impl, **call,
            **_kw(ref, AXES[axis], 0))
        assert_bitwise_or_des(got, want, des, where=f"{axis}/{impl}")
    assert_parity(got, des, where=axis)
    np.testing.assert_array_equal(got.queue_wait, des.queue_wait)
    if "offload_mask" in axis:
        # the plan is the mask: every marked job starts public
        assert (got.n_init_offloaded_jobs == (np.arange(J) % 3 == 0).sum()
                ).all()


def test_axes_change_the_schedule():
    """Each axis moves the schedule off the plain one on these grids (so
    the parity cases above are not the plain schedule twice)."""
    dag = pc.APPS["video"]
    pred, act = workload(dag, J, 0)
    call = dict(c_max_grid=grid_for(dag, pred, (0.3, 0.8)),
                orders=("spt", "hcf"), portfolio=pc.demo_portfolio(3),
                device="cpu")
    rel = _release(J)
    base = pc.simulate_scenarios(dag, pred, act, **call)
    base_rel = pc.simulate_scenarios(dag, pred, act, arrivals=rel, **call)
    look = pc.simulate_scenarios(dag, pred, act, egress_lookahead=True,
                                 **call)
    win = pc.simulate_scenarios(dag, pred, act, arrivals=rel,
                                init_window=2.0, **call)
    mask = pc.simulate_scenarios(dag, pred, act,
                                 offload_mask=np.arange(J) % 3 == 0, **call)
    assert not np.array_equal(look.cost_usd, base.cost_usd)
    assert (win.n_init_offloaded_jobs < base_rel.n_init_offloaded_jobs).any()
    assert not np.array_equal(mask.public_mask, base.public_mask)


def _flag_tasks(ref, side):
    """Five tasks mixing per-task flags (and a release stream for the
    window), three applications, one sweep."""
    out = []
    for i, (name, flags) in enumerate((
            ("video", {}),
            ("image", dict(adaptive=False)),
            ("matrix", dict(init_phase=False)),
            ("video", dict(offload_mask=np.arange(J) % 4 == 1)),
            ("image", dict(init_window=1.5, arrivals=_release(J, 3))))):
        dag = _dag_pair(ref, name)[side]
        pred, act = workload(dag, J, 10 + i)
        out.append(dict(dag=dag, pred=pred, act=act,
                        c_max_grid=grid_for(dag, pred, (0.3, 0.7)),
                        orders=("spt", "hcf"), **flags))
    return out


def test_mixed_task_flags_sweep(ref):
    """One sweep with per-task flags: each task equals the reference's
    twins, the DES, and the task run alone."""
    pf_r, pf_p = _portfolio_pair(ref, 3)
    want = {impl: ref.vectorsim.sweep_scenarios(
        _flag_tasks(ref, 0), portfolio=pf_r, engine_impl=impl)
        for impl in IMPLS}
    got = pc.sweep_scenarios(_flag_tasks(ref, 1), portfolio=pf_p,
                             device="cpu")
    des = pc.sweep_scenarios(_flag_tasks(ref, 1), portfolio=pf_p,
                             engine="des")
    for i, task in enumerate(_flag_tasks(ref, 1)):
        for impl in IMPLS:
            assert_bitwise_or_des(got[i], want[impl][i], des[i],
                                  where=f"task {i} {impl}")
        assert_parity(got[i], des[i], where=f"task {i}")
        alone = pc.sweep_scenarios([task], portfolio=pf_p, device="cpu")[0]
        assert_bitwise(alone, got[i], where=f"task {i} alone")
    assert (got[2].n_init_offloaded_jobs == 0).all()
    assert (got[3].n_init_offloaded_jobs == (np.arange(J) % 4 == 1).sum()
            ).all()


def test_task_flags_override_sweep_flags():
    """A task's flag wins over the sweep's keyword; without one the task
    takes the sweep's."""
    dag = pc.APPS["video"]
    pred, act = workload(dag, J, 4)
    grid = grid_for(dag, pred, (0.3, 0.7))
    plain = pc.simulate_scenarios(dag, pred, act, c_max_grid=grid,
                                  adaptive=False, init_phase=False,
                                  device="cpu")
    got = pc.sweep_scenarios(
        [dict(dag=dag, pred=pred, act=act, c_max_grid=grid, adaptive=False,
              init_phase=False),
         dict(dag=dag, pred=pred, act=act, c_max_grid=grid)],
        adaptive=False, init_phase=False, device="cpu")
    assert_bitwise(got[0], plain)
    assert_bitwise(got[1], plain)
    on = pc.sweep_scenarios(
        [dict(dag=dag, pred=pred, act=act, c_max_grid=grid, adaptive=True,
              init_phase=True)],
        adaptive=False, init_phase=False, device="cpu")[0]
    assert_bitwise(on, pc.simulate_scenarios(dag, pred, act,
                                             c_max_grid=grid, device="cpu"))


def test_lookahead_engine_impls_case(ref):
    """The reference's ``test_engine_impls.py`` lookahead axis: a latency
    batch of two draws, a Poisson stream, the demo portfolio."""
    rng = np.random.default_rng(7)
    dag_r, dag_p = _dag_pair(ref, "video")
    M, S = dag_r.num_stages, 2
    pred = {"P_private": rng.uniform(0.5, 3.0, (S, J, M)),
            "P_public": rng.uniform(0.3, 2.5, (S, J, M)),
            "T_up": rng.uniform(0.01, 0.3, (S, J, M)),
            "T_down": rng.uniform(0.01, 0.3, (S, J, M))}
    act = {k: v * rng.uniform(0.9, 1.1, v.shape) for k, v in pred.items()}
    pf_r = ref.core.demo_portfolio()
    pf_p = convert.portfolio_from_fields(dataclasses.asdict(pf_r))
    call = dict(c_max_grid=(25.0, 60.0), orders=("spt", "hcf"),
                egress_lookahead=True, arrivals="poisson:1.5")
    got = pc.simulate_scenarios(dag_p, pred, act, portfolio=pf_p,
                                device="cpu", **call)
    for impl in IMPLS:
        want = ref.vectorsim.simulate_scenarios(
            dag_r, pred, act, portfolio=pf_r, engine_impl=impl, **call)
        assert_bitwise(got, want, where=impl)
    des = pc.simulate_scenarios(dag_p, pred, act, portfolio=pf_p,
                                engine="des", **call)
    assert_parity(got, des)


@pytest.mark.parametrize("engine", ["vector", "des"])
def test_mask_and_window_validation(engine):
    dag = pc.APPS["video"]
    pred, act = workload(dag, J, 0)
    kw = dict(engine=engine, device="cpu", arrivals=_release(J))
    with pytest.raises(ValueError, match="mutually exclusive"):
        pc.simulate_scenarios(dag, pred, act, init_window=1.0,
                              offload_mask=np.zeros(J, dtype=bool), **kw)
    with pytest.raises(ValueError, match="offload_mask must have shape"):
        pc.simulate_scenarios(dag, pred, act,
                              offload_mask=np.zeros(J + 1, dtype=bool), **kw)
    with pytest.raises(ValueError, match="unknown task keys"):
        pc.sweep_scenarios([dict(dag=dag, pred=pred, bogus=1)],
                           engine=engine, device="cpu")
    with pytest.raises(TypeError):
        pc.sweep_scenarios([dict(dag=dag, pred=pred)], engine=engine,
                           device="cpu", bogus=1)


@pytest.mark.gpu
def test_cuda_axes_match_cpu():
    """The flag mix and the congested lookahead on the card (``acd_evict``
    every adaptive step, ``fifo_dispatch`` under caps) equal the CPU."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import ops

    rng = np.random.default_rng(9)
    tasks = []
    for i, (name, flags) in enumerate((
            ("video", {}), ("image", dict(adaptive=False)),
            ("matrix", dict(init_phase=False)),
            ("video", dict(offload_mask=rng.random(64) < 0.3)),
            ("image", dict(init_window=3.0,
                           arrivals=np.sort(rng.uniform(0, 10, 64)))))):
        dag = pc.APPS[name]
        pred, act = workload(dag, 64, 50 + i)
        tasks.append(dict(dag=dag, pred=pred, act=act,
                          c_max_grid=grid_for(dag, pred, (0.3, 0.7)),
                          orders=("spt", "hcf"), **flags))
    cs = pc.ColdStartModel(warm_up_s=0.5, keep_alive_s=1.0,
                           scale_to_zero=True)
    for kw in (dict(portfolio=pc.demo_portfolio(3)),
               dict(portfolio=pc.demo_portfolio(3), concurrency=2,
                    coldstart=cs, egress_lookahead=True)):
        ops.reset_launch_counts()
        got = pc.sweep_scenarios(tasks, device="cuda", **kw)
        assert ops.acd_evict.launches > 0
        if "concurrency" in kw:
            assert ops.fifo_dispatch.launches > 0
        want = pc.sweep_scenarios(tasks, device="cpu", **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bitwise(g, w, where=f"task {i}")
