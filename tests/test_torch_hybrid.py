"""The hybrid LLM-serving scheduler of the port
(``repro_torch.serving.hybrid``), its fault-tolerance helpers
(``repro_torch.training.fault``) and its launcher
(``repro_torch.launch.serve``) against the reference's.

The port's latency model defaults to an H100's peak rates; the parity
cases build it with the reference's own constants (read from the
reference), so both packages draw the same latencies bit for bit. Then,
on the CPU (``device="cpu"``):

* the analytic model (``use_ridge=False``, pure float64 numpy): DES
  schedules equal the reference's field for field, and the batched engine
  (sweeps, the three frontiers, ``serve_online``) equals the reference's
  vector engine bit for bit except where its XLA CPU build fuses a time
  into a multiply-add (ROADMAP Queue 3 item 13), where the port equals its
  DES exactly (``assert_bitwise_or_des``);
* the ridge fit equals the reference's to ``rtol`` 1e-5 (float32 in two
  libraries); schedules under ridge predictions run on the reference's
  fitted model carried across with ``convert.perf_model_from_fields``, the
  engine held to the port's DES under the parity contract;
* ``plan_batch_torch`` equals numpy's ``init_offload`` bit for bit, and
  the reference's jitted ``plan_batch_jax`` on the tested seeds;
* the reference suites' own assertions (``tests/test_serving.py``,
  ``test_autoscale.py`` and the ``serve_online`` cases of
  ``test_arrivals.py``, ``test_faults.py`` and ``test_coldstart.py``) on
  the port's results.
"""
import dataclasses
import functools
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import repro_torch.core as pc
from repro_torch.configs import get_config
from repro_torch.core import convert
from repro_torch.core.arrivals import PoissonArrivals
from repro_torch.core.coldstart import ColdStartModel, queue_wait_ewma
from repro_torch.core.faults import FaultModel, RetryPolicy
from repro_torch.launch import serve as pserve
from repro_torch.serving import hybrid as ph
from repro_torch.training import fault as ptf
from tests.test_torch_harness import (assert_bitwise, assert_bitwise_or_des,
                                      assert_parity, held_online, reference,
                                      twin, workload)
from tests.test_torch_perfmodel import _fields as perf_fields

#: the frontiers' per-scenario arrays, each held like a result field
FRONTIER_EXACT = {
    ph.AutoscaleFrontier: ("replicas", "c_max", "sla", "pareto"),
    ph.SpotFrontier: ("trace_idx", "c_max", "sla", "pareto"),
    ph.ReliabilityFrontier: ("fault_idx", "c_max", "sla", "availability",
                             "pareto"),
}


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def rh(ref):
    from repro.serving import hybrid

    return hybrid


def ref_peaks():
    from repro.launch.roofline import HBM_BW, PEAK_FLOPS

    return dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW)


def port_sched(n=None, arch="llama3-8b"):
    """The port's scheduler on the CPU at the reference's peak rates."""
    cfg = get_config(arch)
    return ph.HybridServingScheduler(
        cfg, latency_model=ph.ServingLatencyModel(cfg, **ref_peaks()),
        portfolio=None if n is None else ph.elastic_portfolio(n),
        device="cpu")


def ref_sched(ref, rh, n=None, arch="llama3-8b"):
    return rh.HybridServingScheduler(
        ref.configs.get_config(arch),
        portfolio=None if n is None else rh.elastic_portfolio(n))


def held_frontier(method, ps, rs, *args, **kw):
    """One frontier of the port (engine and DES) and of the reference
    (engine): results under ``assert_bitwise_or_des``; the per-scenario
    attainment, indices and Pareto mask equal to the reference's and the
    DES's; costs bit for bit or, where the times moved, to the DES's
    ``isclose``. Returns the port's frontier."""
    got = getattr(ps, method)(*args, **kw)
    des = getattr(ps, method)(*args, engine="des", **kw)
    want = getattr(rs, method)(*twin(args),
                               **{k: twin(v) for k, v in kw.items()})
    assert_parity(got.result, des.result)
    assert_bitwise_or_des(got.result, want.result, des.result)
    for fld in FRONTIER_EXACT[type(got)]:
        for other in (want, des):
            np.testing.assert_array_equal(getattr(got, fld),
                                          getattr(other, fld), err_msg=fld)
    assert got.sla_s == want.sla_s
    return got


# -- the latency model ----------------------------------------------------

class TestLatencyModel:
    def _pair(self, ref, arch):
        from repro.serving.hybrid import ServingLatencyModel

        return (ph.ServingLatencyModel(get_config(arch), **ref_peaks()),
                ServingLatencyModel(ref.configs.get_config(arch)))

    def test_prefill_scales_with_length(self, ref):
        lm, rlm = self._pair(ref, "llama3-8b")
        L = np.array([512, 1024, 2048])
        t = lm.prefill_s(L)
        np.testing.assert_array_equal(t, rlm.prefill_s(L))
        assert t[1] == pytest.approx(2 * t[0], rel=1e-6)
        assert t[2] == pytest.approx(4 * t[0], rel=1e-6)

    def test_decode_memory_bound_grows_with_kv(self, ref):
        lm, rlm = self._pair(ref, "llama3-8b")
        t1 = lm.decode_s(np.array([64]), np.array([1024]))
        t2 = lm.decode_s(np.array([64]), np.array([32768]))
        np.testing.assert_array_equal(
            t2, rlm.decode_s(np.array([64]), np.array([32768])))
        assert t2 > t1

    def test_window_bounds_kv_for_hybrid_arch(self, ref):
        lm, rlm = self._pair(ref, "recurrentgemma-9b")
        t1 = lm.decode_s(np.array([64]), np.array([4096]))
        t2 = lm.decode_s(np.array([64]), np.array([500000]))
        np.testing.assert_allclose(t1, t2, rtol=1e-6)
        np.testing.assert_array_equal(
            t1, rlm.decode_s(np.array([64]), np.array([4096])))

    @pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b",
                                      "rwkv6-1.6b"])
    def test_latencies_equal_the_reference(self, ref, arch):
        lm, rlm = self._pair(ref, arch)
        rng = np.random.default_rng(0)
        plen, ntok = rng.integers(64, 4096, 40), rng.integers(16, 512, 40)
        for seed in (None, 3):
            got = lm.latencies(plen, ntok, None if seed is None
                               else np.random.default_rng(seed))
            want = rlm.latencies(plen, ntok, None if seed is None
                                 else np.random.default_rng(seed))
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_defaults_are_the_h100s(self, ref):
        """The port's peaks are an H100 SXM's (989 TFLOP/s dense bf16,
        3.35 TB/s); every other default is the reference's."""
        from repro.serving.hybrid import ServingLatencyModel

        cfg = get_config("llama3-8b")
        lm = ph.ServingLatencyModel(cfg)
        assert lm.peak_flops == 989e12 and lm.hbm_bw == 3.35e12
        rlm = ServingLatencyModel(ref.configs.get_config("llama3-8b"))
        for f in ("chips_per_replica", "mfu", "mem_eff", "public_speedup",
                  "public_startup_s", "pack_s"):
            assert getattr(lm, f) == getattr(rlm, f), f
        n = cfg.active_param_count()
        assert lm.prefill_s(np.array([1000]))[0] == \
            2.0 * n * 1000.0 / (8 * 989e12 * 0.4)
        assert ph.HybridServingScheduler(cfg, device="cpu").lat.peak_flops \
            == 989e12


# -- the scheduler: schedules, sweeps, the fit ----------------------------

@pytest.fixture(scope="module")
def fitted(ref, rh):
    """Both schedulers fitted on 150 traces; the port also with the
    reference's fitted model carried across (``carried``)."""
    ps, rs = port_sched(), ref_sched(ref, rh)
    ps.fit_perf_models(n_train=150)
    rs.fit_perf_models(n_train=150)
    carried = port_sched()
    carried.perf_model = convert.perf_model_from_fields(
        carried.dag, perf_fields(rs.perf_model), device="cpu")
    return ps, rs, carried


def _requests(seed, J, lo=128, hi=4096, tlo=32, thi=512):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, J), rng.integers(tlo, thi, J)


def test_fit_matches_the_reference(fitted):
    ps, rs, carried = fitted
    plen, ntok = _requests(9, 64)
    feats = np.stack([plen, ntok], 1).astype(np.float64)
    want = rs.perf_model.predict(feats)
    for model, rtol in ((ps.perf_model, 1e-5), (carried.perf_model, 1e-6)):
        got = model.predict(feats)
        for k in ("P_private", "P_public", "upload", "download"):
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=k)


def _schedule_both(fitted, plen, ntok, c_max, order="spt"):
    """One (order, C_max) schedule: the analytic model bit for bit against
    the reference's DES; the carried ridge model on the port's engine
    against its DES. Returns the carried model's DES schedule."""
    ps, rs, carried = fitted
    got = ps.schedule(plen, ntok, c_max=c_max, order=order, use_ridge=False)
    want = rs.schedule(plen, ntok, c_max=c_max, order=order,
                       use_ridge=False)
    assert_bitwise(got.result, want.result)
    rep = carried.schedule(plen, ntok, c_max=c_max, order=order)
    vec = carried.schedule_sweep(plen, ntok, [c_max], orders=(order,))
    assert_parity(vec.scenario(0), rep.result)
    return rep


def test_hybrid_meets_deadline_cheaper_than_public(fitted):
    ps, rs, _ = fitted
    plen, ntok = _requests(2, 48)
    pub, priv = ps.baselines(plen, ntok)
    rpub, rpriv = rs.baselines(plen, ntok)
    assert_bitwise(pub, rpub)
    assert_bitwise(priv, rpriv)
    c_max = priv.makespan * 0.5
    rep = _schedule_both(fitted, plen, ntok, c_max)
    assert rep.result.makespan <= c_max * 1.15
    assert 0 < rep.result.cost_usd < pub.cost_usd
    assert rep.result.makespan < priv.makespan


def test_spt_cheaper_than_hcf_for_compute_heavy(fitted):
    ps = fitted[0]
    plen, ntok = _requests(3, 64)
    _, priv = ps.baselines(plen, ntok)
    c_max = priv.makespan * 0.55
    spt = _schedule_both(fitted, plen, ntok, c_max, "spt")
    hcf = _schedule_both(fitted, plen, ntok, c_max, "hcf")
    assert spt.result.cost_usd <= hcf.result.cost_usd * 1.1


def test_offloads_decrease_with_deadline(fitted):
    ps, rs, carried = fitted
    plen, ntok = _requests(5, 48)
    _, priv = ps.baselines(plen, ntok)
    offs = []
    for frac in (0.4, 0.6, 0.9):
        rep = carried.schedule(plen, ntok, c_max=priv.makespan * frac)
        offs.append(rep.result.n_offloaded_stages)
    assert offs[0] >= offs[1] >= offs[2]
    grid = [priv.makespan * f for f in (0.4, 0.6, 0.9)]
    got = ps.schedule_sweep(plen, ntok, grid, orders=("spt", "hcf"),
                            use_ridge=False)
    want = rs.schedule_sweep(plen, ntok, grid, orders=("spt", "hcf"),
                             use_ridge=False)
    des = ps.schedule_sweep(plen, ntok, grid, orders=("spt", "hcf"),
                            use_ridge=False, engine="des")
    assert_parity(got, des)
    assert_bitwise_or_des(got, want, des)


def test_spot_frontier_markets_x_deadlines(ref, rh):
    ps, rs = port_sched(3), ref_sched(ref, rh, 3)
    plen, ntok = _requests(7, 48, lo=512, tlo=64)
    tot = float(ps.lat.latencies(plen, ntok, None)["P_private"].sum()
                / ps.dag.replicas.sum())
    grid = ph.spot_elastic_traces(3, num_segments=4,
                                  horizon_s=tot * 0.6) + [None]
    cg = tuple(tot * f for f in (0.2, 0.5))
    f = held_frontier("spot_frontier", ps, rs, plen, ntok, grid,
                      c_max_grid=cg, use_ridge=False)
    assert f.num_scenarios == len(grid) * len(cg)
    assert f.pareto.any()
    assert f.per_trace_cost().shape == (len(grid),)
    assert (f.cost_usd > 0).any()


def test_spot_elastic_traces_equal_the_reference(rh):
    got = ph.spot_elastic_traces(3, num_segments=5, horizon_s=40.0, seed=2)
    want = rh.spot_elastic_traces(3, num_segments=5, horizon_s=40.0, seed=2)
    assert [[dataclasses.asdict(t) for t in fam] for fam in got] == \
        [[dataclasses.asdict(t) for t in fam] for fam in want]
    assert dataclasses.asdict(ph.elastic_portfolio(4)) == \
        dataclasses.asdict(rh.elastic_portfolio(4))


# -- plan_batch_torch ----------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_plan_batch_torch_matches_numpy_and_reference(ref, rh, seed):
    rng = np.random.default_rng(4 + seed)
    P = rng.uniform(0.1, 2.0, (32, 3)).astype(np.float32)
    keys = P.sum(1)
    cap = 20.0 + seed
    want = pc.init_offload(P.sum(1), keys, cap)
    got = ph.plan_batch_torch(torch.from_numpy(P), torch.from_numpy(keys),
                              cap)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    jnp = ref.jax.numpy
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(rh.plan_batch_jax(jnp.asarray(P), jnp.asarray(keys),
                                     cap)))


def test_plan_batch_torch_float64_capacity_edges():
    """float64 totals at J = 4096 with capacities landing exactly on
    prefix sums: the host prefix keeps numpy's order, bit for bit."""
    rng = np.random.default_rng(11)
    P = rng.lognormal(0.0, 0.5, (4096, 3))
    keys = rng.permutation(4096).astype(np.float64)
    csum = np.cumsum(P.sum(1)[np.argsort(keys, kind="stable")])
    for cap in (csum[100], csum[2047], np.nextafter(csum[3000], 0.0),
                0.0, float(csum[-1])):
        want = pc.init_offload(P.sum(1), keys, cap)
        got = ph.plan_batch_torch(torch.from_numpy(P),
                                  torch.from_numpy(keys), cap)
        np.testing.assert_array_equal(got.numpy(), want)


# -- pareto mask and the autoscaling frontier ------------------------------

class TestParetoMask:
    def test_dominated_point_removed(self):
        cost = np.array([1.0, 2.0, 3.0])
        sla = np.array([0.5, 0.9, 0.8])
        np.testing.assert_array_equal(ph.pareto_mask(cost, sla),
                                      [True, True, False])

    def test_duplicates_survive(self):
        m = ph.pareto_mask(np.array([1.0, 1.0]), np.array([0.7, 0.7]))
        assert m.all()

    def test_strict_domination_on_one_axis(self):
        m = ph.pareto_mask(np.array([1.0, 2.0]), np.array([0.7, 0.7]))
        np.testing.assert_array_equal(m, [True, False])

    def test_frontier_is_mutually_non_dominating(self, rh):
        rng = np.random.default_rng(0)
        cost = rng.uniform(0, 1, 64)
        sla = rng.uniform(0, 1, 64)
        mask = ph.pareto_mask(cost, sla)
        np.testing.assert_array_equal(mask, rh.pareto_mask(cost, sla))
        idx = np.flatnonzero(mask)
        c, s = cost[idx], sla[idx]
        for i in range(len(idx)):
            dom = ((c <= c[i]) & (s >= s[i])
                   & ((c < c[i]) | (s > s[i])))
            assert not dom.any()


REPLICA_GRID = [np.array([p, d, 1]) for p in (1, 2, 4) for d in (2, 4, 8)]
C_MAX_GRID = (1.0, 2.0, 4.0, 8.0)


@pytest.fixture(scope="module")
def autoscale(ref, rh):
    rng = np.random.default_rng(3)
    plen, ntok = rng.integers(64, 4096, 32), rng.integers(32, 512, 32)
    return port_sched(), ref_sched(ref, rh), plen, ntok


class TestAutoscaleFrontier:
    def test_grid_shape_and_nondominated(self, autoscale):
        ps, rs, plen, ntok = autoscale
        fr = held_frontier("autoscale_frontier", ps, rs, plen, ntok,
                           REPLICA_GRID, C_MAX_GRID, use_ridge=False)
        assert isinstance(fr, ph.AutoscaleFrontier)
        assert fr.num_scenarios == len(REPLICA_GRID) * len(C_MAX_GRID)
        assert fr.sla_s == min(C_MAX_GRID)
        assert fr.pareto.any()
        np.testing.assert_allclose(fr.total_usd,
                                   fr.public_usd + fr.reserve_usd)
        idx = fr.frontier()
        assert (np.diff(fr.total_usd[idx]) >= 0).all()
        assert (np.diff(fr.sla[idx]) >= 0).all()
        assert len(fr.table().splitlines()) == len(idx) + 1

    def test_engines_agree(self, autoscale):
        ps, rs, plen, ntok = autoscale
        kw = dict(use_ridge=False)
        v = ps.autoscale_frontier(plen, ntok, REPLICA_GRID[:4], C_MAX_GRID,
                                  **kw)
        d = ps.autoscale_frontier(plen, ntok, REPLICA_GRID[:4], C_MAX_GRID,
                                  engine="des", **kw)
        rd = rs.autoscale_frontier(plen, ntok, REPLICA_GRID[:4], C_MAX_GRID,
                                   engine="des", **kw)
        np.testing.assert_allclose(v.total_usd, d.total_usd,
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(v.sla, d.sla)
        np.testing.assert_array_equal(v.pareto, d.pareto)
        np.testing.assert_array_equal(v.replicas, d.replicas)
        # the host reductions in the reference's order: the DES frontiers
        # of both packages equal value for value
        for fld in ("sla", "public_usd", "reserve_usd", "total_usd",
                    "makespan", "pareto", "replicas", "c_max"):
            np.testing.assert_array_equal(getattr(d, fld), getattr(rd, fld),
                                          err_msg=fld)

    def test_bigger_pod_never_attains_less_at_fixed_knob(self, autoscale):
        ps, _, plen, ntok = autoscale
        grid = [np.array([i, 2 * i, i]) for i in (1, 2, 4)]
        fr = ps.autoscale_frontier(plen, ntok, grid, C_MAX_GRID,
                                   use_ridge=False)
        best = [fr.sla[(fr.replicas[:, 0] == i)].max() for i in (1, 2, 4)]
        assert best[0] <= best[1] + 1e-12 <= best[2] + 2e-12

    def test_straggler_axis_rides_along(self, autoscale):
        ps, rs, plen, ntok = autoscale
        slow = {(1, 0): 4.0}
        fr = held_frontier("autoscale_frontier", ps, rs, plen, ntok,
                           [np.array([2, 4, 2])], C_MAX_GRID,
                           replica_speeds=[None, slow], use_ridge=False)
        assert fr.num_scenarios == len(C_MAX_GRID) * 2
        healthy, degraded = fr.sla[0::2], fr.sla[1::2]
        assert (degraded <= healthy + 1e-12).all()
        assert (fr.makespan[1::2] >= fr.makespan[0::2] - 1e-9).all()


# -- serve_online: arrivals, faults, congestion ----------------------------

@pytest.fixture(scope="module")
def online(ref, rh):
    rng = np.random.default_rng(0)
    J = 48
    return (port_sched(), ref_sched(ref, rh), rng.integers(64, 2048, J),
            rng.integers(16, 256, J), PoissonArrivals(rate=8.0, seed=7))


class TestServeOnline:
    def test_modes_and_metrics(self, online):
        ps, rs, plen, ntok, arr = online
        reports = {m: held_online(ps, rs, plen, ntok, arr, "des", sla_s=4.0,
                                  replan_every_s=0.5, use_ridge=False,
                                  mode=m)
                   for m in ("private", "public", "hybrid")}
        assert reports["private"].result.cost_usd == 0.0
        assert reports["public"].result.offload_fraction == 1.0
        assert reports["public"].result.cost_usd > 0.0
        hyb = reports["hybrid"]
        assert 0.0 <= hyb.sla_attainment <= 1.0
        assert hyb.result.cost_usd <= reports["public"].result.cost_usd
        s = hyb.summary()
        assert s["requests"] == len(plen)
        assert s["p95_latency_s"] >= s["mean_latency_s"] * 0.5

    def test_engines_agree_online(self, online):
        ps, rs, plen, ntok, arr = online
        a = held_online(ps, rs, plen, ntok, arr, "vector", sla_s=4.0,
                        replan_every_s=0.5, use_ridge=False)
        b = ps.serve_online(plen, ntok, arr, sla_s=4.0, replan_every_s=0.5,
                            use_ridge=False, engine="des")
        assert a.result.makespan == pytest.approx(b.result.makespan)
        assert a.result.cost_usd == pytest.approx(b.result.cost_usd)
        assert a.sla_attainment == b.sla_attainment

    def test_admission_quantization(self, online):
        ps, rs, plen, ntok, arr = online
        rep = held_online(ps, rs, plen, ntok, arr, "des", sla_s=4.0,
                          replan_every_s=1.0, use_ridge=False)
        assert (rep.admitted >= rep.release - 1e-12).all()
        np.testing.assert_allclose(rep.admitted % 1.0, 0.0, atol=1e-9)
        rep0 = ps.serve_online(plen, ntok, arr, sla_s=4.0,
                               replan_every_s=0.0, use_ridge=False,
                               engine="des")
        np.testing.assert_array_equal(rep0.admitted, rep0.release)

    def test_coarser_replan_never_improves_admission(self, online):
        ps, _, plen, ntok, arr = online
        fine = ps.serve_online(plen, ntok, arr, sla_s=4.0,
                               replan_every_s=0.25, use_ridge=False,
                               engine="des")
        coarse = ps.serve_online(plen, ntok, arr, sla_s=4.0,
                                 replan_every_s=2.0, use_ridge=False,
                                 engine="des")
        assert (coarse.admitted >= fine.admitted - 1e-12).all()


class TestServeOnlineFaults:
    """The graceful-degradation cases of the reference's chaos suite."""

    def test_serve_online_init_offload_is_causal(self, ref, rh):
        ps, rs = port_sched(2), ref_sched(ref, rh, 2)
        rng = np.random.default_rng(0)
        Jr = 16
        plen, ntok = rng.integers(64, 1024, Jr), rng.integers(16, 128, Jr)
        rel = np.concatenate([np.zeros(4), np.full(Jr - 4, 30.0)])
        rep = held_online(ps, rs, plen, ntok, rel, sla_s=2.0,
                          replan_every_s=1.0, init_offload=True)
        assert int(rep.result.n_init_offloaded_jobs) <= 4

    def test_full_provider_outage_survives(self, ref, rh):
        ps, rs = port_sched(3), ref_sched(ref, rh, 3)
        rng = np.random.default_rng(1)
        Jr = 20
        plen, ntok = rng.integers(64, 2048, Jr), rng.integers(16, 256, Jr)
        fm = FaultModel.from_rate(0.3, Jr, 3, max_attempts=3, seed=2,
                                  outages=tuple((p, 0.0, 1e9)
                                                for p in range(3)))
        rep = held_online(ps, rs, plen, ntok, "poisson:4.0", sla_s=3.0,
                          replan_every_s=1.0, faults=fm,
                          retry=RetryPolicy(max_attempts=3))
        summ = rep.summary()
        assert rep.result.public_mask.sum() == 0
        assert np.isfinite(summ["cost_usd"])
        assert 0.0 <= summ["abandoned_frac"] <= 1.0
        assert 0.0 <= summ["sla_attainment"] \
            <= summ["sla_attainment_served"]

    @pytest.mark.parametrize("engine", ["des", "vector"])
    def test_in_flight_pinning_under_outage(self, ref, rh, engine):
        ps, rs = port_sched(3), ref_sched(ref, rh, 3)
        rng = np.random.default_rng(3)
        Jr = 24
        plen, ntok = rng.integers(64, 2048, Jr), rng.integers(16, 256, Jr)
        out = ((0, 2.0, 30.0), (1, 3.0, 40.0))
        fm = FaultModel.from_rate(0.25, Jr, 3, max_attempts=3, seed=5,
                                  outages=out, outage_kills=False)
        rep = held_online(ps, rs, plen, ntok, "poisson:6.0", engine,
                          sla_s=3.0, replan_every_s=0.5, faults=fm,
                          retry=RetryPolicy(max_attempts=3))
        res = rep.result
        windows = {p: (a, b) for (p, a, b) in out}
        jj, kk = np.nonzero(res.public_mask)
        for j, k in zip(jj, kk):
            w = windows.get(int(res.provider[j, k]))
            if w is None:
                continue
            assert not (w[0] <= res.start[j, k] < w[1]) or np.isnan(
                res.start[j, k])

    def test_engines_agree_under_faults_online(self, ref, rh):
        ps, rs = port_sched(3), ref_sched(ref, rh, 3)
        rng = np.random.default_rng(4)
        Jr = 18
        plen, ntok = rng.integers(64, 2048, Jr), rng.integers(16, 256, Jr)
        b = held_online(ps, rs, plen, ntok, "poisson:5.0", sla_s=2.5,
                        replan_every_s=1.0, faults=0.3,
                        init_offload=True).result
        a = ps.serve_online(plen, ntok, "poisson:5.0", sla_s=2.5,
                            replan_every_s=1.0, faults=0.3, engine="des",
                            init_offload=True).result
        assert np.isclose(a.makespan, b.makespan, rtol=1e-9)
        assert np.isclose(a.cost_usd, b.cost_usd, rtol=1e-9)
        assert (a.public_mask == b.public_mask).all()
        assert (a.attempts == b.attempts).all()
        assert (a.abandoned == b.abandoned).all()

    def test_reliability_frontier(self, ref, rh):
        ps, rs = port_sched(3), ref_sched(ref, rh, 3)
        rng = np.random.default_rng(5)
        Jr = 16
        plen, ntok = rng.integers(64, 2048, Jr), rng.integers(16, 256, Jr)
        fr = held_frontier("reliability_frontier", ps, rs, plen, ntok,
                           fault_grid=[None, 0.25], c_max_grid=(2.0, 4.0),
                           retry=RetryPolicy(max_attempts=2))
        assert fr.num_scenarios == 4
        assert fr.pareto.any()
        assert (fr.availability >= 0).all() and (fr.availability <= 1).all()
        assert len(fr.frontier()) == int(fr.pareto.sum())
        assert "cost $" in fr.table()
        assert (fr.availability[fr.fault_idx == 0] == 1.0).all()


class TestTrainingReuse:
    """The port's ``training/fault.py`` on the core's backoff."""

    def test_run_with_restarts_uses_policy_schedule(self, monkeypatch):
        slept = []
        monkeypatch.setattr(ptf.time, "sleep", slept.append)
        calls = []

        def work(attempt):
            calls.append(attempt)
            if attempt < 3:
                raise RuntimeError("boom")
            return attempt

        assert ptf.run_with_restarts(work, max_restarts=3,
                                     backoff_s=0.25) == 3
        assert calls == [0, 1, 2, 3]
        assert slept == pytest.approx([0.25, 0.5, 1.0])

    def test_run_with_restarts_exhausts(self):
        def always(attempt):
            raise RuntimeError("boom")

        with pytest.raises(RuntimeError):
            ptf.run_with_restarts(always, max_restarts=2, backoff_s=0.0)

    def test_straggler_slowdowns(self, ref):
        from repro.training.fault import straggler_slowdowns

        hist = {(0, 1): [0.1] * 20 + [0.4], (0, 0): [0.1] * 20,
                (2, 3): [0.2] * 5 + [0.21]}
        sl = ptf.straggler_slowdowns(hist)
        assert sl == straggler_slowdowns(hist)
        assert set(sl) == {(0, 1)}
        assert 3.5 < sl[(0, 1)] < 4.5

    def test_slowdowns_feed_simulation(self, ref):
        dag = pc.APPS["matrix"]
        pred, act = workload(dag, 6, 8)
        sl = ptf.straggler_slowdowns({(0, 0): [0.1] * 20 + [0.5]})
        slowed = pc.simulate(dag, pred, act, c_max=1e6, replica_slowdown=sl)
        base = pc.simulate(dag, pred, act, c_max=1e6)
        assert slowed.makespan >= base.makespan - 1e-12
        want = ref.simulator.simulate(ref.core.APPS["matrix"], pred, act,
                                      c_max=1e6, replica_slowdown=sl)
        assert_bitwise(slowed, want)

    def test_straggler_telemetry_reaches_serve_online(self, online):
        ps, rs, plen, ntok, arr = online
        steps = {(1, 0): [0.1] * 20 + [0.5]}
        rep = held_online(ps, rs, plen, ntok, arr, "des", sla_s=4.0,
                          replan_every_s=0.5, use_ridge=False,
                          replica_step_times=steps)
        base = ps.serve_online(plen, ntok, arr, sla_s=4.0,
                               replan_every_s=0.5, use_ridge=False,
                               engine="des")
        assert rep.result.makespan >= base.result.makespan - 1e-12


class TestOnlineCongestionFeedback:
    def test_ewma_math(self):
        est = queue_wait_ewma([np.array([1.0, 0.0]), np.array([3.0, 1.0])],
                              alpha=0.5)
        np.testing.assert_allclose(est, [2.0, 0.5])
        assert queue_wait_ewma([]) is None
        with pytest.raises(ValueError, match="alpha"):
            queue_wait_ewma([np.zeros(2)], alpha=0.0)
        with pytest.raises(ValueError):
            queue_wait_ewma([np.array([-1.0])])

    def test_serve_online_threads_load_kwargs(self, ref, rh):
        ps, rs = port_sched(), ref_sched(ref, rh)
        rng = np.random.default_rng(0)
        J = 12
        plen = rng.integers(64, 1024, J)
        ntok = rng.integers(16, 128, J)
        rep = held_online(
            ps, rs, plen, ntok, "poisson:6.0", sla_s=4.0, concurrency=1,
            coldstart=ColdStartModel(warm_up_s=0.2, keep_alive_s=0.5),
            stage_queue_waits=[np.full(3, 0.1), np.full(3, 0.4)])
        assert rep.result.queue_wait is not None
        assert np.isfinite(rep.result.completion).all()

    def test_queue_wait_telemetry_length_checked(self):
        ps = port_sched()
        with pytest.raises(ValueError, match="stage_queue_waits"):
            ps.serve_online(np.array([128]), np.array([16]),
                            arrivals=np.array([0.0]), sla_s=4.0,
                            stage_queue_waits=[np.zeros(2)])

    def test_observed_congestion_shifts_the_plan(self, ref, rh):
        ps, rs = port_sched(3), ref_sched(ref, rh, 3)
        rng = np.random.default_rng(7)
        J = 16
        plen = rng.integers(256, 4096, J)
        ntok = rng.integers(64, 512, J)
        arrivals = np.sort(rng.uniform(0.0, 1.0, J))
        kw = dict(sla_s=1.5, order="hcf", seed=3)
        blind = ps.serve_online(plen, ntok, arrivals, **kw)
        seen = held_online(ps, rs, plen, ntok, arrivals, **kw,
                           stage_queue_waits=[np.full(3, 50.0)])
        changed = (
            not np.array_equal(blind.result.public_mask,
                               seen.result.public_mask)
            or not np.array_equal(
                np.nan_to_num(blind.result.provider, nan=-1),
                np.nan_to_num(seen.result.provider, nan=-1))
            or not np.array_equal(blind.result.start, seen.result.start))
        assert changed, "congestion telemetry did not reach the plan"


# -- the launcher and the device ------------------------------------------

def _main_lines(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def test_launch_serve_main_on_the_cpu(ref, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu``: the smoke
    batch runs on the CPU, and with the reference's peak rates the plan's
    lines are the reference launcher's."""
    from repro.launch import serve as rserve

    lines = _main_lines(pserve.main, ["--arch", "llama3-8b", "--requests",
                                      "24", "--execute-smoke", "--device",
                                      "cpu"])
    assert lines[0].startswith("executed 8 requests on cpu")
    assert lines[1] == "arch=llama3-8b J=24 order=spt"
    assert lines[2].startswith("all-private:") and "met=" in lines[4]

    monkeypatch.setattr(ph.ServingLatencyModel, "__init__",
                        functools.partialmethod(
                            ph.ServingLatencyModel.__init__, **ref_peaks()))
    monkeypatch.setattr(sys, "argv", ["serve", "--requests", "24"])
    want = _main_lines(lambda argv: rserve.main(), None)
    got = _main_lines(pserve.main, ["--requests", "24", "--device", "cpu"])
    # the schedule line rests on the two libraries' float32 ridge fits
    # (equal to rtol 1e-5), so only the baselines are held to the letter
    assert got[:3] == want[:3]
    assert got[3].startswith("hybrid     :") and "met=" in got[3]


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = get_config("llama3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ph.HybridServingScheduler(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pserve.main(["--requests", "4"])
    ps = ph.HybridServingScheduler(cfg, device="cpu")
    assert ps.device == torch.device("cpu")


@pytest.mark.gpu
def test_cuda_compare_policies_equals_the_cpu():
    """``compare_policies`` on the card (``acd_evict`` and, under caps,
    ``fifo_dispatch``) equals the same comparison on the CPU field for
    field, uncapped with a fault axis and congested."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import ops

    cfg = get_config("llama3-8b")
    rng = np.random.default_rng(0)
    J = 96
    plen, ntok = rng.integers(64, 2048, J), rng.integers(16, 256, J)
    names = ["skedulix", "private", "public", "random", "noah",
             "costanalysis"]
    cs = ColdStartModel(warm_up_s=0.5, keep_alive_s=1.0, scale_to_zero=True)
    for kw in (dict(faults=[None, 0.3], retry=RetryPolicy()),
               dict(concurrency=2, coldstart=cs)):
        reps = {}
        for dev in ("cuda", "cpu"):
            s = ph.HybridServingScheduler(
                cfg, portfolio=ph.elastic_portfolio(3), device=dev)
            ops.reset_launch_counts()
            reps[dev] = s.compare_policies(
                plen, ntok, names, sla_s=4.0, arrivals="poisson:8.0",
                replan_every_s=0.5, use_ridge=False, **kw)
            if dev == "cuda":
                counts = ops.launch_counts()
                assert counts["acd_evict"] > 0
                assert ("concurrency" not in kw
                        or counts["fifo_dispatch"] > 0)
        for i, name in enumerate(names):
            assert_bitwise(reps["cuda"].results[i], reps["cpu"].results[i],
                           where=name)
        for fld in ("cost_usd", "sla", "makespan", "offload_frac",
                    "abandoned_frac"):
            np.testing.assert_array_equal(getattr(reps["cuda"], fld),
                                          getattr(reps["cpu"], fld))
