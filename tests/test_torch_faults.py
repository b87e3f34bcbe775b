"""Fault injection and recovery in the port's engine, against the reference.

The same seeded fault grids (iid failure draws, provider outage windows,
partial-kill billing, retry budgets with jittered backoff) go through the
port's engine on the CPU (``device="cpu"``: every adaptive step runs the
plain version of ``acd_evict``), the reference's engine with
``engine_impl="pallas"`` (its kernels in interpret mode) and ``"loop"``,
and the port's DES. The contract, as in the reference's
``tests/test_faults.py``:

* against the reference vector engine, every field bit for bit (attempt
  and failure counts, abandonment, lost-work billing included);
* against the DES, the executed schedule exactly, with the attempt,
  failure and abandonment counts, and cost and makespan to a relative
  1e-12;
* a zero fault grid is the fault-free schedule bit for bit.

One exception, a property of the reference: with ``kill_frac`` below 1 its
XLA CPU build fuses the failure instant ``start + kill_frac * duration``
into one multiply-add, which the DES does not. The port follows the DES
there (its times equal the DES's exactly) and holds those scenarios of the
reference to a relative 1e-14, every discrete field still exact.
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
from repro_torch.core import convert, faults as pfaults
from tests.test_torch_harness import (FIELDS, assert_bitwise, assert_parity,
                                      grid_for, reference, workload)

J = 11
IMPLS = ("pallas", "loop")
#: the discrete fields of a result, exact in every comparison
DISCRETE = ("public_mask", "provider", "replica", "segment", "attempts",
            "failed", "abandoned", "n_offloaded_stages",
            "n_init_offloaded_jobs", "per_stage_offloads", "queue_wait",
            "cold")


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


def _portfolio_pair(ref, n):
    pf = ref.cost.demo_portfolio(n)
    return pf, convert.portfolio_from_fields(dataclasses.asdict(pf))


def _port(x):
    """The port's twin of a reference fault object (FaultModel,
    RetryPolicy, or an axis of them); floats and None pass through."""
    if isinstance(x, (list, tuple)):
        return [_port(v) for v in x]
    if dataclasses.is_dataclass(x):
        cls = getattr(pfaults, type(x).__name__)
        return cls(**{f.name: getattr(x, f.name)
                      for f in dataclasses.fields(x)})
    return x


def chaos_model(ref, dag, J, seed, rate=0.35, max_attempts=3,
                outages=((0, 2.0, 6.0), (1, 4.0, 5.0))):
    """The reference chaos suite's fixture (``tests/strategies.py``):
    seeded iid failures, two staggered outages, partial-kill billing."""
    return ref.core.FaultModel.from_rate(
        rate, J, dag.num_stages, max_attempts=max_attempts, seed=seed,
        outages=outages, kill_frac=0.6)


def _kill_frac(axis, n_fault):
    """Each fault-axis entry's kill_frac (1.0 for rates and None)."""
    axis = axis if isinstance(axis, (list, tuple)) else [axis]
    out = [getattr(f, "kill_frac", 1.0) for f in axis]
    assert len(out) == n_fault
    return np.array(out)


def assert_matches_reference(port, want, faults, where=""):
    """Bit for bit, except the times of scenarios whose fault model kills
    at a fraction below 1 (the reference's multiply-add): there to a
    relative 1e-14, the discrete fields still exact."""
    kill = _kill_frac(faults, int(port.fault_idx.max()) + 1)
    fused = kill[port.fault_idx] < 1.0
    assert_bitwise(port, want, fields=DISCRETE + ("fault_idx",),
                   where=where)

    class Sub:
        def __init__(self, res, sel):
            self.res, self.sel = res, sel

        def __getattr__(self, name):
            return np.asarray(getattr(self.res, name))[self.sel]

    assert_bitwise(Sub(port, ~fused), Sub(want, ~fused), where=where)
    for fld in ("start", "end", "completion", "makespan", "cost_usd"):
        a = np.asarray(getattr(port, fld))[fused]
        b = np.asarray(getattr(want, fld))[fused]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=1e-14, atol=0,
                                   err_msg=f"{where} {fld}")


def assert_des(port, des, where=""):
    """The parity contract against the DES, the recovery counts exact."""
    assert_parity(port, des, where=where)
    assert_bitwise(port, des, fields=("attempts", "failed", "abandoned",
                                      "fault_idx"), where=where)


def run_all(ref, dag_name, faults, retry, seed, fracs=(0.25, 0.6),
            orders=("spt", "hcf"), n_providers=3, impls=IMPLS, **kw):
    """Both reference twins, the port on the CPU and the port's DES."""
    dag_r, dag_p = _dag_pair(ref, dag_name)
    pred, act = workload(dag_r, J, seed)
    pf_r, pf_p = _portfolio_pair(ref, n_providers)
    call = dict(c_max_grid=grid_for(dag_r, pred, fracs), orders=orders,
                **kw)
    out = {impl: ref.vectorsim.simulate_scenarios(
        dag_r, pred, act, portfolio=pf_r, faults=faults, retry=retry,
        engine_impl=impl, **call) for impl in impls}
    kw_p = dict(call, portfolio=pf_p, faults=_port(faults),
                retry=_port(retry))
    out["port"] = pc.simulate_scenarios(dag_p, pred, act, device="cpu",
                                        **kw_p)
    out["des"] = pc.simulate_scenarios(dag_p, pred, act, engine="des",
                                       **kw_p)
    return out


class TestEquivalence:
    """The port == the reference's twins == the DES on fault scenarios."""

    @pytest.mark.parametrize("dag", ["video", "image", "llm_serve",
                                     "pinned"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_chaos_scenarios_match(self, ref, dag, seed):
        dag_r = _dag_pair(ref, dag)[0]
        retry = ref.core.RetryPolicy(max_attempts=3, backoff_s=0.3,
                                     jitter_frac=0.4)
        faults = [None, 0.3, chaos_model(ref, dag_r, J, seed)]
        r = run_all(ref, dag, faults, retry, seed,
                    impls=IMPLS if seed == 0 else ("pallas",))
        for impl in IMPLS if seed == 0 else ("pallas",):
            assert_matches_reference(r["port"], r[impl], faults,
                                     where=f"{dag}/{impl}")
        assert_des(r["port"], r["des"], where=dag)
        v = r["port"]
        # the chaos axis exercised the recovery machinery
        assert v.failed.sum() > 0 and v.attempts.sum() > v.public_mask.sum()

    def test_no_fallback_abandonment_matches(self, ref):
        dag_r = _dag_pair(ref, "video")[0]
        faults = chaos_model(ref, dag_r, J, 4, rate=0.5, max_attempts=2)
        retry = ref.core.RetryPolicy(max_attempts=2, private_fallback=False)
        r = run_all(ref, "video", faults, retry, 4, fracs=(0.3,),
                    orders=("spt",))
        for impl in IMPLS:
            assert_matches_reference(r["port"], r[impl], faults,
                                     where=impl)
        assert_des(r["port"], r["des"])
        v = r["port"]
        assert v.abandoned.any(), "chaos config should abandon something"
        # abandoned jobs never report a completion, in either engine
        assert np.isnan(v.completion[v.abandoned]).all()
        assert np.isnan(r["des"].completion[r["des"].abandoned]).all()

    def test_outage_kills_in_flight_work(self, ref):
        """An outage window opening mid-run reclaims the attempt; lost work
        bills pro rata, bit for bit against the reference."""
        dag_r = _dag_pair(ref, "image")[0]
        outages = ((0, 0.5, 8.0), (1, 1.0, 9.0))
        fm = ref.core.FaultModel.from_rate(0.0, J, dag_r.num_stages,
                                           max_attempts=2, outages=outages)
        retry = ref.core.RetryPolicy(max_attempts=2)
        r = run_all(ref, "image", fm, retry, 6, fracs=(0.3,),
                    orders=("spt",))
        for impl in IMPLS:
            assert_bitwise(r["port"], r[impl], where=impl)
        assert_des(r["port"], r["des"])
        no_kill = pc.simulate_scenarios(
            _dag_pair(ref, "image")[1], *workload(dag_r, J, 6),
            c_max_grid=grid_for(dag_r, workload(dag_r, J, 6)[0], (0.3,)),
            portfolio=_portfolio_pair(ref, 3)[1], device="cpu",
            faults=pc.FaultModel.from_rate(0.0, J, dag_r.num_stages,
                                           max_attempts=2, outages=outages,
                                           outage_kills=False),
            retry=pc.RetryPolicy(max_attempts=2))
        # with kills off the windows only mask placement epochs
        assert no_kill.failed.sum() <= r["port"].failed.sum()
        assert r["port"].failed.sum() > 0


class TestDegenerate:
    """Fault-free configs are the fault-free schedule, bit for bit."""

    @pytest.mark.parametrize("engine", ["des", "vector"])
    def test_zero_model_bit_exact(self, engine):
        dag = pc.APPS["video"]
        pred, act = workload(dag, J, 2)
        kw = dict(c_max_grid=grid_for(dag, pred), orders=("spt", "hcf"),
                  portfolio=pc.demo_portfolio(3), engine=engine,
                  device="cpu")
        base = pc.simulate_scenarios(dag, pred, act, **kw)
        zero = pc.simulate_scenarios(
            dag, pred, act, **kw,
            faults=pc.FaultModel.from_rate(0.0, J, dag.num_stages,
                                           max_attempts=3),
            retry=pc.RetryPolicy(max_attempts=3, backoff_s=0.5))
        assert_bitwise(zero, base, fields=tuple(
            f for f in FIELDS if f != "fault_idx"))
        assert not zero.abandoned.any() and zero.failed.sum() == 0
        assert (zero.attempts == zero.public_mask.astype(int)).all()

    @pytest.mark.parametrize("engine", ["des", "vector"])
    def test_single_attempt_slot_bit_exact(self, engine):
        """One attempt slot at rate 0: the degenerate chain replays the
        plain engine verbatim."""
        dag = pc.APPS["matrix"]
        pred, act = workload(dag, J, 3)
        kw = dict(c_max_grid=grid_for(dag, pred), orders=("spt",),
                  portfolio=pc.demo_portfolio(2), engine=engine,
                  device="cpu")
        base = pc.simulate_scenarios(dag, pred, act, **kw)
        one = pc.simulate_scenarios(
            dag, pred, act, **kw, faults=pc.FaultModel.none(
                J, dag.num_stages), retry=pc.RetryPolicy(max_attempts=1))
        assert_bitwise(one, base, fields=("makespan", "cost_usd",
                                          "completion", "start", "end"))

    def test_init_window_none_is_bit_exact(self):
        dag = pc.APPS["image"]
        pred, act = workload(dag, J, 5)
        rel = np.linspace(0.0, 5.0, J)
        for engine in ("des", "vector"):
            kw = dict(c_max_grid=grid_for(dag, pred), orders=("spt",),
                      arrivals=rel, engine=engine, device="cpu")
            base = pc.simulate_scenarios(dag, pred, act, **kw)
            wide = pc.simulate_scenarios(dag, pred, act, **kw,
                                         init_window=1e9)
            assert_bitwise(wide, base)


class TestInitWindow:
    def test_window_gates_late_releases(self, ref):
        """The init offload never plans over jobs released after the
        first window; port == reference twins == DES."""
        dag_r, dag_p = _dag_pair(ref, "video")
        pred, act = workload(dag_r, J, 7)
        rel = np.concatenate([np.zeros(3), np.full(J - 3, 50.0)])
        kw = dict(c_max_grid=grid_for(dag_r, pred, (0.4,)), orders=("spt",),
                  arrivals=rel, init_window=1.0)
        got = pc.simulate_scenarios(dag_p, pred, act, device="cpu", **kw)
        for impl in IMPLS:
            assert_bitwise(got, ref.vectorsim.simulate_scenarios(
                dag_r, pred, act, engine_impl=impl, **kw), where=impl)
        des = pc.simulate_scenarios(dag_p, pred, act, engine="des", **kw)
        assert_des(got, des)
        # late jobs can still be ACD-evicted, never init-offloaded
        n_window = int(got.n_init_offloaded_jobs.max())
        assert n_window <= 3
        full = pc.simulate_scenarios(dag_p, pred, act, device="cpu",
                                     **dict(kw, init_window=None))
        assert int(full.n_init_offloaded_jobs.max()) > n_window


class TestProperties:
    """The reference's deterministic recovery properties, on the port."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_more_retry_budget_never_abandons_more(self, seed):
        """Without fallback a larger attempt budget only turns abandoned
        stages into served ones (the draws are nested)."""
        dag = pc.APPS["video"]
        pred, act = workload(dag, J, seed)
        rng = np.random.default_rng(100 + seed)
        A_max = 4
        fail = rng.random((J, dag.num_stages, A_max)) < 0.45
        grid = grid_for(dag, pred, (0.3,))
        prev = None
        for A in range(1, A_max + 1):
            fm = pc.FaultModel(fail=fail[:, :, :A],
                               jitter=np.zeros((J, dag.num_stages, A)))
            res = pc.simulate_scenarios(
                dag, pred, act, c_max_grid=grid, orders=("spt",),
                portfolio=pc.demo_portfolio(3), faults=fm, device="cpu",
                retry=pc.RetryPolicy(max_attempts=A, backoff_s=0.1,
                                     private_fallback=False))
            n_ab = int(res.abandoned.sum())
            if prev is not None:
                assert n_ab <= prev, \
                    f"budget {A} abandoned {n_ab} > {prev} at {A - 1}"
            prev = n_ab

    @pytest.mark.parametrize("seed", [0, 1])
    def test_outage_widening_never_cheaper(self, seed):
        """Uniform latencies, no transfers, kills off: a wider outage only
        shrinks each placement's feasible set, so the bill never falls
        and the makespan never moves."""
        dag = pc.APPS["matrix"]
        pred, act = workload(dag, J, seed)
        pred["P_private"] = np.full((J, dag.num_stages), 1e9)
        rel = np.linspace(0.0, 6.0, J)
        pf = pc.ProviderPortfolio(tuple(
            pc.Provider(f"u{i}", quantum_ms=1.0, usd_per_gb_ms=r * 2.1e-9,
                        latency_mult=1.0)
            for i, r in enumerate((1.0, 0.8, 1.3))))
        prev_cost, prev_mk = -np.inf, None
        for widen in (1e-6, 2.0, 5.0, 20.0):
            fm = pc.FaultModel.from_rate(
                0.0, J, dag.num_stages, max_attempts=1,
                outages=((0, 1.0, 1.0 + widen), (1, 2.0, 2.0 + widen)),
                outage_kills=False)
            res = pc.simulate_scenarios(
                dag, pred, pred, c_max_grid=(1e6,), orders=("spt",),
                portfolio=pf, include_transfers=False, arrivals=rel,
                faults=fm, retry=pc.RetryPolicy(max_attempts=1),
                device="cpu")
            cost, mk = float(res.cost_usd[0]), float(res.makespan[0])
            assert cost >= prev_cost - 1e-12
            if prev_mk is not None:
                assert np.isclose(mk, prev_mk, rtol=1e-9)
            prev_cost, prev_mk = cost, mk

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_zero_rate_is_identity(self, seed):
        dag = pc.APPS["image"]
        pred, act = workload(dag, J, seed)
        kw = dict(c_max_grid=grid_for(dag, pred, (0.5,)), orders=("spt",),
                  portfolio=pc.demo_portfolio(3), device="cpu")
        base = pc.simulate_scenarios(dag, pred, act, **kw)
        zero = pc.simulate_scenarios(dag, pred, act, **kw, faults=0.0,
                                     retry=pc.RetryPolicy(max_attempts=2))
        assert_bitwise(zero, base, fields=("makespan", "cost_usd",
                                           "public_mask"))


def test_sweep_task_fault_axes_match_reference(ref):
    """A sweep mixing a faulty and a fault-free task (separate engine
    calls) and the scheduler's ``schedule_sweep(faults=)``."""
    def tasks(side):
        out = []
        for name, seed, faults in (("video", 0, [None, 0.3]),
                                   ("image", 1, None)):
            dag = _dag_pair(ref, name)[side]
            pred, act = workload(dag, J, seed)
            out.append(dict(dag=dag, pred=pred, act=act,
                            c_max_grid=grid_for(dag, pred, (0.3, 0.6)),
                            faults=faults))
        return out

    pf_r, pf_p = _portfolio_pair(ref, 3)
    want = ref.vectorsim.sweep_scenarios(tasks(0), portfolio=pf_r,
                                         engine_impl="pallas")
    got = pc.sweep_scenarios(tasks(1), portfolio=pf_p, device="cpu")
    des = pc.sweep_scenarios(tasks(1), portfolio=pf_p, engine="des")
    for i in range(2):
        assert_bitwise(got[i], want[i], fields=FIELDS + ("fault_idx",),
                       where=f"task {i}")
        assert_des(got[i], des[i], where=f"task {i}")
    assert got[0].failed.sum() > 0 and got[1].failed.sum() == 0
    sched = pc.SkedulixScheduler(tasks(1)[0]["dag"], portfolio=pf_p)
    t = tasks(1)[0]
    res = sched.schedule_sweep(t["c_max_grid"], pred=t["pred"], act=t["act"],
                               faults=[None, 0.3], device="cpu")
    assert_bitwise(res, got[0])


try:        # optional: fuzz the engines' agreement when hypothesis is here
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @given(rate=st.floats(min_value=0.0, max_value=0.9),
           seed=st.integers(min_value=0, max_value=50))
    @settings(max_examples=15, deadline=None)
    def test_engines_agree_fuzzed(rate, seed):
        dag = pc.APPS["matrix"]
        pred, act = workload(dag, 6, seed)
        kw = dict(c_max_grid=grid_for(dag, pred, (0.4,)), orders=("spt",),
                  portfolio=pc.demo_portfolio(2),
                  faults=pc.FaultModel.from_rate(rate, 6, dag.num_stages,
                                                 max_attempts=2, seed=seed),
                  retry=pc.RetryPolicy(max_attempts=2))
        v = pc.simulate_scenarios(dag, pred, act, device="cpu", **kw)
        d = pc.simulate_scenarios(dag, pred, act, engine="des", **kw)
        assert_des(v, d)


@pytest.mark.gpu
def test_cuda_fault_sweep_matches_cpu():
    """The attempt chain on the card (``acd_evict`` at every adaptive
    step) equals the CPU run field for field, on a 3-app sweep."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import ops

    tasks = []
    for i, name in enumerate(("image", "matrix", "video")):
        dag = pc.APPS[name]
        pred, act = workload(dag, 64, 40 + i)
        tasks.append(dict(dag=dag, pred=pred, act=act,
                          c_max_grid=grid_for(dag, pred, (0.3, 0.6)),
                          orders=("spt", "hcf"), faults=[0.0, 0.3]))
    kw = dict(portfolio=pc.demo_portfolio(3),
              retry=pc.RetryPolicy(max_attempts=3, jitter_frac=0.3))
    ops.reset_launch_counts()
    got = pc.sweep_scenarios(tasks, device="cuda", **kw)
    assert ops.acd_evict.launches > 0
    want = pc.sweep_scenarios(tasks, device="cpu", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_bitwise(g, w, fields=FIELDS + ("fault_idx",),
                       where=f"task {i}")
    assert sum(int(g.failed.sum()) for g in got) > 0
