"""Load-dependent latency in the port: concurrency caps, cold starts, pool
traces, against the reference.

The same seeded congested workloads (bursty arrivals, deadlines that force
offloads, caps that bind, keep-alive windows that lapse) go through the
port's engine on the CPU (``device="cpu"``: the capped dispatch chain runs
the plain version of ``fifo_dispatch``), the reference's engine with
``engine_impl="pallas"`` (its Pallas kernels in interpret mode) and
``"loop"``, and the port's DES. The contract, as in the reference's own
``tests/test_coldstart.py``:

* against the reference vector engine, every result field bit for bit,
  ``cost_usd`` included (the occupancy surcharge and the bill add as one
  value per (job, stage));
* against the DES, the executed schedule exactly (start, end, queue wait,
  cold flags, providers, replicas, segments, makespan) and ``cost_usd`` to
  a relative 1e-12 (the DES sums the bill chronologically);
* degenerate configs (no finite cap, a zero-penalty model, a constant
  pool) give the plain schedule bit for bit;
* the combinations the reference rejects raise its errors.
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
from repro_torch.core import convert
from tests.test_torch_harness import FIELDS, assert_bitwise, reference

IMPLS = ("pallas", "loop")

#: the executed schedule, compared to the bit against the DES
EXACT_FIELDS = ("makespan", "start", "end", "completion", "queue_wait",
                "cold", "provider", "replica", "segment", "public_mask")

#: (concurrency, coldstart, pool_trace) per config; "CS"/"POOL" name the
#: shared models below, built on each side from the same fields
LOAD_CONFIGS = {
    "capped": dict(concurrency=1),
    "capped2": dict(concurrency=2),
    "cold": dict(coldstart="CS"),
    "capped+cold": dict(concurrency=1, coldstart="CS"),
    "pool": dict(pool_trace="POOL"),
    "pool+cold": dict(pool_trace="POOL", coldstart="CS"),
    "pool+cold+capped": dict(pool_trace="POOL", coldstart="CS",
                             concurrency=1),
}


@pytest.fixture(scope="module")
def ref():
    return reference()


def _models(ref, side):
    """The shared cold-start model and pool trace, for one package
    (side 0 = the reference's objects, 1 = the port's)."""
    from repro.core.coldstart import ColdStartModel, PoolTrace

    cs = ColdStartModel(warm_up_s=0.5, keep_alive_s=1.0, scale_to_zero=True)
    pool = PoolTrace(counts=(1, 2), breakpoints=(2.0,))
    if side == 0:
        return dict(CS=cs, POOL=pool)
    return dict(CS=convert.coldstart_from_fields(dataclasses.asdict(cs)),
                POOL=convert.pool_trace_from_fields(dataclasses.asdict(pool)))


def _kw(ref, cfg, side):
    models = _models(ref, side)
    return {k: models[v] if isinstance(v, str) else v
            for k, v in cfg.items()}


def _dag(ref, name, side):
    if name == "matrix2":
        from repro.core.dag import matrix_app

        d = matrix_app(replicas=2)
    else:
        d = ref.core.APPS[name]
    return d if side == 0 else convert.dag_from_fields(dataclasses.asdict(d))


def congested(dag, J=9, seed=0, horizon=2.0):
    """A scenario tight enough that caps bind and keep-alive lapses:
    bursty arrivals, a deadline forcing offloads (the reference suite's
    generator)."""
    rng = np.random.default_rng(seed)
    M = dag.num_stages
    pred = dict(P_private=rng.uniform(0.5, 2.0, (J, M)),
                P_public=rng.uniform(0.2, 1.5, (J, M)),
                up_mb=rng.uniform(1.0, 30.0, (J, M)),
                down_mb=rng.uniform(1.0, 30.0, (J, M)))
    arrivals = np.sort(rng.uniform(0.0, horizon, J))
    return pred, arrivals


def assert_exact_vs_des(port, des, where=""):
    """The executed schedule to the bit; the bill to a relative 1e-12."""
    for fld in EXACT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(port, fld)),
                                      np.asarray(getattr(des, fld)),
                                      err_msg=f"{where} field {fld}")
    np.testing.assert_allclose(port.cost_usd, des.cost_usd, rtol=1e-12,
                               atol=0, err_msg=f"{where} field cost_usd")


def _run_all(ref, dag_name, call, cfg, J=9, seed=0, horizon=2.0,
             portfolio=None):
    """Port (cpu), port DES and both reference twins on one grid."""
    dag_r, dag_p = _dag(ref, dag_name, 0), _dag(ref, dag_name, 1)
    pred, arrivals = congested(dag_r, J=J, seed=seed, horizon=horizon)
    pf_r = pf_p = {}
    if portfolio is not None:
        pf_r = dict(portfolio=ref.cost.demo_portfolio(portfolio))
        pf_p = dict(portfolio=convert.portfolio_from_fields(
            dataclasses.asdict(pf_r["portfolio"])))
    full = dict(call, arrivals=arrivals)
    out = {impl: ref.vectorsim.simulate_scenarios(
        dag_r, pred, engine_impl=impl, **full, **_kw(ref, cfg, 0), **pf_r)
        for impl in IMPLS}
    kw_p = dict(full, **_kw(ref, cfg, 1), **pf_p)
    out["port"] = pc.simulate_scenarios(dag_p, pred, device="cpu", **kw_p)
    out["des"] = pc.simulate_scenarios(dag_p, pred, engine="des", **kw_p)
    return out


@pytest.fixture(scope="module")
def load_runs(ref):
    call = dict(c_max_grid=(4.0, 8.0), orders=("spt", "hcf"))
    return {name: _run_all(ref, "matrix2", call, cfg)
            for name, cfg in LOAD_CONFIGS.items()}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(LOAD_CONFIGS))
def test_load_configs_match_reference_engine(load_runs, name, impl):
    r = load_runs[name]
    assert r["port"].num_scenarios == 4
    assert_bitwise(r["port"], r[impl], where=f"{name}/{impl}")


@pytest.mark.parametrize("name", sorted(LOAD_CONFIGS))
def test_load_configs_match_des(load_runs, name):
    r = load_runs[name]
    assert_exact_vs_des(r["port"], r["des"], where=name)
    cfg = LOAD_CONFIGS[name]
    if "concurrency" in cfg:
        assert r["port"].queue_wait.sum() > 0  # the caps bind
    if "coldstart" in cfg:
        assert r["port"].cold.any()


@pytest.mark.parametrize("portfolio", [None, 3], ids=["lambda", "demo3"])
def test_video_caps_and_cold(ref, portfolio):
    """The widest canonical DAG, caps and cold starts together, on the
    single provider and on a 3-provider portfolio."""
    cfg = dict(concurrency=2, coldstart="CS")
    r = _run_all(ref, "video", dict(c_max_grid=(6.0,), orders=("spt",)),
                 cfg, J=7, seed=3, horizon=3.0, portfolio=portfolio)
    for impl in IMPLS:
        assert_bitwise(r["port"], r[impl], where=f"video/{impl}")
    assert_exact_vs_des(r["port"], r["des"], where="video")
    assert r["port"].public_mask.any() and r["port"].cold.any()


def test_multi_app_sweep_caps_and_cold(ref):
    """One sweep over three applications (stage padding, one fused engine
    call) under caps and cold starts on a 3-provider portfolio."""
    def tasks(side):
        out = []
        for i, name in enumerate(("image", "matrix", "video")):
            dag = _dag(ref, name, side)
            pred, arrivals = congested(dag, J=9, seed=10 + i)
            out.append(dict(dag=dag, pred=pred, arrivals=arrivals,
                            c_max_grid=(4.0, 7.0), orders=("spt", "hcf")))
        return out

    pf_r = ref.cost.demo_portfolio(3)
    pf_p = convert.portfolio_from_fields(dataclasses.asdict(pf_r))
    want = {impl: ref.vectorsim.sweep_scenarios(
        tasks(0), portfolio=pf_r, engine_impl=impl, concurrency=2,
        coldstart=_models(ref, 0)["CS"]) for impl in IMPLS}
    kw = dict(portfolio=pf_p, concurrency=2, coldstart=_models(ref, 1)["CS"])
    got = pc.sweep_scenarios(tasks(1), device="cpu", **kw)
    des = pc.sweep_scenarios(tasks(1), engine="des", **kw)
    for i in range(3):
        for impl in IMPLS:
            assert_bitwise(got[i], want[impl][i], where=f"task {i} {impl}")
        assert_exact_vs_des(got[i], des[i], where=f"task {i}")
    assert sum(g.queue_wait.sum() for g in got) > 0
    used = np.concatenate([g.provider.ravel() for g in got])
    assert len(set(used[used >= 0].tolist())) >= 2


def test_schedule_sweep_forwards_load_options(ref):
    dag = pc.matrix_app(replicas=2)
    pred, arrivals = congested(dag)
    kw = dict(arrivals=arrivals, concurrency=1,
              coldstart=_models(ref, 1)["CS"],
              pool_trace=_models(ref, 1)["POOL"])
    got = pc.SkedulixScheduler(dag).schedule_sweep(
        (4.0, 8.0), pred=pred, orders=("spt", "hcf"), device="cpu", **kw)
    want = pc.simulate_scenarios(dag, pred, c_max_grid=(4.0, 8.0),
                                 orders=("spt", "hcf"), device="cpu", **kw)
    assert_bitwise(got, want)
    assert got.queue_wait.sum() > 0 and got.cold.any()


class TestDegenerateBitExact:
    """Uncapped / zero-penalty / constant-pool configs are the plain
    schedule, bit for bit (the reference's ``TestDegenerateBitExact``)."""

    def _base(self, **kw):
        dag = pc.matrix_app(replicas=2)
        pred, arrivals = congested(dag)
        call = dict(c_max_grid=(4.0, 8.0), orders=("spt", "hcf"),
                    arrivals=arrivals, device="cpu")
        return (pc.simulate_scenarios(dag, pred, **call),
                pc.simulate_scenarios(dag, pred, **call, **kw))

    def _assert_bitwise(self, base, other, skip=()):
        assert_bitwise(other, base,
                       fields=tuple(f for f in FIELDS if f not in skip))

    def test_uncapped_concurrency(self):
        base, un = self._base(concurrency=np.inf)
        self._assert_bitwise(base, un)

    def test_zero_penalty_coldstart(self):
        # cold flags may set (the keep-alive bookkeeping runs); every
        # other field is untouched because the penalty is 0.0
        base, zp = self._base(coldstart=pc.ColdStartModel(
            warm_up_s=0.0, keep_alive_s=0.25, scale_to_zero=True))
        self._assert_bitwise(base, zp, skip=("cold",))
        assert zp.cold.any()

    def test_constant_pool_trace(self):
        dag = pc.matrix_app(replicas=2)
        base, const = self._base(pool_trace=pc.PoolTrace(
            counts=(tuple(dag.replicas),)))
        self._assert_bitwise(base, const)


class TestValidation:
    """The reference's exclusions, with its errors, on both engines."""

    def _args(self):
        dag = pc.matrix_app(replicas=2)
        pred, arrivals = congested(dag)
        return dag, pred, dict(c_max_grid=(4.0,), orders=("spt",),
                               arrivals=arrivals)

    @pytest.mark.parametrize("engine", ["vector", "des"])
    def test_faults_exclusion(self, engine):
        dag, pred, call = self._args()
        with pytest.raises(ValueError, match="faults"):
            pc.simulate_scenarios(dag, pred, engine=engine, device="cpu",
                                  faults=0.2, concurrency=1, **call)

    @pytest.mark.parametrize("engine", ["vector", "des"])
    def test_chunking_exclusion(self, engine):
        dag, pred, call = self._args()
        with pytest.raises(ValueError, match="chunk_jobs"):
            pc.simulate_scenarios(dag, pred, engine=engine, device="cpu",
                                  chunk_jobs=4,
                                  coldstart=pc.ColdStartModel(0.5), **call)
        with pytest.raises(ValueError, match="chunk_jobs"):
            pc.sweep_scenarios([dict(dag=dag, pred=pred)], engine=engine,
                               device="cpu", chunk_jobs=4, concurrency=1)

    @pytest.mark.parametrize("engine", ["vector", "des"])
    def test_replicas_axis_pool_exclusion(self, engine):
        dag, pred, call = self._args()
        pool = pc.PoolTrace(counts=(1, 2), breakpoints=(2.0,))
        with pytest.raises(ValueError, match="replicas axis"):
            pc.simulate_scenarios(dag, pred, engine=engine, device="cpu",
                                  replicas=[[1, 1], [2, 2]],
                                  pool_trace=pool, **call)
        with pytest.raises(ValueError, match="replicas axis"):
            pc.sweep_scenarios([dict(dag=dag, pred=pred,
                                     replicas=[[1, 1], [2, 2]])],
                               engine=engine, device="cpu", pool_trace=pool)

    def test_bad_concurrency_rejected(self):
        dag, pred, call = self._args()
        with pytest.raises(ValueError, match="concurrency"):
            pc.simulate_scenarios(dag, pred, device="cpu", concurrency=0,
                                  **call)
        with pytest.raises(ValueError, match="concurrency"):
            pc.simulate(dag, pred, c_max=4.0,
                        arrivals=call["arrivals"], concurrency=0)

    def test_noop_when_inactive(self):
        pc.coldstart.validate_load_kwargs(False, None, None, faulty=True,
                                          chunk_jobs=8)


class TestLoadIsReal:
    """Caps really queue and cold starts really cost, on the port's engine
    (the reference's ``test_queueing_is_real_and_billed`` and
    ``test_cold_penalty_is_real``)."""

    def test_queueing_is_real_and_billed(self):
        dag = pc.matrix_app(replicas=1)
        pred, arrivals = congested(dag, J=10, seed=1)
        kw = dict(c_max=2.0, order="spt", arrivals=arrivals,
                  engine="vector", device="cpu")
        base = pc.simulate(dag, pred, **kw)
        capped = pc.simulate(dag, pred, concurrency=1, **kw)
        assert np.asarray(capped.queue_wait).sum() > 0.0
        assert capped.cost_usd > base.cost_usd
        assert capped.makespan >= base.makespan

    def test_cold_penalty_is_real(self):
        dag = pc.matrix_app(replicas=2)
        pred, arrivals = congested(dag, seed=2)
        kw = dict(c_max=4.0, order="spt", arrivals=arrivals,
                  engine="vector", device="cpu")
        warm = pc.simulate(dag, pred, **kw)
        cold = pc.simulate(dag, pred, coldstart=pc.ColdStartModel(
            warm_up_s=0.5, keep_alive_s=1.0, scale_to_zero=True), **kw)
        assert np.asarray(cold.cold).sum() > 0
        first = np.asarray(cold.cold) & ~np.asarray(cold.public_mask)
        assert (np.asarray(cold.start)[first]
                >= np.asarray(warm.start)[first]).all()


@pytest.mark.gpu
def test_cuda_engine_matches_cpu_under_load():
    """The engine on the card (the fifo_dispatch kernel, the cold and
    pooled event loop) equals the engine on the CPU field for field, under
    caps with cold starts and under a pool trace, on a multi-app sweep."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import ops

    tasks = []
    for i, name in enumerate(("image", "matrix", "video")):
        dag = pc.APPS[name]
        pred, arrivals = congested(dag, J=64, seed=20 + i, horizon=8.0)
        tasks.append(dict(dag=dag, pred=pred, arrivals=arrivals,
                          c_max_grid=(6.0, 12.0), orders=("spt", "hcf")))
    cs = pc.ColdStartModel(warm_up_s=0.5, keep_alive_s=1.0,
                           scale_to_zero=True)
    pf = pc.demo_portfolio(3)
    for kw in (dict(concurrency=2, coldstart=cs),
               dict(coldstart=cs, concurrency=[1, None, 2],
                    pool_trace=pc.PoolTrace(counts=(1, 2),
                                            breakpoints=(3.0,)))):
        ops.reset_launch_counts()
        got = pc.sweep_scenarios(tasks, device="cuda", portfolio=pf, **kw)
        assert ops.fifo_dispatch.launches > 0
        want = pc.sweep_scenarios(tasks, device="cpu", portfolio=pf, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bitwise(g, w, where=f"task {i}")
