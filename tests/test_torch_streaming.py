"""Job paging (``chunk_jobs``) and ``azure:`` workloads in the port.

The paged path must be indistinguishable from the monolithic one: the
engine pages a release stream's jobs through engine calls (slot clocks
carried across pages, every page checked against the next page's
releases and grown when its work overlaps them), the DES admits arrival
epochs in windows, and neither changes a field of the result. Held
against the reference (its ``pallas`` and ``loop`` twins, bit for bit,
its page and retry counts too), the DES, and the port's own monolithic
run, as the reference's ``tests/test_streaming.py`` holds its engine:

* paged == monolithic at several page sizes, several pages really run;
* the DES's windowed admission == its monolithic run == the engine;
* pages under the whole scenario stack (portfolio, faults, init offload,
  whose plan resolves over the whole job axis before any page);
* the ``azure:`` family: parsing, sampling (arrays bit for bit the
  reference's), determinism, end to end;
* the ``egress_lookahead`` term on a paged stream and the regime it
  flips;
* a hypothesis property: cost and makespan do not depend on the page
  size.
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
from repro_torch.core import convert, vectorsim as pvs
from tests.test_torch_harness import (FIELDS, assert_bitwise, assert_parity,
                                      reference, workload)

J = 64
IMPLS = ("pallas", "loop")


@pytest.fixture(scope="module")
def ref():
    return reference()


def _dag_pair(ref, name):
    d = ref.core.APPS[name]
    return d, convert.dag_from_fields(dataclasses.asdict(d))


def burst_workload(dag, J, seed, burst=8, gap=1000.0):
    """Bursts of ``burst`` jobs ``gap`` seconds apart: every burst drains
    before the next releases, so pages of at least ``burst`` jobs are
    safe and several pages run."""
    pred, act = workload(dag, J, seed)
    rng = np.random.default_rng(seed + 77)
    release = (np.arange(J) // burst) * gap + rng.uniform(0.0, 5.0, J)
    return pred, act, release


def _paged_pair(ref, name, pred, act, release, chunk, impls=IMPLS, **kw):
    """The reference's twins and the port at one page size, with each
    side's page counters."""
    dag_r, dag_p = _dag_pair(ref, name)
    kw = dict(kw, arrivals=release, chunk_jobs=chunk)
    out, stats = {}, {}
    for impl in impls:
        ref.vectorsim._LAST_PAGE_STATS.clear()
        out[impl] = ref.vectorsim.simulate_scenarios(
            dag_r, pred, act, engine_impl=impl, **kw)
        stats[impl] = dict(ref.vectorsim._LAST_PAGE_STATS)
    pvs._LAST_PAGE_STATS.clear()
    out["port"] = pc.simulate_scenarios(dag_p, pred, act, device="cpu", **kw)
    stats["port"] = dict(pvs._LAST_PAGE_STATS)
    return out, stats


@pytest.mark.parametrize("chunk", [J, J // 2, 17])
def test_chunked_bit_exact_vs_monolithic(ref, chunk):
    dag = pc.APPS["image"]
    pred, act, release = burst_workload(dag, J, seed=3)
    kw = dict(c_max_grid=(8.0, 40.0), orders=("spt", "hcf"))
    out, stats = _paged_pair(ref, "image", pred, act, release, chunk, **kw)
    mono = pc.simulate_scenarios(dag, pred, act, arrivals=release,
                                 device="cpu", **kw)
    assert_bitwise(out["port"], mono)
    for impl in IMPLS:
        assert_bitwise(out["port"], out[impl], where=impl)
        assert stats["port"] == stats[impl], impl
    if chunk < J:
        assert stats["port"]["pages"] > 1


@pytest.mark.parametrize("chunk", [J, J // 2, 17])
def test_chunked_matches_des(chunk):
    dag = pc.APPS["image"]
    pred, act, release = burst_workload(dag, J, seed=5)
    kw = dict(c_max=20.0, order="spt", arrivals=release, chunk_jobs=chunk)
    d = pc.simulate(dag, pred, act, engine="des", **kw)
    v = pc.simulate(dag, pred, act, engine="vector", device="cpu", **kw)
    assert_parity(v, d)
    # the DES's windowed admission replays the monolithic event order
    d_mono = pc.simulate(dag, pred, act, c_max=20.0, order="spt",
                         arrivals=release)
    assert_bitwise(d, d_mono)


def test_unsafe_pages_fall_back_by_growing(ref):
    """A dense stream (every page's work overlaps the next release) is
    still exact: the safety check grows the page, with the reference's
    retry count."""
    dag = pc.APPS["image"]
    pred, act = workload(dag, 32, 9)
    release = np.linspace(0.0, 1.0, 32)
    out, stats = _paged_pair(ref, "image", pred, act, release, 4,
                             c_max_grid=(15.0,))
    mono = pc.simulate_scenarios(dag, pred, act, arrivals=release,
                                 c_max_grid=(15.0,), device="cpu")
    assert_bitwise(out["port"], mono)
    for impl in IMPLS:
        assert_bitwise(out["port"], out[impl], where=impl)
        assert stats["port"] == stats[impl], impl
    assert stats["port"]["retries"] > 0


def test_chunked_full_scenario_stack(ref):
    """Pages carry every axis: a 3-provider portfolio, a fault axis with
    retries, and the initialization offload resolved over the whole job
    axis before paging."""
    dag = pc.APPS["image"]
    pred, act, release = burst_workload(dag, 48, seed=11)
    pf_r = ref.cost.demo_portfolio(3)
    pf_p = convert.portfolio_from_fields(dataclasses.asdict(pf_r))
    kw = dict(c_max_grid=(10.0,), orders=("spt",), faults=[0.25],
              init_phase=True)
    out, stats = _paged_pair(ref, "image", pred, act, release, 16,
                             impls=("pallas",), portfolio=pf_r, **kw)
    pvs._LAST_PAGE_STATS.clear()
    got = pc.simulate_scenarios(dag, pred, act, arrivals=release,
                                chunk_jobs=16, portfolio=pf_p,
                                device="cpu", **kw)
    assert dict(pvs._LAST_PAGE_STATS) == stats["pallas"]
    assert stats["pallas"]["pages"] > 1
    mono = pc.simulate_scenarios(dag, pred, act, arrivals=release,
                                 portfolio=pf_p, device="cpu", **kw)
    fields = FIELDS + ("fault_idx",)
    assert_bitwise(got, mono, fields=fields)
    assert_bitwise(got, out["pallas"], fields=fields)
    assert got.failed.sum() > 0 and got.n_init_offloaded_jobs.max() > 0
    # and the DES agrees at the same page size
    kw_s = dict(c_max=10.0, order="spt", faults=0.25, arrivals=release,
                chunk_jobs=16, portfolio=pf_p)
    d = pc.simulate(dag, pred, act, engine="des", **kw_s)
    v = pc.simulate(dag, pred, act, engine="vector", device="cpu", **kw_s)
    assert_parity(v, d)
    assert_bitwise(v, d, fields=("attempts", "failed", "abandoned"))


def test_chunked_offload_mask_and_window(ref):
    """A supplied offload plan and an init window page too (the plan
    path, ``init_mode=2``, takes each page's slice)."""
    dag_r, dag_p = _dag_pair(ref, "video")
    pred, act, release = burst_workload(dag_r, 40, seed=13, burst=5,
                                        gap=600.0)
    mask = np.arange(40) % 3 == 1
    for kw in (dict(offload_mask=mask), dict(init_window=1500.0)):
        kw.update(c_max_grid=(12.0, 30.0), orders=("spt", "hcf"))
        out, stats = _paged_pair(ref, "video", pred, act, release, 10,
                                 impls=("pallas",), **kw)
        mono = pc.simulate_scenarios(dag_p, pred, act, arrivals=release,
                                     device="cpu", **kw)
        assert_bitwise(out["port"], mono)
        assert_bitwise(out["port"], out["pallas"])
        assert stats["port"] == stats["pallas"]
        assert stats["port"]["pages"] > 1


def test_chunk_jobs_validation():
    dag = pc.APPS["image"]
    pred, act, release = burst_workload(dag, 16, seed=1)
    with pytest.raises(ValueError, match="chunk_jobs"):
        pc.simulate(dag, pred, act, arrivals=release, chunk_jobs=0)
    with pytest.raises(ValueError, match="chunk_jobs"):
        pc.simulate_scenarios(dag, pred, act, arrivals=release,
                              chunk_jobs=0, device="cpu")


# -- azure workload family ---------------------------------------------------

def test_parse_workload_specs():
    wl = pc.parse_workload("azure:day=tue,scale=1e5,seed=3,noise=0.1")
    assert wl == pc.AzureWorkload(day="tue", scale=100000, seed=3,
                                  noise=0.1)
    assert pc.parse_workload("azure") == pc.AzureWorkload()
    assert pc.parse_workload(wl) is wl
    with pytest.raises(ValueError, match="workload family"):
        pc.parse_workload("gcp:scale=10")
    with pytest.raises(ValueError, match="unknown key"):
        pc.parse_workload("azure:jobs=10")
    with pytest.raises(ValueError, match="malformed"):
        pc.parse_workload("azure:day")
    with pytest.raises(ValueError, match="unknown day"):
        pc.parse_workload("azure:day=xyz")
    with pytest.raises(ValueError, match="scale"):
        pc.parse_workload("azure:scale=0")
    with pytest.raises(TypeError):
        pc.parse_workload(42)


@pytest.mark.parametrize("spec", [
    "azure:day=wed,scale=500,horizon=3600",
    "azure:day=sat,scale=300,seed=7",
    "azure:scale=50,noise=0",
    "azure:day=tue,scale=100000"])
def test_resolve_workload_equals_reference(ref, spec):
    """The port samples the reference's arrays bit for bit from the same
    committed trace file."""
    from repro.core import workloads as rw

    dag_r, dag_p = _dag_pair(ref, "image")
    want = rw.resolve_workload(spec, dag_r, 2.5)
    got = pc.resolve_workload(spec, dag_p, 2.5)
    for g, w in zip(got[:2], want[:2]):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(got[2], want[2])
    wl = pc.parse_workload(spec)
    np.testing.assert_array_equal(
        pc.day_counts(wl), rw.day_counts(rw.parse_workload(spec)))


def test_workload_sampling_properties():
    dag = pc.APPS["image"]
    wl = "azure:day=wed,scale=500,horizon=3600"
    p1, a1, r1 = pc.resolve_workload(wl, dag)
    p2, a2, r2 = pc.resolve_workload(wl, dag)
    np.testing.assert_array_equal(r1, r2)          # deterministic
    np.testing.assert_array_equal(p1["P_private"], p2["P_private"])
    assert r1.shape == (500,) and p1["P_private"].shape == (500, 3)
    assert (r1 >= 0).all() and (r1 <= 3600).all()
    assert len(np.unique(r1)) == 500               # continuous: tie-free
    assert (a1["P_private"] != p1["P_private"]).any()  # model error
    _, act0, _ = pc.resolve_workload("azure:scale=50,noise=0", dag)
    p0, _, _ = pc.resolve_workload("azure:scale=50,noise=0", dag)
    np.testing.assert_array_equal(act0["P_private"], p0["P_private"])
    _, _, r3 = pc.resolve_workload("azure:day=thu,scale=500,horizon=3600",
                                   dag)
    assert not np.array_equal(r1, r3)
    # the weekend dip scales traffic down
    assert pc.day_counts(pc.AzureWorkload(day="sat")).sum() \
        < pc.day_counts(pc.AzureWorkload(day="mon")).sum()


def test_workload_excludes_pred():
    dag = pc.APPS["image"]
    pred, act = workload(dag, 8, 0)
    with pytest.raises(ValueError, match="not both"):
        pc.simulate_scenarios(dag, pred, act, workload="azure:scale=8",
                              device="cpu")
    with pytest.raises(ValueError, match="not both"):
        pc.sweep_scenarios([dict(dag=dag, pred=pred,
                                 workload="azure:scale=8")], device="cpu")
    with pytest.raises(ValueError, match="not both"):
        pc.SkedulixScheduler(dag).schedule(10.0, pred=pred,
                                           workload="azure:scale=8")


def test_azure_end_to_end_chunked(ref):
    dag_r, dag_p = _dag_pair(ref, "image")
    kw = dict(c_max_grid=(30.0,), orders=("spt",),
              workload="azure:day=tue,scale=300,horizon=600,noise=0")
    mono = pc.simulate_scenarios(dag_p, None, device="cpu", **kw)
    pvs._LAST_PAGE_STATS.clear()
    paged = pc.simulate_scenarios(dag_p, None, device="cpu", chunk_jobs=64,
                                  **kw)
    stats = dict(pvs._LAST_PAGE_STATS)
    assert_bitwise(paged, mono)
    for impl in IMPLS:
        ref.vectorsim._LAST_PAGE_STATS.clear()
        want = ref.vectorsim.simulate_scenarios(
            dag_r, None, engine_impl=impl, chunk_jobs=64, **kw)
        assert_bitwise(paged, want, where=impl)
        assert stats == dict(ref.vectorsim._LAST_PAGE_STATS)
    assert stats["pages"] > 1
    des = pc.simulate_scenarios(dag_p, None, engine="des", chunk_jobs=64,
                                **kw)
    assert_parity(paged, des)


def test_schedule_and_sweep_take_workloads(ref):
    """``schedule(workload=)``, ``schedule_sweep(workload=, chunk_jobs=)``
    and a ``workload`` task key, against the reference's scheduler."""
    dag_r, dag_p = _dag_pair(ref, "video")
    spec = "azure:day=fri,scale=120,horizon=900"
    s_r = ref.scheduler.SkedulixScheduler(dag_r)
    s_p = pc.SkedulixScheduler(dag_p)
    want = s_r.schedule(20.0, workload=spec)
    got = s_p.schedule(20.0, workload=spec)
    assert_bitwise(got.result, want.result)
    vec = s_p.schedule(20.0, workload=spec, engine="vector", device="cpu",
                       chunk_jobs=32)
    assert_parity(vec.result, got.result)
    sw_r = s_r.schedule_sweep((20.0, 40.0), workload=spec, chunk_jobs=32,
                              orders=("spt", "hcf"), engine_impl="pallas")
    sw_p = s_p.schedule_sweep((20.0, 40.0), workload=spec, chunk_jobs=32,
                              orders=("spt", "hcf"), device="cpu")
    assert_bitwise(sw_p, sw_r)
    task = pc.sweep_scenarios([dict(dag=dag_p, workload=spec,
                                    c_max_grid=(20.0, 40.0),
                                    orders=("spt", "hcf"))],
                              chunk_jobs=32, device="cpu")[0]
    assert_bitwise(task, sw_p)


# -- egress lookahead ---------------------------------------------------------

def lookahead_setup(side_pkg):
    """Two chains: a->b (public sink, fat edges) and d->e (pinned sink).

    "leaky" has the cheaper compute and a punitive egress rate, "safe" a
    slightly dearer compute and free egress. Myopic placement puts a on
    leaky and pays leaky's egress at b; lookahead charges a's own
    downstream edge and routes a to safe, while d (pinned successor: no
    lookahead term) still takes leaky's discount. ``side_pkg`` is the
    package whose objects are built (the port's ``repro_torch.core`` or
    the reference's)."""
    dag = side_pkg.AppDAG(
        "lookahead",
        (side_pkg.Stage("a", 1), side_pkg.Stage("b", 1),
         side_pkg.Stage("d", 1),
         side_pkg.Stage("e", 1, must_private=True)),
        ((0, 1), (2, 3)))
    rng = np.random.default_rng(21)
    Jn, M = 12, 4
    P_priv = rng.uniform(1.0, 2.0, (Jn, M))
    pred = dict(P_private=P_priv,
                P_public=P_priv * rng.uniform(0.9, 1.1, (Jn, M)),
                upload=np.full((Jn, M), 0.01),
                download=np.full((Jn, M), 0.5))
    safe = side_pkg.Provider("safe", usd_per_gb_ms=3e-8,
                             egress_usd_per_gb=0.0)
    leaky = side_pkg.Provider("leaky", usd_per_gb_ms=2e-8,
                              egress_usd_per_gb=50.0)
    return (dag, pred, side_pkg.ProviderPortfolio((safe, leaky)),
            side_pkg.ProviderPortfolio((safe,)))


@pytest.mark.parametrize("engine", ["des", "vector"])
def test_lookahead_flips_portfolio_vs_solo(engine):
    dag, pred, duo, solo = lookahead_setup(pc)

    # c_max ~ 0: the init phase offloads every job, every unpinned stage
    def run(pf, look):
        return pc.simulate(dag, pred, c_max=1e-6, engine=engine,
                           portfolio=pf, egress_lookahead=look,
                           device="cpu")

    myopic, aware = run(duo, False), run(duo, True)
    base = run(solo, False)
    assert myopic.cost_usd > base.cost_usd      # the losing regime
    assert aware.cost_usd < base.cost_usd       # lookahead flips it
    # a solo portfolio's argmin does not see the lookahead term
    assert run(solo, True).cost_usd == base.cost_usd


def test_lookahead_engines_agree(ref):
    """Port == reference twins == DES, on the batch and on a paged
    stream."""
    dag, pred, duo, _ = lookahead_setup(pc)
    dag_r, _, duo_r, _ = lookahead_setup(ref.core)
    rel = (np.arange(12) // 4) * 500.0
    for extra in (dict(), dict(arrivals=rel, chunk_jobs=4)):
        for look in (False, True):
            kw = dict(c_max_grid=(1e-6,), egress_lookahead=look, **extra)
            v = pc.simulate_scenarios(dag, pred, portfolio=duo,
                                      device="cpu", **kw)
            d = pc.simulate_scenarios(dag, pred, portfolio=duo,
                                      engine="des", **kw)
            assert_parity(v, d, where=f"{extra.keys()} {look}")
            # the loop twin on the batch (its paged run recompiles per
            # page size)
            for impl in IMPLS[:1] if extra else IMPLS:
                want = ref.vectorsim.simulate_scenarios(
                    dag_r, pred, portfolio=duo_r, engine_impl=impl, **kw)
                assert_bitwise(v, want, where=f"{impl} {look}")


# -- hypothesis: page-size invariance -----------------------------------------

def test_chunk_size_invariance_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    dag = pc.APPS["image"]
    Jp = 24
    pred, act, release = burst_workload(dag, Jp, seed=2, burst=4, gap=400.0)
    kw = dict(c_max_grid=(12.0,), arrivals=release, device="cpu")
    mono = pc.simulate_scenarios(dag, pred, act, **kw)

    @settings(max_examples=8, deadline=None)
    @given(chunk=st.sampled_from([1, 3, 5, 8, 13, 24]))
    def prop(chunk):
        paged = pc.simulate_scenarios(dag, pred, act, chunk_jobs=chunk,
                                      **kw)
        assert float(paged.cost_usd.sum()) == float(mono.cost_usd.sum())
        assert float(paged.makespan.max()) == float(mono.makespan.max())
        assert_bitwise(paged, mono)

    prop()


@pytest.mark.gpu
def test_cuda_paged_day_matches_cpu():
    """A paged ``azure:`` day on the card (``acd_evict`` at every adaptive
    step, clocks carried across pages) equals the monolithic card run and
    the CPU field for field."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import ops

    dag = pc.APPS["image"]
    kw = dict(workload="azure:day=tue,scale=1500", c_max_grid=(30.0, 60.0),
              orders=("spt", "hcf"))
    ops.reset_launch_counts()
    pvs._LAST_PAGE_STATS.clear()
    paged = pc.simulate_scenarios(dag, None, chunk_jobs=256, device="cuda",
                                  **kw)
    assert ops.acd_evict.launches > 0 and pvs._LAST_PAGE_STATS["pages"] > 1
    mono = pc.simulate_scenarios(dag, None, device="cuda", **kw)
    cpu = pc.simulate_scenarios(dag, None, chunk_jobs=256, device="cpu",
                                **kw)
    assert_bitwise(paged, mono)
    assert_bitwise(paged, cpu)
