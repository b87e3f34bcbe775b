"""The port's vector engine twins, held against the reference's.

The port has three interchangeable inner loops (``engine_impl=``): the
one-event ``"loop"`` body, the batched ``"scan"`` body (the ACD cascade's
certain set in array operations) and the batched ``"kernel"`` body (the
``acd_evict`` and ``fifo_dispatch`` kernels; the reference's
``"pallas"``). The port of the reference's ``tests/test_engine_impls.py``,
on its seven-axis grid and six more axes (a pool trace, the lookahead
term under caps, and the per-task flags):

* the three impls equal one another bit for bit;
* each equals its reference twin (``loop`` and ``scan`` by name,
  ``kernel`` to ``pallas``) bit for bit, except a time the reference's
  XLA CPU build fuses into a multiply-add: there the DES decides
  (``assert_bitwise_or_des``);
* ``loop`` and ``scan`` meet the DES under the parity contract;
* a paged run under each twin equals its monolithic run, and a paged
  ``azure:`` day its reference twin; a mixed-flag sweep under each twin
  equals the kernel's;
* the resolver, the twins' trip counts and kernel calls, the sequential
  float prefix the twins rely on, two hypothesis properties, the sweep's
  prep cache, and (``gpu``) each twin on the card against the CPU.
"""
import functools

import numpy as np
import pytest
import torch

import repro_torch.core as pc
from repro_torch.core import vectorsim
from repro_torch.kernels import ops, ref as kref
from tests.test_torch_harness import (FIELDS, assert_bitwise,
                                      assert_bitwise_or_des, assert_parity,
                                      reference)

J = 13
IMPLS = ("loop", "scan", "kernel")
#: the reference's name of each port impl
REF_IMPL = {"loop": "loop", "scan": "scan", "kernel": "pallas"}
#: fields a discrete DES comparison holds exactly beside the parity contract
DES_EXACT = ("attempts", "failed", "abandoned", "queue_wait", "cold")


@pytest.fixture(scope="module")
def ref():
    return reference()


def _workload(seed, J=J, S=2):
    """The reference suite's workload: the video DAG, a 2-draw batch."""
    rng = np.random.default_rng(seed)
    M = pc.APPS["video"].num_stages
    pred = {"P_private": rng.uniform(0.5, 3.0, (S, J, M)),
            "P_public": rng.uniform(0.3, 2.5, (S, J, M)),
            "T_up": rng.uniform(0.01, 0.3, (S, J, M)),
            "T_down": rng.uniform(0.01, 0.3, (S, J, M))}
    act = {k: v * rng.uniform(0.9, 1.1, v.shape) for k, v in pred.items()}
    return pred, act


def _axes(core):
    """The reference suite's seven axes and six of the engine's other
    options, built from one package's core (the port's or the
    reference's): a pool trace under caps and cold starts (the pooled
    slot windows), the lookahead term in the capped chain's keys, and the
    per-task flags (no ACD sweep, no initialization offload, a supplied
    offload plan, a windowed initialization offload)."""
    return {
        "base": {},
        "arrivals": dict(arrivals="poisson:1.5"),
        "traces": dict(price_traces=[None, core.spot_portfolio(seed=3)],
                       arrivals="poisson:2.0"),
        "faults": dict(faults=[None, 0.3],
                       retry=core.RetryPolicy(max_attempts=3),
                       arrivals="poisson:1.0"),
        "caps": dict(concurrency=4, arrivals="poisson:2.0"),
        "cold": dict(concurrency=3, coldstart=core.ColdStartModel(0.5, 2.0),
                     arrivals="poisson:2.0"),
        "lookahead": dict(egress_lookahead=True, arrivals="poisson:1.5"),
        "pool": dict(concurrency=3,
                     pool_trace=core.PoolTrace(counts=(1, 2),
                                               breakpoints=(2.0,)),
                     coldstart=core.ColdStartModel(0.5, 2.0),
                     arrivals="poisson:2.0"),
        "lookahead_caps": dict(egress_lookahead=True, concurrency=2,
                               coldstart=core.ColdStartModel(0.5, 2.0),
                               arrivals="poisson:2.0"),
        "no_adaptive": dict(adaptive=False, concurrency=2,
                            arrivals="poisson:1.5"),
        "no_init_phase": dict(init_phase=False, arrivals="poisson:1.5"),
        "offload_mask": dict(offload_mask=np.arange(J) % 4 == 1,
                             arrivals="poisson:1.5"),
        "init_window": dict(init_window=1.5, arrivals="poisson:1.5"),
    }


AXES = sorted(_axes(pc))
#: the axes whose queues run the capped dispatch chain
CAPPED = ("caps", "cold", "pool", "lookahead_caps", "no_adaptive")
#: the reference suite's deadlines, which offload nothing at J = 13, and
#: tight ones, under which the ACD cascade evicts on every axis, caps
#: queue and cold starts fire
GRIDS = {"reference": (25.0, 60.0), "tight": (5.0, 10.0)}


def _grid(grid):
    return dict(c_max_grid=GRIDS[grid], orders=("spt", "hcf"))


@functools.lru_cache(maxsize=None)
def _port(axis, impl, grid="reference"):
    """The port's result and its per-stage body steps on one axis."""
    pred, act = _workload(7)
    res = pc.simulate_scenarios(pc.APPS["video"], pred, act, **_grid(grid),
                                portfolio=pc.demo_portfolio(),
                                engine_impl=impl, device="cpu",
                                **_axes(pc)[axis])
    return res, vectorsim._LAST_RUN_STATS["trips"]


@functools.lru_cache(maxsize=None)
def _des(axis, grid):
    pred, act = _workload(7)
    return pc.simulate_scenarios(pc.APPS["video"], pred, act, **_grid(grid),
                                 portfolio=pc.demo_portfolio(), engine="des",
                                 **_axes(pc)[axis])


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("axis", AXES)
def test_three_impls_one_result(axis, grid):
    kernel = _port(axis, "kernel", grid)[0]
    for impl in ("loop", "scan"):
        assert_bitwise(_port(axis, impl, grid)[0], kernel,
                       fields=FIELDS + ("fault_idx", "trace_idx"),
                       where=f"{axis} {grid}: {impl} == kernel")


@pytest.mark.parametrize("axis", AXES)
def test_the_tight_grid_exercises_the_twins(axis):
    """The comparisons are not vacuous: on the tight grid every axis
    with the ACD sweep on evicts past the initialization offload; caps
    queue, cold starts fire, faults fail attempts and each flag takes
    effect."""
    res = _port(axis, "loop", "tight")[0]
    M = res.per_stage_offloads.shape[1]
    evicted = res.n_offloaded_stages > M * res.n_init_offloaded_jobs
    if axis == "no_adaptive":
        assert not evicted.any() and res.n_init_offloaded_jobs.any()
    else:
        assert evicted.any()
    if axis in CAPPED:
        assert res.queue_wait.max() > 0
    if axis in ("cold", "pool", "lookahead_caps"):
        assert res.cold.any()
    if axis == "faults":
        assert res.failed.any()
    if axis == "no_init_phase":
        assert not res.n_init_offloaded_jobs.any()
    if axis == "offload_mask":
        assert (res.n_init_offloaded_jobs == (np.arange(J) % 4 == 1).sum()
                ).all()
    if axis == "init_window":
        base = _port("arrivals", "loop", "tight")[0]
        assert (res.n_init_offloaded_jobs < base.n_init_offloaded_jobs).any()


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("axis", AXES)
def test_impl_matches_its_reference_twin(ref, axis, impl, grid):
    pred, act = _workload(7)
    want = ref.vectorsim.simulate_scenarios(
        ref.core.APPS["video"], pred, act, **_grid(grid),
        portfolio=ref.core.demo_portfolio(), engine_impl=REF_IMPL[impl],
        **_axes(ref.core)[axis])
    assert_bitwise_or_des(_port(axis, impl, grid)[0], want,
                          _des(axis, grid),
                          where=f"{axis} {grid}: {impl} vs {REF_IMPL[impl]}")


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("impl", ("loop", "scan"))
@pytest.mark.parametrize("axis", ("base", "cold", "faults", "pool"))
def test_twin_meets_the_des(axis, impl, grid):
    got, des = _port(axis, impl, grid)[0], _des(axis, grid)
    assert_parity(got, des, where=f"{axis} {grid}: {impl}")
    assert_bitwise(got, des, fields=DES_EXACT, where=f"{axis} {grid}: {impl}")


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_run_equals_the_monolithic_run(impl):
    pred, act = _workload(3, J=40, S=1)
    kw = dict(c_max_grid=(5.0, 10.0), orders=("spt", "hcf"),
              arrivals="poisson:0.3", portfolio=pc.demo_portfolio(),
              engine_impl=impl, device="cpu")
    mono = pc.simulate_scenarios(pc.APPS["video"], pred, act, **kw)
    paged = pc.simulate_scenarios(pc.APPS["video"], pred, act,
                                  chunk_jobs=8, **kw)
    assert vectorsim._LAST_PAGE_STATS["pages"] > 1
    assert vectorsim._LAST_RUN_STATS["impl"] == impl
    assert_bitwise(paged, mono, where=f"paged {impl}")
    assert (mono.n_offloaded_stages > 4 * mono.n_init_offloaded_jobs).any()


#: an ``azure:`` trace day short enough for the reference's twins here
AZURE = "azure:day=mon,scale=40,horizon=300"


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_azure_day_matches_its_reference_twin(ref, impl):
    """A paged ``azure:`` day under each impl: equal to its monolithic
    run, to the other impls, and to its reference twin (the DES decides a
    fused time); several pages run and the ACD sweep evicts."""
    kw = dict(workload=AZURE, c_max_grid=(4.0, 15.0), orders=("spt",),
              chunk_jobs=8)
    paged = pc.simulate_scenarios(pc.APPS["video"], None, engine_impl=impl,
                                  device="cpu", **kw)
    pages = dict(vectorsim._LAST_PAGE_STATS)
    assert pages["pages"] > 1
    mono = pc.simulate_scenarios(pc.APPS["video"], None, engine_impl=impl,
                                 device="cpu", **dict(kw, chunk_jobs=None))
    assert_bitwise(paged, mono, where=f"azure paged {impl}")
    if impl != "kernel":
        kernel = pc.simulate_scenarios(pc.APPS["video"], None,
                                       engine_impl="kernel", device="cpu",
                                       **kw)
        assert_bitwise(paged, kernel, where=f"azure {impl} == kernel")
    M = paged.per_stage_offloads.shape[1]
    assert (paged.n_offloaded_stages > M * paged.n_init_offloaded_jobs).any()
    ref.vectorsim._LAST_PAGE_STATS.clear()
    want = ref.vectorsim.simulate_scenarios(
        ref.core.APPS["video"], None, engine_impl=REF_IMPL[impl], **kw)
    assert dict(ref.vectorsim._LAST_PAGE_STATS) == pages
    des = pc.simulate_scenarios(pc.APPS["video"], None, engine="des", **kw)
    assert_bitwise_or_des(paged, want, des, where=f"azure {impl}")


@pytest.mark.parametrize("impl", ("loop", "scan"))
def test_mixed_flag_sweep_equals_the_kernel(impl):
    """One sweep of tasks with mixed per-task flags under a twin equals
    the same sweep under ``kernel``, task by task."""
    tasks = []
    for i, flags in enumerate((
            {}, dict(adaptive=False), dict(init_phase=False),
            dict(offload_mask=np.arange(J) % 4 == 1),
            dict(init_window=1.5, arrivals="poisson:1.5"))):
        pred, act = _workload(20 + i)
        tasks.append(dict(dag=pc.APPS["video"], pred=pred, act=act,
                          c_max_grid=(5.0, 10.0), orders=("spt", "hcf"),
                          **flags))
    kw = dict(portfolio=pc.demo_portfolio(), concurrency=3, device="cpu")
    kernel = pc.sweep_scenarios(tasks, engine_impl="kernel", **kw)
    got = pc.sweep_scenarios(tasks, engine_impl=impl, **kw)
    for i, (a, b) in enumerate(zip(got, kernel)):
        assert_bitwise(a, b, where=f"task {i}: {impl} == kernel")


# -- the resolver -------------------------------------------------------------

@pytest.mark.parametrize("name", ("vectorized", "pallas"))
def test_resolver_rejects_unknown_names(name):
    with pytest.raises(ValueError, match="engine_impl") as err:
        pc.resolve_engine_impl(name)
    assert all(n in str(err.value) for n in IMPLS)


@pytest.mark.parametrize("impl", IMPLS)
def test_explicit_names_resolve_to_themselves(impl):
    assert pc.resolve_engine_impl(impl) == impl


@pytest.mark.parametrize("value", ("loop", "scan", "pallas"))
@pytest.mark.parametrize("var", ("REPRO_TORCH_ENGINE_IMPL",
                                 "REPRO_ENGINE_IMPL"))
def test_the_environment_picks_no_impl(monkeypatch, var, value):
    """The default is "kernel" whatever the environment holds: only an
    explicit argument takes a caller off the kernels."""
    monkeypatch.setenv(var, value)
    assert pc.ENGINE_IMPLS == ("loop", "scan", "kernel")
    assert pc.resolve_engine_impl(None) == "kernel"
    pred, act = _workload(7)
    pc.simulate_scenarios(pc.APPS["video"], pred, act, **_grid("tight"),
                          portfolio=pc.demo_portfolio(), device="cpu")
    assert vectorsim._LAST_RUN_STATS["impl"] == "kernel"


# -- trips, kernel calls, the sequential prefix -------------------------------

@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("axis", AXES)
def test_loop_takes_at_least_the_scan_trips(axis, grid):
    """Over a grid's stages: a stage alone may take the scan twin more
    steps (a deferred dispatch batch, a rewound speculation)."""
    loop, scan = _port(axis, "loop", grid)[1], _port(axis, "scan", grid)[1]
    assert len(loop) == len(scan) == 1
    assert sum(loop[0]) >= sum(scan[0]), (loop, scan)


@pytest.mark.parametrize("impl", IMPLS)
def test_twins_call_no_kernel(monkeypatch, impl):
    """Under the twins neither kernel wrapper nor its plain version is
    called (so on the card neither kernel launches); under ``kernel`` both
    wrappers are, as before."""
    calls = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for name in ("acd_evict", "fifo_dispatch"):
        monkeypatch.setattr(ops, name, spy(name, getattr(ops, name)))
        plain = f"{name}_plain"
        monkeypatch.setattr(kref, plain, spy(plain, getattr(kref, plain)))
    ops.reset_launch_counts()
    pred, act = _workload(7)
    pc.simulate_scenarios(pc.APPS["video"], pred, act, **_grid("tight"),
                          portfolio=pc.demo_portfolio(), engine_impl=impl,
                          device="cpu", **_axes(pc)["cold"])
    assert all(n == 0 for n in ops.launch_counts().values())
    if impl == "kernel":
        assert calls.get("acd_evict", 0) > 0
        assert calls.get("fifo_dispatch", 0) > 0
    else:
        assert calls == {}


def test_cpu_cumsum_is_sequential():
    """The twins' float prefixes rest on ``torch.cumsum`` of a CPU float64
    row summing left to right: it equals an explicit sequential loop."""
    rng = np.random.default_rng(0)
    x = rng.lognormal(0.0, 2.0, (30, 4096)) * rng.choice([1e-6, 1.0, 1e6],
                                                         (30, 4096))
    x[:, ::7] = 0.0
    xt = torch.from_numpy(x)
    acc = torch.zeros(30, dtype=torch.float64)
    want = torch.empty_like(xt)
    for j in range(x.shape[1]):
        acc = acc + xt[:, j]
        want[:, j] = acc
    assert torch.equal(torch.cumsum(xt, 1), want)


def test_certain_set_round_matches_the_one_at_a_time_cascade():
    """The scan twin's round: its certain set lies inside the greedy evict
    set (the kernel's, found one violator at a time), holds each row's
    first violator, and is the whole set wherever no violator is left."""
    rng = np.random.default_rng(1)
    B, n = 40, 60
    P = torch.from_numpy(rng.lognormal(0.0, 0.5, (B, n)))
    # some rows with high thresholds, where the round is complete
    thresh = torch.from_numpy(rng.uniform(0.0, 0.3 * n, (B, n))
                              + rng.choice([0.0, 35.0], (B, 1)))
    q1 = torch.from_numpy(rng.random((B, n)) < 0.8)
    evict, left = vectorsim._acd_twin(P, q1, q1, thresh, certain=True)
    viol = vectorsim._acd_twin(P, q1, q1, thresh, certain=False)[0]
    greedy = kref.acd_evict_plain(P, thresh, q1)
    assert torch.equal(evict | left, viol)
    assert not (evict & ~greedy).any()
    rows = viol.any(1)
    first = torch.argmax(viol.to(torch.int32), dim=1)
    assert evict[rows, first[rows]].all()
    full = ~left.any(1)
    assert torch.equal(evict[full], greedy[full])
    assert left.any() and (full & rows).any()


# -- hypothesis: the reference's two properties -------------------------------

try:        # optional: fuzz the twins' agreement when hypothesis is here
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    J_PROP = 6

    @st.composite
    def workloads(draw, J=J_PROP):
        """``tests/strategies.py:workloads`` on ``matrix_app(replicas=2)``:
        seeded uniform private latencies, a drawn public speed ratio."""
        seed = draw(st.integers(min_value=0, max_value=10**6))
        speed = draw(st.floats(min_value=0.3, max_value=0.9))
        rng = np.random.default_rng(seed)
        P = rng.uniform(0.5, 5.0, (J, pc.matrix_app(replicas=2).num_stages))
        return dict(P_private=P, P_public=P * speed)

    @st.composite
    def arrival_streams(draw, J=J_PROP, horizon=6.0):
        """``tests/strategies.py:arrival_streams``: [J] sorted releases."""
        seed = draw(st.integers(min_value=0, max_value=10**6))
        return np.sort(np.random.default_rng(seed).uniform(0.0, horizon, J))

    def _twins_agree(pred, arr, **load):
        kw = dict(c_max_grid=(4.0,), orders=("spt",), arrivals=arr,
                  device="cpu", **load)
        dag = pc.matrix_app(replicas=2)
        loop = pc.simulate_scenarios(dag, pred, engine_impl="loop", **kw)
        for impl in ("scan", "kernel"):
            assert_bitwise(pc.simulate_scenarios(dag, pred, engine_impl=impl,
                                                 **kw), loop,
                           where=f"{impl} == loop")

    @given(pred=workloads(), arr=arrival_streams())
    @settings(max_examples=12, deadline=None)
    def test_scan_matches_loop_on_random_workloads(pred, arr):
        _twins_agree(pred, arr)

    @given(pred=workloads(), arr=arrival_streams())
    @settings(max_examples=8, deadline=None)
    def test_scan_matches_loop_under_cold_and_caps(pred, arr):
        _twins_agree(pred, arr, concurrency=2,
                     coldstart=pc.ColdStartModel(warm_up_s=0.4,
                                                 keep_alive_s=1.5))


# -- the prep cache -----------------------------------------------------------

def _cache_tasks(c_max=(25.0, 60.0)):
    pred, act = _workload(5)
    return [dict(dag=pc.APPS["video"], pred=pred, act=act, c_max_grid=c_max,
                 orders=("spt", "hcf"))]


def _last_entry():
    return next(reversed(vectorsim._PREP_CACHE.values()))[0]


def test_repeated_sweep_hits_the_prep_cache():
    tasks = _cache_tasks()
    pf = pc.demo_portfolio()
    first = pc.sweep_scenarios(tasks, portfolio=pf, device="cpu")[0]
    assert vectorsim._LAST_RUN_STATS["plan_s"] > 0
    prepped = _last_entry()
    first.c_max[:] = -1.0  # a caller's edit reaches no cached task
    again = pc.sweep_scenarios(tasks, portfolio=pf, device="cpu")[0]
    assert vectorsim._LAST_RUN_STATS["plan_s"] == 0.0
    assert vectorsim._LAST_RUN_STATS["prep_s"] >= 0.0
    assert _last_entry() is prepped
    assert np.array_equal(again.c_max, (25.0, 60.0, 25.0, 60.0) * 2)
    fresh = pc.sweep_scenarios(_cache_tasks(), portfolio=pf, device="cpu",
                               engine_impl="loop")[0]
    assert _last_entry() is prepped  # equal arrays by content: a hit
    assert_bitwise(again, fresh)


@pytest.mark.parametrize("kind", ("ndarray", "tensor"))
def test_in_place_edit_misses_the_prep_cache(kind):
    """An array keys by its content, a CPU tensor as well: an in-place
    edit of a ``pred`` entry misses and the sweep sees the new demand."""
    tasks = _cache_tasks()
    if kind == "tensor":
        tasks[0]["pred"] = {k: torch.from_numpy(v)
                            for k, v in tasks[0]["pred"].items()}
    pf = pc.demo_portfolio()
    before = pc.sweep_scenarios(tasks, portfolio=pf, device="cpu")[0]
    prepped = _last_entry()
    tasks[0]["pred"]["P_private"][0, 0] *= 4.0
    after = pc.sweep_scenarios(tasks, portfolio=pf, device="cpu")[0]
    assert vectorsim._LAST_RUN_STATS["plan_s"] > 0
    assert _last_entry() is not prepped
    pred = {k: np.asarray(v) for k, v in tasks[0]["pred"].items()}
    want = pc.simulate_scenarios(pc.APPS["video"], pred,
                                 tasks[0]["act"], c_max_grid=(25.0, 60.0),
                                 orders=("spt", "hcf"), portfolio=pf,
                                 engine="des")
    assert_parity(after, want)
    assert not np.array_equal(before.start, after.start)


def test_prep_cache_holds_at_most_eight_grids():
    pf = pc.demo_portfolio()
    for i in range(10):
        pc.sweep_scenarios(_cache_tasks((20.0 + i,)), portfolio=pf,
                           device="cpu")
    assert len(vectorsim._PREP_CACHE) == vectorsim._PREP_CACHE_MAX == 8
    # the two oldest grids were dropped, the newest is kept
    pc.sweep_scenarios(_cache_tasks((29.0,)), portfolio=pf, device="cpu")
    assert vectorsim._LAST_RUN_STATS["plan_s"] == 0.0
    pc.sweep_scenarios(_cache_tasks((20.0,)), portfolio=pf, device="cpu")
    assert vectorsim._LAST_RUN_STATS["plan_s"] > 0


def test_cpu_sweep_after_a_cuda_keyed_entry(monkeypatch):
    """The device is not part of the key and no entry holds a device
    tensor: a sweep asked of ``cuda`` (here resolved to the CPU, the
    engine's device seam) leaves an entry that a ``cpu`` sweep hits, with
    the same result."""
    tasks = _cache_tasks((31.0, 45.0))
    pf = pc.demo_portfolio()
    real = vectorsim.resolve_device
    monkeypatch.setattr(vectorsim, "resolve_device",
                        lambda device=None: real("cpu"))
    on_cuda = pc.sweep_scenarios(tasks, portfolio=pf, device="cuda")[0]
    monkeypatch.setattr(vectorsim, "resolve_device", real)
    prepped = _last_entry()
    for p in prepped:
        assert all(isinstance(v, np.ndarray) for v in p.args.values())
    on_cpu = pc.sweep_scenarios(tasks, portfolio=pf, device="cpu")[0]
    assert vectorsim._LAST_RUN_STATS["plan_s"] == 0.0
    assert _last_entry() is prepped
    assert_bitwise(on_cpu, on_cuda)


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_twins_match_cpu():
    """Each impl on the card equals the CPU field for field on the grid's
    congested axes, the twins with no kernel launched and their float
    prefixes on the host; then a repeated sweep on the CPU hits the entry
    the card's sweep left."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    pred, act = _workload(11, J=64)
    for axis in ("cold", "faults", "lookahead"):
        for impl in IMPLS:
            kw = dict(_grid("tight"), portfolio=pc.demo_portfolio(),
                      engine_impl=impl, **_axes(pc)[axis])
            ops.reset_launch_counts()
            got = pc.simulate_scenarios(pc.APPS["video"], pred, act,
                                        device="cuda", **kw)
            counts = ops.launch_counts()
            cpu = pc.simulate_scenarios(pc.APPS["video"], pred, act,
                                        device="cpu", **kw)
            assert vectorsim._LAST_RUN_STATS["plan_s"] == 0.0
            assert_bitwise(got, cpu, where=f"{axis} {impl}")
            if impl == "kernel":
                assert counts["acd_evict"] > 0
            else:
                assert counts["acd_evict"] == counts["fifo_dispatch"] == 0
