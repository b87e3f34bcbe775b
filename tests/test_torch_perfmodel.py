"""The port's perf models (``repro_torch.core.perfmodel``) against the
reference's (``repro.core.perfmodel``).

Both packages fit in float32 (the reference's ``jnp.result_type(float)``
with 64-bit types off) and draw their CV folds from the same permutation,
so they choose the same ridge penalty; parameters and predictions agree to
float32 rounding (``rtol`` 1e-5; the two libraries reduce and solve in
different orders). The numpy permutation equals
``jax.random.permutation(PRNGKey(seed), n)`` bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (SkedulixScheduler, dag_from_fields,
                              perf_model_from_fields)
from repro_torch.core import perfmodel as P
from repro_torch.core import prng
from repro_torch.core.precision import ieee_float32
from tests.test_torch_harness import reference

RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return reference()


# n = 1625 is the last size with one shuffle round, 1626 the first with two
@pytest.mark.parametrize("n", [1, 2, 5, 45, 64, 774, 1000, 1625, 1626, 1700,
                               5000])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_permutation_matches_jax(ref, seed, n):
    jax = ref.jax
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    np.testing.assert_array_equal(prng.permutation(seed, n), want)


def test_split_and_bits_match_jax(ref):
    jax = ref.jax
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    got = prng.split(prng.prng_key(3))
    assert got == [tuple(int(v) for v in jax.random.key_data(k))
                   for k in (k1, k2)]
    np.testing.assert_array_equal(
        prng.random_bits32(got[1], 37),
        np.asarray(jax.random.bits(k2, (37,), dtype=np.uint32)))


def _regression(seed, n, d, collinear=False):
    rng = np.random.default_rng(seed)
    X = rng.lognormal(10.0, 0.3, (n, d))
    if collinear:  # the matrix app's features: csv bytes = 2.5 * n^2
        X[:, 1] = X[:, 0] / 2.5
    y = X @ rng.uniform(1e-7, 1e-6, d) + rng.normal(0, 0.01, n) + 0.3
    return X, y


CASES = [(0, 45, 2, False), (1, 60, 3, False), (2, 200, 2, True),
         (3, 774, 3, False), (4, 31, 1, False)]


def _assert_ridge_close(port, ref_model, X):
    for name in ("b", "mu", "sigma"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(),
            np.asarray(getattr(ref_model, name)), rtol=RTOL, err_msg=name)
    got = port.predict(X).numpy()
    want = np.asarray(ref_model.predict(X))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("seed,n,d,collinear", CASES)
@pytest.mark.parametrize("lam", [1e-3, 1.0, 100.0])
def test_fit_ridge_matches_reference(ref, seed, n, d, collinear, lam):
    X, y = _regression(seed, n, d, collinear)
    port = P.fit_ridge(X, y, lam, device="cpu")
    want = ref.perfmodel.fit_ridge(X, y, lam)
    _assert_ridge_close(port, want, X)
    if not collinear:  # collinear weights are fixed only along (1, 1)
        np.testing.assert_allclose(port.w.numpy(), np.asarray(want.w),
                                   rtol=1e-4)


@pytest.mark.parametrize("seed,n,d,collinear", CASES)
def test_grid_search_picks_the_reference_lambda(ref, seed, n, d, collinear):
    X, y = _regression(seed, n, d, collinear)
    port, lam = P.grid_search_ridge(X, y, device="cpu")
    want, want_lam = ref.perfmodel.grid_search_ridge(X, y)
    assert lam == want_lam
    _assert_ridge_close(port, want, X)


def test_grid_search_takes_explicit_folds(ref):
    """``fold_id=`` replaces the permutation; the reference's own folds
    (built from jax's permutation) give the default result."""
    jnp = ref.jax.numpy
    X, y = _regression(5, 90, 2)
    perm = ref.jax.random.permutation(ref.jax.random.PRNGKey(0), 90)
    folds = np.asarray(jnp.zeros(90, dtype=jnp.int32).at[perm].set(
        jnp.arange(90) % 5))
    np.testing.assert_array_equal(P.fold_ids(90, 5, 0), folds)
    a, lam_a = P.grid_search_ridge(X, y, fold_id=folds, device="cpu")
    b, lam_b = P.grid_search_ridge(X, y, device="cpu")
    assert lam_a == lam_b
    np.testing.assert_array_equal(a.w.numpy(), b.w.numpy())
    # every row in its own fold is leave-one-out CV: still a valid search
    c, lam_c = P.grid_search_ridge(X, y, k=90, fold_id=np.arange(90),
                                   device="cpu")
    assert lam_c in [float(np.float32(v)) for v in P.DEFAULT_LAMS]


def test_mape_matches_reference(ref):
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0.1, 2.0, 50), rng.uniform(0.1, 2.0, 50)
    assert P.mape(a, b) == ref.perfmodel.mape(a, b)


#: (app, number of base features): the apps' DAGs and feature widths
APPS = (("matrix", 2), ("video", 2), ("image", 3))


@pytest.fixture(scope="module")
def app_traces(ref):
    """Seeded traces shaped like each app's (base features [N, D0],
    private/public/outsize/overhead [N, M]): stage latencies and sizes
    linear in the features plus noise, so the ridge fits have something
    to find. The apps' own traces are held in ``test_torch_apps.py``."""
    out = {}
    for seed, (name, d0) in enumerate(APPS):
        dag = ref.core.APPS[name]
        M, n = dag.num_stages, 40 + 10 * seed
        rng = np.random.default_rng(seed)
        base = rng.lognormal(11.0, 0.3, (n, d0))
        if name == "matrix":
            base[:, 0] = 2.5 * base[:, 1]  # csv bytes = 2.5 * n^2
        coef = rng.uniform(1e-7, 1e-6, (d0, M))
        overhead = rng.uniform(0.015, 0.020, (n, M))
        compute = base @ coef * rng.lognormal(0.0, 0.05, (n, M))
        out[name] = (dag, dict(
            base_features=base, private=compute + overhead,
            public=(compute / 1.7 + 0.05) * rng.lognormal(0, 0.05, (n, M)),
            outsize=base[:, :1] * rng.uniform(0.5, 2.0, M)
            * rng.lognormal(0, 0.02, (n, M)),
            overhead=overhead))
    return out


def _port_dag(dag):
    return dag_from_fields(dataclasses.asdict(dag))


def _assert_pred_close(got, want):
    for key in ("P_private", "P_public", "sizes", "upload", "download"):
        assert got[key].dtype == np.float64
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("app", ["matrix", "video", "image"])
def test_app_perf_model_matches_reference(ref, app_traces, app):
    dag, traces = app_traces[app]
    tr, te = ref.apps.split_traces(traces, len(traces["private"]) * 3 // 4)
    want = ref.perfmodel.fit_app_perf_model(dag, tr)
    port = P.fit_app_perf_model(_port_dag(dag), tr, device="cpu")
    _assert_pred_close(port.predict(te["base_features"]),
                       want.predict(te["base_features"]))
    for sp, sr in zip(port.stages, want.stages):
        assert sp.overhead_s == sr.overhead_s


def _fields(model):
    """Plain fields of a reference AppPerfModel (numpy arrays)."""
    def ridge(m):
        return None if m is None else {k: np.asarray(getattr(m, k))
                                       for k in ("w", "b", "mu", "sigma")}
    return {"stages": [dict(private=ridge(s.private), public=ridge(s.public),
                            outsize=ridge(s.outsize), upload=ridge(s.upload),
                            download=ridge(s.download),
                            overhead_s=s.overhead_s)
                       for s in model.stages]}


@pytest.mark.parametrize("app", ["matrix", "video", "image"])
def test_perf_model_from_fields_reproduces_reference(ref, app_traces, app):
    dag, traces = app_traces[app]
    want = ref.perfmodel.fit_app_perf_model(dag, traces)
    port = perf_model_from_fields(_port_dag(dag), _fields(want),
                                  device="cpu")
    for sp in port.stages:
        assert sp.private.w.dtype == torch.float32
    base = traces["base_features"]
    got, exp = port.predict(base), want.predict(base)
    for key in exp:  # same parameters: only the product's order differs
        np.testing.assert_allclose(got[key], exp[key], rtol=1e-6,
                                   err_msg=key)


def test_scheduler_predict_raises_without_a_model(ref):
    sched = SkedulixScheduler(_port_dag(ref.core.APPS["matrix"]))
    with pytest.raises(ValueError, match="no perf model attached"):
        sched.predict(np.ones((3, 2)))
    with pytest.raises(ValueError, match="no perf model attached"):
        sched.schedule(1.0, base_features=np.ones((3, 2)))
    with pytest.raises(ValueError):
        ref.scheduler.SkedulixScheduler(
            ref.core.APPS["matrix"]).predict(np.ones((3, 2)))


def test_scheduler_predict_uses_the_perf_model(ref, app_traces):
    dag, traces = app_traces["matrix"]
    pm = P.fit_app_perf_model(_port_dag(dag), traces, device="cpu")
    sched = SkedulixScheduler(pm.dag, pm)
    base = traces["base_features"][:12]
    got = sched.predict(base)
    want = pm.predict(base)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    rep = sched.schedule(float(got["P_private"].sum()) / 4.0,
                         base_features=base)
    assert np.isfinite(rep.result.makespan)
    assert rep.pred["P_private"] is not None


@pytest.mark.parametrize("outer", ["tf32", "ieee", "legacy high"])
def test_ieee_float32_turns_tf32_off_in_its_scope_and_restores(outer):
    """The fits' scope: TF32 off for cuBLAS and cuDNN inside, and the
    process's own setting back after it, whichever API set it (also as
    the decorator the fits and predictions use)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = matmul.fp32_precision
    try:
        if outer == "legacy high":
            torch.set_float32_matmul_precision("high")
        else:
            matmul.fp32_precision = outer
        seen = matmul.fp32_precision

        @ieee_float32()
        def inside():
            return matmul.fp32_precision, cudnn.allow_tf32

        with ieee_float32():
            assert (matmul.fp32_precision, cudnn.allow_tf32) == ("ieee",
                                                                 False)
        assert inside() == ("ieee", False)
        assert matmul.fp32_precision == seen
        if outer == "legacy high":
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        matmul.fp32_precision = before
    torch.get_float32_matmul_precision()  # the legacy reader still works
