"""The port's applications (``repro_torch.apps``) against the reference's
(``repro.apps``): stage outputs, trace generation and the quickstart's
profile -> fit -> predict -> schedule pipeline, on the CPU at small scales.

Tolerances, stage by stage (each port stage gets the reference stage's own
input, so errors do not compound):

- matrix MM: bit for bit (integer ``x @ x.T``, exact in float32); LU: the
  same pivots, and the packed factors within ``1e-4 * max|LU|`` (the
  Gram matrix's condition number amplifies float32 rounding of two LAPACK
  builds);
- video EF and RI: bit for bit (quarter weights and means of 4 integers,
  exact in float32); DO and ME: ``|d| <= 1e-5 |want| + 1e-7`` (float32
  convolutions summed in another order);
- image uint8/int32 stages: at most 1 apart in at most 0.1% of elements
  (the two libraries round the float32 resize and DCT sums differently
  before the truncating cast or the rounding; ROADMAP Queue 3).

With the same clock, ``generate_traces`` gives identical trace dicts for
matrix and video; image's output sizes follow its packed-coefficient
counts and agree within 0.5%.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import apps
from repro_torch.apps import image, video
from repro_torch.core import SkedulixScheduler, dag_from_fields
from repro_torch.core import perfmodel as P
from tests.test_torch_harness import reference

SCALES = {"matrix": (0.2, 0.3), "video": (0.2, 0.3), "image": (0.15, 0.25)}


@pytest.fixture(scope="module")
def ref():
    return reference()


def _to_torch(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unwrap(out):
    return out[0] if isinstance(out, tuple) else out


def test_detector_weights_equal_the_reference(ref):
    detect = ref.video._make_detector(7)
    cells = dict(zip(detect.__code__.co_freevars,
                     (c.cell_contents for c in detect.__closure__)))
    with np.load(video.DETECTOR_WEIGHTS) as z:
        assert sorted(z.files) == ["w1", "w2", "w3"]
        assert sum(z[k].size for k in z.files) == 3672
        for name in ("w1", "w2", "w3"):
            want = np.asarray(cells[name])
            assert z[name].dtype == np.float32
            np.testing.assert_array_equal(z[name], want)
    for w, name in zip(video.load_detector_weights("cpu"), ("w1", "w2", "w3")):
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(cells[name]).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("n,k,stride", [(96, 3, 2), (48, 3, 2), (7, 3, 2),
                                        (12, 3, 1), (1, 3, 2)])
def test_same_padding_is_xla_s(ref, n, k, stride):
    """``"SAME"``: even inputs pad (0, 1) at stride 2, odd ones (1, 1)."""
    import jax

    x = np.arange(n * n, dtype=np.float32).reshape(1, n, n, 1)
    w = np.ones((k, k, 1, 1), np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = video._conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("n_in,n_out", [(300, 200), (176, 200), (200, 200),
                                        (1184, 200), (45, 200)])
def test_resize_weights_are_jax_s(ref, n_in, n_out):
    import jax.numpy as jnp
    from jax._src.image import scale

    want = scale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                    scale._fill_triangle_kernel, True)
    got = image.resize_weights(n_in, n_out)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                               rtol=0, atol=2 * np.finfo(np.float32).eps)
    assert np.asarray(jnp.asarray(want)).shape == got.shape


def _check_lu(x_np, got_lu):
    """Pivots equal to the reference's and factors within 1e-4 max|LU|."""
    import jax
    import jax.numpy as jnp

    lu_r, piv_r, _ = jax.lax.linalg.lu(jnp.asarray(x_np))
    _, piv_p = torch.linalg.lu_factor(torch.from_numpy(x_np))
    np.testing.assert_array_equal(piv_p.numpy() - 1, np.asarray(piv_r))
    lu_r = np.asarray(lu_r)
    assert np.abs(got_lu - lu_r).max() <= 1e-4 * np.abs(lu_r).max()


def _assert_uint_close(got, want, where):
    assert got.dtype == want.dtype and got.shape == want.shape, where
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, f"{where}: max diff {d.max()}"
    assert (d > 0).mean() <= 1e-3, f"{where}: {(d > 0).mean()} differ"


@pytest.mark.parametrize("app", ["matrix", "video", "image"])
@pytest.mark.parametrize("which", [0, 1])
def test_stage_outputs_match_reference(ref, app, which):
    scale = SCALES[app][which]
    rspec = ref.apps.SPECS[app](scale=scale)
    pspec = apps.SPECS[app](scale=scale, device="cpu")
    rng_r, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    n_jobs = 2 if app == "image" else 3
    for j in range(n_jobs):
        job_r, feats_r = rspec.make_job(rng_r)
        job_p, feats_p = pspec.make_job(rng_p)
        np.testing.assert_array_equal(feats_p, feats_r)
        np.testing.assert_array_equal(job_p.numpy(), np.asarray(job_r))
        assert job_p.device.type == "cpu"
        outs = ref.apps.run_job(rspec, job_r)
        dag = rspec.dag
        for k in dag.topo_order():
            preds = dag.predecessors(k)
            ins_r = [outs[p] for p in preds] if preds else [job_r]
            raw = pspec.stage_fns[k]([_to_torch(x) for x in ins_r])
            got = _np(_unwrap(raw))
            want = np.asarray(outs[k])
            where = f"{app} job {j} stage {dag.stages[k].name}"
            assert got.shape == want.shape and got.dtype == want.dtype, where
            name = dag.stages[k].name
            if app == "matrix" and k == 0 or (
                    app == "video" and name in ("EF", "RI")):
                np.testing.assert_array_equal(got, want, err_msg=where)
            elif app == "matrix":
                _check_lu(np.array(ins_r[0], dtype=np.float32), got)
            elif app == "video":
                assert (np.abs(got - want)
                        <= 1e-5 * np.abs(want) + 1e-7).all(), where
            else:
                _assert_uint_close(got, want, where)
                if isinstance(raw, tuple):  # compress: packed bytes
                    _, nbytes_r = ref.apps.base._unwrap(
                        rspec.stage_fns[k](ins_r))
                    assert abs(raw[1] - nbytes_r) <= 2e-3 * got.size, where


def _stepping_clock():
    """A clock stepping 1-7 ms per call, the same sequence in every run."""
    state = {"i": 0, "t": 0.0}

    def now():
        state["i"] += 1
        state["t"] += 1e-3 * (1 + state["i"] % 7)
        return state["t"]
    return now


TRACE_RUNS = {"matrix": (0.2, 16), "video": (0.2, 8), "image": (0.15, 4)}


@pytest.mark.parametrize("app", ["matrix", "video", "image"])
def test_generate_traces_match_reference(ref, app):
    scale, n = TRACE_RUNS[app]
    want = ref.apps.generate_traces(ref.apps.SPECS[app](scale=scale), n,
                                    seed=3, time_fn=_stepping_clock())
    got = apps.generate_traces(apps.SPECS[app](scale=scale, device="cpu"),
                               n, seed=3, time_fn=_stepping_clock())
    assert sorted(got) == sorted(want)
    for key in want:
        if app == "image" and key == "outsize":
            np.testing.assert_allclose(got[key], want[key], rtol=5e-3)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_run_job_and_split_traces(ref):
    spec = apps.SPECS["video"](scale=0.2, device="cpu")
    job, _ = spec.make_job(np.random.default_rng(0))
    outs = apps.run_job(spec, job)
    assert sorted(outs) == [0, 1, 2, 3]
    assert outs[1].shape[1:] == (16, 4) and outs[1].dtype == torch.float32
    traces = {"a": np.arange(10), "b": np.arange(20).reshape(10, 2)}
    tr, te = apps.split_traces(traces, 7)
    want_tr, want_te = ref.apps.split_traces(traces, 7)
    for key in traces:
        np.testing.assert_array_equal(tr[key], want_tr[key])
        np.testing.assert_array_equal(te[key], want_te[key])


def test_bare_app_spec_resolves_its_device():
    """A user's own ``AppSpec`` runs where the port's entry points run:
    ``cuda`` unless it names another device, raising without a GPU."""
    base = apps.SPECS["matrix"](scale=0.2, device="cpu")
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(apps.AppSpec) if f.name != "device"}
    if torch.cuda.is_available():
        assert apps.AppSpec(**fields).device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            apps.AppSpec(**fields)
    spec = apps.AppSpec(**fields, device="cpu")
    assert spec.device == torch.device("cpu")
    traces = apps.generate_traces(spec, 12, seed=0)
    pm = apps.fit_models(spec, traces)
    assert pm.stages[0].private.device == torch.device("cpu")


def test_quickstart_pipeline_matches_reference(ref):
    """``examples/quickstart.py``'s loop on both packages: the matrix app
    at half scale, 60 traced jobs split 45/15, the ridge models, their
    predictions and an SPT and an HCF schedule at 0.55x the all-private
    makespan."""
    rspec = ref.apps.SPECS["matrix"](scale=0.5)
    pspec = apps.SPECS["matrix"](scale=0.5, device="cpu")
    traces_r = ref.apps.generate_traces(rspec, 60, seed=0,
                                        time_fn=_stepping_clock())
    traces_p = apps.generate_traces(pspec, 60, seed=0,
                                    time_fn=_stepping_clock())
    for key in traces_r:
        np.testing.assert_array_equal(traces_p[key], traces_r[key])
    tr, te = apps.split_traces(traces_p, 45)
    pm_r = ref.apps.fit_models(rspec, tr)
    pm_p = apps.fit_models(pspec, tr)
    # the same penalty for every model
    for k in range(2):
        X = P.default_feature_builder(
            k, tr["base_features"], None if k == 0 else tr["outsize"][:, 0])
        ov = float(np.mean(tr["overhead"][:, k]))
        for y in (tr["private"][:, k] - ov, tr["public"][:, k],
                  tr["outsize"][:, k]):
            assert (P.grid_search_ridge(X, y, device="cpu")[1]
                    == ref.perfmodel.grid_search_ridge(X, y)[1])
    base = te["base_features"]
    pred_r, pred_p = pm_r.predict(base), pm_p.predict(base)
    for key in pred_r:
        np.testing.assert_allclose(pred_p[key], pred_r[key], rtol=1e-5,
                                   err_msg=key)
    act = dict(P_private=te["private"], P_public=te["public"],
               upload=pred_r["upload"], download=pred_r["download"])
    ref_sched = ref.scheduler.SkedulixScheduler(rspec.dag, pm_r)
    port_sched = SkedulixScheduler(
        dag_from_fields(dataclasses.asdict(rspec.dag)), pm_p)
    keys = ("P_private", "P_public", "upload", "download")
    priv = ref.simulator.simulate_all_private(
        rspec.dag, {k: pred_r[k] for k in keys}, act)
    c_max = priv.makespan * 0.55
    bitwise = all(np.array_equal(pred_p[k], pred_r[k]) for k in keys)
    for order in ("spt", "hcf"):
        want = ref_sched.schedule(c_max, base_features=base, act=act,
                                  order=order).result
        got = port_sched.schedule(c_max, base_features=base, act=act,
                                  order=order).result
        if bitwise:
            for fld in ("public_mask", "start", "end", "makespan",
                        "cost_usd"):
                np.testing.assert_array_equal(getattr(got, fld),
                                              getattr(want, fld))
        else:
            np.testing.assert_allclose(got.makespan, want.makespan,
                                       rtol=1e-5)
            np.testing.assert_allclose(got.cost_usd, want.cost_usd,
                                       rtol=1e-5)
        assert got.met_deadline == want.met_deadline
