"""Parity harness between the PyTorch port (``repro_torch``) and the JAX
reference (``repro``), and the port's import rules.

:func:`reference` is the only way the port's tests reach the reference. On
JAX releases that dropped ``jax.experimental.enable_x64`` the reference's
engine module fails to import; the harness installs ``jax.enable_x64``
under the old name for the duration of the import and removes it again, so
nothing else in the test run sees the shim. Call it from fixtures or
test bodies only, never while a module is imported: the reference must not
sit in ``sys.modules`` while pytest collects other files.
"""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "src" / "repro_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"

_REF = None


def reference() -> types.SimpleNamespace:
    """The reference modules the port is held against (imported once)."""
    global _REF
    if _REF is None:
        import jax
        import jax.experimental

        shim = not hasattr(jax.experimental, "enable_x64")
        if shim:
            jax.experimental.enable_x64 = jax.enable_x64
        try:
            import repro.apps as apps
            import repro.core as core
            from repro.apps import image, matrix, video
            from repro.core import (arrivals, cost, dag, greedy, perfmodel,
                                    priority, scheduler, simulator,
                                    vectorsim)
            from repro.kernels import matmul, ops
            import repro.configs as configs
            import repro.models as models
            from repro.kernels import rglru, rwkv6
            from repro.models import layers, moe, recurrent
            from repro.serving import engine
            from repro.launch import specs as launch_specs
            # the package's ``roofline`` is the function, not the module
            launch_roofline = importlib.import_module(
                "repro.launch.roofline")
        finally:
            if shim:
                del jax.experimental.enable_x64
        from repro.kernels import acd_sweep, ref
        from repro.serving.hybrid import serving_dag
        _REF = types.SimpleNamespace(
            jax=jax, core=core, arrivals=arrivals, cost=cost, dag=dag,
            greedy=greedy, priority=priority, scheduler=scheduler,
            simulator=simulator, vectorsim=vectorsim, acd_sweep=acd_sweep,
            kref=ref, serving_dag=serving_dag, apps=apps, matrix=matrix,
            video=video, image=image, perfmodel=perfmodel, matmul=matmul,
            kops=ops, configs=configs, models=models, layers=layers,
            recurrent=recurrent, moe=moe, rglru=rglru, rwkv6=rwkv6,
            engine=engine, launch_roofline=launch_roofline,
            launch_specs=launch_specs)
    return _REF


def workload(dag, J, seed, jitter=0.1):
    """Seeded pred/act matrices (the reference equivalence suite's)."""
    rng = np.random.default_rng(seed)
    M = dag.num_stages
    P_priv = rng.lognormal(0.0, 0.5, (J, M)) * 2.0
    pred = dict(P_private=P_priv,
                P_public=P_priv * rng.uniform(0.8, 1.6, (J, M)),
                upload=rng.uniform(0.05, 0.3, (J, M)),
                download=rng.uniform(0.05, 0.3, (J, M)))
    act = {k: v * rng.lognormal(0, jitter, v.shape) for k, v in pred.items()}
    return pred, act


def grid_for(dag, pred, fracs=(0.3, 0.6, 1.2)):
    base = float(pred["P_private"].sum()) / float(dag.replicas.sum())
    return tuple(float(base * f) for f in fracs)


#: result fields every engine comparison covers
FIELDS = ("makespan", "cost_usd", "public_mask", "completion", "start",
          "end", "n_offloaded_stages", "n_init_offloaded_jobs",
          "per_stage_offloads", "provider", "replica", "segment",
          "attempts", "failed", "abandoned", "queue_wait", "cold")


def assert_bitwise(port, ref, fields=FIELDS, where=""):
    """Every field equal value for value (NaN matches NaN)."""
    for fld in fields:
        a = np.asarray(getattr(port, fld))
        b = np.asarray(getattr(ref, fld))
        assert a.shape == b.shape, f"{where} {fld}: {a.shape} != {b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=f"{where} field {fld}")


def assert_parity(port, des, where=""):
    """The parity contract against the DES: placements, replicas,
    providers, segments and start/end exact; cost and makespan isclose."""
    for fld in ("public_mask", "provider", "replica", "segment", "start",
                "end", "completion", "n_offloaded_stages",
                "n_init_offloaded_jobs", "per_stage_offloads"):
        np.testing.assert_array_equal(np.asarray(getattr(port, fld)),
                                      np.asarray(getattr(des, fld)),
                                      err_msg=f"{where} field {fld}")
    for fld in ("makespan", "cost_usd"):
        np.testing.assert_allclose(getattr(port, fld), getattr(des, fld),
                                   rtol=1e-12, atol=0,
                                   err_msg=f"{where} field {fld}")


#: times a multiply-add contraction of the reference's XLA build can move
FMA_FIELDS = ("start", "end", "completion", "queue_wait", "makespan",
              "cost_usd")


def assert_bitwise_or_des(port, ref, des, where=""):
    """Every field of ``port`` equal to the reference's, except a time
    the reference's XLA CPU build computes through a fused multiply-add
    where the DES rounds the product first: there the port must equal the
    DES exactly (the DES decides) and the reference to a relative 1e-14.
    Discrete fields are always exact."""
    assert_bitwise(port, ref, fields=tuple(f for f in FIELDS
                                           if f not in FMA_FIELDS),
                   where=where)
    for fld in FMA_FIELDS:
        a = np.asarray(getattr(port, fld))
        b = np.asarray(getattr(ref, fld))
        d = np.asarray(getattr(des, fld))
        off = ~((a == b) | (np.isnan(a) & np.isnan(b)))
        if not off.any():
            continue
        if fld not in ("makespan", "cost_usd"):
            np.testing.assert_array_equal(a[off], d[off],
                                          err_msg=f"{where} {fld} vs DES")
        np.testing.assert_allclose(a[off], b[off], rtol=1e-14, atol=0,
                                   err_msg=f"{where} {fld}")


def twin(x):
    """The reference's twin of a port object (an arrival process, fault
    model, retry policy, cold-start model, policy, ...): the class of the
    same name in the reference's module, built from the same fields (a
    dataclass) or the same attributes. Lists and tuples map element-wise;
    anything not of the port passes through."""
    if isinstance(x, (list, tuple)) and not dataclasses.is_dataclass(x):
        return type(x)(twin(v) for v in x)
    mod = type(x).__module__
    if isinstance(x, type) or not mod.startswith("repro_torch."):
        return x
    cls = getattr(importlib.import_module(
        mod.replace("repro_torch", "repro", 1)), type(x).__name__)
    if dataclasses.is_dataclass(x):
        return cls(**{f.name: getattr(x, f.name)
                      for f in dataclasses.fields(x)})
    out = object.__new__(cls)
    out.__dict__.update(vars(x))
    return out


def held_online(ps, rs, plen, ntok, arrivals, engine="vector", **kw):
    """``serve_online`` of a port scheduler ``ps`` and a reference one
    ``rs`` on one stream (every other argument twinned): the DES field for
    field; the engine bit for bit or, where the reference fuses a time,
    equal to the port's DES (``assert_bitwise_or_des``). Returns the
    port's report."""
    rep = ps.serve_online(plen, ntok, arrivals, engine=engine, **kw)
    want = rs.serve_online(plen, ntok, twin(arrivals), engine=engine,
                           **{k: twin(v) for k, v in kw.items()})
    np.testing.assert_array_equal(rep.release, want.release)
    np.testing.assert_array_equal(rep.admitted, want.admitted)
    assert rep.mode == want.mode
    if engine == "des":
        assert_bitwise(rep.result, want.result)
        assert rep.summary() == want.summary()
    else:
        des = ps.serve_online(plen, ntok, arrivals, engine="des", **kw)
        assert_parity(rep.result, des.result)
        assert_bitwise_or_des(rep.result, want.result, des.result)
    return rep


def _imported_modules(path: Path):
    """Absolute module names imported by a Python source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted(PORT_DIR.rglob("*.py")) + [CHIP_SMOKE]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), (
                f"{path.relative_to(ROOT)} imports {mod}")


def test_import_repro_torch_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.apps, "
            "repro_torch.core.perfmodel, repro_torch.kernels.build, "
            "repro_torch.configs, repro_torch.models, repro_torch.serving, "
            "repro_torch.core.milp, repro_torch.training, "
            "repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_reference_shim_is_removed_after_import():
    ref = reference()
    import jax.experimental

    assert not hasattr(jax.experimental, "enable_x64")
    # the reference engine itself still runs (it bound the name at import)
    dag = ref.core.APPS["matrix"]
    pred, act = workload(dag, 6, 0)
    out = ref.vectorsim.simulate_scenarios(dag, pred, act,
                                           engine_impl="loop")
    assert out.num_scenarios == 1
    assert not hasattr(jax.experimental, "enable_x64")
