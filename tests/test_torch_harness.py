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
            import repro.core as core
            from repro.core import (arrivals, cost, dag, greedy, priority,
                                    scheduler, simulator, vectorsim)
        finally:
            if shim:
                del jax.experimental.enable_x64
        from repro.kernels import acd_sweep, ref
        from repro.serving.hybrid import serving_dag
        _REF = types.SimpleNamespace(
            jax=jax, core=core, arrivals=arrivals, cost=cost, dag=dag,
            greedy=greedy, priority=priority, scheduler=scheduler,
            simulator=simulator, vectorsim=vectorsim, acd_sweep=acd_sweep,
            kref=ref, serving_dag=serving_dag)
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
    code = ("import sys, repro_torch, repro_torch.kernels.build; "
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
