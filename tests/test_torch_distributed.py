"""The port's distribution layer (``repro_torch.distributed``,
``repro_torch.launch.mesh``, the sharded ``Trainer`` and
``launch/train.py --mesh``) against the reference's and against the
unsharded port.

- The sharding rules: every parameter's spec and ZeRO spec, the decode
  caches' and the batch's, for every architecture at its full config
  (shapes from the port's ``meta``-device model and the reference's
  ``jax.eval_shape``), on the (16, 16), (2, 16, 16), (2, 4) and (1, 1)
  meshes, with the default flags, ``fold_model=False``, ``w2d`` and
  ``moe_token_gather``: equal to the reference's exactly.
- The sharded step, in float32 at the smoke configs of llama3-8b and
  olmoe-1b-7b, on ``gloo`` groups of separate rank processes
  (``tests/_torch_ranks.py``): at one rank (mesh (1, 1)) bit for bit the
  unsharded port, int8 moments too; on (1, 2), where the rules leave the
  batch whole ('data' has one index) and cut the weights over 'model',
  bit for bit too (the int8 moments then keep the whole leaves' blocks
  across cut rows); on (2, 1) and (2, 2), where the ranks sum their rows'
  gradients in another order, the losses and gradient norms within a
  relative 1e-6 and the parameters after 2 steps within 1e-5 of their
  scale.
- Checkpoints: saved on (2, 2) with int8 moments, restored on (2, 1),
  (1, 2), (1, 1) and without a mesh bit for bit, and read by the
  reference's ``restore``.
- ``gpipe`` on 4 ranks against the reference's on 4 host devices
  (``tests/_subproc.py:run_py``) and the sequential stages, within 1e-6;
  ``_quantize`` bit for bit the reference's; ``make_compressed_dp_step``
  on 4 ranks against the reference's on 4 devices within 1e-6 of the
  gradient's scale (the sum over ranks in gloo's order), its error
  feedback (the gradient's residual) included;
  ``wire_bytes`` equal.
- ``python -m repro_torch.launch.train --mesh test`` on 4 ranks trains;
  ``--mesh single`` / ``multi`` without 256 / 512 ranks raise.
"""
import dataclasses
import functools
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import (MeshSharder, NamedSharding, P,
                                     ShardingRules, batch_shardings,
                                     cache_shardings, opt_state_shardings,
                                     param_shardings)
from repro_torch.distributed.compression import _quantize, wire_bytes
from repro_torch.models import Model
from tests._subproc import run_py
from tests._torch_ranks import ROOT, spawn
from tests.test_torch_harness import reference

LOSS_RTOL = 1e-6
PARAM_OF_SCALE = 1e-5
GPIPE_ATOL = 1e-6
COMPRESS_RTOL = 1e-6


class StubMesh:
    """Axis names and sizes only: what the rules read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
FLAGS = {"default": {}, "no_fold": {"fold_model": False},
         "w2d": {"w2d": True}, "token_gather": {"moe_token_gather": True}}
CACHE = (64, 1024)                 # batch, cache_len of the decode caches
BATCHES = (256, 64, 8, 3)          # rows of the batch specs


@pytest.fixture(scope="module")
def ref():
    R = reference()
    from repro.distributed import compression, sharding
    R.sharding, R.compression = sharding, compression
    R.shapes = {}
    return R


def _ref_shapes(R, arch):
    """The reference's parameter and cache trees of ``arch`` as shapes
    (``jax.eval_shape``), cached."""
    if arch not in R.shapes:
        import jax
        m = R.models.Model(R.configs.get_config(arch))
        R.shapes[arch] = (
            jax.eval_shape(m.init, jax.random.PRNGKey(0)),
            jax.eval_shape(lambda: m.init_cache(*CACHE)))
    return R.shapes[arch]


def _flat_ref(tree):
    import jax
    from jax.sharding import PartitionSpec
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    """The port's model of ``arch`` on the ``meta`` device (shapes only)."""
    return Model(get_config(arch), device="meta")


def _flat_port(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_port(v, path + (str(i),)))
        return out
    return {"/".join(path): tuple(tree.spec)}


# -- the rules ---------------------------------------------------------------------

@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references(ref, monkeypatch, arch, mesh, flags):
    import jax

    monkeypatch.setattr(ref.sharding, "NamedSharding",
                        lambda m, spec: spec)
    shape, axes = MESHES[mesh]
    rules = ShardingRules(get_config(arch), StubMesh(shape, axes),
                          **FLAGS[flags])
    rrules = ref.sharding.ShardingRules(ref.configs.get_config(arch),
                                        StubMesh(shape, axes), **FLAGS[flags])
    model = _port_model(arch)
    params = dict(model.named_parameters())
    rparams, rcache = _ref_shapes(ref, arch)
    for zero in (False, True):
        got = {k.replace(".", "/"): tuple(v.spec) for k, v in
               param_shardings(rules, params, zero=zero).items()}
        want = _flat_ref(ref.sharding.param_shardings(rrules, rparams,
                                                      zero=zero))
        assert got == want, f"param specs, zero={zero}"
    got = {k.replace(".", "/"): tuple(v.spec)
           for k, v in opt_state_shardings(rules, params).items()}
    assert got == _flat_ref(ref.sharding.opt_state_shardings(rrules,
                                                             rparams))
    cache = model.init_cache(*CACHE)
    assert _flat_port(cache_shardings(rules, cache)) == _flat_ref(
        ref.sharding.cache_shardings(rrules, rcache))
    for b in BATCHES:
        batch = {"tokens": torch.empty((b, 16), device="meta"),
                 "loss_mask": torch.empty((b, 16), device="meta")}
        rbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                  for k, v in batch.items()}
        assert _flat_port(batch_shardings(rules, batch)) == _flat_ref(
            ref.sharding.batch_shardings(rrules, rbatch)), b
        for name in ("activations", "ffn_hidden", "attn_heads", "kv_cache",
                     "moe_expert_in5", "moe_hidden5", "rnn_hidden"):
            hshape = {"moe_expert_in5": (b, 4, 128, 20, 64),
                      "moe_hidden5": (b, 4, 128, 20, 4864)}.get(
                name, (b, 32, 512, 128))
            if name in ("activations", "ffn_hidden", "rnn_hidden"):
                hshape = (b, 512, 4096)
            want = rrules.hint(name, hshape)
            got = rules.hint(name, hshape)
            assert (got is None) == (want is None)
            assert got is None or tuple(got) == tuple(want), (name, b)


def test_spec_type_and_local_parts():
    """``P`` is a tuple of entries as ``PartitionSpec``; a NamedSharding
    cuts a dim over its axes' product, row-major in the entry's order."""
    spec = P(("data", "model"), None)
    assert tuple(spec) == (("data", "model"), None) and repr(spec).startswith(
        "P(")
    mesh = StubMesh((2, 4), ("data", "model"))
    mesh.coords = {"data": 1, "model": 2}
    sh = NamedSharding(mesh, spec)
    assert sh.local_shape((16, 3)) == (2, 3)
    assert sh.bounds((16, 3)) == ((12, 14), (0, 3))
    sh = NamedSharding(mesh, P("model", "data"))
    assert sh.bounds((8, 4)) == ((4, 6), (2, 4))
    with pytest.raises(ValueError, match="split"):
        sh.local_shape((6, 4))


def test_mesh_sharder_checks_the_rows_against_the_rule():
    mesh = StubMesh((2, 4), ("data", "model"))
    rules = ShardingRules(get_config("llama3-8b"), mesh)
    sharder = MeshSharder(rules)
    x = torch.zeros((2, 16, 4096))
    assert sharder(x, "activations") is x          # no batch cut: whole
    sharder.global_batch = 16                       # cut 8 ways
    assert sharder(x, "residual") is x
    with pytest.raises(ValueError, match="cut 8 ways"):
        sharder(torch.zeros((4, 16, 4096)), "residual")


# -- the sharded step, checkpoints, gpipe, compression on gloo ranks --------------

TRAIN4 = [("llama3-8b", (2, 2), "float32"), ("olmoe-1b-7b", (2, 2), "float32")]
TRAIN2 = [("llama3-8b", (2, 1), "float32"), ("llama3-8b", (1, 2), "float32"),
          ("llama3-8b", (1, 2), "int8"), ("olmoe-1b-7b", (2, 1), "float32"),
          ("olmoe-1b-7b", (1, 2), "int8")]
TRAIN1 = [("llama3-8b", (1, 1), "float32"), ("llama3-8b", (1, 1), "int8"),
          ("olmoe-1b-7b", (1, 1), "int8")]
#: a recurrent config on two ranks: its gradients summed across them
TRAIN2_RECURRENT = [("rwkv6-1.6b", (2, 1), "float32")]
RESTORE = {2: [(2, 1), (1, 2)], 1: [(1, 1), None]}
#: where every rank computes the whole batch, so nothing is summed across
#: ranks and the step is the unsharded one bit for bit
WHOLE_BATCH = {(1, 1), (1, 2)}


def _inputs():
    rng = np.random.default_rng(0)
    return dict(
        xs=rng.normal(size=(6, 2, 8)).astype(np.float32),
        ws=(rng.normal(size=(4, 8, 8)) * 0.3).astype(np.float32),
        w=(rng.normal(size=(16, 16)) * 0.1).astype(np.float32),
        batch=rng.normal(size=(16, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank case: 4 ranks (the (2, 2) steps, the checkpoint's
    save, gpipe, compression), then 2 ranks and 1 rank (their steps, the
    checkpoint's restores)."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    x = {k: v.tolist() for k, v in _inputs().items()}
    four = spawn("suite", 4, cases=[
        ("train", dict(runs=TRAIN4)),
        ("ckpt", dict(ckpt=ckpt, shape=(2, 2))),
        ("gpipe", dict(xs=x["xs"], ws=x["ws"])),
        ("compress", dict(w=x["w"], batch=x["batch"]))])
    out = {"train": {}, "restore": {}, "ckpt": ckpt, "saved": four[1],
           "gpipe": four[2], "compress": four[3]}
    runs = {4: four[0]}
    for world in (2, 1):
        got = spawn("suite", world, cases=[
            ("train", dict(runs=TRAIN2 + TRAIN2_RECURRENT if world == 2
                           else TRAIN1))] + [
            ("ckpt", dict(ckpt=ckpt, shape=shape, save=False))
            for shape in RESTORE[world]])
        runs[world] = got[0]
        for shape, res in zip(RESTORE[world], got[1:]):
            out["restore"][shape and tuple(shape)] = res
    for res in runs.values():
        for arch, shape, sd, got, want in res:
            out["train"][arch, shape, sd] = (got, want)
    return out


def _scale_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _step_values(log):
    """A training log's entries without ``straggled``: that is the step
    timer's wall-clock verdict on each run's own steps, not a value the
    step computes."""
    return [{k: v for k, v in e.items() if k != "straggled"} for e in log]


@pytest.mark.parametrize("arch,shape,state_dtype",
                         TRAIN4 + TRAIN2 + TRAIN1 + TRAIN2_RECURRENT)
def test_sharded_step_matches_unsharded(ranks, arch, shape, state_dtype):
    got, want = ranks["train"][arch, shape, state_dtype]
    assert [e["step"] for e in got["log"]] == [1, 2]
    assert sorted(got["state"]) == sorted(want["state"])
    if shape in WHOLE_BATCH:
        assert _step_values(got["log"]) == _step_values(want["log"])
        for k, t in want["state"].items():
            assert torch.equal(got["state"][k], t), k
        return
    for g, w in zip(got["log"], want["log"]):
        for key in ("loss", "grad_norm"):
            assert abs(g[key] - w[key]) <= LOSS_RTOL * abs(w[key]), key
        assert g["tokens"] == w["tokens"] and g["lr"] == w["lr"]
    for k, t in want["state"].items():
        if k.startswith("params"):
            assert _scale_err(got["state"][k], t) <= PARAM_OF_SCALE, k


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (1, 1), None])
def test_checkpoint_restores_on_any_mesh(ranks, shape):
    """Saved on (2, 2) with int8 moments (whole leaves, rank 0 writing);
    a fresh trainer on another mesh restores its parts bit for bit."""
    saved, got = ranks["saved"], ranks["restore"][shape]
    assert got["step"] == saved["step"] == 2
    assert sorted(got["state"]) == sorted(saved["state"])
    for k, t in saved["state"].items():
        assert torch.equal(got["state"][k], t), k


def test_sharded_checkpoint_is_read_by_the_reference(ref, ranks):
    import jax

    cfg = dataclasses.replace(ref.configs.get_smoke_config("llama3-8b"),
                              dtype="float32", kv_dtype="float32")
    params = ref.models.Model(cfg).init(jax.random.PRNGKey(3))
    from repro.training import checkpoint, optimizer
    opt = optimizer.adamw_init(params, optimizer.AdamWConfig(
        state_dtype="int8"))
    like = jax.tree_util.tree_map(lambda x: x * 0,
                                  {"params": params, "opt": opt})
    got, step = checkpoint.restore(ranks["ckpt"], like)
    assert step == 2
    flat = {"::".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(got)}
    saved = ranks["saved"]["state"]
    assert sorted(flat) == sorted(saved)
    for k, t in saved.items():
        np.testing.assert_array_equal(flat[k], t.numpy(), err_msg=k)


_GPIPE_REF = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.distributed.pipeline import gpipe
x = np.load(r'{path}')
mesh = Mesh(np.array(jax.devices()[:4]), ('stage',))
fn = lambda p, x: jnp.tanh(x @ p['w'])
with mesh:
    out = gpipe(fn, mesh, 'stage', 4, x['xs'].shape[0])(
        {{'w': jnp.asarray(x['ws'])}}, jnp.asarray(x['xs']))
np.save(r'{out}', np.asarray(out))
"""

_COMPRESS_REF = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.distributed.compression import make_compressed_dp_step
x = np.load(r'{path}')
mesh = Mesh(np.array(jax.devices()), ('data',))
w = jnp.asarray(x['w'])
loss_fn = lambda p, b: jnp.mean((b @ p['w'] - b) ** 2)
with mesh:
    g, ef, loss = make_compressed_dp_step(loss_fn, mesh, 'data')(
        {{'w': w}}, jnp.asarray(x['batch']), {{'w': jnp.zeros_like(w)}})
np.savez(r'{out}', g=np.asarray(g['w']), ef=np.asarray(ef['w']),
         loss=np.asarray(loss))
"""


def _run_reference(tmp_path, code, name):
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **_inputs())
    out = str(tmp_path / name)
    run_py(code.format(path=path, out=out), devices=4, timeout=300)
    return np.load(out)


def test_gpipe_matches_reference_and_sequential(ranks, tmp_path):
    got = ranks["gpipe"]
    want = _run_reference(tmp_path, _GPIPE_REF, "gpipe.npy")
    np.testing.assert_allclose(got["out"], want, rtol=0, atol=GPIPE_ATOL)
    np.testing.assert_allclose(got["out"], got["sequential"], rtol=0,
                               atol=GPIPE_ATOL)


def test_compressed_dp_step_matches_reference(ranks, tmp_path):
    got = ranks["compress"]
    want = _run_reference(tmp_path, _COMPRESS_REF, "compress.npz")
    # the error feedback is the gradient's quantization residual: an ulp
    # of the gradient moves it by as much, so both are held to a relative
    # COMPRESS_RTOL of the gradient's scale
    scale = float(np.abs(want["g"]).max())
    for key in ("g", "ef"):
        assert np.abs(got[key] - want[key]).max() <= COMPRESS_RTOL * scale
    assert abs(got["loss"] - float(want["loss"])) <= (
        COMPRESS_RTOL * abs(float(want["loss"])))
    assert np.abs(got["ef"]).max() > 0          # the residual is carried
    assert any(np.abs(e - got["ef_by_rank"][0]).max() > 0
               for e in got["ef_by_rank"][1:])  # each rank its own


@pytest.mark.parametrize("shape", [(1000,), (16, 16), (3, 700), (256,)])
def test_quantize_is_the_references(ref, shape):
    x = np.random.default_rng(len(shape)).normal(0, 2, shape).astype(
        np.float32)
    q, scale, n = _quantize(torch.from_numpy(x))
    rq, rscale, rn = ref.compression._quantize(ref.jax.numpy.asarray(x))
    assert n == rn
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))


@pytest.mark.parametrize("compressed", [False, True])
def test_wire_bytes_is_the_references(ref, compressed):
    import jax.numpy as jnp

    shapes = {"a": ((300,), np.float32), "b": ((16, 16), np.float32),
              "c": ((5, 7), np.float16)}
    port = {k: torch.zeros(s, dtype=getattr(torch, np.dtype(d).name))
            for k, (s, d) in shapes.items()}
    rtree = {k: jnp.zeros(s, d) for k, (s, d) in shapes.items()}
    assert wire_bytes(port, compressed) == ref.compression.wire_bytes(
        rtree, compressed)


# -- the launcher --------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_train_mesh_test_on_four_ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh", "test",
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "8",
         "--seq", "32", "--state-dtype", "int8"],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0] * 4, outs
    lines = outs[0].strip().splitlines()
    assert lines[-1].startswith("step     2 loss="), outs[0]
    assert math.isfinite(float(lines[-1].split("loss=")[1].split()[0]))
    assert not any("loss=" in o for o in outs[1:]), outs[1:]  # rank 0 logs


@pytest.mark.gpu
def test_cuda_quantization_and_schedule_equal_the_cpus():
    """Divisions by a constant give the CPU's bits on the card (torch's
    CUDA kernel would multiply by the rounded reciprocal of a Python
    divisor): ``_div`` itself, the int8 moments' linear quantization, the
    compressed step's and the schedule's warm-up. (The log-domain moment
    goes through the card's ``log``, which is not the CPU's: ROADMAP
    Queue 3 item 23's family.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.training import optimizer as TO

    x = torch.randn((64, 4096), generator=torch.Generator().manual_seed(0))
    for d in (127.0, 254.0, 7, 993, 3.0):
        assert torch.equal(TO._div(x.cuda(), d).cpu(), TO._div(x, d)), d
    want = TO.quantize_q8(x)
    got = TO.quantize_q8(x.cuda())
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    q, scale, n = _quantize(x.cuda())
    wq, wscale, wn = _quantize(x)
    assert n == wn and torch.equal(q.cpu(), wq)
    assert torch.equal(scale.cpu(), wscale)
    cfg = TO.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=1000)
    for step in range(7):
        s = torch.tensor(step, dtype=torch.int32)
        assert torch.equal(TO._lr_at(cfg, s.cuda()).cpu(), TO._lr_at(cfg, s))
